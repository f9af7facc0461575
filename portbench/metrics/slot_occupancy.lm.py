"""Live slots over ``max_batch``, the mean over the decode steps that
ended before the traced slice (the engine's ``slot_steps`` over its
steps), in %."""

from portbench.yardstick import decode


def read(run):
    return decode.slot_occupancy_pct(run)
