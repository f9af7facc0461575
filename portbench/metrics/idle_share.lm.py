"""Share of the traced slice in which no operation ran on the device
(one minus the union of kernel, copy and fill intervals over the slice),
in %."""

from portbench.yardstick import readings


def read(run):
    return readings.idle_share_pct(run)
