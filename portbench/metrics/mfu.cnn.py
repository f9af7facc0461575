"""The whole step's share of the int8 peak: the operations of the
images answered before the traced slice, per second, over 1,979 TOP/s,
in %."""

from portbench.yardstick import peaks, readings


def read(run):
    return readings.mfu_pct(run, peaks.INT8_OPS_PER_S)
