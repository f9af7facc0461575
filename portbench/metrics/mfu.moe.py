"""The whole step's share of the float32 peak: the FLOPs of the
tokens answered before the traced slice, per second, over 67 TFLOP/s
(the configuration runs float32 with TF32 off), in %."""

from portbench.yardstick import peaks, readings


def read(run):
    return readings.mfu_pct(run, peaks.FP32_FLOPS_PER_S)
