"""The whole step's share of the bf16 peak: the FLOPs of the tokens
emitted before the traced slice (the yardstick's count of a decoded
token at the pool's mean prompt length), per second, over 989 TFLOP/s
(the configuration runs bf16), in %."""

from portbench.yardstick import peaks, readings


def read(run):
    return readings.mfu_pct(run, peaks.BF16_FLOPS_PER_S)
