"""K1 (the fused dot layer's requantizing entry) against its roofline:
the least time of its launches in the traced slice (the larger of bytes
at HBM bandwidth and int8 operations at the tensor-core peak, per layer
at the dispatch's images) over their device time, in %."""

from portbench.yardstick import readings


def read(run):
    return readings.k1_roofline_pct(run)
