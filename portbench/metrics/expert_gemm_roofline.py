"""The expert products and the router against their roofline: the FLOPs
the dispatched tokens need (router and top-k experts, not empty capacity
slots) at the float32 peak over the device time of the GEMM kernels in
the traced slice, in %."""

from portbench.yardstick import readings


def read(run):
    return readings.expert_gemm_roofline_pct(run)
