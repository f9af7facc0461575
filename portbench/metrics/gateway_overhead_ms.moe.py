"""Median of a dispatch's gateway time outside the forward
(``DispatchStages.total - forward``), over dispatches completed before the
traced slice, in ms."""

from portbench.yardstick import readings


def read(run):
    return readings.stage_median_ms(run, lambda st: st.total - st.forward)
