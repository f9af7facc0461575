"""Median of a dispatch's forward in the worker thread, the copy of
the answers to the host included (``DispatchStages.forward``), over
dispatches completed before the traced slice, in ms."""

from portbench.yardstick import readings


def read(run):
    return readings.stage_median_ms(run, lambda st: st.forward)
