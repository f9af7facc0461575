"""Share of the traced slice the process spent in garbage collection
(Σ ``process.gc`` spans within the slice over the slice), in %."""

from portbench.yardstick import spans


def read(run):
    return spans.gc_pause_share_pct(run, spans.recorded())
