"""Share of the traced slice's device idle time (outside the union of
its kernels, copies and fills) that lies inside some ``engine.*`` span,
in %, the spans put on the trace's clock at each decode step's and
prefill's read-back of its sampled tokens.  No reading unless then, in
at least 90 % of the slice's steps and prefills, the upload the host
waits for (a step's tokens and positions, a prefill's prompt) ends
where the spans say it does: the test that the spans and the device
trace share one clock."""

from portbench.yardstick import engine_spans, spans


def read(run):
    return engine_spans.idle_named_share_pct(run, spans.recorded())
