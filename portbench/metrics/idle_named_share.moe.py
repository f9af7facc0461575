"""Share of the traced slice's device idle time (outside the union of
its kernels, copies and fills) that lies inside some program span other
than a request's queue wait, in %, the spans put on the trace's clock
at each dispatch's input copy.  No reading unless then, in at least
90 % of the slice's dispatches, the answers' device-to-host copy lies
inside that dispatch's ``gateway.copy_out`` span (within 0.1 ms): the
test that the spans and the device trace share one clock."""

from portbench.yardstick import spans


def read(run):
    return spans.idle_named_share_pct(run, spans.recorded())
