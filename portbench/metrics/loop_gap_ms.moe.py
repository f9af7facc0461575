"""Median time from the end of one dispatch (its futures resolved) to
the pop of the next (from one ``gateway.dispatch`` span's end to the
next one's start), over consecutive dispatches in the traced slice: the
event loop outside every stage, in ms."""

from portbench.yardstick import spans


def read(run):
    return spans.loop_gap_ms(run, spans.recorded())
