"""Median host time of one ``Engine.step`` (the ``engine.step``
stretch: the tokens' upload, the model's decode step over every slot,
sampling and the tokens' read-back), from the server's stamps around
each step that ended before the traced slice, in ms."""

from portbench.yardstick import decode


def read(run):
    return decode.step_ms(run)
