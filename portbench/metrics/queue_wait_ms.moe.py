"""Median of a request's wait in the gateway's queue, from its admission
to the pop of its batch (the ``gateway.queue`` span), over the requests
popped in the traced slice, in ms."""

from portbench.yardstick import spans


def read(run):
    return spans.queue_wait_ms(run, spans.recorded())
