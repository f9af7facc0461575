"""Median of a dispatch's copy of its payloads to the device
(``x.to(device)`` in ``CompiledModel.__call__``, the ``runtime.copy_in``
span), over the dispatches in the traced slice, in ms."""

from portbench.yardstick import spans


def read(run):
    return spans.copy_in_ms(run, spans.recorded())
