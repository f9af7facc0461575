"""Host time of the prefills that ended before the traced slice (each an
``Engine.submit``: the prompt's upload, the model's prefill, the first
token's read-back and the slot's cache write) per 1,000 prompt tokens,
in ms."""

from portbench.yardstick import decode


def read(run):
    return decode.prefill_ms_per_ktok(run)
