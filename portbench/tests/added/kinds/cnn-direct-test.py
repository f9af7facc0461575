"""A kind added as a file alone (test only): the CNN kind, served by
``servers/direct-test.py``."""

from pathlib import Path

from portbench import catalog

_cnn = catalog.module("kinds", "cnn", Path(__file__).resolve().parents[2])
System = _cnn.System
UNIT = _cnn.UNIT
SERVER = "direct-test"
