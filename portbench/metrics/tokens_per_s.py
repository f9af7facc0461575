"""Tokens answered in the window per second of the window (a request
carries the configuration's tokens per request)."""

from portbench.yardstick import readings


def read(run):
    return readings.rate_per_s(run)
