"""Images answered in the window per second of the window."""

from portbench.yardstick import readings


def read(run):
    return readings.rate_per_s(run)
