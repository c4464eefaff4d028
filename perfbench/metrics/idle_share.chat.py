"""Share of the traced window with no operation running on the device, in percent."""
from perfbench.harness import readings


def read(run):
    return readings.idle_share(run)
