"""95th percentile of the gaps between consecutive output tokens of a
request, over every gap of every request with both tokens in the window."""
from perfbench.harness import readings


def read(run):
    return readings.p95_ms(run.window.gaps())
