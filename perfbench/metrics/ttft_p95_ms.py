"""95th percentile, over every request whose first token came in the
window, of the time from its client's send to its first token."""
from perfbench.harness import readings


def read(run):
    return readings.p95_ms(run.window.ttfts())
