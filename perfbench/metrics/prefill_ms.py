"""Median wall time of a round's prefill in the window, from the call into
``lm.prefill`` to the delivery of its tokens."""
from perfbench.harness import readings


def read(run):
    return readings.median_ms(dt for _, dt in run.window.prefills())
