"""Median wall time of a decode step in the window (from one delivery of
tokens to the next)."""
from perfbench.harness import readings


def read(run):
    return readings.median_ms(dt for _, _, dt in run.window.decode_steps())
