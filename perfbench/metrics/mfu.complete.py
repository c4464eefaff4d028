"""The FLOPs that the window's delivered tokens need (prompt tokens, not
pads; live rows; attention over the real context) over the window's
seconds at the card's bf16 peak, in percent."""
from perfbench.harness import readings


def read(run):
    return readings.mfu(run)
