"""Arithmetic that several metric readers share (`perfbench/metrics`)."""
from __future__ import annotations

import math

import numpy as np

from . import work


def median_ms(seconds) -> float | None:
    seconds = list(seconds)
    return float(np.median(seconds)) * 1e3 if seconds else None


def p95_ms(seconds) -> float | None:
    return float(np.percentile(seconds, 95)) * 1e3 if len(seconds) else None


def mfu(run) -> float | None:
    """FLOPs of the tokens delivered in the window over the window's seconds
    at the card's peak, in percent."""
    if run.peaks is None:
        return None
    flops = work.window_flops(run.model, run.window)
    return 100.0 * flops / (run.window.seconds * run.peaks["flops"]) if flops else None


def idle_share(run) -> float | None:
    """Share of the traced window in which no operation ran on the device, in percent."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline(run, kind: str, phase: str, *spans: str) -> float | None:
    """The bound of every ``kind`` sublayer call of ``phase`` ("decode" or
    "prefill") in the rounds traced with spans over the device time
    launched inside ``spans``, in percent."""
    if run.spans is None or run.peaks is None:
        return None
    trace, window = run.spans
    bound = 0.0
    for r in window.rounds:
        if phase == "prefill":
            if not math.isnan(r.t_prefill):          # the prefill was launched
                bound += work.kind_bound_s(run.model, kind, "prefill",
                                           [len(q.prompt) for q in r.reqs], run.peaks)
            continue
        for s in range(1, r.launched_steps() + 1):
            bound += work.kind_bound_s(run.model, kind, "decode", work.live_lengths(r, s),
                                       run.peaks)
    device = trace.device_s(*spans)
    return 100.0 * bound / device if bound and device else None
