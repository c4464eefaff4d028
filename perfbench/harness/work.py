"""The work the window's requests need, from the sublayer kinds' counts.

Useful work only: prompt tokens and not pads, live rows and not rows past
their length, attention over each request's real context (its prompt and
the tokens it has so far).  Each function returns (FLOPs, bytes) or sums
of bound seconds on the card's peaks (`peaks.json`).
"""
from __future__ import annotations

from perfbench import reference


def _layer_kinds(model: dict):
    for i in range(model["n_layers"]):
        yield from reference.layer_kinds(model, i)


def live_lengths(rnd, s: int) -> list[int]:
    """Real context, after step s's slot, of each row still live at decode step s."""
    return [len(r.prompt) + s for r in rnd.reqs if s < r.max_new]


def kind_bound_s(model: dict, kind: str, phase: str, arg, peaks: dict) -> float:
    """Seconds the card needs at least for every ``kind`` sublayer of one
    call: ``phase`` "decode" (``arg``: the live rows' context lengths) or
    "prefill" (``arg``: the prompt lengths)."""
    fn = getattr(reference.kind(kind), f"{phase}_work")
    flops, nbytes = fn(model, arg)
    per = max(flops / peaks["flops"], nbytes / peaks["bytes_per_s"])
    return per * sum(k == kind for k in _layer_kinds(model))


def window_flops(model: dict, window) -> float:
    """FLOPs of the tokens delivered inside the window: each first token's
    prefill of its prompt, each later token's decode step at its context.
    Both counts add up over rows, so each kind is counted once over all."""
    prompts, contexts = [], []
    for r in window.rounds:
        for i, req in enumerate(r.reqs):
            for s, t in enumerate(r.times(i)):
                if not window.inside(t):
                    continue
                if s:
                    contexts.append(len(req.prompt) + s)
                else:
                    prompts.append(len(req.prompt))
    total = reference.kind("embed_head").work(model, len(prompts) + len(contexts))[0]
    for k in _layer_kinds(model):
        kind = reference.kind(k)
        total += kind.prefill_work(model, prompts)[0] + kind.decode_work(model, contexts)[0]
    return total
