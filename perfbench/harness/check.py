"""Whether what the timed path served is correct.

Once the window has closed and the server is freed: every finished
request must hold exactly its drawn number of tokens, each a row of the
vocabulary (``bad_answers``, limit 0).  A sample of the finished requests,
drawn from the seed, with the one that served most tokens in it, goes
through the float32 reference (`perfbench.reference`) as the server saw
it (pads, prompt, served tokens fed back).  At each served token the
reference's best logit less the logit of the token served is a gap; the
widest over the sample (``logit_gap``) and their mean (``mean_gap``) are
each held to the cell's limit.  With greedy serving a sound program only
parts from the reference where two logits lie within its rounding of each
other, so most gaps are 0: the widest catches one token served wrong, the
mean a precision lost everywhere, which the widest, a tail that swings
from seed to seed, may not separate from rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

from .weights import seed64


def finished(rounds):
    return [(r, i) for r in rounds if r.completions is not None for i in range(len(r.reqs))]


def bad_answers(rounds, vocab: int) -> int:
    bad = 0
    for r, i in finished(rounds):
        toks = r.completions[i].tokens
        if len(toks) != r.reqs[i].max_new or any(not 0 <= t < vocab for t in toks):
            bad += 1
    return bad


def sample(rounds, seed: int, tokens: int, max_requests: int):
    """Finished (round, index) pairs: the longest, then others in an order
    drawn from the seed, until ``tokens`` served tokens or ``max_requests``."""
    done = finished(rounds)
    if not done:
        return []
    longest = max(range(len(done)), key=lambda k: done[k][0].reqs[done[k][1]].max_new)
    order = np.random.default_rng(seed64(seed, 3)).permutation(len(done))
    picked, n = [], 0
    for k in [longest] + [k for k in order if k != longest]:
        if n >= tokens or len(picked) >= max_requests:
            break
        r, i = done[k]
        picked.append((r, i))
        n += len(r.completions[i].tokens)
    return picked


def sequences(picked, device):
    """Each sampled request as the server ran it: (sequence, first scored
    position, served tokens)."""
    out = []
    for r, i in picked:
        prompt, served = r.reqs[i].prompt, r.completions[i].tokens
        seq = np.zeros(r.bucket + len(served) - 1, np.int64)
        seq[r.bucket - len(prompt):r.bucket] = prompt
        seq[r.bucket:] = served[:-1]
        out.append((torch.from_numpy(seq).to(device), r.bucket - 1,
                    torch.tensor(served, dtype=torch.long, device=device)))
    return out


def reference_logits(model: dict, weights: dict, seqs, quant: str | None = None) -> list:
    """The reference's logits at each sequence's scored positions."""
    return reference.logits(model, weights, [s for s, _, _ in seqs], [f for _, f, _ in seqs],
                            quant=quant)


def served_gaps(want: list, seqs):
    """Each served token's gap below the reference's best, all sequences'."""
    return torch.cat([w.max(dim=-1).values - w.gather(1, tok[:, None])[:, 0]
                      for w, (_, _, tok) in zip(want, seqs)])


def compare(model: dict, weights: dict, rounds, seed: int, settings: dict, device,
            control: str | None = None) -> dict:
    """The numbers a run compares: ``bad_answers``, ``compared_tokens``,
    ``logit_gap`` and ``mean_gap`` (None where nothing was compared).

    ``control`` (a precision of `reference.logits`, "fp8"): the control, the
    reference in that precision put in the program's place.  At each
    position of the sampled requests (their prompts and served tokens) the
    token it puts first is judged in place of the served one."""
    chk = settings["check"]
    bad = bad_answers(rounds, model["vocab"])
    picked = [] if bad else sample(rounds, seed, chk["tokens"], chk["max_requests"])
    seqs = sequences(picked, device)
    widest = mean = None
    if seqs:
        want = reference_logits(model, weights, seqs)
        if control is not None:
            low = reference_logits(model, weights, seqs, quant=control)
            seqs = [(s, f, lo.argmax(dim=-1)) for (s, f, _), lo in zip(seqs, low)]
        gaps = served_gaps(want, seqs)
        widest, mean = float(gaps.max()), float(gaps.mean())
    return {"bad_answers": bad, "compared_tokens": sum(len(t) for _, _, t in seqs),
            "logit_gap": widest, "mean_gap": mean}


def held(values: dict, settings: dict) -> dict:
    """Each number beside its limit.  A gap is compared where the cell's
    settings give it a limit (``logit_gap_limit``, ``mean_gap_limit``)."""
    chk = settings["check"]
    out = {"bad_answers": {"value": values["bad_answers"], "limit": 0},
           "compared_tokens": {"value": values["compared_tokens"], "limit": chk["min_tokens"],
                               "at_least": True}}
    for key in ("logit_gap", "mean_gap"):
        if f"{key}_limit" in chk:
            out[key] = {"value": values[key], "limit": chk[f"{key}_limit"]}
    return out


def judge(model: dict, weights: dict, rounds, seed: int, settings: dict, device,
          control: str | None = None) -> dict:
    """The numbers compared, each beside its limit (`compare`, `held`)."""
    return held(compare(model, weights, rounds, seed, settings, device, control), settings)


def passed(checks: dict) -> bool:
    for c in checks.values():
        v = c["value"]
        if v is None or v != v:
            return False
        if (v < c["limit"]) if c.get("at_least") else (v > c["limit"]):
            return False
    return True
