"""The one traffic generator: requests from a mix's file of parameters.

A mix (``perfbench/traffic/<name>.json``) gives its public source, the
distributions of prompt and output lengths and a pairing seed.  The sizes
are a fixed set: a block of as many requests as the closed loop has
clients, whose prompt and output lengths are the distributions'
quantiles at ``(i + 0.5) / clients``, paired by the mix's own
``pair_seed``.  A round of the server takes one request from every
client, so every round serves one block: the same bucket, the same
longest output and the same work.  The run's seed only orders each block
and draws the token ids, so every seed serves the same sizes in another
order.

Distributions: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``
(clipped to [min, max]) and ``{"dist": "uniform", "min", "max"}`` (whole
numbers, both ends included).  Token ids are uniform over the model's
vocabulary.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Request:
    uid: int
    prompt: np.ndarray          # int64 token ids
    max_new: int


def quantile(dist: dict, u: float) -> int:
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
        return int(min(max(round(x), lo), hi))
    if dist["dist"] == "uniform":
        return int(min(lo + math.floor(u * (hi - lo + 1)), hi))
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def block_sizes(mix: dict, n: int) -> list[tuple[int, int]]:
    """A block's ``n`` (prompt length, output length) pairs, in the mix's order."""
    us = [(i + 0.5) / n for i in range(n)]
    prompts = [quantile(mix["prompt_len"], u) for u in us]
    outs = [quantile(mix["output_len"], u) for u in us]
    order = np.random.default_rng(mix["pair_seed"]).permutation(n)
    return [(prompts[i], outs[j]) for i, j in enumerate(order)]


class Stream:
    """The requests of one run of ``clients`` clients, in the order they send them."""

    def __init__(self, mix: dict, vocab: int, seed: int, clients: int, stream: int = 0):
        if mix.get("loop") != "closed":
            raise ValueError(f"only closed loops are generated, got {mix.get('loop')!r}")
        self.sizes = block_sizes(mix, clients)
        self.vocab = vocab
        self.rng = np.random.default_rng([seed % 2 ** 64, stream])
        self.pending: list = []
        self.uid = 0

    def take(self, n: int) -> list[Request]:
        out = []
        for _ in range(n):
            if not self.pending:
                self.pending = [self.sizes[i] for i in self.rng.permutation(len(self.sizes))]
            p, m = self.pending.pop(0)
            out.append(Request(self.uid, self.rng.integers(0, self.vocab, p, dtype=np.int64), m))
            self.uid += 1
        return out
