"""The port's `LMServer` on the CPU against the JAX `LMServer(impl="ref")`.

Both servers hold the same parameters (the JAX server's, through
``bridge.from_jax``) and compute in float32.  Greedy tokens are compared
under the tie rule: random-init models have near-tie logits, where an
argmax may flip on differences far below any tolerance.  So each
request's tokens must agree up to the first step whose top-2 logit margin
(read from a teacher-forced replay of the JAX tokens through the port
model) is under ``TIE``, the float32 logit tolerance of the model tests;
past such a step the two may part.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.runtime.server import LMServer as JaxServer
from repro.runtime.server import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.runtime.server import LMServer, Request, _bucket

TIE = 1e-4


def _requests(cfg, n, seed=3, max_new=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, cfg.vocab, rng.integers(3, 20)).tolist(), max_new)
            for i in range(n)]


def _margins(cfg, model, reqs, jax_tokens):
    """Top-2 logit margin at each step of each request, replaying the JAX
    tokens through the port model exactly as the server batches them."""
    B = len(reqs)
    bucket = _bucket(max(len(p) for _, p, _ in reqs))
    toks = np.zeros((B, bucket), np.int64)
    for i, (_, p, _) in enumerate(reqs):
        toks[i, bucket - len(p):] = p
    steps = max(len(t) for t in jax_tokens)
    cap = bucket + max(m for _, _, m in reqs)
    logits, cache = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, capacity=cap)
    out = []
    for t in range(steps):
        top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).tolist())
        feed = [[jt[t] if t < len(jt) else 0] for jt in jax_tokens]
        logits, cache = lm.decode_step(cfg, model, cache, torch.tensor(feed))
    return np.array(out).T            # (B, steps)


@pytest.mark.parametrize("name", ["tiny", "qwen2.5-3b-smoke", "mamba2-370m-smoke"])
def test_completions_match_jax_server(name):
    jcfg = dataclasses.replace(jax_get_config(name), compute_dtype="float32")
    cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
    jax_srv = JaxServer(jcfg, max_batch=2, seed=0, impl="ref")
    model = bridge.from_jax(cfg, jax.tree.map(np.array, jax_srv.params), device="cpu")
    srv = LMServer(cfg, max_batch=2, params=model, device="cpu")
    reqs = _requests(cfg, 3)
    want = jax_srv.serve([JaxRequest(u, p, m) for u, p, m in reqs])
    got = srv.serve([Request(u, p, m) for u, p, m in reqs])
    assert [c.uid for c in got] == [c.uid for c in want]
    for lo in range(0, len(reqs), 2):                 # the servers' rounds
        rnd = reqs[lo:lo + 2]
        jt = [c.tokens for c in want[lo:lo + 2]]
        margins = _margins(cfg, model, rnd, jt)
        for i, c in enumerate(got[lo:lo + 2]):
            diff = [t for t, (a, b) in enumerate(zip(c.tokens, jt[i])) if a != b]
            if diff:
                assert margins[i][diff[0]] < TIE, (c.uid, diff[0], margins[i][diff[0]])
            else:
                assert len(c.tokens) == len(jt[i])
    assert srv.stats.requests == 3 and srv.stats.rounds == 2
    assert len(srv.stats.decode_step_s) > 0
    assert srv.stats.summary()["decode_tokens"] == sum(len(c.tokens) for c in got)


def test_temperature_sampling_is_seeded():
    cfg = get_config("tiny")
    model = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    reqs = [Request(u, p, m) for u, p, m in _requests(cfg, 2, max_new=5)]
    runs = [LMServer(cfg, params=model, temperature=0.8, seed=7, device="cpu").serve(reqs)
            for _ in range(2)]
    assert [c.tokens for c in runs[0]] == [c.tokens for c in runs[1]]
    assert all(0 <= t < cfg.padded_vocab for c in runs[0] for t in c.tokens)


def test_empty_queue_and_oversized_round():
    srv = LMServer(get_config("tiny"), max_batch=2, device="cpu")
    assert srv.serve([]) == []
    with pytest.raises(ValueError):
        srv.serve_round([Request(i, [5, 6]) for i in range(3)])
