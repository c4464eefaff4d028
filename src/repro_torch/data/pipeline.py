"""Deterministic, checkpointable synthetic data pipeline, ported from
``repro/data/pipeline.py``.

Batch ``i`` is a pure function of ``(seed, i, host)``: the key is
``fold_in(fold_in(PRNGKey(seed), step), host)`` and the tokens are drawn
with the JAX package's generator, reimplemented in numpy
(`threefry`), so that the port trains on the same tokens as the JAX
package, bitwise.  Batches are numpy int32 arrays of shape ``(accum,
micro_batch, seq)``; the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from . import threefry


@dataclass(frozen=True)
class DataState:
    """Checkpointable pipeline position."""
    step: int
    seed: int

    def advance(self, n: int = 1) -> "DataState":
        return dataclasses.replace(self, step=self.step + n)

    def to_dict(self) -> dict:
        return {"step": int(self.step), "seed": int(self.seed)}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(step=int(d["step"]), seed=int(d["seed"]))


class _Base:
    """Per-(step, host) keys and batch assembly."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, accum: int = 1):
        accum = max(accum, 1)
        if global_batch % accum:
            raise ValueError(f"global batch {global_batch} is not a multiple of accum {accum}")
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.accum = int(accum)
        self.seed = int(seed)

    def init_state(self) -> DataState:
        return DataState(step=0, seed=self.seed)

    def _key(self, state: DataState, host_id: int) -> np.ndarray:
        k = threefry.fold_in(threefry.prng_key(state.seed), state.step)
        return threefry.fold_in(k, host_id)

    def _sample(self, key, batch: int) -> np.ndarray:  # -> (batch, seq_len + 1) int32
        raise NotImplementedError

    def host_batch(self, state: DataState, host_id: int = 0, n_hosts: int = 1) -> dict:
        """This host's slice of global batch ``state.step``: {tokens, labels},
        each (accum, local_batch // accum, seq_len) int32; labels are the
        next-token targets."""
        if self.global_batch % n_hosts:
            raise ValueError(f"global batch {self.global_batch} over {n_hosts} hosts")
        local = self.global_batch // n_hosts
        if local % self.accum:
            raise ValueError(f"local batch {local} is not a multiple of accum {self.accum}")
        toks = self._sample(self._key(state, host_id), local)
        mb = local // self.accum
        shape = (self.accum, mb, self.seq_len)
        return {"tokens": np.ascontiguousarray(toks[:, :-1]).reshape(shape),
                "labels": np.ascontiguousarray(toks[:, 1:]).reshape(shape)}

    def __iter__(self):
        state = self.init_state()
        while True:
            yield self.host_batch(state), state
            state = state.advance()


class SyntheticUniformLM(_Base):
    """i.i.d. uniform tokens (throughput runs; nothing to learn)."""

    def _sample(self, key, batch: int) -> np.ndarray:
        return threefry.randint(key, (batch, self.seq_len + 1), 0, self.vocab)


class SyntheticBigramLM(_Base):
    """Tokens from a fixed random bigram chain: each token has ``branch``
    successors, drawn from ``PRNGKey(seed ^ 0x5EED)``; the best loss is
    about log(branch) nats."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, accum: int = 1, branch: int = 4):
        super().__init__(vocab, seq_len, global_batch, seed, accum)
        self.branch = int(branch)
        self._succ = threefry.randint(threefry.prng_key(seed ^ 0x5EED),
                                      (self.vocab, self.branch), 0, self.vocab)

    def _sample(self, key, batch: int) -> np.ndarray:
        k0, k1 = threefry.split(key)
        tok = threefry.randint(k0, (batch,), 0, self.vocab)
        choices = threefry.randint(k1, (batch, self.seq_len), 0, self.branch)
        out = np.empty((batch, self.seq_len + 1), dtype=np.int32)
        out[:, 0] = tok
        for t in range(self.seq_len):
            tok = self._succ[tok, choices[:, t]]
            out[:, t + 1] = tok
        return out

    def optimal_loss(self) -> float:
        """Entropy of the chain, about log(branch) (ignoring collisions)."""
        return float(np.log(self.branch))


def make_pipeline(kind: str, cfg, shape, *, seed: int = 0, accum: int | None = None):
    """Pipeline for a (ModelConfig, ShapeCfg) cell."""
    cls = {"bigram": SyntheticBigramLM, "uniform": SyntheticUniformLM}[kind]
    return cls(vocab=cfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch,
               seed=seed, accum=accum if accum is not None else cfg.grad_accum)
