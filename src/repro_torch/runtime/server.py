"""Batched LM serving on one device: prefill + decode rounds.

Ported from ``repro/runtime/server.py``.  Two backends:

  * **single-device** (default): one prefill + decode loop over the whole
    model, rounds served one after another;
  * **pipelined** (``pipeline=runtime.pipeline.DecodePipeline(...)``):
    rounds become serving-slot *groups* streamed concurrently through a
    planned, placed stage pipeline; each stage's cache slice stays
    resident and sampled tokens feed back over a token stream.
    Completions are token-identical to the single-device backend under
    greedy sampling (same grouping, bucketing, and EOS/budget
    bookkeeping).

Round-based batching: take up to ``max_batch`` queued requests,
right-align their prompts in a matrix padded with token 0 to a
power-of-two bucket (the pad positions are attended, as in the JAX
server), run one prefill that builds the KV caches, then one-token
decode steps until every row hits EOS or its token budget.

The cache stays on the device and is updated in place; the one host sync
per decode step is the read of the sampled tokens that the EOS and
budget bookkeeping needs.  Throughput accounting separates prompt
(prefill) tokens from generated (decode) tokens, and every decode step's
wall time is kept in ``ServeStats.decode_step_s``.

With ``mesh=`` (a ("data", "model") ``DeviceMesh``) every rank of the mesh
runs the same server on the same requests (SPMD): the weights are placed
by `launch.sharding.tree_shardings`, each round runs under
``sharding_ctx.activate(from_mesh(mesh))``, the prompts and tokens are
placed by ``batch_specs`` and the caches by ``cache_specs``
(`sharding_ctx.place_cache`), and every rank reads the whole logits of
each step to sample, so all ranks hold the same completions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from .. import sharding_ctx as sctx
from ..configs.base import ModelConfig
from ..kernels import ops
from ..models import build_model


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new: int = 32


@dataclass
class Completion:
    uid: int
    tokens: list[int]
    prompt_len: int
    prefill_s: float
    decode_s: float


@dataclass
class ServeStats:
    requests: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    rounds: int = 0
    # wall time of each decode step, sampled-token read included: the
    # read syncs with the device every step, so each gap is a real step
    # (single-device backend)
    decode_step_s: list = field(default_factory=list)
    slo: dict | None = None        # last pipelined serve's client-side
    #                                percentiles (`ServeRunResult.slo()`);
    #                                None on the single-device backend

    def summary(self) -> dict:
        out = {
            "requests": self.requests,
            "rounds": self.rounds,
            "prefill_tok_per_s": self.prefill_tokens / self.prefill_s
            if self.prefill_s else 0.0,
            "decode_tok_per_s": self.decode_tokens / self.decode_s
            if self.decode_s else 0.0,
            "decode_tokens": self.decode_tokens,
        }
        if self.slo is not None:
            out["slo"] = dict(self.slo)
        return out


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class LMServer:
    def __init__(self, cfg: ModelConfig, *, max_batch: int = 8, eos_id: int = 1,
                 params=None, seed: int = 0, temperature: float = 0.0,
                 impl: str | None = None, device="cuda", pipeline=None,
                 tracer=None, injector=None, health=None, preflight: bool = True,
                 mesh=None):
        """``device``: where the model runs; the card unless the caller asks
        for the CPU, and without a card this raises.  ``params``: an
        `models.lm.LM` on that device (e.g. from `bridge.from_jax`); else
        the pipeline's, or random weights from ``seed``.  ``impl``: None
        for the kernels, ``"ref"`` for the oracle route (A/B runs).
        Temperature sampling draws from a generator seeded from ``seed``;
        it does not reproduce ``jax.random``'s draws.

        ``pipeline``: a `runtime.pipeline.DecodePipeline` on the same
        device — when set, ``serve`` streams request groups of
        ``max_batch`` through it instead of the single-device loop.
        ``tracer``: an optional pipeline `Tracer` (pipelined backend only;
        None = tracing off).  ``injector`` (a `failures.ReplicaFaultPlan`)
        and ``health`` (a `pipeline.health.HealthController`) ride along
        on every pipelined serve — chaos drills and self-healing,
        pipelined backend only.  ``preflight``: statically verify each
        pipelined serve's plan (`core.verify`) before launch; False skips
        the check (the single-device backend has no plan to verify
        either way).

        A request carries tokens only, as the JAX server's do: a prefix
        frontend's model (internvl2-26b) is served text-only, and an
        encoder-decoder, whose prefill needs the encoder's frames, is
        refused here (the JAX server fails in its prefill).

        ``mesh``: serve SPMD over this ("data", "model") ``DeviceMesh``, on
        its device type (``device`` is then ignored); every rank of it
        builds the server with the same ``params`` or ``seed``.  The weights
        are tensor parallel over "model", without FSDP."""
        if cfg.encdec:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder's prefill needs batch['frames'], and a "
                "request carries tokens only; run it through models.lm.build_model(cfg)"
                ".prefill / .decode_step with frames in the batch")
        if mesh is not None and pipeline is not None:
            raise ValueError("a server takes a mesh or a pipeline, not both")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            device = "cpu" if mesh.device_type == "cpu" else "cuda"
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.eos_id = eos_id
        self.temperature = temperature
        self.impl = ops.check_impl(impl)
        self.model = build_model(cfg, impl)
        self.pipeline = pipeline
        self.tracer = tracer
        self.injector = injector
        self.health = health
        self.preflight = preflight
        self.last_run = None         # the last pipelined serve's ServeRunResult
        if pipeline is not None:
            if pipeline.device != self.device:
                raise ValueError(f"the pipeline runs on {pipeline.device}, the server "
                                 f"on {self.device}")
            params = pipeline.params if params is None else params
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(device=self.device, generator=gen)
        if params.embed.device != self.device and getattr(pipeline, "pool", None) is None:
            raise ValueError(f"params live on {params.embed.device}, the server on "
                             f"{self.device}")
        if mesh is not None:
            from ..launch import sharding as shd
            policy = shd.ShardingPolicy(fsdp=False)
            shd.distribute_params(params, shd.tree_shardings(params, mesh, cfg, policy))
        self.params = params
        self.stats = ServeStats()
        self._gen = torch.Generator(device=self.device).manual_seed(seed ^ 0xC0FFEE)

    def _context(self):
        if self.mesh is None:
            return sctx.activate(None)
        return sctx.activate(sctx.from_mesh(self.mesh))

    def _place(self, tokens):
        """Tokens (B, S) as the batch's spec lays them out on the mesh."""
        if self.mesh is None:
            return tokens
        from ..launch import sharding as shd
        spec = shd.batch_specs(self.mesh, {"t": tokens})["t"]
        return shd.place(tokens, shd.NamedSharding(self.mesh, spec))

    def _sample(self, logits):
        if hasattr(logits, "full_tensor"):
            logits = logits.full_tensor()        # every rank samples the same
        last = logits[:, -1, :]                  # over the padded vocab
        if self.temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    @torch.no_grad()
    def serve_round(self, reqs: list[Request]) -> list[Completion]:
        with self._context():
            return self._serve_round(reqs)

    def _serve_round(self, reqs: list[Request]) -> list[Completion]:
        if not 0 < len(reqs) <= self.max_batch:
            raise ValueError(f"a round takes 1..{self.max_batch} requests, got {len(reqs)}")
        B = len(reqs)
        bucket = _bucket(max(len(r.prompt) for r in reqs))
        cap = bucket + max(r.max_new for r in reqs)
        toks = np.zeros((B, bucket), np.int64)
        for i, r in enumerate(reqs):                 # right-align prompts so
            toks[i, bucket - len(r.prompt):] = r.prompt   # last token is real
        batch = {"tokens": self._place(torch.from_numpy(toks).to(self.device))}

        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, batch, capacity=cap)
        last = self._sample(logits)
        out_tokens = [[t] for t in last.tolist()]
        t_prefill = time.perf_counter() - t0

        done = np.array([t[0] == self.eos_id for t in out_tokens])
        budget = np.array([r.max_new for r in reqs])
        t1 = time.perf_counter()
        t_step = t1
        steps = 0
        cur = last[:, None]
        while not done.all() and steps < budget.max() - 1:
            logits, cache = self.model.decode_step(self.params, cache, self._place(cur))
            nxt = self._sample(logits)
            steps += 1
            for i, tok in enumerate(nxt.tolist()):   # the step's one host sync
                if not done[i] and steps < budget[i]:
                    out_tokens[i].append(tok)
                    if tok == self.eos_id:
                        done[i] = True
                elif not done[i]:
                    done[i] = True
            now = time.perf_counter()
            self.stats.decode_step_s.append(now - t_step)
            t_step = now
            cur = nxt[:, None]
        t_decode = time.perf_counter() - t1

        self.stats.requests += B
        self.stats.rounds += 1
        self.stats.prefill_tokens += B * bucket
        self.stats.decode_tokens += sum(len(t) for t in out_tokens)
        self.stats.prefill_s += t_prefill
        self.stats.decode_s += t_decode
        return [Completion(uid=r.uid, tokens=out_tokens[i], prompt_len=len(r.prompt),
                           prefill_s=t_prefill, decode_s=t_decode)
                for i, r in enumerate(reqs)]

    def serve(self, reqs: list[Request]) -> list[Completion]:
        """Drain a queue in ``max_batch``-sized rounds.  The pipelined
        backend streams *all* rounds concurrently through the stage
        pipeline (each round = one serving-slot group); the single-device
        backend serves them one after another."""
        if self.pipeline is not None:
            return self._serve_pipelined(reqs)
        out: list[Completion] = []
        for i in range(0, len(reqs), self.max_batch):
            out.extend(self.serve_round(reqs[i:i + self.max_batch]))
        return out

    def _serve_pipelined(self, reqs: list[Request]) -> list[Completion]:
        """Stream request groups through the decode pipeline.

        Per-completion prefill/decode times are the group's pipeline spans
        (dispatch -> first sampled token -> last token).  Aggregate stats
        use run-level wall windows — groups overlap in the pipeline, so
        summing per-group spans would double-count time."""
        if not reqs:
            return []
        run = self.pipeline.serve(
            [r.prompt for r in reqs], [r.max_new for r in reqs],
            eos_id=self.eos_id, group_size=self.max_batch,
            temperature=self.temperature, tracer=self.tracer,
            injector=self.injector, health=self.health, preflight=self.preflight)
        self.last_run = run
        self.stats.requests += len(reqs)
        self.stats.rounds += len(run.groups)
        self.stats.slo = run.slo()
        self.stats.prefill_tokens += run.prefill_tokens
        self.stats.decode_tokens += run.decode_tokens
        # wall windows (they overlap under pipelining): prefill counts
        # until the LAST group's prefill lands — interleaved decode makes
        # the reported prefill rate a lower bound, never an inflated one
        first_prefill = min(g.t_prefill_done for g in run.groups)
        self.stats.prefill_s += max(g.t_prefill_done for g in run.groups)
        self.stats.decode_s += max(
            max(g.t_last for g in run.groups) - first_prefill, 0.0)
        out: list[Completion] = []
        for i, (r, toks) in enumerate(zip(reqs, run.tokens)):
            g = run.groups[run.group_of[i]]
            out.append(Completion(
                uid=r.uid, tokens=toks, prompt_len=len(r.prompt),
                prefill_s=g.t_prefill_done - g.t_start,
                decode_s=max(g.t_last - g.t_prefill_done, 0.0)))
        return out
