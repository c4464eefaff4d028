"""Decode-shape serving pipelines: prefill + token streams over placed stages.

Ported from ``repro/runtime/pipeline/decode.py``.  Request groups prefill
once, then emit one token per step until every slot hits EOS or its
budget: traffic whose length is decided by the pipeline's own output.
This module runs that shape on the engine (`engine.Engine`):

  * stages are built from the *same model code* the single-device server
    runs — `models/lm.prefill_blocks` / `decode_blocks` over a slice of
    ``LM.layers`` (a list slice of the ``nn.ModuleList``: the same
    modules, no copy) — so a pipelined serve is token-identical to
    `LMServer.serve_round` under greedy sampling;
  * every block stage keeps its **KV/SSM cache slice resident**: the
    prefill op builds the stage's slice of `lm.init_cache` (its layers
    only, and one ``pos`` device scalar), decode ops update it **in
    place** and advance ``pos`` in place after their layers, as
    `lm.decode_step` does; only the (B, S|1, d_model) hidden state
    crosses the inter-stage FIFOs;
  * request groups map to stage replicas by ``gid % nr`` (cache
    affinity), so a replicated stage serves groups concurrently like the
    plan's round-robin replication;
  * the head stage samples in its op and feeds the token back to the
    embed stage over a `channels.StreamChannel`: decode ops are scheduled
    as tokens arrive, and the stream closes when the last group drains;
  * each (stage, replica) launches on a CUDA stream of its own, made once
    per pipeline, and its op bodies run on one worker thread of the
    pipeline's `engine.Lanes`; an op body returns as soon as its kernels
    are queued, with a `DeviceWatch` (a CUDA event on its stream) that the
    engine polls, so no op body waits for the device.  ``overlap=False``
    runs every op on the caller's thread and stream, one after another;
  * every program is an `aot.AotProgram`, run once per group shape on
    scratch inputs before the engine's clock starts (``warmup=``), on the
    thread and stream that will run the group's ops, so no served request
    pays a first launch (``compile_stats.late == 0``).

Streams and memory.  The engine dispatches a consumer only after it has
seen its producer's event, so a hidden state is complete before the next
stage reads it.  What remains is the caching allocator: a tensor made on
one stream and freed after another stream read it could be handed out
again on the first while the read is still queued.  Each op body
therefore marks its tensor inputs with ``Tensor.record_stream`` on its
own stream.  A group's cache is made and used on one (stage, replica)
stream only.

On one card every placement slice is the card: the replicas of a stage
share the ``LM``'s tensors, so the weights live once however many
replicas the plan asks for.  Encoder-decoder and multimodal frontends are
rejected: the pipeline runs embed -> blocks -> head only.

Left out against the JAX module (later items): failover (``fail_replica``,
cache replay, migration), admission pause and ``resume``, the static
preflight (``core.verify``), and health ticks.

`runtime/server.LMServer` uses this as its pipelined backend
(``LMServer(cfg, pipeline=DecodePipeline(...))``).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ... import resolve_device
from ...configs.base import ModelConfig
from ...core.stg import STG
from ...kernels import ops
from ...models import blocks, lm
from ...models.common import rmsnorm
from ..server import _bucket            # one bucketing rule: token parity
from .aot import AotProgram, CompileStats, _where
from .channels import Fifo, StreamChannel
from .engine import (AsyncResult, DeviceWatch, Engine, EngineResult, Lanes, Op,
                     describe_position)
from .placement import Placement, place


# ===========================================================================
# stage computation (models/lm over a slice of the layers)
# ===========================================================================
# A stage owns the embedding, a span of layers and the head, each or not:
# its prefill program is (p, x, cap) -> (y, cache or None), its decode
# program (p, cache, x) -> y.  A stage holding the embedding takes token
# ids, one holding the head returns logits.  The head normalises every
# row and projects the last one, as `lm.prefill` and `lm.decode_step` do,
# so the same kernels see the same rows.
def _stage_fns(cfg: ModelConfig, has_embed: bool, has_blocks: bool,
               has_head: bool, impl: str | None):
    def embed(p, x):
        return p["embed"][x] if has_embed else x

    def head(p, y):
        if not has_head:
            return y
        return rmsnorm(y, p["norm"], cfg.norm_eps, impl)[:, -1:] @ p["w"]

    def prefill(p, x, cap):
        x = embed(p, x)
        cache = None
        if has_blocks:
            B, S, _ = x.shape
            cache = lm.init_cache(cfg, B, cap, dtype=x.dtype, device=x.device,
                                  span=p["span"])
            x = lm.prefill_blocks(cfg, p["layers"], x,
                                  torch.arange(S, device=x.device),
                                  cache["layers"], impl=impl)
            cache["pos"].fill_(S)
        return head(p, x), cache

    def decode(p, cache, x):
        x = embed(p, x)
        if has_blocks:
            x = lm.decode_blocks(cfg, p["layers"], cache["layers"], x,
                                 cache["pos"], impl=impl)
            cache["pos"].add_(1)
        return head(p, x)
    return prefill, decode


@dataclass(frozen=True)
class _StageDesc:
    """One executed pipeline stage, possibly the fusion of several base
    stages (its name joins theirs with ``+``); ``span`` is the union of
    the members' block-period spans (None for a lone embed/head)."""
    name: str
    has_embed: bool
    span: tuple[int, int] | None
    has_head: bool

    @property
    def key(self) -> tuple[bool, bool, bool]:
        return (self.has_embed, self.span is not None, self.has_head)


# ===========================================================================
# run state
# ===========================================================================
@dataclass
class _Group:
    """One serving slot group: a batch of requests decoding in lockstep,
    mirroring `LMServer.serve_round`'s round semantics exactly (same
    bucketing, same EOS/budget bookkeeping) so completions are
    token-identical."""
    gid: int
    tokens: np.ndarray                 # (B, bucket) right-aligned prompts
    bucket: int
    cap: int
    budget: np.ndarray
    done: np.ndarray = None
    out_tokens: list = None
    steps: int = 0                     # completed decode steps
    t_start: float = 0.0
    t_prefill_done: float = 0.0
    t_last: float = 0.0
    decode_done_s: list = field(default_factory=list)
    last_logits: torch.Tensor = None   # (B, 1, Vp) of the group's last step

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]


@dataclass
class ServeRunResult(EngineResult):
    """One pipelined serve: per-request tokens + the engine's measurement
    surface (stage completion streams, fifo stats, trace)."""
    tokens: list = field(default_factory=list)   # per request, generated
    group_of: list = field(default_factory=list)  # request index -> group id
    groups: list = field(default_factory=list)   # _Group bookkeeping
    fifo_stats: dict = field(default_factory=dict)
    placement: Placement | None = None
    streams_used: int = 0              # distinct CUDA streams that ran ops

    @property
    def decode_tokens(self) -> int:
        return sum(len(t) for t in self.tokens)

    @property
    def prefill_tokens(self) -> int:
        return sum(g.batch * g.bucket for g in self.groups)

    def decode_done_s(self) -> list[float]:
        """Merged decode-step completion times across groups (run-relative,
        sorted) — the serving-side analogue of a stage's completion
        stream."""
        return sorted(t for g in self.groups for t in g.decode_done_s)

    def decode_tokens_per_s(self) -> float:
        """Steady-state generated tokens/s from the merged decode
        completion stream (excludes prefill and the fill ramp; falls back
        to wall-clock for very short runs)."""
        ts = self.decode_done_s()
        toks_per_step = (sum(g.batch for g in self.groups)
                         / max(1, len(self.groups)))
        if len(ts) >= 3:
            k = max(1, len(ts) // 4)
            w = ts[k:]
            if len(w) >= 2 and w[-1] > w[0]:
                return toks_per_step * (len(w) - 1) / (w[-1] - w[0])
        return self.decode_tokens / max(self.wall_s, 1e-9)

    def token_latencies_s(self) -> list[float]:
        """Per-token latency samples: gaps between successive decode-step
        completions *within* each group (what a client slot observes)."""
        out = []
        for g in self.groups:
            ts = [g.t_prefill_done] + list(g.decode_done_s)
            out.extend(b - a for a, b in zip(ts, ts[1:]))
        return out

    def slo(self) -> dict:
        """Per-request serving SLO percentiles (flat ms dict): queue wait
        (submit -> first prefill dispatch), TTFT (submit -> first sampled
        token), and inter-token gap — `metrics.serving_slo` over the
        group timings.  Groups are the unit a client slot experiences, so
        samples are per group, gaps per decoded token."""
        from .metrics import serving_slo
        return serving_slo(
            queue_wait_s=[g.t_start for g in self.groups],
            ttft_s=[g.t_prefill_done for g in self.groups],
            token_gap_s=self.token_latencies_s())


# ===========================================================================
# stage programs
# ===========================================================================
class _ServeStageProgram:
    """One serving stage's op queue on the shared engine.

    Ops arrive dynamically: prefill ops for all groups are enqueued up
    front; each decode op is enqueued (to *every* stage, with one global
    sequence number) the moment the head samples the previous token — the
    queue order is therefore identical across stages and every FIFO sees
    a contiguous seq stream, re-sorted by the engine's reorder buffers
    when replicas retire out of order."""

    def __init__(self, s: int, pipe: "DecodePipeline", run: "_ServeRun"):
        self.s = s
        self.S = len(pipe.stage_names)
        self.name = pipe.stage_names[s]
        self.pipe = pipe
        self.run = run
        self.n_replicas = len(pipe.stage_devices[s])
        self.queue: list = []          # (kind, gid, seq, pos)
        self.pos_i = 0
        self.stall_mark = -1
        self.wait_reason = None   # (reason, fifo) of the last deferral
        self.caches: dict[int, dict] = {}      # gid -> resident cache slice

    def enqueue(self, kind: str, gid: int, seq: int, pos: int) -> None:
        self.queue.append((kind, gid, seq, pos))

    def pending(self) -> int:
        return len(self.queue) - self.pos_i

    def rep_of(self, gid: int) -> int:
        return gid % self.n_replicas

    def peek(self) -> Op | None:
        if self.pos_i >= len(self.queue):
            return None
        kind, gid, seq, _ = self.queue[self.pos_i]
        return Op(stage=self.s, kind=kind, seq=seq, rep=self.rep_of(gid))

    def ready(self, op: Op, count_stall: bool = False) -> float | None:
        s, S, run = self.s, self.S, self.run
        if s > 0 and not run.acts[s - 1].can_pop(1):
            self.wait_reason = ("starve", run.acts[s - 1])
            return None
        if s == 0 and op.kind == "D" and not run.feedback.can_pop(1):
            self.wait_reason = ("starve", run.feedback)
            return None
        if s < S - 1 and not run.acts[s].can_push(1):
            if self.stall_mark != self.pos_i:
                self.stall_mark = self.pos_i
                run.acts[s].note_stall()
            self.wait_reason = ("credit", run.acts[s])
            return None
        return 0.0

    def idle_reason(self):
        """Why this stage's op queue is *empty*: the head hasn't sampled
        the token that schedules the next op yet, so the stage is starved
        on its input edge (the feedback stream for stage 0, the upstream
        act fifo otherwise).  None once the token stream closed — run
        drained, idleness isn't a wait."""
        run = self.run
        if run.feedback.closed:
            return None
        src = run.feedback if self.s == 0 else run.acts[self.s - 1]
        return ("starve", src)

    def dispatch(self, op: Op, driver):
        s, S, run = self.s, self.S, self.run
        kind, gid, seq, pos = self.queue[self.pos_i]
        self.pos_i += 1
        g = run.groups[gid]
        if s == 0:                                        # embed
            if kind == "P":
                g.t_start = time.perf_counter()
                payload = torch.from_numpy(g.tokens)
            else:
                seq_got, (gid_got, toks) = run.feedback.pop(1)[0]
                assert (seq_got, gid_got) == (seq, gid), \
                    f"feedback order broke: {(seq_got, gid_got)}!={(seq, gid)}"
                payload = toks
        else:
            seq_got, (gid_got, x) = run.acts[s - 1].pop_hold(1)[0]
            assert (seq_got, gid_got) == (seq, gid), \
                f"fifo order broke: {(seq_got, gid_got)}!={(seq, gid)}"
            op.releases.append((run.acts[s - 1], 1))
            payload = x
        if s < S - 1:
            run.acts[s].reserve(1)
        return self._task_for(kind, gid, pos, payload, op.rep)

    def _task_for(self, kind: str, gid: int, pos: int, payload, rep: int):
        pipe, run = self.pipe, self.run
        desc = pipe.stage_descs[self.s]
        pre, dec = pipe._programs[desc.key]
        stream = pipe.stage_streams[self.s][rep] if run.overlap else None
        if pipe.device.type == "cuda":
            run.streams.add((stream or torch.cuda.current_stream(pipe.device)).cuda_stream)
        sample = None
        if desc.has_head:
            def sample(logits):
                return pipe._sample(logits, gid, run.temperature)
        params = pipe.stage_params[self.s]
        if kind == "P":
            return (_run_stage, (pre, params, payload, pipe.device, stream, sample,
                                 None, run.groups[gid].cap))
        cache = self.caches.get(gid)
        if pipe.check_pos and cache is not None:
            held = int(cache["pos"])                      # a host sync: tests only
            assert held == pos, f"{self.name} gid {gid}: cache at pos {held}, op at {pos}"
        return (_run_stage, (dec, params, payload, pipe.device, stream, sample, cache))

    def retire(self, op: Op, result, engine: Engine) -> float:
        s, run = self.s, self.run
        (y, cache, toks), t_done = result
        gid = run.gid_of[op.seq]
        if cache is not None:                             # a prefill's cache
            self.caches[gid] = cache                      # stays resident here
        if self.pipe.stage_descs[s].has_head:             # head: sampled
            run.on_head(op, y, toks, t_done, engine)
        else:
            engine.ordered_push(run.acts[s], op.seq, (gid, y), t_done)
        return t_done

    def describe(self) -> str:
        return describe_position(
            self.name, self.pos_i, self.queue,
            lambda q: f"{q[0]}(gid={q[1]},seq={q[2]})")


def _run_stage(prog: AotProgram, params, x: torch.Tensor, device, stream, sample,
               cache=None, cap=None):
    """One op body: launch the stage program on the stage's stream and
    return without waiting for the device; the engine retires the op off
    the returned `DeviceWatch`.  ``cap`` given: a prefill, which makes the
    stage's cache for the group; else a decode step on ``cache``.

    The input was made on another stage's stream (or is the prompt, still
    on the host): it is marked for this stream (``record_stream``), so
    the allocator does not hand its block out again while this stream
    still reads it.  A head stage samples here too and starts the tokens'
    copy to the host, so that retirement reads them without a sync."""
    on = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with torch.no_grad(), on:
        if x.device != device:
            x = x.to(device)
        elif stream is not None:
            x.record_stream(stream)
        if cap is not None:
            y, cache = prog(params, x, cap)
        else:
            y, cache = prog(params, cache, x), None
        toks = None
        if sample is not None:
            dev_toks = sample(y)
            toks = (dev_toks, dev_toks.to("cpu", non_blocking=True))
        watch = DeviceWatch(device)
    return AsyncResult(((y, cache, toks),), watch=[watch])


class _ServeRun:
    """Shared state of one pipelined serve: groups, channels, the global
    op sequence, and the head-side bookkeeping."""

    def __init__(self, pipe: "DecodePipeline", groups: list, *,
                 eos_id: int, capacity_blocks: int, overlap: bool,
                 temperature: float | None = None):
        self.pipe = pipe
        self.groups = groups
        self.eos_id = eos_id
        self.overlap = overlap
        self.temperature = temperature
        self.streams: set = set()              # handles of the CUDA streams
        #                                        ops ran on
        self.gid_of: list[int] = []            # seq -> gid
        self.programs = [_ServeStageProgram(s, pipe, self)
                         for s in range(len(pipe.stage_names))]
        S = len(self.programs)
        self.acts = [pipe._edge_fifo(s, capacity_blocks) for s in range(S - 1)]
        # the continuous token stream: head -> embed feedback.  At most
        # one token per live group is ever in flight (a group's next op
        # consumes it before its next push), so n_groups slots suffice.
        self.feedback = StreamChannel(block=1, capacity_blocks=1,
                                      min_capacity=max(2, len(groups)))
        self.open_groups = len(groups)

    def enqueue(self, kind: str, gid: int, pos: int) -> int:
        seq = len(self.gid_of)
        self.gid_of.append(gid)
        for p in self.programs:
            p.enqueue(kind, gid, seq, pos)
        return seq

    def on_head(self, op: Op, logits, toks, t_done: float, engine: Engine) -> None:
        """Book the sampled tokens at head retirement and schedule the
        group's next decode step (or retire the group) —
        `LMServer.serve_round` bookkeeping, verbatim, so completions are
        token-identical.  ``toks``: the tokens on the device (fed back to
        the embed stage as they are) and their copy on the host, complete
        since the op's event fired."""
        g = self.groups[self.gid_of[op.seq]]
        dev_toks, host_toks = toks
        nxt = host_toks.numpy()
        g.last_logits = logits
        if op.kind == "P":
            g.t_prefill_done = t_done - engine.t0
            for i in range(g.batch):
                g.out_tokens[i] = [int(nxt[i])]
            g.done = np.array([t[0] == self.eos_id for t in g.out_tokens])
        else:
            g.steps += 1
            g.decode_done_s.append(t_done - engine.t0)
            for i in range(g.batch):
                if not g.done[i] and g.steps < g.budget[i]:
                    tok = int(nxt[i])
                    g.out_tokens[i].append(tok)
                    if tok == self.eos_id:
                        g.done[i] = True
                elif not g.done[i]:
                    g.done[i] = True
        if (not g.done.all()) and g.steps < g.budget.max() - 1:
            seq = self.enqueue("D", g.gid, g.bucket + g.steps)
            self.feedback.push([(seq, (g.gid, dev_toks[:, None]))], t_done)
        else:
            g.t_last = t_done - engine.t0
            for p in self.programs:            # free the group's resident
                p.caches.pop(g.gid, None)      # cache slices immediately
            self.open_groups -= 1
            if self.open_groups == 0:
                self.feedback.close()


# ===========================================================================
# the pipeline
# ===========================================================================
class DecodePipeline:
    """A placed serving pipeline: prefill + decode token streams through a
    planned, placed, replicated LM stage graph.

    ``stg``/``sel`` come from the planner on a decode shape
    (`as_selection` accepts the PlanResult directly);
    ``periods_per_stage`` groups adjacent block-pattern periods into one
    stage.  ``params``: an `models.lm.LM` on the pipeline's device — pass
    the single-device server's for A/B parity; else random weights from
    ``seed``, the same the server draws from that seed.  ``devices``
    (or ``device``): where the stages run, the card unless the caller
    asks for the CPU (``devices=["cpu"]``); without a card this raises.
    The pool is one device: every placement slice folds onto it.
    ``warmup`` (default True) runs every stage program once per group
    shape before the engine starts; ``compile_stats.late`` counts first
    calls that landed inside a timed serve (kept at zero by the default).

    ``fusion_plan``: planner-selected stage combining
    (`core.restructure`).  ``None`` runs every base stage as its own
    program; ``"auto"`` scores candidate fusions with
    `planner.plan_fusion`-equivalent rules on the analytic graph; an
    explicit plan is a contiguous partition of the base stage chain,
    e.g. ``[("embed", "blocks00"), ("blocks01",), ("blocks02",),
    ("blocks03", "head")]``.  A fused stage runs ONE program for the
    member sequence — one op and one fewer FIFO hop per fused boundary —
    with the member math unchanged (token parity with the unfused
    pipeline) and each member's cache slice resident as before.
    ``overlap``: each (stage, replica) on its own stream and its ops on
    one of ``workers`` worker threads (True), or every op on the caller's
    thread and stream, one after another (False).  ``close`` stops the
    worker threads.  ``temperature`` > 0 samples from a generator per
    group seeded from ``seed``; it does not reproduce ``jax.random``'s
    draws, nor the single-device server's single generator.
    """

    check_pos = False      # tests: hold each decode op's host position
    #                        against its cache's device ``pos`` (a sync)

    def __init__(self, cfg: ModelConfig, stg: STG, sel, *,
                 devices=None, device="cuda", periods_per_stage: int = 1,
                 capacity_blocks: int = 2, seed: int = 0,
                 overlap: bool = True, replica_queue: int = 2,
                 workers: int | None = None, params=None,
                 temperature: float = 0.0, warmup: bool = True,
                 fusion_plan=None, impl: str | None = None):
        from . import as_selection
        sel = as_selection(sel)
        if cfg.encdec or cfg.frontend:
            raise ValueError(
                f"{cfg.name}: DecodePipeline runs embed->blocks->head "
                f"decoder pipelines only (enc-dec / multimodal frontends "
                f"are a ROADMAP item)")
        pool = {resolve_device(d) for d in (devices if devices is not None else [device])}
        if len(pool) != 1:
            raise NotImplementedError(
                f"DecodePipeline runs on one device, got {sorted(map(str, pool))}")
        self.device = pool.pop()
        self.cfg = cfg
        self.stg = stg
        self.sel = sel
        self.overlap = overlap
        self.replica_queue = max(1, replica_queue)
        self.workers = workers
        self.temperature = temperature
        self.impl = ops.check_impl(impl)
        self.seed = seed
        self._gens: dict[int, torch.Generator] = {}

        L = len(cfg.block_pattern)
        pps = max(1, periods_per_stage)
        graph_blocks = [n for n in stg.topo_order()
                        if n not in ("embed", "head")]
        if not all(n.startswith("block") for n in graph_blocks):
            raise ValueError(
                f"graph nodes {graph_blocks} are not decoder blocks: "
                f"DecodePipeline executes embed->blocks->head only")
        if len(graph_blocks) != cfg.n_layers:
            raise ValueError(
                f"graph has {len(graph_blocks)} block nodes but the model "
                f"has {cfg.n_layers} layers — plan and model disagree")

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_params(cfg, device=self.device, generator=gen)
        if params.embed.device != self.device:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"pipeline on {self.device}")
        self.params = params
        self.periods_per_stage = pps
        head_w = lm._head(cfg, params)

        # stage list: embed, one per pps-period group, head — then the
        # fusion plan partitions that base chain into executed stages.
        # Each block-owning stage owns periods [a, b) == layers
        # [a*L, b*L): a slice of the model's layer list.
        self.stage_names: list[str] = []
        self.stage_params: list[dict] = []     # stage -> its tensors
        self.stage_devices: list[list] = []    # stage -> replica -> device
        self.stage_streams: list[list] = []    # stage -> replica -> stream
        self.period_span: list = []            # stage -> (lo, hi) or None
        pl = place(stg, sel, [self.device])
        self.placement = pl

        def owners_of(lo_p, hi_p):
            return [f"block{li:02d}" for li in range(lo_p * L, hi_p * L)]

        spans = [(a, min(a + pps, cfg.n_periods))
                 for a in range(0, cfg.n_periods, pps)]
        base = [("embed", None)] + [
            (f"blocks{idx:02d}", sp) for idx, sp in enumerate(spans)] \
            + [("head", None)]
        groups = self._resolve_fusion(base, fusion_plan, stg, sel)
        self.fusion_plan = (tuple(groups)
                            if any(len(g) > 1 for g in groups) else None)
        base_span = dict(base)
        self.stage_descs: list[_StageDesc] = []
        for grp in groups:
            m_spans = [base_span[m] for m in grp if base_span[m] is not None]
            span = (m_spans[0][0], m_spans[-1][1]) if m_spans else None
            self.stage_descs.append(_StageDesc(
                name="+".join(grp), has_embed="embed" in grp, span=span,
                has_head="head" in grp))
        for desc in self.stage_descs:
            owners = ["embed"] if desc.has_embed else []
            stage_p = {}
            if desc.has_embed:
                stage_p["embed"] = params.embed
            if desc.span is not None:
                block_owners = owners_of(*desc.span)
                owners.extend(block_owners)
                picks = {sel.choices[o] for o in block_owners}
                if len(picks) > 1:
                    raise ValueError(
                        f"stage {desc.name} groups graph nodes "
                        f"{block_owners} whose plan choices differ "
                        f"({sorted(picks)}) — use periods_per_stage=1 "
                        f"or align the plan")
                lo, hi = desc.span[0] * L, desc.span[1] * L
                stage_p.update(layers=params.layers[lo:hi], span=(lo, hi))
            if desc.has_head:
                owners.append("head")
                stage_p.update(norm=params.final_norm, w=head_w)
            # replica pool: every member owner's placement slices (nr x
            # n_owners replicas, each doing the whole stage's work, same
            # planned capacity); on one device they share the tensors
            n_rep = max(1, sum(len(pl.replicas_of(o)) for o in owners))
            self.stage_names.append(desc.name)
            self.stage_params.append(stage_p)
            self.stage_devices.append([self.device] * n_rep)
            self.stage_streams.append(
                [torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
                 for _ in range(n_rep)])
            self.period_span.append(desc.span)
        self.lanes = Lanes([len(d) for d in self.stage_devices], self._n_workers())

        # one (prefill, decode) program pair per stage signature present
        self.warmup = warmup
        self.compile_stats = CompileStats()
        self._warmed: set = set()
        self._programs: dict = {}
        for desc in self.stage_descs:
            if desc.key in self._programs:
                continue
            tag = "+".join(n for n, on in zip(("embed", "blocks", "head"), desc.key) if on)
            pre, dec = _stage_fns(cfg, *desc.key, self.impl)
            self._programs[desc.key] = (
                AotProgram(pre, name=f"{tag}.prefill", stats=self.compile_stats),
                AotProgram(dec, name=f"{tag}.decode", stats=self.compile_stats))

    def _resolve_fusion(self, base, fusion_plan, stg, sel):
        """Normalize ``fusion_plan`` to a contiguous partition of the base
        stage chain.  ``"auto"`` scores candidates on the analytic graph
        (`core.restructure.auto_fusion`): span-bearing block stages are
        ``heavy`` (they never fuse together — that axis is
        ``periods_per_stage``), so the scorer absorbs the stateless
        embed/head endpoints into their neighbours, minimizing host
        dispatches per token."""
        names = [n for n, _ in base]
        if fusion_plan is None:
            return [(n,) for n in names]
        if fusion_plan == "auto":
            from ...core import restructure
            L = len(self.cfg.block_pattern)
            dev, reps = {}, {}
            for name, span in base:
                owners = [name] if span is None else [
                    f"block{li:02d}"
                    for li in range(span[0] * L, span[1] * L)]
                dev[name] = sum(sel.impl_of(stg, o).ii for o in owners)
                reps[name] = min(sel.replicas(o) for o in owners)
            heavy = [n for n, sp in base if sp is not None]
            return [tuple(g) for g in restructure.auto_fusion(
                names, dev_us=dev, heavy=heavy, replicas=reps,
                dev_in_score=False).groups]
        groups = [(g,) if isinstance(g, str) else tuple(g)
                  for g in fusion_plan]
        flat = [n for g in groups for n in g]
        if flat != names:
            raise ValueError(
                f"fusion_plan {groups} is not a contiguous partition of "
                f"the stage chain {names}")
        return groups

    # -- sampling -----------------------------------------------------------
    def _sample(self, logits, gid: int, temperature: float | None = None):
        """Greedy by default (token-identical to the single-device
        server); temperature > 0 samples from the group's generator."""
        t = self.temperature if temperature is None else temperature
        last = logits[:, -1, :]
        if t <= 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / t, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gens[gid])[:, 0]

    def _edge_fifo(self, s: int, capacity_blocks: int) -> Fifo:
        # same slot accounting as the JAX pipeline: reservations from
        # producer dispatch to consumer retirement, plus buffered slack;
        # one device, so nothing to stage ahead of a pop
        prod = len(self.stage_devices[s])
        cons = len(self.stage_devices[s + 1])
        slots = (prod + cons) * self.replica_queue
        return Fifo(block=1, capacity_blocks=capacity_blocks,
                    min_capacity=capacity_blocks + slots)

    def _n_workers(self) -> int:
        if self.workers is not None:
            return max(1, self.workers)
        return min(16, max(2, sum(len(d) for d in self.stage_devices)))

    def _warm_group(self, g: _Group, overlap: bool) -> None:
        """Run every program group ``g``'s ops will run — prefill at (B,
        bucket), a decode step on the cache it made, and the greedy sampler
        at the head — once, on scratch inputs, where the ops will run:
        overlapped, on the lane thread of each stage's replica for ``g``
        and on that replica's stream; else on this thread and its stream.
        Runs before the engine's clock starts; no served request pays a
        first launch."""
        shape = (g.batch, g.bucket, g.cap)
        jobs = []
        for s in range(len(self.stage_descs)):
            rep = g.gid % len(self.stage_devices[s])
            key = (s, rep, shape) if overlap else (s, _where(), shape)
            if key in self._warmed:
                continue
            if overlap:
                jobs.append(self.lanes.submit(s, rep, self._warm_stage, s,
                                              self.stage_streams[s][rep], *shape))
            else:
                self._warm_stage(s, None, *shape)
            self._warmed.add(key)
        for job in jobs:
            job.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_stage(self, s: int, stream, batch: int, bucket: int, cap: int) -> None:
        cfg, dev = self.cfg, self.device
        dt = self.params.embed.dtype
        desc = self.stage_descs[s]
        pre, dec = self._programs[desc.key]
        on = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with torch.no_grad(), on:
            if desc.has_embed:
                xp = torch.zeros((batch, bucket), dtype=torch.long, device=dev)
                xd = torch.zeros((batch, 1), dtype=torch.long, device=dev)
            else:
                xp = torch.zeros((batch, bucket, cfg.d_model), dtype=dt, device=dev)
                xd = torch.zeros((batch, 1, cfg.d_model), dtype=dt, device=dev)
            y, cache = pre.precompile(self.stage_params[s], xp, cap)
            y = dec.precompile(self.stage_params[s], cache, xd)
            if desc.has_head and (self.temperature or 0.0) <= 0.0:
                self._sample(y, gid=-1).to("cpu", non_blocking=True)

    def close(self) -> None:
        """Stop the worker threads: the pipeline serves overlapped no
        more."""
        self.lanes.close()

    # -- serving ------------------------------------------------------------
    def _groups(self, prompts: list[list[int]], max_new, group_size: int):
        """The serve's slot groups, as `LMServer.serve` forms its rounds."""
        if isinstance(max_new, int):
            max_new = [max_new] * len(prompts)
        if len(max_new) != len(prompts):
            raise ValueError("max_new must be a scalar or match prompts")
        groups: list[_Group] = []
        group_of: list[int] = []
        for gid, lo in enumerate(range(0, len(prompts), group_size)):
            chunk = prompts[lo:lo + group_size]
            budgets = np.array(max_new[lo:lo + group_size])
            bucket = _bucket(max(len(p) for p in chunk))
            # the cache capacity `lm.prefill` makes for the server's round
            cap = blocks.attn_cache_capacity(self.cfg, bucket + int(budgets.max()))
            toks = np.zeros((len(chunk), bucket), np.int64)
            for i, p in enumerate(chunk):          # right-align prompts so
                toks[i, bucket - len(p):] = p      # last token is real
            groups.append(_Group(
                gid=gid, tokens=toks, bucket=bucket, cap=cap,
                budget=budgets, out_tokens=[None] * len(chunk)))
            group_of.extend([gid] * len(chunk))
        return groups, group_of

    def warm(self, prompts: list[list[int]], max_new, *, group_size: int = 8,
             overlap: bool | None = None) -> None:
        """Run every program at the group shapes ``serve`` will form for
        these requests, where it will run them, now (``serve`` does it
        itself when ``warmup``)."""
        overlap = self.overlap if overlap is None else overlap
        for g in self._groups(prompts, max_new, group_size)[0]:
            self._warm_group(g, overlap)

    def serve(self, prompts: list[list[int]], max_new, *, eos_id: int = 1,
              group_size: int = 8, capacity_blocks: int = 2,
              overlap: bool | None = None,
              temperature: float | None = None,
              tracer=None) -> ServeRunResult:
        """Serve ``prompts`` in ``group_size`` slot groups streamed
        concurrently through the pipeline.  Grouping, bucketing, and
        EOS/budget bookkeeping mirror `LMServer.serve_round` on each
        group, so a single-device server with ``max_batch=group_size``
        produces token-identical completions.  ``temperature`` overrides
        the pipeline-level default for this run.  ``tracer``: optional
        `trace.Tracer` — the serve emits op spans, credit/starve waits,
        and fifo occupancy (incl. the head->embed feedback stream);
        warm-up stays untraced."""
        if not prompts:
            raise ValueError("serve() needs at least one prompt")
        overlap = self.overlap if overlap is None else overlap
        groups, group_of = self._groups(prompts, max_new, group_size)
        if self.warmup:
            for g in groups:
                self._warm_group(g, overlap)
        for g in groups:
            if g.gid not in self._gens:
                self._gens[g.gid] = torch.Generator(device=self.device).manual_seed(
                    (self.seed ^ 0xC0FFEE) + g.gid)

        run = _ServeRun(self, groups, eos_id=eos_id,
                        capacity_blocks=capacity_blocks, overlap=overlap,
                        temperature=temperature)
        for g in groups:
            run.enqueue("P", g.gid, 0)
        res, engine = self._launch(run, group_of, overlap=overlap, tracer=tracer)
        for g in groups:                       # run-relative group timings
            g.t_start = max(0.0, g.t_start - engine.t0)
        return res

    def _launch(self, run: _ServeRun, group_of: list, *, overlap: bool,
                tracer) -> tuple[ServeRunResult, Engine]:
        """Wire channels, drive the engine to quiescence, fold the engine
        result into a `ServeRunResult`."""
        names = self.stage_names
        fifo_map = {f"act{s}": run.acts[s] for s in range(len(run.acts))}
        fifo_map["feedback"] = run.feedback
        if tracer is not None:
            for s in range(len(run.acts)):
                tracer.watch_fifo(run.acts[s], f"act{s}",
                                  src=names[s], dst=names[s + 1])
            tracer.watch_fifo(run.feedback, "feedback",
                              src=names[-1], dst=names[0])
        engine = Engine(run.programs, overlap=overlap,
                        replica_queue=self.replica_queue,
                        tracer=tracer, fifos=fifo_map, lanes=self.lanes)
        with self.compile_stats.window():
            er = engine.run()
        assert run.feedback.exhausted, \
            "token stream not drained: a group retired with tokens in flight"

        res = ServeRunResult(
            tokens=[], group_of=group_of, groups=run.groups,
            stage_done_s=er.stage_done_s, stage_seconds=er.stage_seconds,
            stage_firings=er.stage_firings,
            stage_dispatch_s=er.stage_dispatch_s, op_trace=er.op_trace,
            max_inflight=er.max_inflight, wall_s=er.wall_s,
            stage_wait_s=er.stage_wait_s, placement=self.placement,
            streams_used=len(run.streams))
        idx_in_group: dict[int, int] = {}
        for gid in group_of:
            i = idx_in_group.get(gid, 0)
            idx_in_group[gid] = i + 1
            res.tokens.append(run.groups[gid].out_tokens[i])
        for s in range(len(run.acts)):
            res.fifo_stats[("act", s)] = run.acts[s].stats
        res.fifo_stats["feedback"] = run.feedback.stats
        return res, engine
