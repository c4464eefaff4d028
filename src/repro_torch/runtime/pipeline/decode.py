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
    plan's round-robin replication; a stage's ``rep_map`` overrides that
    rule once a replica died (``dead``) or shed a group;
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
    thread and stream of every replica a group may be routed to, so no
    served request pays a first launch (``compile_stats.late == 0``), not
    even one moved by failover or migration.

Failover, migration, pause and resume.  A replica that dies mid-serve
(``serve(injector=)``, `engine.Engine._replica_fault`) hands its groups
to survivors (`_ServeStageProgram.fail_replica`): its in-flight ops are
redone there under their original sequence numbers, and each moved
group's cache slice is rebuilt *fresh* by deterministic replay of its
prompt and fed-token history (`_Group.fed`) through the same programs on
the lanes and streams they were warmed on (`DecodePipeline._replay_cache`)
— a dead op may have half-updated the old slice in place, and no
surviving slice is touched.  A slow replica sheds groups
(`shed_replica`, driven by `health.HealthController`).  An
admission-paused serve (``pause_after_tokens=``) parks its groups with
their caches resident and exports a `ResumeState`; `DecodePipeline.resume`
continues it here or on a re-planned pipeline
(`runtime.elastic.rescale_serving`), adopting each cache slice whose span
matches and replaying the others.  Where a cache changes owner (migration,
resume), the new owner's stream waits on an event recorded on the old
owner's stream and the cache is marked for the new stream
(``record_stream``): on one card that hand-off is the whole copy.

Streams and memory.  The engine dispatches a consumer only after it has
seen its producer's event, so a hidden state is complete before the next
stage reads it.  What remains is the caching allocator: a tensor made on
one stream and freed after another stream read it could be handed out
again on the first while the read is still queued.  Each op body
therefore marks its tensor inputs with ``Tensor.record_stream`` on its
own stream.  A group's cache is made and used on one (stage, replica)
stream at a time, and handed off as above when its owner changes.

In one process every placement slice is its one device: the replicas of
a stage share the ``LM``'s tensors, so the weights live once however many
replicas the plan asks for.  Over several devices the pipeline runs a
process a device (``devices=`` a `launch.mesh.RankPool`, `remote`): each
replica of a stage on its placement slice's first rank (a tp > 1 slice
folds there, as the JAX package folds it onto its first device), its
caches resident there; the pool's first rank schedules and keeps the
groups' bookkeeping, the head's rank reports each sampled token there,
and it goes back to the embed stage in its next decode command.  The drills
run there too (`_RankServeStageProgram`): a replica on another rank fails
over (its lost ops waited home on its rank, their outputs and its groups'
slices freed there, each slice replayed on its survivor's rank, step by
step on the ranks of the preceding stages), a migration moves a slice rank
to rank, a pause parks the slices on their ranks (`remote.PARKED`), and a
resume adopts, moves or replays each one, here or on the successor that
`runtime.elastic.rescale_serving` builds over a subset of the ranks.
Encoder-decoder and multimodal frontends are rejected: the pipeline runs
embed -> blocks -> head only.

Every serve is preflighted (`core.verify.verify_decode_plan`, ``preflight=``)
as in the JAX module; the port has no buffer donation, so the cache
contract it checks is that a stage's decode leaves every cache tensor's
shape, dtype and storage as it found them.

`runtime/server.LMServer` uses this as its pipelined backend
(``LMServer(cfg, pipeline=DecodePipeline(...))``).
"""
from __future__ import annotations

import contextlib
import itertools
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
from ..failures import PipelineFailure
from ..server import _bucket            # one bucketing rule: token parity
from .aot import AotProgram, CompileStats, _where
from .channels import Fifo, StreamChannel
from .engine import (AsyncResult, DeviceWatch, Engine, EngineResult, Lanes, Op,
                     RemoteLanes, describe_position)
from .placement import Placement, place
from .remote import OverRanks, Ref, meta_of, posted, stream_handle, tree_flatten, tree_meta


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
    cur: np.ndarray = None             # last sampled token per slot (B,)
    t_start: float = 0.0
    t_prefill_done: float = 0.0
    t_last: float = 0.0
    decode_done_s: list = field(default_factory=list)
    last_logits: torch.Tensor = None   # (B, 1, Vp) of the group's last step
    fed: list = field(default_factory=list)
    # token history: fed[j] is a host copy of the (B,) token batch fed
    # back for decode step j.  out_tokens is NOT enough to replay a cache —
    # done slots keep feeding their last sampled token in lockstep without
    # emitting it — so failover/resume cache rebuilds read this instead.

    @property
    def batch(self) -> int:
        return self.tokens.shape[0]


@dataclass
class ServeRunResult(EngineResult):
    """One pipelined serve: per-request tokens + the engine's measurement
    surface (stage completion streams, fifo stats, trace).  As an
    `EngineResult` it exposes ``stage_inverse_us``, so a serve run feeds
    `measure.compare_lm(stg, sel, run, stage_map=pipe.graph_stage_map())`
    — serving traffic is a calibration source for re-planning."""
    tokens: list = field(default_factory=list)   # per request, generated
    group_of: list = field(default_factory=list)  # request index -> group id
    groups: list = field(default_factory=list)   # _Group bookkeeping
    fifo_stats: dict = field(default_factory=dict)
    placement: Placement | None = None
    streams_used: int = 0              # distinct CUDA streams that ran ops
    paused: bool = False               # admission-paused mid-stream
    resume_state: object = None        # `ResumeState` when paused
    ranks: dict = field(default_factory=dict)
    # over ranks: rank -> {"host_s": its op bodies' host seconds, "stall_s":
    # of those, the injected stalls it slept, "late", "bytes_sent",
    # "bytes_moved" (of those, slices and weights moved), "launches": kernel
    # launches in the timed serve}
    migrations: list = field(default_factory=list)
    # over ranks: one dict per migrated slice {stage, gid, from, to,
    # from_rank, to_rank, bytes (moved rank to rank, 0 on one rank)}
    adopted: dict = field(default_factory=dict)
    # over ranks, a resume: {"moved": one dict per parked slice adopted
    # {stage, gid, from_rank, to_rank, bytes}, "replayed": {stage, gid,
    # rank} per slice rebuilt where the spans differ}

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
        # failover/rebalance state: group routing defaults to the cache-
        # affinity rule gid % n_replicas; rep_map overrides it after a
        # replica dies (or a straggler sheds load), dead marks replicas
        # the engine must never route to again
        self.rep_map: dict[int, int] = {}
        self.dead: set[int] = set()
        self.redo: list = []           # (kind, gid, seq, pos, payload):
        #                                lost ops re-issued under their
        #                                ORIGINAL seq so reorder holes fill
        self.done_count: dict[int, int] = {}   # gid -> retired ops here
        self.inflight: dict[int, int] = {}     # gid -> dispatched-unretired

    def enqueue(self, kind: str, gid: int, seq: int, pos: int) -> None:
        self.queue.append((kind, gid, seq, pos))

    def free(self, gid: int) -> None:
        """A group is done: its cache slice here goes."""
        self.caches.pop(gid, None)

    def pending(self) -> int:
        return len(self.queue) - self.pos_i + len(self.redo)

    def rep_of(self, gid: int) -> int:
        return self.rep_map.get(gid, gid % self.n_replicas)

    def stream_of(self, rep: int):
        """The stream replica ``rep``'s ops run on in this serve."""
        return self.pipe._owner_stream(self.s, rep, self.run.overlap)

    def peek(self) -> Op | None:
        if self.redo:
            kind, gid, seq, _pos, _payload = self.redo[0]
            return Op(stage=self.s, kind=kind, seq=seq, rep=self.rep_of(gid))
        if self.pos_i >= len(self.queue):
            return None
        kind, gid, seq, _ = self.queue[self.pos_i]
        return Op(stage=self.s, kind=kind, seq=seq, rep=self.rep_of(gid))

    def ready(self, op: Op, count_stall: bool = False) -> float | None:
        s, S, run = self.s, self.S, self.run
        if self.redo:
            # a replayed op re-runs from its saved inputs and retires into
            # the slot its original dispatch already reserved — no fifo
            # state to wait for
            return 0.0
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
        if self.redo:
            # replay of a lost op: inputs were saved at its original
            # dispatch; that dispatch's downstream reservation is still
            # outstanding, so no pop and no reserve here — retirement
            # fills the reorder hole under the original seq
            kind, gid, seq, pos, payload = self.redo.pop(0)
            op.recover = (kind, gid, seq, pos, payload)
            self.inflight[gid] = self.inflight.get(gid, 0) + 1
            return self._task_for(kind, gid, seq, pos, payload, op.rep)
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
        op.recover = (kind, gid, seq, pos, payload)
        self.inflight[gid] = self.inflight.get(gid, 0) + 1
        return self._task_for(kind, gid, seq, pos, payload, op.rep)

    def _task_for(self, kind: str, gid: int, seq: int, pos: int, payload, rep: int):
        """Build the op body from in-hand inputs (``payload`` is the
        prompt, the fed-back tokens or the popped hidden state) — shared
        by the normal dispatch path and failover redo, so a redo runs the
        exact math the lost op would have."""
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
        y, cache, toks, t_done = self._outcome(op, result, engine)
        gid = run.gid_of[op.seq]
        self.done_count[gid] = self.done_count.get(gid, 0) + 1
        self.inflight[gid] = self.inflight.get(gid, 1) - 1
        if cache is not None:                             # a prefill's cache
            self.caches[gid] = cache                      # stays resident here
        if self.pipe.stage_descs[s].has_head:             # head: sampled
            run.on_head(op, y, toks, t_done, engine)
        else:
            engine.ordered_push(run.acts[s], op.seq, (gid, y), t_done)
        return t_done

    def _outcome(self, op: Op, result, engine: Engine):
        """(output, the prefill's cache or None, the head's sampled tokens
        (on the device, on the host) or None, completion time) of a retired
        op."""
        (y, cache, toks), t_done = result
        return y, cache, toks, t_done

    # -- failover & rebalance -----------------------------------------------
    def fail_replica(self, rep: int, driver, lost: list) -> None:
        """Replica ``rep`` died: remap its groups onto survivors, rebuild
        the cache slices that died with it, and queue the drained
        in-flight ops for redo under their original sequence numbers.
        No survivors -> `PipelineFailure` (the engine attaches its
        diagnostic bundle).

        A drained op's kernels may still be running on the dead
        replica's stream, writing its group's cache in place: the
        current stream waits on that stream (an event), and every
        dropped cache tensor is marked for the current stream, so the
        allocator cannot hand its memory out again before those kernels
        end.  Each moved group's slice is rebuilt fresh by deterministic
        replay of its prompt and fed-token history up to its last
        retired op here — bitwise what the dead replica held."""
        pipe, run = self.pipe, self.run
        moved = self._take_over(rep, lost)
        here = pipe._owner_stream(self.s, rep, False)     # the current stream
        for gid in moved:
            old = self.caches.pop(gid, None)
            if old is None:
                continue
            pipe._hand_off(old, self.stream_of(rep), here)
            del old
            k = self.done_count.get(gid, 0)
            if k > 0:
                reps = [run.programs[j].rep_of(gid) for j in range(self.s + 1)]
                self.caches[gid] = pipe._replay_cache(
                    run.groups[gid], self.s, k, reps, run.overlap)

    def _take_over(self, rep: int, lost: list) -> list:
        """Mark replica ``rep`` dead, remap its groups round-robin onto the
        survivors and queue the lost ops' redo; returns the moved groups.
        No survivor -> `PipelineFailure`."""
        self.dead.add(rep)
        alive = [r for r in range(self.n_replicas) if r not in self.dead]
        if not alive:
            raise PipelineFailure(
                f"stage {self.name}: replica r{rep} was the last one — "
                f"nothing left to fail over to",
                stage=self.name, replica=rep)
        moved = [gid for gid in range(len(self.run.groups))
                 if self.rep_of(gid) == rep]
        for i, gid in enumerate(moved):
            self.rep_map[gid] = alive[i % len(alive)]
        for op in lost:
            kind, gid, seq, pos, payload = op.recover
            self.inflight[gid] = self.inflight.get(gid, 1) - 1
            self.redo.append((kind, gid, seq, pos, payload))
        return moved

    def migrate_gid(self, gid: int, to_rep: int) -> bool:
        """Move one group to another replica between its ops (straggler
        shedding): routing flips and the resident cache slice is handed
        to the new owner's stream — the source replica is alive and on
        the same card, so no copy and no replay.  Refused while the
        group has an op in flight anywhere at this stage."""
        if self.inflight.get(gid) or to_rep in self.dead:
            return False
        frm = self.rep_of(gid)
        if frm == to_rep:
            return True
        self.rep_map[gid] = to_rep
        if gid in self.caches:
            self.pipe._hand_off(self.caches[gid], self.stream_of(frm),
                                self.stream_of(to_rep))
        return True

    def shed_replica(self, rep: int, max_groups: int = 1) -> int:
        """Shift dispatch share off a slow replica: migrate up to
        ``max_groups`` of its idle groups to the least-loaded healthy
        peer.  Returns how many actually moved."""
        peers = [r for r in range(self.n_replicas)
                 if r not in self.dead and r != rep]
        if not peers:
            return 0
        n_groups = len(self.run.groups)
        moved = 0
        for gid in range(n_groups):
            if moved >= max_groups:
                break
            g = self.run.groups[gid]
            if self.rep_of(gid) != rep or gid not in self.caches \
                    or g.done is not None and g.done.all():
                continue
            load = {r: sum(1 for g2 in range(n_groups)
                           if self.rep_of(g2) == r) for r in peers}
            to = min(peers, key=lambda r: (load[r], r))
            if self.migrate_gid(gid, to):
                moved += 1
        return moved

    def describe(self) -> str:
        return describe_position(
            self.name, self.pos_i, self.queue,
            lambda q: f"{q[0]}(gid={q[1]},seq={q[2]})")


def _run_stage(prog: AotProgram, params, x: torch.Tensor, device, stream, sample,
               cache=None, cap=None, after=None):
    """One op body: launch the stage program on the stage's stream and
    return without waiting for the device; the engine retires the op off
    the returned `DeviceWatch`.  ``cap`` given: a prefill, which makes the
    stage's cache for the group; else a decode step on ``cache``.
    ``after``: a CUDA event the stream waits on first (a cache replay's
    previous stage, on another stream).

    The input was made on another stage's stream (or is the prompt, still
    on the host): it is marked for this stream (``record_stream``), so
    the allocator does not hand its block out again while this stream
    still reads it.  A head stage samples here too and starts the tokens'
    copy to the host, so that retirement reads them without a sync."""
    on = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    with torch.no_grad(), on:
        if after is not None:
            torch.cuda.current_stream(device).wait_event(after)
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


_TOKENS = itertools.count()     # the controller's names of pauses and replays


# -- over ranks: the weights a successor's rank lacks ---------------------------
def _weight_names(cfg: ModelConfig) -> list:
    """The weights by `lm.init_params`'s ``keep`` names."""
    return (["embed", "final_norm"] + ([] if cfg.tie_embeddings else ["head"])
            + [f"layers.{i}" for i in range(cfg.n_layers)])


def _weight_slots(params, name: str) -> list:
    """(module, attribute, tensor) of each tensor of weight ``name``."""
    if not name.startswith("layers."):
        return [(params, name, getattr(params, name))]
    layer = params.layers[int(name.split(".")[1])]
    out = []
    for full, p in layer.named_parameters():
        path, _, attr = full.rpartition(".")
        out.append((layer.get_submodule(path), attr, p))
    return out


def _weight_tensors(params, name: str) -> list:
    return [t for _, _, t in _weight_slots(params, name)]


def _held_weights(pipe) -> list:
    """The weights this rank holds (a function for `remote.Controller.call`)."""
    return [n for n in _weight_names(pipe.cfg)
            if not any(t.is_meta for t in _weight_tensors(pipe.params, n))]


def _build_successor(pipe, spec: dict):
    """On every rank of ``pipe``'s pool (the world, which makes the new
    pool's groups): the successor's pool and, on its ranks, the successor on
    ``pipe``'s weights (what a rank lacks comes next, `_on_install`).  A
    member other than the controller runs the successor's worker beside
    ``pipe``'s.  Returns the successor on the controller, else None."""
    from ...launch.mesh import rank_pool
    pool = rank_pool(spec["ranks"], device=pipe.device, transport=pipe.pool.transport,
                     timeout_s=pipe.pool.timeout_s)
    if pool.rank not in pool.ranks:
        return None
    succ = DecodePipeline(spec["cfg"], spec["stg"], spec["plan"], devices=pool,
                          params=pipe.params, **spec["kw"])
    pipe.successor = succ
    if pool.is_controller:
        return succ
    succ._work_beside(pipe)
    return None


def _settle_weights(pipe, leaving: list) -> list:
    """After the weight moves: a rank that leaves the pool lets its weights
    go (``pipe``'s stages there with them); a successor binds its stages to
    the weights its rank now holds.  Returns what this rank holds."""
    if pipe.pool.rank in leaving:
        for name in _weight_names(pipe.cfg):
            for mod, attr, t in _weight_slots(pipe.params, name):
                mod._parameters[attr] = torch.nn.Parameter(t.to("meta"),
                                                           requires_grad=t.requires_grad)
        pipe.stage_params = [{} for _ in pipe.stage_descs]
    succ = getattr(pipe, "successor", None)
    if succ is not None:
        succ._bind_params()
    return _held_weights(pipe)


class _RankServeStageProgram(_ServeStageProgram):
    """`_ServeStageProgram` over ranks: the same op queue, routing and
    channels; an op is posted to its replica's rank (`_on_stage` there), its
    hidden state sent there from the rank that holds it, and a FIFO token
    is a `remote.Ref` to a hidden state that stays on its rank.  The head's
    rank reports the sampled token ids, which come back to the embed stage
    in its next decode command; a group's cache slices stay on their ranks
    until the group is done (``caches`` holds each one's `remote.TreeMeta`
    here, the slice itself stays on its replica's rank).

    The drills: an op's hidden-state input is kept by its holder until the
    op (or its redo on a survivor) retires; an injected stall rides in the
    op's command (``stall_s``); a dead replica's lost ops are waited home
    on its rank and what they made freed there (`drain_lost`), its groups'
    slices freed there and replayed on the survivors' ranks
    (`DecodePipeline._replay_ranks`); a migration moves the slice rank to
    rank (``migrations`` of the run records each)."""

    def __init__(self, s: int, pipe: "DecodePipeline", run: "_ServeRun"):
        super().__init__(s, pipe, run)
        self.ctl = pipe._ctl
        self.stall_s = 0.0                 # the engine's stall for the next op
        self.sent: dict[int, tuple] = {}   # seq -> (command id, rank, replica)

    def rank_of(self, rep: int) -> int:
        return self.pipe.stage_ranks[self.s][rep]

    def _task_for(self, kind: str, gid: int, seq: int, pos: int, payload, rep: int):
        """The op's command to its replica's rank: ``payload`` (the prompt
        or the fed-back tokens, or a `Ref` to the producer's hidden state,
        which its holder keeps until this op retires) inline or sent from
        the rank that holds it."""
        run = self.run
        rank = self.rank_of(rep)
        spec = (self.ctl.inputs_for(payload, [rank], keep=True)[rank]
                if isinstance(payload, Ref) else ("value", np.asarray(payload)))
        what = f"{kind} of {self.name} replica {rep} group {gid} (op {seq})"
        cid = self.ctl.post(rank, {
            "do": "run", "fn": "stage", "lane": (self.s, rep) if run.overlap else None,
            "s": self.s, "rep": rep, "kind": kind, "gid": gid, "seq": seq,
            "cap": run.groups[gid].cap, "temperature": run.temperature,
            "overlap": run.overlap, "inputs": {"x": spec}, "stall_s": self.stall_s,
            "what": what})
        self.stall_s = 0.0
        self.sent[seq] = (cid, rank, rep)
        return posted, (self.ctl, cid, [rank], what)

    def _outcome(self, op: Op, result, engine: Engine):
        run = self.run
        cid, t_done = result
        rank = self.rank_of(op.rep)
        self.sent.pop(op.seq, None)
        rep = self.ctl.take(cid)[rank]
        run.rank_host_s[rank] = run.rank_host_s.get(rank, 0.0) + rep["host_s"]
        run.rank_stall_s[rank] = run.rank_stall_s.get(rank, 0.0) + rep["stall_s"]
        if engine.tracer is not None:
            engine.tracer.op_rank(self.name, op.rep, rank, rep["host_s"])
        engine.result.stage_dispatch_s[self.name] += rep["host_s"]
        if rep.get("stream") is not None:
            run.streams.add((rank, rep["stream"]))
        if isinstance(op.recover[4], Ref):            # its input, kept till now
            self.ctl.drop(op.recover[4].rank, [op.recover[4].key], "an op's input")
        if rep.get("cache") is not None:
            self.caches[run.gid_of[op.seq]] = rep["cache"]
        if self.pipe.stage_descs[self.s].has_head:    # the tokens, on the host only
            return None, None, (None, rep["tokens"]), t_done
        return Ref(rank, ("h", self.s, op.seq, op.rep), rep["meta"]), None, None, t_done

    def free(self, gid: int) -> None:
        if self.caches.pop(gid, None) is not None:
            self.ctl.drop(self.rank_of(self.rep_of(gid)), [("cache", self.s, gid)],
                       f"free group {gid}'s cache of {self.name}")

    # -- failover & rebalance over ranks -------------------------------------
    def drain_lost(self, lost: list) -> None:
        """The dead replica's rank lives (the fault is simulated) and runs
        the lost ops to their end: wait each one's report home and drop it,
        and free its output there."""
        for op in lost:
            cid, rank, rep = self.sent.pop(op.seq)
            self.ctl.wait(cid, [rank], f"lost op {op.seq} of {self.name}")
            if not self.pipe.stage_descs[self.s].has_head:
                self.ctl.drop(rank, [("h", self.s, op.seq, rep)], f"lost op {op.seq}'s output")

    def fail_replica(self, rep: int, driver, lost: list) -> None:
        """`_ServeStageProgram.fail_replica` over ranks: the routing remap and
        the redo queue alike; the moved groups' slices freed on the dead
        replica's rank and each rebuilt by replay on its survivor's rank
        (every preceding stage's step on the rank of the group's replica
        there, the hidden state sent rank to rank as live traffic sends
        it)."""
        pipe, run = self.pipe, self.run
        moved = self._take_over(rep, lost)
        if pipe.period_span[self.s] is None or not moved:
            return
        # a lost prefill may have left a slice there that ``caches`` never saw
        self.ctl.drop(self.rank_of(rep), [("cache", self.s, gid) for gid in moved],
                   f"the dead {self.name} r{rep}'s slices")
        for gid in moved:
            if self.caches.pop(gid, None) is None:
                continue
            reps = [run.programs[j].rep_of(gid) for j in range(self.s + 1)]
            self.caches[gid] = pipe._replay_ranks(
                run.groups[gid], self.s, self.done_count.get(gid, 0), reps, run.overlap)

    def migrate_gid(self, gid: int, to_rep: int) -> bool:
        """`_ServeStageProgram.migrate_gid` over ranks: the slice moves from
        the source replica's rank to the new owner's (freed at the source),
        or is handed to its stream on the same rank."""
        if self.inflight.get(gid) or to_rep in self.dead:
            return False
        frm = self.rep_of(gid)
        if frm == to_rep:
            return True
        self.rep_map[gid] = to_rep
        meta = self.caches.get(gid)
        if meta is not None:
            a, b = self.rank_of(frm), self.rank_of(to_rep)
            key = ("cache", self.s, gid)
            if a != b:
                self.ctl.move(Ref(a, key, meta), b, key, ack=False)
            self.pipe._adopt(b, key, key, self.s, to_rep, self.run.overlap)
            self.run.migrations.append({"stage": self.name, "gid": gid, "from": frm,
                                        "to": to_rep, "from_rank": a, "to_rank": b,
                                        "bytes": meta.nbytes if a != b else 0})
        return True


class _ServeRun:
    """Shared state of one pipelined serve: groups, channels, the global
    op sequence, and the head-side bookkeeping."""

    def __init__(self, pipe: "DecodePipeline", groups: list, *,
                 eos_id: int, capacity_blocks: int, overlap: bool,
                 temperature: float | None = None,
                 pause_at: int | None = None,
                 open_groups: int | None = None,
                 feedback_capacity: int | None = None):
        self.pipe = pipe
        self.groups = groups
        self.eos_id = eos_id
        self.overlap = overlap
        self.temperature = temperature
        self.pause_at = pause_at       # admission pause: groups reaching
        self.parked: list[int] = []    # this many decode steps park (their
        #                                caches stay resident for export)
        #                                instead of feeding back
        self.streams: set = set()              # handles of the CUDA streams
        #                                        ops ran on
        self.rank_host_s: dict = {}            # over ranks: rank -> op host seconds
        self.rank_stall_s: dict = {}           # and of those, stalls slept
        self.migrations: list = []             # over ranks: each slice migrated,
        self.moved_slices: list = []           # moved rank to rank on resume,
        self.replayed_slices: list = []        # replayed on resume
        self.gid_of: list[int] = []            # seq -> gid
        program = _ServeStageProgram if pipe.pool is None else _RankServeStageProgram
        self.programs = [program(s, pipe, self) for s in range(len(pipe.stage_names))]
        S = len(self.programs)
        self.acts = [pipe._edge_fifo(s, capacity_blocks) for s in range(S - 1)]
        # the continuous token stream: head -> embed feedback.  At most
        # one token per live group is ever in flight (a group's next op
        # consumes it before its next push), so n_groups slots suffice.
        # The head pushes here *unconditionally* at retirement, which is
        # why `verify_decode_plan` requires capacity >= n_groups — an
        # override below that statically fails preflight.
        fb_cap = feedback_capacity if feedback_capacity is not None \
            else max(2, len(groups))
        self.feedback = StreamChannel(block=1, capacity_blocks=1,
                                      min_capacity=fb_cap)
        self.open_groups = len(groups) if open_groups is None else open_groups

    def rank_times(self) -> dict:
        """Over ranks: rank -> {"host_s", "stall_s"} of its op bodies."""
        return {r: {"host_s": s, "stall_s": self.rank_stall_s.get(r, 0.0)}
                for r, s in self.rank_host_s.items()}

    def enqueue(self, kind: str, gid: int, pos: int) -> int:
        seq = len(self.gid_of)
        self.gid_of.append(gid)
        for p in self.programs:
            p.enqueue(kind, gid, seq, pos)
        return seq

    def on_head(self, op: Op, logits, toks, t_done: float, engine: Engine) -> None:
        """Book the sampled tokens at head retirement and schedule the
        group's next decode step (or park or retire the group) —
        `LMServer.serve_round` bookkeeping, verbatim, so completions are
        token-identical.  ``toks``: the tokens on the device (fed back to
        the embed stage as they are) and their copy on the host, complete
        since the op's event fired; ``fed`` and ``cur`` keep copies of
        the host values."""
        g = self.groups[self.gid_of[op.seq]]
        dev_toks, host_toks = toks
        nxt = np.array(host_toks)
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
        g.cur = nxt
        if (not g.done.all()) and g.steps < g.budget.max() - 1:
            if self.pause_at is not None and g.steps >= self.pause_at:
                # admission pause: park the group instead of feeding its
                # token back — caches stay resident for the export,
                # g.cur is the un-fed token resume() re-feeds
                self.parked.append(g.gid)
                self.open_groups -= 1
                if self.open_groups == 0:
                    self.feedback.close()
            else:
                seq = self.enqueue("D", g.gid, g.bucket + g.steps)
                g.fed.append(g.cur.copy())
                fed = nxt[:, None] if dev_toks is None else dev_toks[:, None]
                self.feedback.push([(seq, (g.gid, fed))], t_done)
        else:
            g.t_last = t_done - engine.t0
            for p in self.programs:            # free the group's resident
                p.free(g.gid)                  # cache slices immediately
            self.open_groups -= 1
            if self.open_groups == 0:
                self.feedback.close()


@dataclass
class ResumeState:
    """Everything a drained, admission-paused serve hands the next
    pipeline: the group bookkeeping (prompts, budgets, sampled-token
    history, the un-fed ``cur`` token) and each block stage's resident
    cache slices keyed by the stage's period span, with the stream each
    was last used on.  A resuming pipeline whose stage spans match
    *adopts* the slices (a hand-off to its streams — the cheap path);
    mismatched spans are rebuilt by deterministic replay from prompt +
    fed-token history, so a rescale can change the stage partitioning
    without touching in-flight requests.  Single use: the resumed serve
    updates the adopted slices in place."""
    groups: list                       # _Group objects, indexed by gid
    group_of: list                     # request index -> gid
    eos_id: int
    stage_caches: dict = field(default_factory=dict)
    # stage name -> {"span": (lo, hi), "caches": {gid: cache},
    #                "streams": {gid: stream the cache was last used on}};
    # over ranks {"span": (lo, hi), "slices": {gid: (rank, key, meta)}}:
    # each slice parked on its rank (`remote.PARKED`) under ``key``
    owner: object = None
    # over ranks: the pipeline that parked the slices, whose controller
    # moves one to another rank and frees what no resume adopts

    def live_groups(self) -> list:
        return [g for g in self.groups
                if g.done is not None and not g.done.all()
                and g.steps < g.budget.max() - 1]

    def free(self) -> None:
        """Over ranks: let go of every parked slice no resume adopted."""
        if self.owner is None:
            return
        for entry in self.stage_caches.values():
            for rank, key, _ in entry.pop("slices", {}).values():
                self.owner._ctl.drop(rank, [key], "a parked slice")


# ===========================================================================
# the pipeline
# ===========================================================================
class DecodePipeline(OverRanks):
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
    One device: every placement slice folds onto it.  A
    `launch.mesh.RankPool` (or a ``DeviceMesh``, or a list of ranks): a
    process a rank, every rank building the same pipeline with the same
    ``params`` or ``seed``; the pool's first rank serves (``serve``,
    ``LMServer(pipeline=)``) and calls ``close``, every other rank
    ``work``.  Weights drawn from ``seed`` are drawn whole on each rank,
    a layer at a time, and a rank holds only its stages' tensors and the
    layer being drawn (the others go to the meta device as they are made).
    ``warmup`` (default True) runs every stage program once per group
    shape on every replica before the engine starts; ``compile_stats.late``
    counts first calls that landed inside a timed serve (kept at zero by
    the default, failover and migration included).

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
        from ...launch.mesh import as_rank_pool
        self.pool = as_rank_pool(devices, device) if devices is not None else None
        if self.pool is None:
            pool = {resolve_device(d) for d in (devices if devices is not None else [device])}
            if len(pool) != 1:
                raise NotImplementedError(
                    f"DecodePipeline runs on one device in one process, got "
                    f"{sorted(map(str, pool))}; over several devices it runs a process "
                    f"a device (devices=launch.mesh.RankPool)")
            self.device = pool.pop()
        else:
            self.device = self.pool.device
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

        self.periods_per_stage = pps

        # stage list: embed, one per pps-period group, head — then the
        # fusion plan partitions that base chain into executed stages.
        # Each block-owning stage owns periods [a, b) == layers
        # [a*L, b*L): a slice of the model's layer list.
        self.stage_names: list[str] = []
        self.stage_params: list[dict] = []     # stage -> its tensors
        self.stage_devices: list[list] = []    # stage -> replica -> device
        self.stage_streams: list[list] = []    # stage -> replica -> stream
        self.stage_ranks: list[list] = []      # over ranks: stage -> replica -> rank
        self.period_span: list = []            # stage -> (lo, hi) or None
        pl = place(stg, sel, self.pool if self.pool is not None else [self.device])
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
        stage_owners = []
        for desc in self.stage_descs:
            owners = ["embed"] if desc.has_embed else []
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
            if desc.has_head:
                owners.append("head")
            stage_owners.append(owners)
            # over ranks, each replica on its slice's first rank: a tp > 1
            # slice folds there, as the JAX package folds it onto its
            # first device
            if self.pool is not None:
                self.stage_ranks.append(
                    [sl.devices[0] for o in owners for sl in pl.replicas_of(o)] or [self.pool[0]])
        mine = None
        if self.pool is not None:
            mine = [any(r == self.pool.rank for r in ranks) for ranks in self.stage_ranks]
        keep = None if mine is None else self._weight_keys(mine).__contains__
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_params(cfg, device=self.device, generator=gen, keep=keep)
        elif not isinstance(params, torch.nn.Module):
            params = params(keep)
        self.params = params
        if params.embed.device != self.device and mine is None:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"pipeline on {self.device}")
        self._bind_params()
        for s_, (desc, owners) in enumerate(zip(self.stage_descs, stage_owners)):
            # replica pool: every member owner's placement slices (nr x
            # n_owners replicas, each doing the whole stage's work, same
            # planned capacity); on one device they share the tensors
            n_rep = max(1, sum(len(pl.replicas_of(o)) for o in owners))
            own = [mine is None or self.stage_ranks[s_][k] == self.pool.rank
                   for k in range(n_rep)]
            self.stage_names.append(desc.name)
            self.stage_devices.append([self.device] * n_rep)
            self.stage_streams.append(
                [torch.cuda.Stream(self.device) if self.device.type == "cuda" and own[k]
                 else None for k in range(n_rep)])
            self.period_span.append(desc.span)
        self.lanes = Lanes([len(d) for d in self.stage_devices], self._n_workers())
        if self.pool is not None:
            from .remote import Controller
            self.ranks = sorted({r for ranks in self.stage_ranks for r in ranks})
            self._ctl = Controller(self.pool, self) if self.pool.is_controller else None

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

    def _weight_keys(self, mine: list) -> set:
        """Over ranks: the names of `lm.init_params`'s ``keep`` (``"embed"``,
        ``"final_norm"``, ``"head"``, ``"layers.<i>"``) that the stages with a
        replica on a rank read (``mine``: a flag a stage), the embedding too
        where a tied head reads it.  Weights drawn from the seed are drawn
        whole, and the rest let go at once."""
        L = len(self.cfg.block_pattern)
        keep = set()
        for desc, own in zip(self.stage_descs, mine):
            if not own:
                continue
            if desc.has_embed or (desc.has_head and self.cfg.tie_embeddings):
                keep.add("embed")
            if desc.has_head:
                keep.add("final_norm")
                if not self.cfg.tie_embeddings:
                    keep.add("head")
            if desc.span is not None:
                keep.update(f"layers.{i}" for i in range(desc.span[0] * L, desc.span[1] * L))
        return keep

    def _bind_params(self) -> None:
        """Each stage's tensors, taken from ``params`` (again after a
        successor's weights came: `_on_install`)."""
        cfg, params = self.cfg, self.params
        L = len(cfg.block_pattern)
        head_w = lm._head(cfg, params)
        self.stage_params = []
        for desc in self.stage_descs:
            stage_p = {}
            if desc.has_embed:
                stage_p["embed"] = params.embed
            if desc.span is not None:
                lo, hi = desc.span[0] * L, desc.span[1] * L
                stage_p.update(layers=params.layers[lo:hi], span=(lo, hi))
            if desc.has_head:
                stage_p.update(norm=params.final_norm, w=head_w)
            self.stage_params.append(stage_p)

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
        at the head — once, on scratch inputs, where the ops may run:
        overlapped, on the lane thread and stream of *every* replica of
        each stage (failover and migration may route ``g`` to any of
        them, and a cache replay runs there too); else on this thread and
        its stream.  Runs before the engine's clock starts; no served
        request pays a first launch."""
        shape = (g.batch, g.bucket, g.cap)
        if self.pool is not None:
            if (shape, overlap) not in self._warmed:
                self._ctl.run_on(self.ranks, {"fn": "warm", "shape": shape, "overlap": overlap},
                                 f"warm-up at {shape}")
                self._warmed.add((shape, overlap))
            return
        jobs = []
        for s in range(len(self.stage_descs)):
            for rep in range(len(self.stage_devices[s]) if overlap else 1):
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
        """Stop the worker threads, and free the cuBLAS workspaces that their
        (thread, stream) pairs made: the pipeline serves overlapped no more.
        PyTorch keys a workspace by (cuBLAS handle, stream) and frees them
        only all at once, so the workspaces of other threads go too and are
        made again at their next product: call it while no other thread
        runs one.  Over ranks, the controller's ``close`` stops every rank's
        worker, each of which does so on its rank (``rank_bytes_sent``: what
        each rank sent to the others, over the pipeline's life)."""
        if self.pool is None:
            self.close_lanes()
        elif self._ctl is not None:
            self.rank_bytes_sent = self._ctl.close()

    def close_lanes(self) -> None:
        self.lanes.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch._C._cuda_clearCublasWorkspaces()

    def _successor(self, stg: STG, plan, ranks, kw: dict) -> "DecodePipeline":
        """Over ranks: the `DecodePipeline` of ``plan`` on a pool of
        ``ranks`` (of this pool, this controller first), which this
        controller's plan, sent to every rank, builds there
        (`_build_successor`).  Each weight a successor rank lacks is moved
        to it from the lowest rank that holds it, in this controller's
        order, bitwise; the ranks that leave let theirs go, so this
        pipeline then only hands its parked state over and closes
        (``weights_moved`` and ``weights_held`` record both)."""
        import torch.distributed as dist
        ranks = [int(r) for r in ranks]
        if (not ranks or ranks[0] != self.pool.controller or len(set(ranks)) != len(ranks)
                or not set(ranks) <= set(self.pool.ranks)):
            raise ValueError(f"a successor's ranks {ranks} are ranks of the pool "
                             f"{list(self.pool.ranks)}, its controller first")
        if sorted(self.pool.ranks) != list(range(dist.get_world_size())):
            raise NotImplementedError("every rank of the world makes a successor's groups: "
                                      "the pipeline's pool must span the world")
        ctl = self._ctl
        succ = ctl.call(_build_successor, dict(cfg=self.cfg, stg=stg, plan=plan, ranks=ranks,
                                               kw=kw))[ctl.rank]
        held = {r: set(names) for r, names in ctl.call(_held_weights).items()}
        succ.weights_moved = []
        for r in ranks:
            lacks = succ._weight_keys([r in rs for rs in succ.stage_ranks]) - held[r]
            for name in sorted(lacks):
                src = min(a for a, names in held.items() if name in names)
                metas = [meta_of(t) for t in _weight_tensors(self.params, name)]
                ctl.post(src, {"do": "run", "fn": "put_weights", "lane": None, "name": name,
                               "ack": False, "what": f"weight {name} for rank {r}"})
                ctl.move(Ref(src, ("w", name), metas), r, ("w", name), ack=False)
                ctl.post(r, {"do": "run", "fn": "install", "lane": None, "name": name,
                             "ack": False, "what": f"install weight {name}"})
                succ.weights_moved.append({"weight": name, "from_rank": src, "to_rank": r,
                                           "bytes": sum(int(np.prod(sh)) * getattr(
                                               torch, dt).itemsize for sh, dt in metas)})
        succ.weights_held = ctl.call(_settle_weights,
                                     [r for r in self.pool.ranks if r not in ranks])
        return succ

    # -- over ranks: the workers' side ----------------------------------------
    def _on_warm(self, w, cmd, inputs):
        """Every program of the group shape ``shape`` run once on scratch
        inputs by each (stage, replica) on this rank, where its ops run."""
        overlap, shape = cmd["overlap"], cmd["shape"]
        jobs = []
        for s, ranks in enumerate(self.stage_ranks):
            for rep, r in enumerate(ranks):
                if r != w.rank:
                    continue
                if overlap:
                    jobs.append(self.lanes.submit(s, rep, self._warm_stage, s,
                                                  self.stage_streams[s][rep], *shape))
                else:
                    self._warm_stage(s, None, *shape)
        for job in jobs:
            job.result()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {}

    def _on_stage(self, w, cmd, inputs):
        """A prefill or decode op of stage ``s`` on this rank (`_run_stage`):
        the group's cache slice stays here; a hidden state stays here for
        the next stage; the head reports the sampled token ids."""
        s, rep, gid, kind = cmd["s"], cmd["rep"], cmd["gid"], cmd["kind"]
        desc = self.stage_descs[s]
        pre, dec = self._programs[desc.key]
        stream = self.stage_streams[s][rep] if cmd["overlap"] else None
        sample = None
        if desc.has_head:
            temperature = cmd["temperature"]
            if (self.temperature if temperature is None else temperature) > 0.0:
                self._seed_group(gid)

            def sample(logits):
                return self._sample(logits, gid, temperature)
        on = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with on:
            x = w.get(inputs["x"], self.device)
        params = self.stage_params[s]
        if kind == "P":
            ar = _run_stage(pre, params, x, self.device, stream, sample, None, cmd["cap"])
        else:
            ar = _run_stage(dec, params, x, self.device, stream, sample,
                            w.store.get(("cache", s, gid)))
        (y, cache, toks), = ar.payload
        out = {"stream": stream_handle(stream)}
        if cache is not None:
            w.store[("cache", s, gid)] = cache
            out["cache"] = tree_meta(cache)
        if desc.has_head:
            return AsyncResult(dict(out, tokens=toks[1]), ar.watch)
        w.store[("h", s, cmd["seq"], rep)] = y
        return AsyncResult(dict(out, meta=meta_of(y)), ar.watch)

    def _on_replay(self, w, cmd, inputs):
        """One step of a cache replay (`_replay_ranks`) on this rank, as
        replica ``rep`` of stage ``s`` runs it: the prefill (step 0) builds
        a fresh slice under the replay's own key, a decode step updates it;
        the hidden state stays here for the next stage's step."""
        s, rep, token = cmd["s"], cmd["rep"], cmd["token"]
        pre, dec = self._programs[self.stage_descs[s].key]
        stream = self.stage_streams[s][rep] if cmd["overlap"] else None
        on = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with on:
            x = w.get(inputs["x"], self.device)
        key = ("replay", token, s)
        if cmd["j"] == 0:
            ar = _run_stage(pre, self.stage_params[s], x, self.device, stream, None, None,
                            cmd["cap"])
        else:
            ar = _run_stage(dec, self.stage_params[s], x, self.device, stream, None,
                            w.store.get(key))
        (y, cache, _), = ar.payload
        out = {}
        if cache is not None:
            w.store[key] = cache
            out["cache"] = tree_meta(cache)
        if not cmd["last"]:
            w.store[("rh", token, s)] = y
            out["meta"] = meta_of(y)
        return AsyncResult(out, ar.watch)

    def _on_adopt(self, w, cmd, inputs):
        """A slice taken under ``key`` (from ``src`` here: a rename), and,
        given ``rep``, handed to replica ``rep`` of stage ``s``'s stream:
        the allocator keeps its memory until that stream's work on it
        ends."""
        cache = w.take(cmd["src"])
        rep = cmd.get("rep")
        if rep is not None:
            stream = self._owner_stream(cmd["s"], rep, cmd["overlap"])
            if stream is not None:
                for t in tree_flatten(cache)[0]:
                    t.record_stream(stream)
        w.put(cmd["key"], cache)
        return {}

    def _on_put_weights(self, w, cmd, inputs):
        """The tensors of weight ``name`` (`_weight_tensors`) into the store,
        for a move to a successor's rank that lacks them."""
        w.store[("w", cmd["name"])] = [t.detach() for t in _weight_tensors(self.params,
                                                                             cmd["name"])]
        return {}

    def _on_install(self, w, cmd, inputs):
        """Weight ``name``, moved here, installed in ``params`` in place of
        its meta tensors."""
        name = cmd["name"]
        for (mod, attr, old), t in zip(_weight_slots(self.params, name),
                                       w.take(("w", name))):
            mod._parameters[attr] = torch.nn.Parameter(t, requires_grad=old.requires_grad)
        return {}

    # -- cache ownership ------------------------------------------------------
    def _owner_stream(self, s: int, rep: int, overlap: bool):
        """The stream replica ``rep`` of stage ``s`` runs its ops on: its
        own when overlapped, else the calling thread's current one (None
        off the card)."""
        if self.device.type != "cuda":
            return None
        return self.stage_streams[s][rep] if overlap \
            else torch.cuda.current_stream(self.device)

    @staticmethod
    def _hand_off(cache: dict, src, dst) -> None:
        """Give ``cache`` (a stage's slice for one group) a new owner
        stream: ``dst`` waits on an event recorded on ``src`` after all
        the work queued there, and every cache tensor is marked for
        ``dst`` so the allocator cannot reuse its memory before ``dst``'s
        work on it ends.  On one card this is the whole transfer."""
        if dst is None or src == dst:
            return
        ev = torch.cuda.Event()
        ev.record(src)
        dst.wait_event(ev)
        cache["pos"].record_stream(dst)
        for layer in cache["layers"]:
            for t in layer.values():
                t.record_stream(dst)

    def graph_stage_map(self) -> dict[str, str]:
        """graph node -> executed stage name (block nodes collapse onto
        the period-group stage that owns them) — the ``stage_map``
        `measure.compare_lm` needs to read a serve run's completion
        streams against the decode-shape plan."""
        L = len(self.cfg.block_pattern)
        out = {}
        for desc in self.stage_descs:
            if desc.has_embed:
                out["embed"] = desc.name
            if desc.span is not None:
                for li in range(desc.span[0] * L, desc.span[1] * L):
                    out[f"block{li:02d}"] = desc.name
            if desc.has_head:
                out["head"] = desc.name
        return out

    def _replay_cache(self, g: _Group, s_target: int, k: int, reps: list,
                      overlap: bool) -> dict:
        """Rebuild stage ``s_target``'s cache slice for group ``g`` as it
        stood after ``k`` retired ops (prefill + k-1 decode steps), for
        replica ``reps[s_target]``.

        The replay re-runs the programs the live traffic runs (embed ->
        preceding block stages -> target stage) from the prompt and the
        fed-token history, each stage ``s`` as replica ``reps[s]``:
        overlapped, on that replica's lane thread and stream, where its
        programs were warmed, each step's stream waiting on the previous
        step's event; else on this thread and stream.  Every stage builds
        a *fresh* cache (``lm.init_cache`` in its prefill) — the
        surviving resident slices are never touched — and the same
        kernels on the same shapes give bitwise what the lost slice
        held."""
        caches: dict[int, dict] = {}
        after = None
        for j in range(k):
            x = torch.from_numpy(g.tokens if j == 0 else g.fed[j - 1][:, None])
            for s in range(s_target + 1):
                pre, dec = self._programs[self.stage_descs[s].key]
                stream = self.stage_streams[s][reps[s]] if overlap else None
                args = ((pre, self.stage_params[s], x, self.device, stream, None,
                         None, g.cap, after) if j == 0 else
                        (dec, self.stage_params[s], x, self.device, stream, None,
                         caches.get(s), None, after))
                ar = (self.lanes.submit(s, reps[s], _run_stage, *args).result()
                      if overlap else _run_stage(*args))
                (x, cache, _), = ar.payload
                if cache is not None:
                    caches[s] = cache
                after = ar.watch[0].event
        return caches[s_target]

    def _replay_ranks(self, g: _Group, s_target: int, k: int, reps: list,
                      overlap: bool):
        """`_replay_cache` over ranks: each step of each stage ``s`` is a
        command (`_on_replay`) to the rank of replica ``reps[s]``, on its
        lane and stream, the hidden state sent rank to rank as live traffic
        sends it; a step is posted once the one before it reported, so it
        reads a complete input.  Every stage builds a fresh slice under the
        replay's own key; the target's becomes the group's slice on its
        rank, the others go.  Returns its `remote.TreeMeta`."""
        ctl = self._ctl
        token = next(_TOKENS)
        ranks = [self.stage_ranks[s][reps[s]] for s in range(s_target + 1)]
        meta, x = None, None
        for j in range(k):
            for s in range(s_target + 1):
                if s == 0:
                    spec = ("value", np.asarray(g.tokens if j == 0 else g.fed[j - 1][:, None]))
                else:
                    spec = ctl.inputs_for(x, [ranks[s]])[ranks[s]]
                rep = ctl.run_on([ranks[s]], {
                    "fn": "replay", "lane": (s, reps[s]) if overlap else None, "s": s,
                    "rep": reps[s], "j": j, "token": token, "cap": g.cap,
                    "last": s == s_target, "overlap": overlap, "inputs": {"x": spec}},
                    f"replay step {j} of {self.stage_names[s]} for group {g.gid}")[ranks[s]]
                meta = rep.get("cache", meta) if s == s_target else meta
                x = None if s == s_target else Ref(ranks[s], ("rh", token, s), rep["meta"])
        for s in range(s_target):
            ctl.drop(ranks[s], [("replay", token, s)], "a replay's slice")
        self._adopt(ranks[-1], ("replay", token, s_target), ("cache", s_target, g.gid),
                    s_target, reps[s_target], overlap)
        return meta

    def _adopt(self, rank: int, src, key, s: int, rep, overlap: bool) -> None:
        """Post `_on_adopt` to ``rank``: the slice ``src`` there becomes
        ``key``, handed to replica ``rep`` of stage ``s`` (None: no stream)."""
        self._ctl.post(rank, {"do": "run", "fn": "adopt", "lane": None, "src": src, "key": key,
                              "s": s, "rep": rep, "overlap": overlap, "ack": False,
                              "what": f"adopt {src} as {key}"})

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
        itself when ``warmup``), and verify the plan as a ``serve`` with
        the default channel sizes will (the report is cached), so neither
        lands inside a timed serve."""
        overlap = self.overlap if overlap is None else overlap
        groups = self._groups(prompts, max_new, group_size)[0]
        self._preflight(n_groups=len(groups), capacity_blocks=2, feedback_capacity=None,
                        group_shapes=[(g.batch, g.bucket, g.cap) for g in groups])
        if self.pool is not None:
            self._check_controller()
            self._bracket(lambda: [self._warm_group(g, overlap) for g in groups])
            return
        for g in groups:
            self._warm_group(g, overlap)

    def serve(self, prompts: list[list[int]], max_new, *, eos_id: int = 1,
              group_size: int = 8, capacity_blocks: int = 2,
              overlap: bool | None = None,
              temperature: float | None = None,
              tracer=None, injector=None, health=None,
              pause_after_tokens: int | None = None,
              preflight: bool = True,
              feedback_capacity: int | None = None) -> ServeRunResult:
        """Serve ``prompts`` in ``group_size`` slot groups streamed
        concurrently through the pipeline.  Grouping, bucketing, and
        EOS/budget bookkeeping mirror `LMServer.serve_round` on each
        group, so a single-device server with ``max_batch=group_size``
        produces token-identical completions.  ``temperature`` overrides
        the pipeline-level default for this run.  ``tracer``: optional
        `trace.Tracer` — the serve emits op spans, credit/starve waits,
        and fifo occupancy (incl. the head->embed feedback stream);
        warm-up stays untraced.  ``injector``: optional
        `failures.ReplicaFaultPlan` chaos schedule (see
        `_ServeStageProgram.fail_replica` for the failover semantics).
        ``health``: optional `health.HealthController` ticked from the
        engine's retire path.  Over ranks both hold as on one rank: an
        injected stall sleeps on the stalled replica's lane on its rank.
        ``pause_after_tokens``: admission pause —
        groups reaching that many decode steps park instead of
        scheduling further work; the returned result has ``paused=True``
        and a ``resume_state`` that `resume()` (on this or a rescaled
        pipeline) continues without dropping any in-flight request.
        ``preflight``: run the static plan verifier
        (`core.verify.verify_decode_plan`) before launching — channel and
        cycle credits, fusion legality, placement consistency, the cache
        contract — raising `PlanVerificationError` on any ERROR (False =
        escape hatch for deliberately unsafe experiments; the deadlock
        report will note preflight was skipped).  ``feedback_capacity``:
        override the head->embed stream's capacity (default ``max(2,
        n_groups)``) — mainly for demonstrating that an undersized
        feedback path is rejected statically."""
        if not prompts:
            raise ValueError("serve() needs at least one prompt")
        overlap = self.overlap if overlap is None else overlap
        if self.pool is not None:
            self._check_controller()
        groups, group_of = self._groups(prompts, max_new, group_size)
        report = None
        if preflight:
            report = self._preflight(
                n_groups=len(groups), capacity_blocks=capacity_blocks,
                feedback_capacity=feedback_capacity,
                group_shapes=[(g.batch, g.bucket, g.cap) for g in groups])

        def body():
            return self._serve_body(groups, group_of, eos_id=eos_id,
                                    capacity_blocks=capacity_blocks, overlap=overlap,
                                    temperature=temperature, tracer=tracer, injector=injector,
                                    health=health, pause_after_tokens=pause_after_tokens,
                                    feedback_capacity=feedback_capacity, report=report)
        return body() if self.pool is None else self._over_ranks(body)

    def _over_ranks(self, body) -> ServeRunResult:
        """``body`` (a serve or a resume) inside the run bracket of every
        rank, with each rank's costs in the result's ``ranks``."""
        res, costs = self._bracket(body)
        res.ranks = {r: dict(c, **res.ranks.get(r, {"host_s": 0.0, "stall_s": 0.0}))
                     for r, c in costs.items()}
        return res

    def _serve_body(self, groups, group_of, *, eos_id, capacity_blocks, overlap, temperature,
                    tracer, feedback_capacity, report, injector=None, health=None,
                    pause_after_tokens=None) -> ServeRunResult:
        """`serve` past its checks: warm-up, the engine, the result."""
        if self.warmup:
            for g in groups:
                self._warm_group(g, overlap)
        self._seed_groups(groups)
        if self.pool is not None:
            self._ctl.run_on(self.ranks, {"fn": "window"}, "window")

        run = _ServeRun(self, groups, eos_id=eos_id,
                        capacity_blocks=capacity_blocks, overlap=overlap,
                        temperature=temperature,
                        pause_at=pause_after_tokens,
                        feedback_capacity=feedback_capacity)
        for g in groups:
            run.enqueue("P", g.gid, 0)
        res, engine = self._launch(run, group_of, tracer=tracer, injector=injector,
                                   health=health, static_report=report)
        for g in groups:                       # run-relative group timings
            g.t_start = max(0.0, g.t_start - engine.t0)
        if self.pool is not None:
            res.ranks = run.rank_times()
        return res

    def _seed_groups(self, groups) -> None:
        for g in groups:
            self._seed_group(g.gid)

    def _seed_group(self, gid: int) -> None:
        if gid not in self._gens:
            self._gens[gid] = torch.Generator(device=self.device).manual_seed(
                (self.seed ^ 0xC0FFEE) + gid)

    def _preflight(self, *, n_groups: int, capacity_blocks: int,
                   feedback_capacity: int | None, group_shapes):
        """Static verification of this serve's plan tuple; raises
        `core.verify.PlanVerificationError` on any ERROR and caches the
        accepted report (the cache contract doesn't change per serve) on
        ``self.last_preflight``."""
        from ...core import verify as _verify
        fb_cap = feedback_capacity if feedback_capacity is not None \
            else max(2, n_groups)       # the capacity the serve will make
        key = (n_groups, capacity_blocks, fb_cap, frozenset(group_shapes))
        cached = getattr(self, "_preflight_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1].raise_if_errors("DecodePipeline.serve")
        report = _verify.verify_decode_plan(
            self, n_groups=n_groups, capacity_blocks=capacity_blocks,
            feedback_capacity=feedback_capacity, group_shapes=group_shapes)
        self._preflight_cache = (key, report)
        self.last_preflight = report
        return report.raise_if_errors("DecodePipeline.serve")

    def _launch(self, run: _ServeRun, group_of: list, *, tracer, injector=None,
                health=None, static_report=None) -> tuple[ServeRunResult, Engine]:
        """Wire channels, drive the engine to quiescence, fold the engine
        result into a `ServeRunResult` (exporting a `ResumeState` when the
        run admission-paused) — shared by `serve` and `resume`."""
        names = self.stage_names
        fifo_map = {f"act{s}": run.acts[s] for s in range(len(run.acts))}
        fifo_map["feedback"] = run.feedback
        if tracer is not None:
            for s in range(len(run.acts)):
                tracer.watch_fifo(run.acts[s], f"act{s}",
                                  src=names[s], dst=names[s + 1])
            tracer.watch_fifo(run.feedback, "feedback",
                              src=names[-1], dst=names[0])
        engine = Engine(run.programs, overlap=run.overlap,
                        replica_queue=self.replica_queue, tracer=tracer, fifos=fifo_map,
                        lanes=self.lanes if self.pool is None else RemoteLanes(),
                        injector=injector,
                        on_tick=None if health is None else health.tick,
                        tick_every=64 if health is None else health.check_every,
                        static_report=static_report)
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
            stage_wait_s=er.stage_wait_s, failovers=er.failovers,
            placement=self.placement, streams_used=len(run.streams))
        idx_in_group: dict[int, int] = {}
        for gid in group_of:
            i = idx_in_group.get(gid, 0)
            idx_in_group[gid] = i + 1
            res.tokens.append(run.groups[gid].out_tokens[i])
        for s in range(len(run.acts)):
            res.fifo_stats[("act", s)] = run.acts[s].stats
        res.fifo_stats["feedback"] = run.feedback.stats
        res.migrations = run.migrations
        res.adopted = {"moved": run.moved_slices, "replayed": run.replayed_slices}
        if run.parked and self.pool is not None:
            res.paused = True
            res.resume_state = self._park(run, group_of)
        elif run.parked:
            res.paused = True
            res.resume_state = ResumeState(
                groups=run.groups, group_of=list(group_of), eos_id=run.eos_id,
                stage_caches={
                    names[s]: {"span": self.period_span[s],
                               "caches": dict(prog.caches),
                               "streams": {gid: prog.stream_of(prog.rep_of(gid))
                                           for gid in prog.caches}}
                    for s, prog in enumerate(run.programs)
                    if self.period_span[s] is not None})
        return res, engine

    def _park(self, run: _ServeRun, group_of: list) -> ResumeState:
        """Over ranks: each live group's slices renamed into their rank's
        `remote.PARKED`, where a run's ``begin`` leaves them, under a key of
        this pause; the `ResumeState` names each (rank, key, meta)."""
        token = next(_TOKENS)
        stage_caches = {}
        for s, prog in enumerate(run.programs):
            span = self.period_span[s]
            if span is None:
                continue
            slices = {}
            for gid, meta in sorted(prog.caches.items()):
                rank, key = prog.rank_of(prog.rep_of(gid)), ("parked", token, s, gid)
                self._adopt(rank, ("cache", s, gid), key, s, None, run.overlap)
                slices[gid] = (rank, key, meta)
            stage_caches[self.stage_names[s]] = {"span": span, "slices": slices}
        return ResumeState(groups=run.groups, group_of=list(group_of), eos_id=run.eos_id,
                           stage_caches=stage_caches, owner=self)

    def resume(self, state: ResumeState, *, capacity_blocks: int = 2,
               overlap: bool | None = None,
               temperature: float | None = None, tracer=None,
               injector=None, health=None,
               pause_after_tokens: int | None = None,
               preflight: bool = True,
               feedback_capacity: int | None = None) -> ServeRunResult:
        """Continue an admission-paused serve on THIS pipeline — possibly
        a different plan or partitioning than the one that drained
        (`elastic.rescale_serving` builds that pipeline).  Live groups'
        cache slices are adopted: handed off to this pipeline's streams
        when its stage spans match the exporter's, rebuilt by
        deterministic replay from prompt + fed-token history when they
        don't.  Each group's parked token is fed back and decoding
        continues, so no in-flight request is dropped and the combined
        streams are bitwise what an uninterrupted serve yields.  Over
        ranks (`_adopt_parked`) a parked slice stays where it is when its
        new owner is on the same rank, moves rank to rank on the same
        span, and is replayed on the new owners' ranks where the spans
        differ; the state frees what it does not hand over.  Resume before
        closing the pipeline that paused."""
        if self.pool is not None:
            self._check_controller()
        overlap = self.overlap if overlap is None else overlap
        live = state.live_groups()
        if not live:
            raise ValueError("resume() on a state with no live groups")
        if (state.owner is None) != (self.pool is None):
            raise ValueError("a pause over ranks resumes over ranks, a pause in one process "
                             "in one process")
        report = None
        if preflight:
            # the channel is sized for every exported group (finished
            # ones hold no tokens), but only live groups circulate
            fb_cap = feedback_capacity if feedback_capacity is not None \
                else max(2, len(state.groups))
            report = self._preflight(
                n_groups=len(live), capacity_blocks=capacity_blocks,
                feedback_capacity=fb_cap,
                group_shapes=[(g.batch, g.bucket, g.cap) for g in live])

        def body():
            if self.warmup:
                for g in live:
                    self._warm_group(g, overlap)
            self._seed_groups(live)
            if self.pool is not None:
                self._ctl.run_on(self.ranks, {"fn": "window"}, "window")
            run = _ServeRun(self, state.groups, eos_id=state.eos_id,
                            capacity_blocks=capacity_blocks, overlap=overlap,
                            temperature=temperature,
                            pause_at=pause_after_tokens,
                            open_groups=len(live),
                            feedback_capacity=feedback_capacity)
            if self.pool is not None:
                self._adopt_parked(state, run, live)
            else:
                self._adopt_caches(state, run, live)
            for g in live:
                seq = run.enqueue("D", g.gid, g.bucket + g.steps)
                g.fed.append(g.cur.copy())
                run.feedback.push([(seq, (g.gid, torch.from_numpy(g.cur[:, None])))], 0.0)
            res, _engine = self._launch(run, state.group_of, tracer=tracer,
                                        injector=injector, health=health,
                                        static_report=report)
            if self.pool is not None:
                res.ranks = run.rank_times()
            return res
        return body() if self.pool is None else self._over_ranks(body)

    def _adopt_caches(self, state: ResumeState, run: _ServeRun, live: list) -> None:
        """One process: each live group's slices handed off where the spans
        match, replayed where they do not."""
        by_span = {tuple(v["span"]): v for v in state.stage_caches.values()}
        overlap = run.overlap
        for s, prog in enumerate(run.programs):
            span = self.period_span[s]
            donors = by_span.get(tuple(span)) if span is not None else None
            for g in live:
                k = 1 + g.steps        # every stage retired prefill +
                prog.done_count[g.gid] = k     # g.steps decode ops
                if span is None:
                    continue
                rep = prog.rep_of(g.gid)
                if donors is not None and g.gid in donors["caches"]:
                    cache = donors["caches"][g.gid]
                    self._hand_off(cache, donors["streams"][g.gid], prog.stream_of(rep))
                    prog.caches[g.gid] = cache
                else:
                    reps = [run.programs[j].rep_of(g.gid) for j in range(s + 1)]
                    prog.caches[g.gid] = self._replay_cache(g, s, k, reps, overlap)

    def _adopt_parked(self, state: ResumeState, run: _ServeRun, live: list) -> None:
        """Over ranks: each live group's parked slice adopted by its new
        owner where the spans match, first moved there rank to rank by the
        pipeline that parked it (its pool holds both ranks) when the owner
        is on another rank; replayed on the owners' ranks where they do
        not.  Then the state frees what it still names."""
        by_span = {tuple(v["span"]): v for v in state.stage_caches.values()}
        owner, adopt, replay, moves = state.owner, [], [], []
        for s, prog in enumerate(run.programs):
            span = self.period_span[s]
            donors = by_span.get(tuple(span)) if span is not None else None
            for g in live:
                k = 1 + g.steps
                prog.done_count[g.gid] = k
                if span is None:
                    continue
                rep = prog.rep_of(g.gid)
                rank = prog.rank_of(rep)
                if donors is None or g.gid not in donors["slices"]:
                    replay.append((prog, s, g, k))
                    continue
                src, key, meta = donors["slices"].pop(g.gid)
                if src != rank:
                    new = key + ("to", rank)
                    moves.append((owner._ctl.move(Ref(src, key, meta), rank, new), rank))
                    key = new
                adopt.append((rank, key, s, rep, g.gid, meta))
                run.moved_slices.append({"stage": self.stage_names[s], "gid": g.gid,
                                         "from_rank": src, "to_rank": rank,
                                         "bytes": meta.nbytes if src != rank else 0})
        for cid, rank in moves:
            owner._ctl.wait(cid, [rank], "a parked slice's move")
        for rank, key, s, rep, gid, meta in adopt:
            self._adopt(rank, key, ("cache", s, gid), s, rep, run.overlap)
            run.programs[s].caches[gid] = meta
        for prog, s, g, k in replay:
            reps = [run.programs[j].rep_of(g.gid) for j in range(s + 1)]
            prog.caches[g.gid] = self._replay_ranks(g, s, k, reps, run.overlap)
            run.replayed_slices.append({"stage": self.stage_names[s], "gid": g.gid,
                                        "rank": prog.rank_of(reps[s])})
        state.free()
