"""Microbatch pipeline for LM stage graphs: 1F1B training and streaming forwards.

Ported from ``repro/runtime/pipeline/jax_pipe.py`` (named for what it
runs, not for JAX, which this package never imports).  It executes the
planner's LM stage graph (`graphs/lm_graph.build_stg`: embed -> block00..
-> head) as a real microbatch pipeline on the engine (`engine.Engine`):

  * stages are `nn.Module`s built from `models/blocks.py`
    (`build_lm_stages`): ``embed`` holds ``emb``, ``blockNN`` holds
    ``l0..l{k-1}`` (each a ``mix`` and an ``mlp``), ``head`` holds
    ``norm`` and its own ``w_out`` (also where the config ties
    embeddings), each a copy of the JAX stage function;
  * microbatches go to stage replicas round-robin (``mb % nr``); the
    replicas of a stage share its module's tensors, so the weights live
    once however many replicas the plan asks for;
  * execution follows whatever `schedule.Schedule` the caller passes
    (defaults: `schedule.one_f_one_b` for training, `schedule.fill_drain`
    for serving); an interleaved schedule (`schedule.interleaved_1f1b(p,
    m, v)`) runs ``v`` chunks per physical program, op ``(kind, mb,
    chunk)`` running built stage ``chunk * p + s``, over the same
    activation and gradient FIFO chain;
  * ``fusion_plan`` (explicit or ``"auto"``) runs adjacent stages as one
    module whose gradients are keyed by member name.

Operations.  An F op cuts its input into a leaf (``x.detach()
.requires_grad_(i > 0)``), runs the stage under ``torch.enable_grad`` and
keeps ``(y, x)`` as its "vjp"; the B op computes
``torch.autograd.grad(y, [*params, x], y_bar, allow_unused=True)``, the
head's seeding ``y_bar`` from ``loss_fn(logits)`` on a detached leaf (the
sum of the logits when no loss is given), as ``jax.value_and_grad`` does.
A parameter the loss does not reach gets zeros, as ``jax.grad`` gives it.
Nothing calls ``.backward()``: replicas share parameters, and ``.grad``
would race between them.  Each stage's gradients fold **in microbatch
order, in place** (``acc.add_(p_bar)``) into one resident buffer a stage,
whichever replica retires first, so they are bitwise the sequential
oracle's (`LMPipeline.sequential`) under every schedule.  A serving run
(``train=False``) runs under ``torch.no_grad``.

Working copies.  For a run every matrix of the block and head stages is
held as one bfloat16 copy of its float32 master (the dtype every stage
computes in), so that no forward casts it again and autograd keeps no
bfloat16 weights a microbatch: ~154 MB a (layer, microbatch) at
qwen2.5-3b's width.  Each such matrix is cast once a forward, so its
copy's gradient has the bits that the cast's vjp hands the master; the
fold adds it into the float32 accumulator (`first_acc`,
`working_params`).  The embedding table, the norms, an MoE's router and
the experts of a top-k > 1 MoE (cast once a round) stay float32.

Threads and streams.  Overlapped (the default), each stage launches on a
CUDA stream of its own, which its replicas share as they share its
module, and the op bodies of each (stage, replica) run on one worker
thread of the pipeline's `engine.Lanes`, kept across runs.  (A stream a
replica, as `DecodePipeline` has, left the caching allocator 29 pools
for qwen2.5-3b's 38 replicas: cached blocks stranded on one stream
pushed the others into flushes of the whole cache, and a 1F1B run took
twice as long; `PERF.md` §6.)  An op body returns once its kernels are
queued, with a `DeviceWatch` recorded after them, and the engine polls
it.  An F and the B of the same microbatch run on the same stage's
stream, so autograd runs the backward there too (it runs each backward
op on its forward's stream); the watch is recorded after
``autograd.grad`` returns, when the lane's stream has been made to wait
for the backward's.  A tensor made on one stream and read on another (an
activation, a gradient, a stage's input) is marked for the reader's stream
(``record_stream``), so the caching allocator does not hand its block
out again while the read is queued; the fold runs on the scheduler
thread's stream after the engine has seen the B op's event, with each
``p_bar`` marked for that stream.  ``overlap=False`` runs every op on the
caller's thread and stream, one after another.

Warm-up.  Before the clock starts, one F and B of a zero microbatch run
on every (stage, replica)'s own lane thread and stage stream (and the fold on
the scheduler thread), through `aot.AotProgram`'s accounting, so
``compile_stats.late`` stays 0.

In one process every placement slice is its one device, and the stages'
replicas share its tensors.  Over several devices the pipeline runs a
process a device (``devices=`` a `launch.mesh.RankPool`, `remote`): each
replica of a stage runs on its placement slice's ranks, each holding the
stage's weights; a tp > 1 slice of distinct ranks runs its stage SPMD over
its sub-mesh (`launch.mesh.submesh_of`), the parameters DTensors placed by
`launch.sharding.stage_param_shardings` and the input replicated there, as
the JAX package places them; the pool's first rank schedules, every
rank runs its own ops, and the fold runs on replica 0's rank in
microbatch order, so gradients stay bitwise the one-process pipeline's
(tp slices aside: their sums run in another order).  The JAX package's
on-device prefetch and ``_act_barrier`` have no counterpart (an eager
boundary between fused members is already a materialisation point).

Every run is preflighted (`core.verify.verify_lm_plan`, ``preflight=``):
schedule consistency and the credit simulation over this run's FIFO
capacities, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ...configs.base import ModelConfig
from ...core.stg import STG, Selection
from ...kernels import ops
from ...models import blocks
from ...models.common import dtype_of, rmsnorm
from .aot import AotProgram, CompileStats, _where
from .channels import Fifo
from .engine import (AsyncResult, DeviceWatch, Engine, Lanes, Op, describe_position,
                     steady_inverse)
from .placement import Placement, place
from .remote import OverRanks, Ref, posted, stream_handle
from .schedule import SchedOp, Schedule, fill_drain, max_live_by_chunk, one_f_one_b


def selection_from_plan(plan) -> Selection:
    """PlanResult -> Selection over the lm_graph node names (delegates to
    the package-level `as_selection`)."""
    from . import as_selection
    return as_selection(plan)


# ===========================================================================
# stage construction (models/blocks)
# ===========================================================================
class EmbedStage(nn.Module):
    """``embed``: the float32 table's rows, cast to bfloat16 whatever
    ``compute_dtype`` says (`jax_pipe._embed_fwd`)."""

    def __init__(self, cfg: ModelConfig, make: blocks.Maker):
        super().__init__()
        self.emb = make.weight((cfg.padded_vocab, cfg.d_model))

    def forward(self, tokens, *, impl=None):
        return self.emb[tokens].to(torch.bfloat16)


class BlockLayer(nn.Module):
    """One layer of a block stage: ``mix`` (attention or Mamba2), ``mlp``
    (dense, or `blocks.MoE` for a ``"moe"`` layer)."""

    def __init__(self, cfg: ModelConfig, mixer: str, mlp: str, **kw):
        super().__init__()
        self.kind = mixer
        self.mix = (blocks.Attention if mixer == "attn" else blocks.Mamba)(cfg, **kw)
        self.mlp = (blocks.MoE if mlp == "moe" else blocks.MLP)(cfg, **kw)


class BlockStage(nn.Module):
    """``blockNN``: layers ``l0..l{k-1}`` at positions ``arange(S)``
    (`jax_pipe._block_fwd`)."""

    def __init__(self, cfg: ModelConfig, mixers, **kw):
        super().__init__()
        for li, (mixer, mlp) in enumerate(mixers):
            self.add_module(f"l{li}", BlockLayer(cfg, mixer, mlp, **kw))

    def forward(self, x, *, impl=None):
        positions = torch.arange(x.shape[1], device=x.device)
        for layer in self.children():
            if layer.kind == "attn":
                x = layer.mix(x, positions, impl=impl)
            else:
                x, _ = layer.mix(x, impl=impl)
            x = layer.mlp(x, impl=impl)
        return x


class HeadStage(nn.Module):
    """``head``: rmsnorm, then ``h @ w_out`` in the activations' dtype,
    then float32 logits (`jax_pipe._head_fwd`).  Its own ``w_out`` even
    where the config ties embeddings, as the JAX stages have it."""

    def __init__(self, cfg: ModelConfig, make: blocks.Maker):
        super().__init__()
        self.eps = cfg.norm_eps
        self.norm = make.fill(1.0, (cfg.d_model,))
        self.w_out = make.weight((cfg.d_model, cfg.padded_vocab))

    def forward(self, x, *, impl=None):
        h = rmsnorm(x, self.norm, self.eps, impl)
        return (h @ self.w_out.to(h.dtype)).float()


class FusedStage(nn.Module):
    """Adjacent stages run as one: the members in order, each on the
    previous one's output; its parameters are the members', under their
    names."""

    def __init__(self, members: dict):
        super().__init__()
        self.members = nn.ModuleDict(members)

    def forward(self, x, *, impl=None):
        for m in self.members.values():
            x = m(x, impl=impl)
        return x


def build_lm_stages(cfg: ModelConfig, *, layers_per_stage: int | None = None,
                    seed: int = 0, device="cuda", empty: bool = False, keep=None
                    ) -> tuple[list[str], dict]:
    """(stage names, {name: module}) for embed / block groups / head, in
    ``cfg.param_dtype`` (float32 masters, with gradients).

    ``layers_per_stage`` groups adjacent layers into one stage (1 == the
    lm_graph granularity).  Random weights come from a `torch.Generator`
    on ``device`` seeded from ``seed``; ``empty`` leaves them unset, for
    `bridge.stages_from_jax` to fill.  ``keep``: None, or the names of the
    stages to return; the others are drawn all the same, in turn, so the
    kept ones are the whole model's draws, and each is let go as soon as
    it is drawn (the memory held is the kept stages and one other)."""
    device = resolve_device(device)
    generator = None if empty else torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, generator=generator, param_dtype=dtype_of(cfg.param_dtype))
    make = blocks.Maker(cfg, **kw)
    pattern = cfg.block_pattern * (cfg.n_layers // len(cfg.block_pattern))
    lps = layers_per_stage or 1
    names, stages = [], {}

    def add(name, module):
        names.append(name)
        if keep is None or name in keep:
            stages[name] = module
    add("embed", EmbedStage(cfg, make))
    for s0 in range(0, len(pattern), lps):
        add(f"block{s0 // lps:02d}", BlockStage(cfg, tuple(pattern[s0:s0 + lps]), **kw))
    add("head", HeadStage(cfg, make))
    return names, stages


@dataclass
class LMStage:
    """One executed stage: its module (every replica runs it), its
    programs, and where each replica runs."""
    name: str
    module: nn.Module
    fwd: AotProgram               # (module, x) -> y
    bwd: AotProgram               # (params, y, x, y_bar) -> (p_bar, x_bar)
    acc: AotProgram               # (acc, p_bar): acc += p_bar in place
    devices: list                 # replica index -> device (the one device)
    streams: list                 # replica index -> CUDA stream (the stage's), None
    #                               off the card
    dtypes: list                  # the masters' dtypes, parameter order
    members: tuple = ()           # a fused stage's member names, in order
    ranks: list = field(default_factory=list)    # over ranks: replica index ->
    #                               its slice's ranks (empty in one process)
    meshes: list = field(default_factory=list)   # over ranks: replica index ->
    #                               its tp sub-mesh, or None

    @property
    def params(self) -> list:
        return list(self.module.parameters())

    def grad_tree(self, flat: list, names=None) -> dict:
        """A flat gradient list (parameter order) as the stage's tree:
        {parameter name: tensor}, a fused stage's keyed by member first.
        ``names``: the parameter names, where this process holds no module
        of the stage (a pipeline over ranks)."""
        names = names or [n for n, _ in self.module.named_parameters()]
        named = dict(zip(names, flat))
        if not self.members:
            return named
        tree = {m: {} for m in self.members}
        for n, g in named.items():
            _, member, rest = n.split(".", 2)          # "members.<name>.<param>"
            tree[member][rest] = g
        return tree


# ===========================================================================
# result type
# ===========================================================================
@dataclass
class LMPipelineResult:
    outputs: list                           # microbatch logits (serve runs;
                                            # train runs release them at B
                                            # and fill ``losses`` instead)
    losses: dict = field(default_factory=dict)    # mb -> loss value (train)
    stage_seconds: dict[str, float] = field(default_factory=dict)
    stage_firings: dict[str, int] = field(default_factory=dict)
    stage_done_s: dict[str, list[float]] = field(default_factory=dict)
    stage_dispatch_s: dict[str, float] = field(default_factory=dict)
    mb_done_s: list[float] = field(default_factory=list)
    wall_s: float = 0.0
    placement: Placement | None = None
    grads: dict | None = None               # stage -> tree (train runs)
    fifo_stats: dict = field(default_factory=dict)   # edge label -> FifoStats
    stage_wait_s: dict = field(default_factory=dict)
    # stage -> {reason: seconds blocked} (traced runs only): "credit" =
    # output fifo full (downstream slow), "starve" = input empty
    # (upstream slow), "reorder"/"dep" = ordering, not capacity
    max_inflight: int = 0                   # peak concurrently in-flight ops
    op_trace: list = field(default_factory=list)
    # (stage, kind, mb, replica, t_dispatch, t_done) per op, run-relative —
    # the raw material for overlap debugging and gantt-style bench plots
    streams_used: int = 0                   # distinct CUDA streams that ran ops
    ranks: dict = field(default_factory=dict)
    # over ranks: rank -> {"host_s": its op bodies' host seconds, "stall_s":
    # of those, the injected stalls it slept, "late", "bytes_sent": what it
    # sent to other ranks, "launches": kernel launches in the timed run, by
    # kernel}

    def stage_inverse_us(self, name: str) -> float:
        """Effective microseconds per forward firing of one stage: the
        steady-state gap of the stage's merged completion-event stream
        (`engine.steady_inverse`).  Replicas interleave under overlapped
        dispatch, so a replicated stage reads ii/nr — directly comparable
        to the analytic plan (and to the interpreter path's
        ``stage_inverse_throughput``).

        Runs too short to show a steady state (< 4 forward completions)
        fall back to mean in-flight latency per op — an
        order-of-magnitude degraded mode that mixes forward and backward
        ops *and* dispatch-queue wait (overlapping ops can sum past wall
        time).  ``compare_lm`` skips such stages rather than calibrating
        on the fallback."""
        try:
            return steady_inverse(self.stage_done_s.get(name, ())) * 1e6
        except ValueError:
            n = self.stage_firings.get(name, 0)
            return self.stage_seconds[name] / n * 1e6 if n else float("nan")

    def stage_host_us(self, name: str) -> float:
        """Host-side dispatch microseconds per firing (wall time the
        stage's op bodies spent issuing transfers and dispatching
        programs) — the overhead component `measure.compare_lm` surfaces
        as its own column instead of folding into stage II."""
        n = self.stage_firings.get(name, 0)
        return (self.stage_dispatch_s.get(name, 0.0) / n * 1e6
                if n else float("nan"))

    def tokens_per_s(self, toks_per_mb: int) -> float:
        """Steady-state tokens/s from inter-microbatch completion gaps.
        Short runs (< 3 completed microbatches) still exclude the pipeline
        fill ramp by anchoring at the first completion instead of dividing
        by the full wall clock."""
        if len(self.mb_done_s) >= 3:
            k = max(1, len(self.mb_done_s) // 4)
            window = self.mb_done_s[k:]
            if len(window) >= 2 and window[-1] > window[0]:
                return toks_per_mb * (len(window) - 1) / (window[-1] - window[0])
        if len(self.mb_done_s) >= 2 and self.mb_done_s[-1] > self.mb_done_s[0]:
            span = self.mb_done_s[-1] - self.mb_done_s[0]
            return toks_per_mb * (len(self.mb_done_s) - 1) / span
        return toks_per_mb * len(self.mb_done_s) / max(self.wall_s, 1e-9)


# ===========================================================================
# op bodies: launch on the stage's stream and return without
# waiting for the device (`engine.AsyncResult` with one `DeviceWatch`)
# ===========================================================================
def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _stage_forward(module, x, impl):
    return module(x, impl=impl)


def _stage_backward(params: list, y, x, y_bar):
    """(p_bar, x_bar): the gradients of ``y`` against ``y_bar`` for every
    parameter (zeros where the loss does not reach one) and for ``x``
    when it is a leaf that requires grad (None for the token input)."""
    wrt = params + [x] if x.requires_grad else params
    gs = torch.autograd.grad(y, wrt, y_bar, allow_unused=True)
    p_bar = [g if g is not None else torch.zeros_like(p) for g, p in zip(gs, params)]
    return p_bar, (gs[-1] if x.requires_grad else None)


def _fold(acc: list, p_bar: list) -> list:
    for a, b in zip(acc, p_bar):
        a.add_(b)
    return acc


def first_acc(p_bar: list, dtypes: list) -> list:
    """A stage's accumulator from its first microbatch's gradients: each in
    its master's dtype (a working copy's bfloat16 gradient cast up, as the
    cast's vjp does), the others as they are."""
    return [b if b.dtype == d else b.to(d) for b, d in zip(p_bar, dtypes)]


def working_params(module: nn.Module) -> list:
    """(submodule, name, master) of every parameter that a pipeline run
    holds as a bfloat16 working copy: the matrices (2 or more dims) of the
    block and head stages that are not bfloat16 already.  The embedding
    table stays float32: its gradient sums repeated rows, which a
    bfloat16 table would round; so does an MoE's router, which routes in
    float32, and a top-k > 1 MoE's experts: a forward casts them once a
    round, and their masters' gradient sums the rounds' in float32, which
    one copy's bfloat16 gradient would round."""
    if isinstance(module, EmbedStage):
        return []
    if isinstance(module, FusedStage):
        return [w for m in module.members.values() for w in working_params(m)]
    kept = {id(m.router) for m in module.modules() if isinstance(m, blocks.MoE)}
    kept |= {id(p) for m in module.modules() if isinstance(m, blocks.MoE)
             and m.cfg.moe.top_k > 1 for p in m.experts.parameters()}
    return [(sub, name, p) for sub in module.modules() for name, p in sub._parameters.items()
            if p is not None and p.dim() >= 2 and p.dtype != torch.bfloat16
            and id(p) not in kept]


def _seed(logits, loss_fn):
    """(loss or None, y_bar) of the head's logits: the loss's gradient on a
    detached leaf, or ones (the gradient of their sum)."""
    if loss_fn is None:
        return None, torch.ones_like(logits)
    leaf = logits.detach().requires_grad_(True)
    lval = loss_fn(leaf)
    (y_bar,) = torch.autograd.grad(lval, leaf)
    return lval.detach(), y_bar


def _fwd_op(st: LMStage, rep: int, x, train: bool, leaf: bool, device):
    stream = st.streams[rep]
    with _on(stream), torch.set_grad_enabled(train):
        if stream is not None:
            x.record_stream(stream)
        xin = x.detach().requires_grad_(train and leaf)
        y = st.fwd(st.module, xin)
        watch = DeviceWatch(device)
    return AsyncResult((y, (y, xin) if train else None), watch=[watch])


def _bwd_op(st: LMStage, rep: int, vjp, y_bar, logits, loss_fn, device):
    stream = st.streams[rep]
    with _on(stream), torch.enable_grad():
        y, xin = vjp
        lval = None
        if logits is not None:            # last stage: seed from the loss
            lval, y_bar = _seed(logits, loss_fn)
        elif stream is not None:
            y_bar.record_stream(stream)
        p_bar, x_bar = st.bwd(st.params, y, xin, y_bar)
        watch = DeviceWatch(device)
    return AsyncResult((p_bar, x_bar, lval), watch=[watch])


# ===========================================================================
# stage program: one pipeline stage's schedule on the shared engine
# ===========================================================================
class _LMStageProgram:
    """Ready/dispatch/retire hooks for one *physical* stage's scheduled
    F/B ops — an `engine.Program`.

    A physical stage executes one or more virtual-stage *chunks*: op
    ``(kind, mb, chunk)`` runs built model stage ``chunks[chunk]``
    (plain schedules have exactly one chunk, the identity case).  Both F
    and B ops reach each model-stage edge in microbatch order, so each
    inter-stage fifo's head is always the next scheduled microbatch —
    consumers pop the head directly; out-of-order replica completions
    are re-sorted by the engine's per-edge reorder buffer.
    """

    def __init__(self, s: int, pipe: "LMPipeline", ops_: list, *,
                 chunks: list[int], acts: list, grds: list | None,
                 res: LMPipelineResult, microbatches: list, train: bool,
                 loss_fn, grads: dict | None, raw_losses: dict, overlap: bool,
                 streams: set):
        self.s = s
        self.M = pipe.n_stages              # built model stages
        self.pipe = pipe
        self.chunks = chunks                # chunk c -> built stage index
        self.stages = [pipe.stages[i] for i in chunks]
        self.name = (self.stages[0].name if len(chunks) == 1 else
                     "+".join(st.name for st in self.stages))
        self.n_replicas = max(len(st.devices) for st in self.stages)
        self.ops = ops_                     # list[SchedOp]
        self.pos = 0
        self.stall_mark = -1
        self.wait_reason = None   # (reason, fifo) of the last deferral
        self.acts = acts
        self.grds = grds
        self.res = res
        self.microbatches = microbatches
        self.train = train
        self.loss_fn = loss_fn
        self.grads = grads
        self.raw_losses = raw_losses
        self.overlap = overlap
        self.streams = streams
        self.vjps: dict[tuple[int, int], object] = {}   # (built, mb)
        # in-flight-activation ceilings per chunk, from the schedule
        # itself (chunk-aware max_live) — the runtime assert that catches
        # a driver mis-ordering ops against the schedule's memory promise
        self.live_bound = max_live_by_chunk(ops_)
        self._live = {c: 0 for c in self.live_bound}
        # deterministic grad accumulation: p_bars fold in microbatch order
        # per built stage regardless of which replica retires first
        self.acc_next = {i: 0 for i in chunks}
        self.acc_buf = {i: {} for i in chunks}

    def pending(self) -> int:
        return len(self.ops) - self.pos

    def peek(self) -> Op | None:
        if self.pos >= len(self.ops):
            return None
        k = self.ops[self.pos]
        st = self.stages[k.chunk]
        return Op(stage=self.s, kind=k.kind, seq=k.mb, chunk=k.chunk,
                  rep=k.mb % len(st.devices), is_firing=(k.kind == "F"))

    def ready(self, op: Op, count_stall: bool = False) -> float | None:
        """None while blocked on tokens/credits; counts a producer stall
        the first time a given op is deferred purely by output-buffer
        backpressure.  Each None leaves a ``wait_reason`` breadcrumb —
        (reason, blocking fifo) — the tracing driver turns into
        stall/starve attribution."""
        i, M, mb = self.chunks[op.chunk], self.M, op.seq
        if op.kind == "F":
            if i > 0 and not self.acts[i - 1].can_pop(1):
                self.wait_reason = ("starve", self.acts[i - 1])
                return None
            if i < M - 1 and not self.acts[i].can_push(1):
                if self.stall_mark != self.pos:
                    self.stall_mark = self.pos
                    self.acts[i].note_stall()
                self.wait_reason = ("credit", self.acts[i])
                return None               # backpressure: skip this turn
        else:
            if (i, mb) not in self.vjps:
                self.wait_reason = ("dep", None)
                return None               # forward still in flight
            if i < M - 1 and not self.grds[i].can_pop(1):
                self.wait_reason = ("starve", self.grds[i])
                return None
            if i > 0 and not self.grds[i - 1].can_push(1):
                if self.stall_mark != self.pos:
                    self.stall_mark = self.pos
                    self.grds[i - 1].note_stall()
                self.wait_reason = ("credit", self.grds[i - 1])
                return None
        return 0.0

    def dispatch(self, op: Op, driver):
        i, M, mb = self.chunks[op.chunk], self.M, op.seq
        st = self.stages[op.chunk]
        rep = mb % len(st.devices)
        if op.kind == "F":
            if i == 0:
                x = self.microbatches[mb]
            else:
                mb_got, x = self.acts[i - 1].pop_hold(1)[0]
                assert mb_got == mb, f"fifo order broke: {mb_got}!={mb}"
                op.releases.append((self.acts[i - 1], 1))
            if i < M - 1:
                self.acts[i].reserve(1)
            task = self._launch_fwd(st, i, rep, mb, x)
        else:
            y_bar = None
            if i == M - 1:
                # release the vocab-sized tensor: 1F1B exists to bound
                # live activations, so don't hoard logits
                logits, self.res.outputs[mb] = self.res.outputs[mb], None
            else:
                mb_got, y_bar = self.grds[i].pop_hold(1)[0]
                assert mb_got == mb, f"fifo order broke: {mb_got}!={mb}"
                op.releases.append((self.grds[i], 1))
                logits = None
            if i > 0:
                self.grds[i - 1].reserve(1)
            self._live[op.chunk] -= 1
            task = self._launch_bwd(st, i, rep, mb, self.vjps.pop((i, mb)), y_bar, logits)
        self.pos += 1
        return task

    def _stream(self, st: LMStage, rep: int):
        """The stream replica ``rep``'s op runs on (None: the caller's),
        noted in the run's set of streams used."""
        stream = st.streams[rep] if self.overlap else None
        if stream is not None:
            self.streams.add(stream.cuda_stream)
        elif self.pipe.device.type == "cuda":
            self.streams.add(torch.cuda.current_stream(self.pipe.device).cuda_stream)
        return stream

    def _launch_fwd(self, st: LMStage, i: int, rep: int, mb: int, x):
        """The F op's task on its input ``x`` (the microbatch's tokens, or
        the producer's activation)."""
        self._stream(st, rep)
        return (_fwd_op, (self.pipe._placed(st, self.overlap), rep, x, self.train,
                          i > 0, self.pipe.device))

    def _launch_bwd(self, st: LMStage, i: int, rep: int, mb: int, vjp, y_bar, logits):
        """The B op's task: ``y_bar`` the consumer's cotangent, or None on
        the last stage, which seeds from its ``logits``."""
        self._stream(st, rep)
        return (_bwd_op, (self.pipe._placed(st, self.overlap), rep, vjp, y_bar, logits,
                          self.loss_fn, self.pipe.device))

    def retire(self, op: Op, result, engine: Engine) -> float:
        i, M = self.chunks[op.chunk], self.M
        st = self.stages[op.chunk]
        if op.kind == "F":
            y, vjp, t_done = self._fwd_result(op, result, engine)
            if self.train:
                self.vjps[(i, op.seq)] = vjp
                self._live[op.chunk] += 1
                assert self._live[op.chunk] <= self.live_bound[op.chunk], \
                    (f"{self.name}: chunk {op.chunk} holds "
                     f"{self._live[op.chunk]} live activations, schedule "
                     f"promised {self.live_bound[op.chunk]}")
            if i < M - 1:
                engine.ordered_push(self.acts[i], op.seq, y, t_done)
            else:
                self.res.outputs[op.seq] = y
                self.res.mb_done_s.append(t_done - engine.t0)
        else:
            p_bar, x_bar, lval, t_done = self._bwd_result(op, result, engine)
            if i > 0:
                engine.ordered_push(self.grds[i - 1], op.seq, x_bar, t_done)
            if lval is not None:
                self.raw_losses[op.seq] = lval
            buf, nxt = self.acc_buf[i], self.acc_next
            buf[op.seq] = p_bar
            while nxt[i] in buf:
                self._fold(st, i, nxt[i], buf.pop(nxt[i]))
                nxt[i] += 1
        return t_done

    def _fwd_result(self, op: Op, result, engine: Engine):
        """(output, vjp, completion time) of a retired F op."""
        return result

    def _bwd_result(self, op: Op, result, engine: Engine):
        """(what the fold takes, input cotangent, loss or None, completion
        time) of a retired B op."""
        p_bar, x_bar, lval, t_done = result
        return ((p_bar, self.stages[op.chunk].streams[op.rep] if self.overlap else None),
                x_bar, lval, t_done)

    def _fold(self, st: LMStage, i: int, mb: int, p_bar) -> None:
        """Fold microbatch ``mb``'s gradients; the calls come in microbatch
        order."""
        pb, src = p_bar
        self.grads[st.name] = self.pipe._fold_into(st, self.grads[st.name], pb, src)

    def describe(self) -> str:
        return describe_position(self.name, self.pos, self.ops,
                                 SchedOp.describe)


# ===========================================================================
# pipeline assembly + execution
# ===========================================================================
class LMPipeline(OverRanks):
    """A placed LM pipeline ready to stream microbatches.

    ``stg``/``sel`` come from the planner (`selection_from_plan` turns a
    PlanResult into the Selection).  ``layers_per_stage`` groups adjacent
    layers into one stage; ``params``: the stage modules ({name: module},
    from `build_lm_stages` or `bridge.stages_from_jax`) to run — pass one
    set to several pipelines to share weights — or a function of the stage
    names this process runs that returns them; else random float32
    masters from ``seed``.  ``devices`` (or ``device``): where the stages
    run, the card unless the caller asks for the CPU (``devices=["cpu"]``);
    without a card this raises.  One device: every placement slice folds
    onto it.  A `launch.mesh.RankPool` (or a ``DeviceMesh``, or a list of
    ranks): a process a rank, every rank building the same pipeline; the
    pool's first rank calls ``run`` and ``close``, every other rank
    ``work`` (module docstring, `remote`); each rank keeps only the
    stages it runs (drawn from ``seed``, every stage is drawn in turn and
    let go unless it runs here).  ``impl``: ``None`` runs the kernels, ``"ref"`` the
    oracles (`kernels.ops`).

    ``overlap`` selects the asynchronous executor (a stream a stage, a
    lane thread a (stage, replica); the default) or the serial one;
    ``workers`` caps the lanes (default: one per replica, at most 16).
    ``schedule`` is the default `schedule.Schedule` that ``run`` executes
    (per-run ``schedule=`` overrides it; None picks `one_f_one_b` for
    training and `fill_drain` for serving).  ``warmup`` (default True)
    runs every program a run will run, where it will run it, before the
    engine's clock starts; ``compile_stats.late`` counts first calls that
    landed inside a timed run.  ``fusion_plan``: None, ``"auto"`` or a
    contiguous partition of the built stage names.  ``close`` stops the
    lane threads and frees their cuBLAS workspaces.
    """

    def __init__(self, cfg: ModelConfig, stg: STG, sel: Selection, *,
                 devices=None, device="cuda", layers_per_stage: int | None = None,
                 capacity_blocks: int = 2, seed: int = 0,
                 overlap: bool = True, replica_queue: int = 2,
                 workers: int | None = None, params: dict | None = None,
                 schedule: Schedule | None = None, warmup: bool = True,
                 fusion_plan=None, impl: str | None = None):
        from ...launch.mesh import as_rank_pool
        from . import as_selection
        sel = as_selection(sel)
        self.pool = as_rank_pool(devices, device) if devices is not None else None
        if self.pool is None:
            pool = {resolve_device(d) for d in (devices if devices is not None else [device])}
            if len(pool) != 1:
                raise NotImplementedError(
                    f"LMPipeline runs on one device in one process, got "
                    f"{sorted(map(str, pool))}; over several devices it runs a "
                    f"process a device (devices=launch.mesh.RankPool)")
            self.device = pool.pop()
        else:
            self.device = self.pool.device
        self.cfg = cfg
        self.schedule = schedule
        self.stg = stg                 # kept for static verification
        self.sel = sel                 # (core.verify.verify_lm_plan)
        self.impl = ops.check_impl(impl)
        self.placement = place(stg, sel, self.pool if self.pool is not None else [self.device])
        self.overlap = overlap
        self.replica_queue = max(1, replica_queue)
        self.warmup = warmup
        self.compile_stats = CompileStats()
        self._warmed: set = set()
        # map lm_graph node names onto built stages: embed/head by name,
        # blockNN graph nodes collapse onto the built group that owns them
        # (topological, not lexicographic: block100 sorts before block11)
        lps = layers_per_stage or 1
        n_built = -(-cfg.n_layers // lps)
        graph_blocks = [n for n in stg.topo_order() if n not in ("embed", "head")]
        # every graph node must land in exactly one built stage, or the
        # pipeline would silently run less model than the plan placed
        # (e.g. enc-dec graphs emit encNN nodes no decoder stage claims)
        if len(graph_blocks) != sum(len(graph_blocks[i * lps:(i + 1) * lps])
                                    for i in range(n_built)) or not all(
                n.startswith("block") for n in graph_blocks):
            raise ValueError(
                f"graph nodes {graph_blocks} do not map 1:1 onto the "
                f"{n_built} built decoder stages x "
                f"{lps} layer(s): LMPipeline executes embed->blocks->head "
                f"only (encoder/decoder pipelines are a ROADMAP item)")
        self._working_depth = 0
        self.capacity_blocks = capacity_blocks
        self.workers = workers
        self._layouts: dict = {}
        self.owners: dict[str, list[str]] = {}
        if self.pool is not None:
            names = ["embed"] + [f"block{i:02d}" for i in range(n_built)] + ["head"]
            for name in names:
                self.owners[name] = self._owners_of(name, names[1:-1], graph_blocks, lps, sel)
            self._init_ranks(names, params, layers_per_stage, seed, fusion_plan)
            return
        if params is None:
            names, modules = build_lm_stages(cfg, layers_per_stage=layers_per_stage,
                                             seed=seed, device=self.device)
        else:
            names = ["embed"] + [f"block{i:02d}" for i in range(n_built)] + ["head"]
            modules = dict(params(names) if callable(params) else params)
            if list(modules) != names:
                raise ValueError(f"params hold stages {list(modules)}, the plan "
                                 f"builds {names}")
        self.modules = modules
        built_blocks = names[1:-1]
        stages = []
        for name in names:
            owners = self._owners_of(name, built_blocks, graph_blocks, lps, sel)
            # a fused stage does the work of all its owners' graph nodes;
            # use every owner's replica slices (nr x n_owners replicas, each
            # doing n_owners layers of work -> same planned capacity); on
            # one device they share the module's tensors
            n_rep = max(1, sum(len(self.placement.replicas_of(o)) for o in owners))
            module = modules[name]
            if next(module.parameters()).device != self.device:
                raise ValueError(f"stage {name} lives on "
                                 f"{next(module.parameters()).device}, the pipeline "
                                 f"on {self.device}")
            self.owners[name] = owners
            stages.append(self._stage(name, module, n_rep))
        self.stages: list[LMStage] = stages
        self.fusion_plan = None
        if fusion_plan is not None:
            groups = self._resolve_fusion(fusion_plan, {st.name: len(st.devices)
                                                        for st in self.stages})
            if any(len(g) > 1 for g in groups):
                self.stages = self._fuse_lm_stages(groups)
                self.fusion_plan = tuple(groups)
        self.lanes = Lanes([len(st.devices) for st in self.stages], self._n_workers())

    @staticmethod
    def _owners_of(name: str, built_blocks: list, graph_blocks: list, lps: int,
                   sel: Selection) -> list[str]:
        """The graph nodes built stage ``name`` executes."""
        if name in ("embed", "head"):
            return [name]
        # built stage i holds layers [i*lps, (i+1)*lps) — slice the
        # per-layer graph nodes with the same arithmetic
        i = built_blocks.index(name)
        owners = graph_blocks[i * lps:(i + 1) * lps]
        if not owners:
            raise ValueError(
                f"stage {name}: no graph nodes map to it — the "
                f"graph/built-stage invariant above broke")
        picks = {sel.choices[o] for o in owners}
        if len(picks) > 1:
            raise ValueError(
                f"stage {name} groups graph nodes {owners} whose "
                f"plan choices differ ({sorted(picks)}) — the "
                f"executor would drop replicas the plan promised; "
                f"use layers_per_stage=1 or align the plan")
        return owners

    # -- over ranks: construction ------------------------------------------
    def _init_ranks(self, names: list, params, layers_per_stage, seed: int,
                    fusion_plan) -> None:
        """The stages over a `RankPool`, as the JAX package places them over
        devices: each replica of a built stage on its placement slice's
        ranks (its owners' slices, pooled); a fusion group's replicas pool
        its members' slices, each on its slice's first rank, holding every
        member's parameters; a tp > 1 slice of distinct ranks gets its
        sub-mesh (`launch.mesh.submesh_of`, made by every rank in the same
        order) and its stage's parameters as DTensors placed by
        `launch.sharding.stage_param_shardings`.  This rank keeps the
        modules of the stages it runs and drops the others."""
        from ...launch.mesh import submesh_of
        from ...launch.sharding import distribute_params, stage_param_shardings
        from .remote import Controller
        pool, rank = self.pool, self.pool.rank
        slices = {n: [sl.devices for o in self.owners[n] for sl in self.placement.replicas_of(o)]
                  or [(pool[0],)] for n in names}
        groups = [(n,) for n in names]
        self.fusion_plan = None
        if fusion_plan is not None:
            groups = self._resolve_fusion(fusion_plan, {n: len(slices[n]) for n in names})
            if any(len(g) > 1 for g in groups):
                self.fusion_plan = tuple(groups)
        plan = []                          # (name, members, slices) a stage
        for grp in groups:
            if len(grp) == 1:
                plan.append((grp[0], (), slices[grp[0]]))
                continue
            for m in grp:
                if any(len(set(sl)) > 1 for sl in slices[m]):
                    raise ValueError(f"cannot fuse tp-sharded stage {m}: stage combining "
                                     f"requires single-device members")
            name = "+".join(grp)
            self.owners[name] = [o for m in grp for o in self.owners[m]]
            plan.append((name, grp, [(sl[0],) for m in grp for sl in slices[m]]))
        need = {m for name, members, sls in plan if any(rank in sl for sl in sls)
                for m in (members or (name,))}
        if params is None:
            _, modules = build_lm_stages(self.cfg, layers_per_stage=layers_per_stage,
                                         seed=seed, device=self.device, keep=need)
        else:
            if callable(params):
                params = params([n for n in names if n in need])
            missing = sorted(need - set(params))
            if missing:
                raise ValueError(f"rank {rank} runs stages {missing}, which params lack")
            modules = {n: params[n] for n in names if n in need}
        for name, module in modules.items():
            if next(module.parameters()).device != self.device:
                raise ValueError(f"stage {name} lives on {next(module.parameters()).device}, "
                                 f"rank {rank} on {self.device}")
        self.modules = modules
        self.stages = []
        for name, members, sls in plan:
            meshes = [submesh_of(sl, device=self.device.type) for sl in sls]
            mine = [k for k, sl in enumerate(sls) if rank in sl]
            if len({meshes[k] is None for k in mine}) > 1 or \
                    sum(meshes[k] is not None for k in mine) > 1:
                raise NotImplementedError(
                    f"stage {name}: rank {rank} is in several tp slices "
                    f"{[sls[k] for k in mine]}; give the pool more ranks")
            module = None
            if mine:
                module = (FusedStage({m: modules[m] for m in members}) if members
                          else modules[name])
                mesh = meshes[mine[0]]
                if mesh is not None:
                    distribute_params(module, stage_param_shardings(name, module, mesh,
                                                                    self.cfg))
            st = self._stage(name, module, len(sls), members=tuple(members))
            st.ranks, st.meshes = [tuple(sl) for sl in sls], meshes
            self.stages.append(st)
        self.ranks = sorted({r for st in self.stages for sl in st.ranks for r in sl})
        self._tp_lock = threading.Lock()
        self.lanes = Lanes([len(st.devices) for st in self.stages], self._n_workers())
        self._ctl = Controller(pool, self) if pool.is_controller else None

    def _stage(self, name: str, module: nn.Module, n_rep: int,
               members: tuple = ()) -> LMStage:
        impl = self.impl
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" and module is not None else None)
        return LMStage(
            name=name, module=module,
            fwd=AotProgram(lambda m, x: _stage_forward(m, x, impl), name=f"{name}.fwd",
                           stats=self.compile_stats),
            bwd=AotProgram(_stage_backward, name=f"{name}.bwd", stats=self.compile_stats),
            acc=AotProgram(_fold, name=f"{name}.acc", stats=self.compile_stats),
            devices=[self.device] * n_rep,
            streams=[stream] * n_rep,
            dtypes=[] if module is None else [p.dtype for p in module.parameters()],
            members=members)

    def _resolve_fusion(self, fusion_plan, reps: dict) -> list[tuple[str, ...]]:
        """Normalise ``fusion_plan`` into a contiguous partition of the
        built stage names (``reps``: {name: replicas}, in stage order).
        ``"auto"`` asks `core.restructure.auto_fusion` (block stages form
        the ``heavy`` set — merging them is ``layers_per_stage``'s job;
        fusion absorbs the stateless endpoints); an explicit plan is a list
        of adjacent-name tuples."""
        names = list(reps)
        if fusion_plan == "auto":
            from ...core import restructure
            heavy = [n for n in names if n.startswith("block")]
            return list(restructure.auto_fusion(
                names, heavy=heavy, replicas=reps,
                dev_in_score=False).groups)
        groups = [tuple(g) if isinstance(g, (tuple, list)) else (g,)
                  for g in fusion_plan]
        flat = [n for g in groups for n in g]
        if flat != names:
            raise ValueError(
                f"fusion_plan {groups} is not a contiguous partition of "
                f"the built stages {names}")
        return groups

    def _fuse_lm_stages(self, groups: list[tuple[str, ...]]) -> list[LMStage]:
        """Rewrite ``self.stages`` under a fusion plan: each multi-member
        group becomes ONE stage whose module runs the members in order —
        one op, one fifo hop fewer per fused boundary.  Replicas POOL the
        members' placement slices (each pooled replica does the whole
        group's work), so the plan's device budget is kept.  The members'
        modules are shared, not copied, and the fused gradient tree is
        the members' trees under their names, bitwise the unfused ones."""
        by_name = {st.name: st for st in self.stages}
        out: list[LMStage] = []
        for grp in groups:
            if len(grp) == 1:
                out.append(by_name[grp[0]])
                continue
            members = [by_name[n] for n in grp]
            name = "+".join(grp)
            self.owners[name] = [o for m in grp for o in self.owners[m]]
            module = FusedStage({m.name: m.module for m in members})
            out.append(self._stage(name, module, sum(len(m.devices) for m in members),
                                   members=tuple(grp)))
        return out

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def _n_workers(self) -> int:
        if self.workers is not None:
            return max(1, self.workers)
        return min(16, max(2, sum(len(st.devices) for st in self.stages)))

    def graph_stage_map(self) -> dict[str, str]:
        """graph node -> executed stage name (the ``stage_map``
        `measure.compare_lm` needs when a stage owns several graph
        nodes)."""
        return {o: st.name for st in self.stages for o in self.owners[st.name]}

    def _tokens(self, mb) -> torch.Tensor:
        return torch.as_tensor(np.asarray(mb) if not isinstance(mb, torch.Tensor)
                               else mb).to(self.device, torch.long)

    def _placed(self, st: LMStage, overlap: bool) -> LMStage:
        """``st`` as an op body sees it: on its streams when overlapped,
        on the caller's stream (None) when serial."""
        return st if overlap else dataclasses.replace(st, streams=[None] * len(st.devices))

    def _fold_into(self, st: LMStage, acc, pb: list, src):
        """Fold one microbatch's ``pb`` into the stage's accumulator on the
        calling thread's stream (the first ``pb`` becomes the buffer, a
        working copy's gradient cast to its master's dtype, `first_acc`).
        It was made on ``src`` (None: this stream) and is complete there;
        each tensor is marked for this stream, so the allocator keeps its
        block until the fold's reads, and the accumulator's later writes,
        are done."""
        if src is not None:
            here = torch.cuda.current_stream(self.device)
            if here != src:
                for t in pb:
                    t.record_stream(here)
        return first_acc(pb, st.dtypes) if acc is None else st.acc(acc, pb)

    @contextlib.contextmanager
    def _working_copies(self):
        """Each matrix of the block and head stages held, for the context,
        as one bfloat16 copy of its master (`working_params`): every stage
        computes in bfloat16, so each forward's ``.to(bfloat16)`` of it
        returns the copy itself.  A matrix is cast once a forward, so the
        gradient of its copy is the bits the cast's vjp hands its master,
        and the fold adds it into the float32 accumulator; autograd keeps
        no bfloat16 copy of the weights a microbatch, and no cast runs an
        op.  Nested entries share the outer copies."""
        if self._working_depth:
            self._working_depth += 1
            try:
                yield
            finally:
                self._working_depth -= 1
            return
        swapped = []
        with torch.no_grad():
            for module in self.modules.values():
                for sub, name, p in working_params(module):
                    sub._parameters[name] = nn.Parameter(p.to(torch.bfloat16))
                    swapped.append((sub, name, p))
        self._working_depth = 1
        try:
            yield
        finally:
            self._working_depth = 0
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)       # the copies' last reads
            for sub, name, p in swapped:
                sub._parameters[name] = p

    def reference(self, microbatches: list) -> list:
        """Unpipelined forward — the same stage modules applied in sequence
        on the caller's stream; the pipelined serving run must match this
        bitwise."""
        self._one_process("reference")
        outs = []
        with torch.no_grad():
            for mb in microbatches:
                x = self._tokens(mb)
                for st in self.stages:
                    x = st.fwd(st.module, x)
                outs.append(x)
        return outs

    def sequential(self, microbatches: list, *, loss_fn=None) -> tuple[dict, dict]:
        """The sequential oracle of a training run: (grads, losses) from the
        same stage modules, microbatch by microbatch on the caller's stream
        — every stage's forward, the loss, every stage's backward in
        reverse — each stage's gradients folded in microbatch order.  Any
        schedule's run must match it bitwise."""
        self._one_process("sequential")
        acc: list = [None] * self.n_stages
        losses = {}
        for k, mb in enumerate(microbatches):
            x = self._tokens(mb)
            saved = []
            with torch.enable_grad():
                for i, st in enumerate(self.stages):
                    xin = x.detach().requires_grad_(i > 0)
                    x = st.module(xin, impl=self.impl)
                    saved.append((x, xin))
                lval, y_bar = _seed(x, loss_fn)
                if lval is not None:
                    losses[k] = float(lval)
                for i in reversed(range(self.n_stages)):
                    params = self.stages[i].params
                    y, xin = saved.pop()
                    wrt = params + [xin] if i > 0 else params
                    gs = torch.autograd.grad(y, wrt, y_bar, allow_unused=True)
                    pb = [g if g is not None else torch.zeros_like(p)
                          for g, p in zip(gs, params)]
                    y_bar = gs[-1] if i > 0 else None
                    acc[i] = pb if acc[i] is None else [a.add_(b) for a, b in zip(acc[i], pb)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        grads = {st.name: None if a is None else st.grad_tree(a)
                 for st, a in zip(self.stages, acc)}
        return grads, losses

    def _one_process(self, what: str) -> None:
        if self.pool is not None:
            raise NotImplementedError(f"{what}() runs every stage in one process: build the "
                                      f"pipeline on one device for it")

    def _edge_fifo(self, producer: LMStage, consumer: LMStage) -> Fifo:
        # a slot is occupied from producer *dispatch* (reservation) to
        # consumer *retirement* (hold release), so both endpoints' full
        # in-flight complements must fit alongside the buffered tokens:
        # nr x replica_queue reservations on the producer side (else a
        # replicated producer serialises its own replicas on output
        # slots), nr x replica_queue holds on the consumer side, plus
        # ``capacity_blocks`` actually-queued tokens of slack between
        # them — the knob keeps its double-buffering meaning.  One
        # device: nothing to stage ahead of a pop.
        slots = (len(producer.devices) + len(consumer.devices)) \
            * self.replica_queue
        return Fifo(block=1, capacity_blocks=self.capacity_blocks,
                    min_capacity=self.capacity_blocks + slots)

    def _resolve_schedule(self, schedule: Schedule | None, n_micro: int,
                          train: bool) -> Schedule:
        """Check a caller's schedule object against this pipeline and this
        run, or pick the default (`one_f_one_b` / `fill_drain`)."""
        M = self.n_stages
        if schedule is None:
            schedule = self.schedule
        if schedule is None:
            return (one_f_one_b(M, n_micro) if train
                    else fill_drain(M, n_micro))
        if schedule.n_model_stages != M:
            raise ValueError(
                f"schedule {schedule.name} covers "
                f"{schedule.n_stages} x {schedule.n_chunks} = "
                f"{schedule.n_model_stages} model stages; this pipeline "
                f"built {M}")
        if schedule.n_micro != n_micro:
            raise ValueError(
                f"schedule {schedule.name} is for {schedule.n_micro} "
                f"microbatches; run got {n_micro}")
        if train != schedule.trains:
            raise ValueError(
                f"schedule {schedule.name} "
                f"{'has no backward ops' if train else 'schedules backward'}"
                f" — mismatched with train={train}")
        return schedule.validate()

    def _preflight(self, sched: Schedule, n_micro: int, train: bool,
                   act_caps: list, grd_caps: list):
        """Static verification of this run's plan tuple; raises
        `core.verify.PlanVerificationError` on any ERROR.  Cached on the
        schedule's contents (its op streams, not the object: the default
        schedule is built anew each run), the shape and the capacities —
        steady-state reruns of the same plan pay a lookup, not a
        re-simulation."""
        from ...core import verify as _verify
        key = (sched.name, sched.n_stages, sched.n_micro, sched.n_chunks,
               tuple(map(tuple, sched.stage_ops)), tuple(sched.live_bounds),
               n_micro, train, tuple(act_caps), tuple(grd_caps))
        cached = getattr(self, "_preflight_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1].raise_if_errors("LMPipeline.run")
        report = _verify.verify_lm_plan(
            self, schedule=sched, n_micro=n_micro, train=train,
            act_capacities=act_caps, grd_capacities=grd_caps)
        self._preflight_cache = (key, report)
        self.last_preflight = report
        return report.raise_if_errors("LMPipeline.run")

    def _layout(self, sched: Schedule) -> tuple[Lanes, dict]:
        """The lanes of a run under ``sched`` (physical program s, replica
        r -> a lane of this pipeline's threads) and each built stage's
        program: interleaved, a program runs several built stages, all on
        its lanes."""
        chunks = tuple(tuple(sched.model_stage(s, c) for c in range(sched.n_chunks))
                       for s in range(sched.n_stages))
        if chunks not in self._layouts:
            reps = [max(len(self.stages[i].devices) for i in ch) for ch in chunks]
            self._layouts[chunks] = (self.lanes.relayout(reps),
                                     {i: s for s, ch in enumerate(chunks) for i in ch})
        return self._layouts[chunks]

    def warm(self, microbatches: list, *, train: bool = False, loss_fn=None,
             overlap: bool | None = None, schedule: Schedule | None = None) -> None:
        """Run every program that ``run`` with these arguments will run,
        where it will run it, now (``run`` does it itself when
        ``warmup``), so that none lands inside a timed run."""
        overlap = self.overlap if overlap is None else overlap
        sched = self._resolve_schedule(schedule, len(microbatches), train)
        if self.pool is not None:
            self._check_controller()
            self._bracket(lambda: self._warm_ranks(tuple(np.shape(microbatches[0])), train,
                                                   loss_fn, overlap))
            return
        with self._working_copies():
            self._warm_run(self._tokens(microbatches[0]), train, loss_fn, overlap, sched)

    def _warm_run(self, mb: torch.Tensor, train: bool, loss_fn, overlap: bool,
                  sched: Schedule) -> None:
        """Run every program this run will run — each stage's forward,
        with ``train`` its backward on a zero ``y_bar`` (the head's seeded
        by ``loss_fn``) and the fold of what it gives — once, on a zero
        microbatch of ``mb``'s shape, where the run will run it:
        overlapped, on every (stage, replica)'s lane thread, on its stage's stream;
        else on this thread and its stream.  Runs before the engine's
        clock starts."""
        lanes, prog_of = self._layout(sched)
        key = (tuple(mb.shape), str(mb.dtype), train, getattr(loss_fn, "__code__", loss_fn),
               tuple(sorted(prog_of.items())) if overlap else _where())
        if key in self._warmed:
            return
        x = torch.zeros_like(mb)
        for i, st in enumerate(self.stages):
            y = None
            for rep in range(len(st.devices) if overlap else 1):
                args = (i, rep, x, train, loss_fn, overlap)
                out, pb, src = (lanes.submit(prog_of[i], rep, self._warm_stage, *args).result()
                                if overlap else self._warm_stage(*args))
                if pb is not None:
                    st.acc.precompile(self._fold_into(st, None, pb, src), pb)
                y = out if y is None else y
            x = y
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed.add(key)

    def _warm_stage(self, i: int, rep: int, x, train: bool, loss_fn, overlap: bool):
        st = self._placed(self.stages[i], overlap)
        stream = st.streams[rep]
        with _on(stream), torch.set_grad_enabled(train):
            if stream is not None:
                x.record_stream(stream)
            xin = x.detach().requires_grad_(train and i > 0)
            fwd = st.fwd.precompile if isinstance(st.fwd, AotProgram) else st.fwd
            y = fwd(st.module, xin)
            pb = None
            if train:
                y_bar = (_seed(y, loss_fn)[1] if i == self.n_stages - 1
                         else torch.zeros_like(y))
                pb, _ = st.bwd.precompile(st.params, y, xin, y_bar)
            if stream is not None:
                torch.cuda.current_stream(self.device).synchronize()
        return y.detach(), pb, stream

    def close(self) -> None:
        """Stop the lane threads, and free the cuBLAS workspaces that their
        (thread, stream) pairs, and autograd's device thread, made.
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

    # -- over ranks: the workers' side ----------------------------------------
    def _sharded(self, st: LMStage, rep: int):
        """The sharding context of replica ``rep``'s tp sub-mesh (held one
        body at a time on this rank: the context is the process's), or
        none."""
        mesh = st.meshes[rep] if st.meshes else None
        if mesh is None:
            return contextlib.nullcontext()
        from ... import sharding_ctx as sc

        @contextlib.contextmanager
        def held():
            with self._tp_lock, sc.activate(sc.from_mesh(mesh)):
                yield
        return held()

    @staticmethod
    def _spmd(st: LMStage, rep: int, x):
        """``x`` replicated over replica ``rep``'s sub-mesh (a tp slice's
        input), or as it is."""
        mesh = st.meshes[rep] if st.meshes else None
        if mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)

    @staticmethod
    def _spmd_grads(st: LMStage, rep: int, p_bar: list) -> list:
        """A tp slice's parameter gradients laid out as their parameters."""
        if not st.meshes or st.meshes[rep] is None:
            return p_bar
        return [g.redistribute(p.device_mesh, p.placements) for g, p in zip(p_bar, st.params)]

    def _on_begin(self, w, cmd, inputs):
        """A run starts here: the working copies are made (`OverRanks`)."""
        super()._on_begin(w, cmd, inputs)
        self._rank_copies = contextlib.ExitStack()
        self._rank_copies.enter_context(self._working_copies())
        return {}

    def _on_end(self, w, cmd, inputs):
        """A run ends here: the working copies go, after the device's last
        reads of them."""
        self._rank_copies.close()
        return super()._on_end(w, cmd, inputs)

    def _on_warm(self, w, cmd, inputs):
        """Every program of this rank's (stage, replica)s run once, on zero
        inputs of the run's shape, where the run will run it: overlapped,
        on the (stage, replica)'s lane thread and stream; else here; and
        the fold on this thread, where folds run, on replica 0's ranks."""
        train, overlap = cmd["train"], cmd["overlap"]
        for i, st in enumerate(self.stages):
            for rep, sl in enumerate(st.ranks):
                if w.rank not in sl:
                    continue
                args = (i, rep, cmd["shape"], train, cmd["loss_fn"], overlap)
                pb, src = (self.lanes.submit(i, rep, self._warm_rank_stage, *args).result()
                           if overlap else self._warm_rank_stage(*args))
                if pb is not None and w.rank in st.ranks[0]:
                    st.acc.precompile(self._fold_into(st, None, pb, src), pb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {}

    def _warm_rank_stage(self, i: int, rep: int, shape, train: bool, loss_fn, overlap: bool):
        """`_warm_stage` on zeros of this stage's input (token ids, or the
        bfloat16 activations the embed stage gives), SPMD on a tp slice."""
        st = self.stages[i]
        x = (torch.zeros(shape, dtype=torch.long, device=self.device) if i == 0 else
             torch.zeros((*shape, self.cfg.d_model), dtype=torch.bfloat16, device=self.device))
        with self._sharded(st, rep):
            _, pb, stream = self._warm_stage(i, rep, self._spmd(st, rep, x), train, loss_fn,
                                             overlap)
            return None if pb is None else self._spmd_grads(st, rep, pb), stream

    def _on_fwd(self, w, cmd, inputs):
        """An F op on this rank (`_fwd_op`, on a tp slice SPMD over its
        sub-mesh): its output kept here for the consumer, with its vjp."""
        from .remote import _full, meta_of
        i, rep, mb, train = cmd["i"], cmd["rep"], cmd["mb"], cmd["train"]
        st = self._placed(self.stages[i], cmd["overlap"])
        stream = st.streams[rep]
        with self._sharded(st, rep):
            with _on(stream):
                x = w.get(inputs["x"], self.device)
                if i == 0:
                    x = x.to(self.device, torch.long)
            ar = _fwd_op(st, rep, self._spmd(st, rep, x), train, i > 0, self.device)
            y, vjp = ar.payload
            out = self._after_spmd(st, rep, ar, stream, y)
        if w.rank == st.ranks[rep][0]:
            w.store[("y", i, mb)] = out
        if train:
            w.store[("vjp", i, mb)] = vjp
        return AsyncResult({"meta": meta_of(out), "stream": stream_handle(stream)}, ar.watch)

    def _on_bwd(self, w, cmd, inputs):
        """A B op on this rank (`_bwd_op`): the head seeds from its own
        logits; the parameter gradients stay here for the fold, the input's
        for the producer."""
        from .remote import meta_of
        i, rep, mb = cmd["i"], cmd["rep"], cmd["mb"]
        st = self._placed(self.stages[i], cmd["overlap"])
        stream = st.streams[rep]
        vjp = w.store.pop(("vjp", i, mb))
        w.store.pop(("y", i, mb), None)
        with self._sharded(st, rep):
            y_bar, logits = None, vjp[0]
            if i < self.n_stages - 1:
                with _on(stream):
                    y_bar = self._spmd(st, rep, w.get(inputs["y_bar"], self.device))
                logits = None
            ar = _bwd_op(st, rep, vjp, y_bar, logits, cmd["loss_fn"], self.device)
            p_bar, x_bar, lval = ar.payload
            p_bar = self._spmd_grads(st, rep, p_bar)
            x_bar = self._after_spmd(st, rep, ar, stream, x_bar)
        w.store[("pbar", i, mb)] = p_bar
        if x_bar is not None and w.rank == st.ranks[rep][0]:
            w.store[("xbar", i, mb)] = x_bar
        return AsyncResult({"meta_x": meta_of(x_bar), "meta_p": meta_of(p_bar), "loss": lval,
                            "stream": stream_handle(stream)}, ar.watch)

    def _after_spmd(self, st: LMStage, rep: int, ar: AsyncResult, stream, t):
        """A tp slice's output (or input gradient) whole on each of its ranks,
        the op's watch then taken after that collective; ``t`` else."""
        if not st.meshes or st.meshes[rep] is None or t is None:
            return t
        from .remote import _full
        with _on(stream):
            t = _full(t)
            ar.watch = [DeviceWatch(self.device)]
        return t

    def _on_fold(self, w, cmd, inputs):
        """Fold one microbatch's parameter gradients into the stage's
        accumulator here, on replica 0's rank, on this thread: the
        controller posts the folds of a stage in microbatch order."""
        i, rep = cmd["i"], cmd["rep"]
        st = self.stages[i]
        opened = inputs["pbar"]
        pb = w.get(opened, self.device)
        here = opened[0] == "have"
        if not here and st.meshes[0] is not None:
            from torch.distributed.tensor import DTensor
            pb = [DTensor.from_local(t, p.device_mesh, p.placements, run_check=False,
                                     shape=p.shape, stride=p.stride())
                  for t, p in zip(pb, st.params)]
        src = st.streams[rep] if here and cmd["overlap"] else None
        w.store[("acc", i)] = self._fold_into(st, w.store.get(("acc", i)), pb, src)

    def _on_grads(self, w, cmd, inputs):
        """The stage's accumulated gradients, whole (a tp slice's gathered),
        kept for the controller to fetch from replica 0's first rank."""
        from .remote import _full, meta_of
        i = cmd["i"]
        st = self.stages[i]
        acc = w.store.pop(("acc", i), None)
        if acc is None:
            return {"meta": None}
        full = [_full(a) for a in acc]
        if w.rank == st.ranks[0][0]:
            w.store[("grads", i)] = full
        return {"meta": meta_of(full), "names": [n for n, _ in st.module.named_parameters()]}

    def run(self, microbatches: list, *, train: bool = False,
            loss_fn=None, overlap: bool | None = None,
            schedule: Schedule | None = None,
            tracer=None, injector=None,
            preflight: bool = True) -> LMPipelineResult:
        """Stream microbatches through the pipeline under ``schedule``.

        Serving (train=False) defaults to `schedule.fill_drain` streaming
        with bounded inter-stage buffers — a stage whose output fifo is
        full skips its turn until the consumer drains it.  Training
        (train=True) defaults to `schedule.one_f_one_b` with per-stage
        backward and grad accumulation; ``loss_fn(logits) -> scalar``
        seeds the backward (defaults to sum-of-logits).  An interleaved
        schedule (``schedule.interleaved_1f1b(p, m, v)`` with
        ``p * v == n_stages``) runs v virtual-stage chunks per physical
        program over the same FIFO chain — grads stay bitwise-equal to
        the plain schedules.  ``overlap`` overrides the pipeline-level
        knob for this run (the A/B switch).  ``tracer``: an optional
        `trace.Tracer` — the run emits dispatch/retire spans,
        credit/starve waits, and fifo occupancy counters, and fills
        ``res.stage_wait_s``; warmup stays untraced so the aggregates
        cover only the timed window.  ``injector``: an optional
        `failures.ReplicaFaultPlan`; training has no failover hook, so a
        fault raises `PipelineFailure` (over ranks too, after every rank's
        commands came home and the run's tensors were freed on every rank).  ``preflight``: run the static
        plan verifier (`core.verify.verify_lm_plan`) over the resolved
        schedule and the actual act/grd FIFO capacities before building
        the engine, raising `PlanVerificationError` on any ERROR (False
        = escape hatch; the deadlock report then notes preflight was
        skipped).
        """
        if self.pool is not None:
            self._check_controller()
        overlap = self.overlap if overlap is None else overlap
        n_micro = len(microbatches)
        M = self.n_stages
        sched = self._resolve_schedule(schedule, n_micro, train)
        mbs = ([np.asarray(mb.cpu() if isinstance(mb, torch.Tensor) else mb)
                for mb in microbatches] if self.pool is not None
               else [self._tokens(mb) for mb in microbatches])
        acts = [self._edge_fifo(self.stages[i], self.stages[i + 1])
                for i in range(M - 1)]             # i -> i+1 activations
        grds = [self._edge_fifo(self.stages[i + 1], self.stages[i])
                for i in range(M - 1)] if train else None
        report = None
        if preflight:
            report = self._preflight(sched, n_micro, train,
                                     [f.capacity for f in acts],
                                     [f.capacity for f in grds or []])
        if self.pool is not None:
            return self._run_ranks(sched, mbs, acts, grds, report, train=train,
                                   loss_fn=loss_fn, overlap=overlap, tracer=tracer,
                                   injector=injector)
        with self._working_copies():
            return self._execute(sched, mbs, acts, grds, report, train=train, loss_fn=loss_fn,
                                 overlap=overlap, tracer=tracer, injector=injector)

    def _execute(self, sched: Schedule, mbs: list, acts: list, grds: list | None, report, *,
                 train: bool, loss_fn, overlap: bool, tracer, injector) -> LMPipelineResult:
        """`run` past its checks: the warm-up, the engine, the result."""
        if self.warmup and mbs:
            self._warm_run(mbs[0], train, loss_fn, overlap, sched)
        lanes, _ = self._layout(sched)
        res, engine, raw_losses, grads, _ = self._drive(
            _LMStageProgram, sched, mbs, acts, grds, report, train=train, loss_fn=loss_fn,
            overlap=overlap, tracer=tracer, injector=injector, lanes=lanes,
            workers=self._n_workers())
        # drain the async tail before reading the wall clock; the outputs,
        # made on the stages' streams, are the caller's from here on
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            here = torch.cuda.current_stream(self.device)
            for o in res.outputs:
                if o is not None:
                    o.record_stream(here)
        res.losses = {mb: float(v) for mb, v in sorted(raw_losses.items())}
        res.mb_done_s.sort()
        res.wall_s = time.perf_counter() - engine.t0
        if grads is not None:
            res.grads = {st.name: None if grads[st.name] is None
                         else st.grad_tree(grads[st.name]) for st in self.stages}
        return res

    def _drive(self, program, sched: Schedule, mbs: list, acts: list, grds: list | None,
               report, *, train: bool, loss_fn, overlap: bool, tracer, injector, lanes,
               workers: int):
        """The engine over one ``program`` (an `_LMStageProgram` class) a
        physical stage of ``sched``: (the result with the engine's streams
        and the FIFOs' stats, the engine, the raw losses, the folded
        gradients, the programs)."""
        M, p, n_micro = self.n_stages, sched.n_stages, len(mbs)
        fifo_map = {}
        for i in range(M - 1):
            fifo_map[f"act{i}"] = acts[i]
            if grds is not None:
                fifo_map[f"grd{i}"] = grds[i]
        if tracer is not None:
            for i in range(M - 1):
                tracer.watch_fifo(acts[i], f"act{i}",
                                  src=self.stages[i].name,
                                  dst=self.stages[i + 1].name)
                if grds is not None:
                    tracer.watch_fifo(grds[i], f"grd{i}",
                                      src=self.stages[i + 1].name,
                                      dst=self.stages[i].name)
        res = LMPipelineResult(outputs=[None] * n_micro,
                               placement=self.placement)
        grads = {st.name: None for st in self.stages} if train else None
        raw_losses: dict[int, object] = {}
        streams: set = set()
        programs = [
            program(s, self, sched.stage_ops[s],
                    chunks=[sched.model_stage(s, c)
                            for c in range(sched.n_chunks)],
                    acts=acts, grds=grds, res=res,
                    microbatches=mbs, train=train,
                    loss_fn=loss_fn, grads=grads,
                    raw_losses=raw_losses, overlap=overlap, streams=streams)
            for s in range(p)]
        engine = Engine(programs, overlap=overlap, workers=workers,
                        replica_queue=self.replica_queue,
                        tracer=tracer, fifos=fifo_map, lanes=lanes,
                        injector=injector, static_report=report)
        with self.compile_stats.window():
            er = engine.run()
        res.stage_wait_s = er.stage_wait_s
        res.stage_seconds = er.stage_seconds
        res.stage_firings = er.stage_firings
        res.stage_done_s = er.stage_done_s
        res.stage_dispatch_s = er.stage_dispatch_s
        res.op_trace = er.op_trace
        res.max_inflight = er.max_inflight
        res.streams_used = len(streams)
        for i in range(M - 1):
            res.fifo_stats[("act", i)] = acts[i].stats
            if grds is not None:
                res.fifo_stats[("grd", i)] = grds[i].stats
        return res, engine, raw_losses, grads, programs

    # -- over ranks: the controller's side -------------------------------------
    def _run_ranks(self, sched: Schedule, mbs: list, acts: list, grds: list | None, report, *,
                   train: bool, loss_fn, overlap: bool, tracer, injector) -> LMPipelineResult:
        """`run` over ranks: every rank makes its working copies and warms its
        programs, then the engine runs the schedule here, each op posted to
        the ranks of its replica's slice (`_RankStageProgram`); then the
        gradients (or the logits) come here, and each rank's costs.  Under
        ``injector`` a stall sleeps on the op's lane on its rank, and a
        crash escalates as on one rank (`PipelineFailure`, no failover
        hook): every rank's commands in flight are waited home and the
        run's tensors freed on every rank (`remote.OverRanks._bracket`), so
        the pool runs again."""
        import pickle
        if train and loss_fn is not None:
            try:
                pickle.dumps(loss_fn)
            except Exception as e:
                raise ValueError("over ranks, loss_fn goes to the head's rank: pass a "
                                 "module-level function") from e
        res, costs = self._bracket(lambda: self._execute_ranks(
            sched, mbs, acts, grds, report, train=train, loss_fn=loss_fn, overlap=overlap,
            tracer=tracer, injector=injector))
        for r, c in costs.items():
            res.ranks.setdefault(r, {}).update(c)
        return res

    def _warm_ranks(self, shape: tuple, train: bool, loss_fn, overlap: bool) -> None:
        key = (shape, train, getattr(loss_fn, "__code__", loss_fn), overlap)
        if key not in self._warmed:
            self._ctl.run_on(self.ranks, {"fn": "warm", "shape": shape, "train": train,
                                          "loss_fn": loss_fn, "overlap": overlap}, "warm-up")
            self._warmed.add(key)

    def _execute_ranks(self, sched: Schedule, mbs: list, acts: list, grds: list | None,
                       report, *, train: bool, loss_fn, overlap: bool,
                       tracer, injector) -> LMPipelineResult:
        from .engine import RemoteLanes
        ctl = self._ctl
        if self.warmup and mbs:
            self._warm_ranks(tuple(mbs[0].shape), train, loss_fn, overlap)
        ctl.run_on(self.ranks, {"fn": "window"}, "window")
        res, engine, raw_losses, _, programs = self._drive(
            _RankStageProgram, sched, mbs, acts, grds, report, train=train, loss_fn=loss_fn,
            overlap=overlap, tracer=tracer, injector=injector, lanes=RemoteLanes(), workers=1)
        res.wall_s = time.perf_counter() - engine.t0
        res.losses = {mb: float(v) for mb, v in sorted(raw_losses.items())}
        res.mb_done_s.sort()
        for prog in programs:
            for r, host_s in prog.rank_host_s.items():
                d = res.ranks.setdefault(r, {})
                d["host_s"] = d.get("host_s", 0.0) + host_s
                d["stall_s"] = d.get("stall_s", 0.0) + prog.rank_stall_s.get(r, 0.0)
        if train:
            res.grads = {}
            for i, st in enumerate(self.stages):
                reps = ctl.run_on(st.ranks[0], {"fn": "grads", "i": i}, f"grads of {st.name}")
                first = reps[st.ranks[0][0]]
                res.grads[st.name] = None if first["meta"] is None else st.grad_tree(
                    ctl.fetch(Ref(st.ranks[0][0], ("grads", i), first["meta"])),
                    names=first["names"])
        else:
            res.outputs = [None if ref is None else ctl.fetch(ref) for ref in res.outputs]
        return res


class _RankStageProgram(_LMStageProgram):
    """`_LMStageProgram` over ranks: the same schedule, ready checks, FIFO
    credits and fold order; an op is posted to the ranks of its replica's
    slice, its input sent there from the rank that holds it, and a FIFO
    token is a `remote.Ref` to a tensor that stays on its rank.  The folds
    of a stage are posted in microbatch order to replica 0's ranks; a
    replica on other ranks sends its gradients there."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.ctl = self.pipe._ctl
        self.rank_host_s: dict[int, float] = {}
        self.rank_stall_s: dict[int, float] = {}    # of those, stalls slept
        self.stall_s = 0.0          # the engine's injected stall for the next op

    def _launch_fwd(self, st: LMStage, i: int, rep: int, mb: int, x):
        ranks = st.ranks[rep]
        specs = ({r: ("value", x) for r in ranks} if i == 0
                 else self.ctl.inputs_for(x, ranks))
        return self._post(st, i, rep, mb, "F", {"fn": "fwd", "train": self.train}, "x", specs)

    def _launch_bwd(self, st: LMStage, i: int, rep: int, mb: int, vjp, y_bar, logits):
        # the logits and the vjp stay on the head's rank and the op's
        specs = {} if y_bar is None else self.ctl.inputs_for(y_bar, st.ranks[rep])
        return self._post(st, i, rep, mb, "B", {"fn": "bwd", "loss_fn": self.loss_fn},
                          "y_bar", specs)

    def _post(self, st: LMStage, i: int, rep: int, mb: int, kind: str, fields: dict,
              name: str, specs: dict):
        """The op's command to every rank of its slice, ``specs`` its input
        ``name`` on each rank (none: no input); the task the engine polls."""
        ranks = st.ranks[rep]
        what = f"{kind} of {st.name} replica {rep} microbatch {mb}"
        cmd = {"do": "run", "lane": (i, rep) if self.overlap else None, "i": i, "rep": rep,
               "mb": mb, "overlap": self.overlap, "id": self.ctl.new_id(), "what": what,
               "stall_s": self.stall_s, **fields}
        self.stall_s = 0.0
        for r in dict.fromkeys(ranks):
            self.ctl.post(r, dict(cmd, inputs={name: specs[r]} if specs else {}))
        return posted, (self.ctl, cmd["id"], ranks, what)

    def _reports(self, op: Op, result, engine: Engine):
        """(the slice's first rank's report, every rank's, completion time),
        each rank's host seconds booked."""
        cid, t_done = result
        reps = self.ctl.take(cid)
        for r, rep in reps.items():
            self.rank_host_s[r] = self.rank_host_s.get(r, 0.0) + rep["host_s"]
            self.rank_stall_s[r] = self.rank_stall_s.get(r, 0.0) + rep["stall_s"]
            if engine.tracer is not None:
                engine.tracer.op_rank(self.name, op.rep, r, rep["host_s"])
            if rep.get("stream") is not None:
                self.streams.add((r, rep["stream"]))
        engine.result.stage_dispatch_s[self.name] += max(rep["host_s"] for rep in reps.values())
        return reps[self.stages[op.chunk].ranks[op.rep][0]], reps, t_done

    def _fwd_result(self, op: Op, result, engine: Engine):
        first, _, t_done = self._reports(op, result, engine)
        i, st = self.chunks[op.chunk], self.stages[op.chunk]
        return Ref(st.ranks[op.rep][0], ("y", i, op.seq), first["meta"]), True, t_done

    def _bwd_result(self, op: Op, result, engine: Engine):
        first, reps, t_done = self._reports(op, result, engine)
        i, st = self.chunks[op.chunk], self.stages[op.chunk]
        return ((op.rep, {r: rep["meta_p"] for r, rep in reps.items()}),
                Ref(st.ranks[op.rep][0], ("xbar", i, op.seq), first["meta_x"]),
                first.get("loss"), t_done)

    def _fold(self, st: LMStage, i: int, mb: int, p_bar) -> None:
        """Each of replica 0's ranks folds the shard it holds, sent from the
        rank of the same position in the replica that ran the op."""
        rep, metas = p_bar
        for j, r0 in enumerate(st.ranks[0]):
            src = st.ranks[rep][j]
            spec = self.ctl.inputs_for(Ref(src, ("pbar", i, mb), metas[src]), [r0])[r0]
            self.ctl.post(r0, {"do": "run", "fn": "fold", "lane": None, "i": i, "rep": rep,
                               "mb": mb, "overlap": self.overlap, "inputs": {"pbar": spec},
                               "ack": False, "what": f"fold of {st.name} microbatch {mb}"})
