"""Fault-tolerant training loop on one device, ported from
``repro/runtime/trainer.py``.

Layers (bottom-up): data pipeline -> train step (`launch.steps`) ->
checkpointing (async, atomic) -> failure handling.  ``train_loop`` runs
one incarnation of the job; ``run_resilient`` is the job-controller
contract: restart incarnations from the last committed checkpoint until
the step budget is met.

Determinism contract: data batch ``i`` is a pure function of (seed, i),
the parameters come from a seeded ``torch.Generator``, and the step's
kernels use no atomics, so a restart replays the exact token stream from
the restored step and training curves across failures are
bitwise-reproducible on the same device and mesh.

Under a mesh (``mesh=``, or ``tp > 1`` / ``fsdp``, which build
`local_mesh`) the loop is SPMD: every rank of the mesh runs it.  Each
builds the same seeded parameters (or restores the same checkpoint), and
keeps its shards: parameters and optimizer state are placed by
`launch.sharding.tree_shardings` under ``ShardingPolicy(fsdp=loop.fsdp,
tp=loop.tp > 1)``, each batch by ``batch_specs(accum=True)``, and the step
runs under ``sharding_ctx.activate(from_mesh(mesh))``.  A checkpoint
gathers every leaf to its full tensor on every rank (a collective) and
the mesh's first rank writes it, in the one-device format, so a
checkpoint taken on one mesh restores on another.  The first rank alone
writes the metrics.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .. import sharding_ctx as sctx
from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs.base import ModelConfig, ShapeCfg
from ..data import DataState, make_pipeline
from ..launch import sharding as shd
from ..launch.mesh import device_mesh, mesh_ranks
from ..launch.steps import make_train_step
from ..models import lm
from ..models.common import dtype_of
from .failures import FailureInjector, SimulatedNodeFailure
from .straggler import StragglerMonitor


def local_mesh(tp: int = 1, *, device="cuda"):
    """A ("data", "model") mesh of (world // tp, tp) over the world's ranks
    (JAX: over this process's devices).  Needs the default process group
    (`launch.mesh.init_distributed`)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "launch.mesh.init_distributed (or run under torchrun) first")
    n = dist.get_world_size()
    if n % tp:
        raise ValueError(f"{n} ranks not divisible by tp={tp}")
    return device_mesh((n // tp, tp), ("data", "model"), device=device)


@dataclass
class TrainLoopConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    grad_accum: int = 1
    lr: float = 3e-4
    warmup: int = 50
    seed: int = 0
    data_kind: str = "bigram"
    ckpt_dir: str | None = None
    ckpt_interval: int = 50
    keep: int = 3
    log_interval: int = 10
    restore: bool = True
    tp: int = 1
    fsdp: bool = False
    failures: FailureInjector | None = None
    straggler: StragglerMonitor | None = None
    on_metrics: Callable[[dict], None] | None = None
    metrics_path: str | None = None


@dataclass
class TrainSummary:
    steps_run: int
    final_step: int
    losses: dict[int, float] = field(default_factory=dict)
    step_seconds: dict[int, float] = field(default_factory=dict)
    straggler_events: int = 0
    restored_from: int | None = None
    checkpoints: list[int] = field(default_factory=list)
    model: lm.LM | None = field(default=None, repr=False)   # the trained parameters

    @property
    def final_loss(self) -> float:
        return self.losses[max(self.losses)] if self.losses else float("nan")


def _writer(path: str | None):
    """A JSONL appender, and the function that closes it."""
    if path is None:
        return (lambda rec: None), (lambda: None)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fh = p.open("a")

    def write(rec: dict):
        fh.write(json.dumps(rec) + "\n")
        fh.flush()
    return write, fh.close


def state_tree(model: lm.LM, opt_state: dict, step: int, data_state: DataState) -> dict:
    """What a checkpoint holds: the trainable parameters and the optimizer
    state under their names, the step and the data position."""
    return {"params": {k: p for k, p in model.named_parameters() if p.requires_grad},
            "opt_state": opt_state, "step": np.int64(step),
            "data_step": np.int64(data_state.step)}


def _mesh_barrier(mesh) -> None:
    """Waits for every rank of ``mesh`` (an all-reduce on each of its dims)."""
    import torch.distributed as dist
    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    for i in range(mesh.ndim):
        dist.all_reduce(torch.zeros(1, device=dev), group=mesh.get_group(i))


def _scalar(t) -> float:
    """A replicated (DTensor or plain) scalar on the host: the step barrier."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def train_loop(cfg: ModelConfig, loop: TrainLoopConfig, *, device="cuda",
               mesh=None) -> TrainSummary:
    """One incarnation: restore (or init from ``loop.seed``) -> step until
    ``loop.steps`` or a failure.  ``mesh``: a ("data", "model")
    ``DeviceMesh`` to train over (every rank of it calls this); without one,
    ``loop.tp > 1`` or ``loop.fsdp`` build `local_mesh`, and otherwise the
    loop runs on ``device`` alone."""
    if mesh is None and (loop.tp != 1 or loop.fsdp):
        mesh = local_mesh(loop.tp, device=device)
    if mesh is not None:
        device = "cpu" if mesh.device_type == "cpu" else "cuda"
    dev = resolve_device(device)
    shape = ShapeCfg("custom", loop.seq_len, loop.global_batch, "train")
    opt, step_fn = make_train_step(cfg, lr=loop.lr, warmup=loop.warmup,
                                   total_steps=loop.steps, grad_accum=loop.grad_accum)
    pipe = make_pipeline(loop.data_kind, cfg, shape, seed=loop.seed, accum=loop.grad_accum)
    data_state = pipe.init_state()
    model = lm.init_params(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(loop.seed),
                           param_dtype=dtype_of(cfg.param_dtype))
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    opt_state = opt.init(params)

    start_step, restored_from = 0, None
    if loop.restore and loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
        tree, _meta = restore_checkpoint(
            loop.ckpt_dir, state_tree(model, opt_state, 0, data_state))
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(tree["params"][k])
            for name, leaves in opt_state.items():
                _copy_into(leaves, tree["opt_state"][name])
        start_step = int(tree["step"])
        data_state = DataState(step=int(tree["data_step"]), seed=loop.seed)
        restored_from = start_step

    ctx, batch_sh, first = None, None, True
    if mesh is not None:
        policy = shd.ShardingPolicy(fsdp=loop.fsdp, tp=loop.tp > 1)
        opt_sh = shd.tree_shardings(opt_state, mesh, cfg, policy)
        shd.distribute_params(model, shd.tree_shardings(model, mesh, cfg, policy))
        params = {k: p for k, p in model.named_parameters() if p.requires_grad}
        opt_state = shd.tree_map(shd.place, opt_state, opt_sh)
        ctx = sctx.from_mesh(mesh)
        first = mesh_ranks(mesh)[0] == torch.distributed.get_rank()
    write, close_writer = _writer(loop.metrics_path if first else None)
    summary = TrainSummary(steps_run=0, final_step=start_step, restored_from=restored_from,
                           model=model)
    ckpt = (AsyncCheckpointer(loop.ckpt_dir, keep=loop.keep, write=first)
            if loop.ckpt_dir else None)

    def save(step_i):
        if ckpt is None:
            return
        ckpt.save(step_i, state_tree(model, opt_state, step_i, data_state),
                  metadata={"cfg": cfg.name})
        summary.checkpoints.append(step_i)

    try:
        if loop.straggler is not None:
            loop.straggler.new_incarnation()
        for i in range(start_step, loop.steps):
            batch = {k: torch.from_numpy(v).to(dev, torch.long)
                     for k, v in pipe.host_batch(data_state).items()}
            if mesh is not None:
                if batch_sh is None:
                    batch_sh = shd.named(mesh, shd.batch_specs(mesh, batch, accum=True))
                batch = shd.tree_map(shd.place, batch, batch_sh)
            t0 = time.perf_counter()
            if loop.failures is not None:
                loop.failures.maybe_fail(i)   # a crash raises; a stall is timed
            with sctx.activate(ctx):
                metrics = step_fn(model, opt_state, i, batch)
            loss = _scalar(metrics["loss"])   # waits for the device: the step barrier
            dt = time.perf_counter() - t0
            if loop.straggler is not None:
                loop.straggler.observe(i, dt)
            data_state = data_state.advance()
            summary.steps_run += 1
            summary.final_step = i + 1
            summary.step_seconds[i] = dt
            if i % loop.log_interval == 0 or i == loop.steps - 1:
                summary.losses[i] = loss
                rec = {"step": i, "loss": loss, "sec": round(dt, 4)}
                write(rec)
                if loop.on_metrics is not None:
                    loop.on_metrics(rec)
            if loop.ckpt_interval and (i + 1) % loop.ckpt_interval == 0:
                save(i + 1)
        if loop.ckpt_interval and loop.steps % loop.ckpt_interval != 0:
            save(loop.steps)
    finally:
        try:
            if ckpt is not None:
                ckpt.close()
            if ckpt is not None and mesh is not None:
                _mesh_barrier(mesh)           # every rank sees the committed step
        finally:
            close_writer()
            if loop.straggler is not None:
                summary.straggler_events = len(loop.straggler.events)
    return summary


def _copy_into(dst, src) -> None:
    """Copies a restored nested dict of CPU tensors into the live one."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])


def run_resilient(cfg: ModelConfig, loop: TrainLoopConfig, *, max_restarts: int = 3,
                  device="cuda", mesh=None) -> dict:
    """The job-controller contract: restart from the last committed
    checkpoint on a (simulated) node failure, up to ``max_restarts`` times."""
    if not loop.ckpt_dir:
        raise ValueError("resilient training needs a checkpoint dir")
    incarnations: list[TrainSummary] = []
    restarts = 0
    while True:
        try:
            incarnations.append(train_loop(cfg, loop, device=device, mesh=mesh))
            break
        except SimulatedNodeFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
    return {
        "restarts": restarts,
        "incarnations": len(incarnations),
        "total_steps_run": sum(s.steps_run for s in incarnations),
        "final_step": incarnations[-1].final_step,
        "final_loss": incarnations[-1].final_loss,
        "losses": {k: v for s in incarnations for k, v in s.losses.items()},
        "summaries": incarnations,
    }
