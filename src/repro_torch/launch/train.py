"""Training launcher (CLI), ported from ``repro/launch/train.py``.

Runs real steps: the card unless ``--device cpu``.  Fault tolerance,
checkpointing, straggler monitoring and deterministic data come from
``repro_torch.runtime``.  With ``--tp`` above 1 or ``--fsdp`` it trains
SPMD over a ("data", "model") mesh of (world // tp, tp): one process a
device, started by ``torchrun``, whose ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` it reads (NCCL on the
card, gloo with ``--device cpu``).  ``--use-planner`` lets the planner
pick tp for the world's size (`core.planner.to_execution`).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 1 -m repro_torch.launch.train \
        --arch qwen2.5-3b --reduced --fsdp --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 200 --seq-len 128 --global-batch 8 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 50 --fail-at 20:crash --max-restarts 2 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_config
from ..configs.base import ShapeCfg
from ..core import planner
from ..runtime.failures import FailureInjector
from ..runtime.straggler import StragglerMonitor
from ..runtime.trainer import TrainLoopConfig, local_mesh, run_resilient, train_loop
from .mesh import init_distributed


def parse_failures(specs: list[str]) -> FailureInjector | None:
    if not specs:
        return None
    sched = {}
    for s in specs:
        step, kind = s.split(":", 1)
        sched[int(step)] = kind
    return FailureInjector(sched)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config (smoke scale)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="bigram", choices=["bigram", "uniform"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--metrics", default=None, help="metrics JSONL path")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--use-planner", action="store_true",
                    help="let the space/time planner pick tp/dp for the world's size")
    ap.add_argument("--fail-at", action="append", default=[],
                    metavar="STEP:KIND", help="inject a failure, e.g. 20:crash "
                    "or 30:stall:2.0")
    ap.add_argument("--max-restarts", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tp, mesh, rank = args.tp, None, 0
    if args.use_planner or tp != 1 or args.fsdp:
        rank, world = init_distributed(args.device)
        if args.use_planner:
            shape = ShapeCfg("cli", args.seq_len, args.global_batch, "train")
            p = planner.plan(cfg, shape, chips=max(world, 2),
                             mb_seqs=max(1, args.global_batch // args.grad_accum))
            ex = planner.to_execution(p, cfg=cfg, chips=world)
            tp = ex.tp
            if rank == 0:
                print(f"[planner] {p.summary()}")
                print(f"[planner] projected mesh {ex.mesh_shape}; tp={tp} "
                      f"({ex.notes or 'homogeneous'})")
        mesh = local_mesh(tp, device=args.device)
    loop = TrainLoopConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.global_batch,
        grad_accum=args.grad_accum, lr=args.lr, warmup=args.warmup,
        seed=args.seed, data_kind=args.data, ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval, log_interval=args.log_interval,
        metrics_path=args.metrics, tp=tp, fsdp=args.fsdp,
        failures=parse_failures(args.fail_at),
        straggler=StragglerMonitor(),
        on_metrics=lambda rec: rank == 0 and print(
            f"step {rec['step']:6d}  loss {rec['loss']:.4f}  {rec['sec'] * 1e3:8.1f} ms"))
    if args.ckpt_dir:
        out = run_resilient(cfg, loop, max_restarts=args.max_restarts, device=args.device,
                            mesh=mesh)
        if rank == 0:
            print(json.dumps({k: out[k] for k in
                              ("restarts", "incarnations", "total_steps_run",
                               "final_step", "final_loss")}, indent=1))
        return out
    s = train_loop(cfg, loop, device=args.device, mesh=mesh)
    if rank == 0:
        print(f"done: {s.steps_run} steps, final loss {s.final_loss:.4f}, "
              f"stragglers {s.straggler_events}")
    return s


if __name__ == "__main__":
    main()
