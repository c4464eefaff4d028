"""Training launcher (CLI), ported from ``repro/launch/train.py``.

Runs real steps on one device: the card unless ``--device cpu``.  Fault
tolerance, checkpointing, straggler monitoring and deterministic data
come from ``repro_torch.runtime``.  The JAX launcher's mesh options
(``--tp``, ``--fsdp``, ``--use-planner``) have no counterpart: the port
trains on one device.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 200 --seq-len 128 --global-batch 8 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 50 --fail-at 20:crash --max-restarts 2 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_config
from ..runtime.failures import FailureInjector
from ..runtime.straggler import StragglerMonitor
from ..runtime.trainer import TrainLoopConfig, run_resilient, train_loop


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
    ap.add_argument("--fail-at", action="append", default=[],
                    metavar="STEP:KIND", help="inject a failure, e.g. 20:crash "
                    "or 30:stall:2.0")
    ap.add_argument("--max-restarts", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    loop = TrainLoopConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.global_batch,
        grad_accum=args.grad_accum, lr=args.lr, warmup=args.warmup,
        seed=args.seed, data_kind=args.data, ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval, log_interval=args.log_interval,
        metrics_path=args.metrics, failures=parse_failures(args.fail_at),
        straggler=StragglerMonitor(),
        on_metrics=lambda rec: print(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
                                     f"{rec['sec'] * 1e3:8.1f} ms"))
    if args.ckpt_dir:
        out = run_resilient(cfg, loop, max_restarts=args.max_restarts, device=args.device)
        print(json.dumps({k: out[k] for k in
                          ("restarts", "incarnations", "total_steps_run",
                           "final_step", "final_loss")}, indent=1))
    else:
        s = train_loop(cfg, loop, device=args.device)
        print(f"done: {s.steps_run} steps, final loss {s.final_loss:.4f}, "
              f"stragglers {s.straggler_events}")


if __name__ == "__main__":
    main()
