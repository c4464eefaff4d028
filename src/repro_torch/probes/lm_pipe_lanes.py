"""Where a pipelined training run's time goes, by the number of lane threads.

Builds one `LMPipeline` stage set for ``--arch`` at full width (random
float32 masters from a seed), the plan from the port's planner on a
training shape priced on the H100 with every slice on the one card, and
runs it under 1F1B at each ``--workers`` count (pipelines sharing the
stage modules), with ``overlap=False``, and as the sequential oracle:
each warmed first, then timed on the host clock (the card synchronized at
both ends), with the host seconds of its op bodies by stage and what the
caching allocator did meanwhile (``torch.cuda.memory_stats``: flushes and
retries, device mallocs and frees; the peak).  ``--profile``
adds one profiled run of each: the device's busy time, the union of its
kernel intervals over all streams.  Prints one JSON line a run.

Run on a card: ``PYTHONPATH=src python -m repro_torch.probes.lm_pipe_lanes
--arch qwen2.5-3b --layers-per-stage 9 --seq 1024 --workers 1 2 4 16``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    from ..analysis.roofline import HW_H100
    from ..configs import get_config
    from ..configs.base import ShapeCfg
    from ..core import planner
    from ..graphs import lm_graph
    from ..runtime.pipeline import LMPipeline, build_lm_stages
    from .busy import kernel_busy

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--layers-per-stage", type=int, default=9)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 16])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--no-serial", action="store_true", help="skip the overlap=False run")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg = get_config(args.arch)
    shape = ShapeCfg("train_pipe", args.seq, args.micro, "train")
    plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
    stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
    _, modules = build_lm_stages(cfg, layers_per_stage=args.layers_per_stage, device="cuda")
    rng = np.random.default_rng(2024)
    mbs = [rng.integers(0, cfg.vocab, (1, args.seq)).astype(np.int32)
           for _ in range(args.micro)]

    def loss_fn(lg):
        return torch.mean(lg.float() ** 2)

    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free",
                  "num_sync_all_streams")
    last = {}

    def timed(fn):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = torch.cuda.memory_stats()
        last.clear()
        last.update({k: after.get(k, 0) - before.get(k, 0) for k in alloc_keys},
                    peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                    reserved_gb=torch.cuda.memory_reserved() / 2 ** 30)
        return out, wall

    def profiled(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        busy = kernel_busy(prof)[0]
        return dict(profiled_wall_s=wall, device_busy_ms=busy,
                    device_idle_share=max(0.0, 1 - busy / 1e3 / wall))

    def emit(**rec):
        print(json.dumps(dict(arch=cfg.name, layers_per_stage=args.layers_per_stage,
                              microbatch=[1, args.seq], microbatches=args.micro, card=smi,
                              **rec)), flush=True)

    pipe = LMPipeline(cfg, stg, plan, layers_per_stage=args.layers_per_stage, params=modules,
                      device="cuda")
    pipe.sequential(mbs[:1], loss_fn=loss_fn)                 # its shapes' first calls
    _, wall = timed(lambda: pipe.sequential(mbs, loss_fn=loss_fn))
    rec = dict(run="sequential oracle", wall_s=wall, allocator=dict(last))
    if args.profile:
        rec.update(profiled(lambda: pipe.sequential(mbs, loss_fn=loss_fn)))
    emit(**rec)
    runs = [] if args.no_serial else [("overlap=False", None, False)]
    runs += [(f"1f1b, {w} lanes", w, True) for w in args.workers]
    for label, workers, overlap in runs:
        pipe = LMPipeline(cfg, stg, plan, layers_per_stage=args.layers_per_stage,
                          params=modules, device="cuda", workers=workers)
        pipe.warm(mbs, train=True, loss_fn=loss_fn, overlap=overlap)
        res, wall = timed(lambda: pipe.run(mbs, train=True, loss_fn=loss_fn, overlap=overlap))
        rec = dict(run=label, lanes=pipe.lanes.n, wall_s=wall,
                   tok_per_s=res.tokens_per_s(args.seq),
                   host_s={n: res.stage_dispatch_s[n] for n in res.stage_dispatch_s},
                   max_inflight=res.max_inflight, streams_used=res.streams_used,
                   late=pipe.compile_stats.late, allocator=dict(last))
        del res
        if args.profile:
            rec.update(profiled(lambda: pipe.run(mbs, train=True, loss_fn=loss_fn,
                                                 overlap=overlap)))
        emit(**rec)
        pipe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
