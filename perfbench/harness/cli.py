"""One run of one cell: set up, warm up, measure a window, check, report.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the checkout's root.  Set-up (counted in
``setup_s``, from the process's start to the window's): import, the
program's kernel library loaded (on a checkout's first run, built: the
seconds of that step are also reported apart, as ``build_s``), the
weights drawn on the card from the seed, the server, and a warm-up round
of one block of the mix (every round's bucket and cache capacity), cut
after two decode steps.  Then the
closed loop runs ``--seconds``; with ``--trace 1`` its first whole rounds
under ``torch.profiler``, the device alone, then the next with the spans
(`TRACED_S`), and the per-layer metrics read those rounds: busy and idle
time and the host's clock the first, the spans' device time the second.  Once the window has closed and the
peak memory is read, the server is freed and the output is checked
against the float32 reference (`check`).

Standard output: a line ``{"host": ...}`` (`hostinfo`), then the result
as its last line.  Standard error ends with the numbers compared, each
beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run profiles the window's whole rounds up to the first that ends
# this many seconds in, the device alone, then as many again with the spans
# (`trace.Traced`); its per-layer metrics read those rounds
TRACED_S = 10.0


@dataclass
class Run:
    """What a metric reader reads."""
    model: dict
    window: object            # loop.Window
    setup_s: float
    trace: object | None      # trace.Trace of the device alone, over ``window``
    peaks: dict | None        # {"flops", "bytes_per_s"} of this card, or None
    spans: tuple | None = None    # (trace.Trace, loop.Window) of the stretch with spans


def peaks_of(spec, kind: str):
    table = json.loads((spec.root / "perfbench" / "peaks.json").read_text())
    return next((v for k, v in table.items() if k in kind), None)


def warm_up(drv, mix: dict, model: dict, settings: dict, seed: int) -> None:
    """One round of a block drawn apart from the window's, so at its bucket
    and cache capacity, cut after two decode steps."""
    from . import traffic
    drv.stop_after_steps = 2
    try:
        drv.serve(traffic.Stream(mix, model["vocab"], seed, settings["max_batch"], stream=1)
                  .take(settings["max_batch"]), time.perf_counter())
    finally:
        drv.stop_after_steps = None


def build_kernels(on_card: bool) -> float:
    """Seconds spent building or loading the program's kernel library (0
    off the card); a checkout's first run builds it, later runs load it."""
    if not on_card:
        return 0.0
    from . import port
    t0 = time.perf_counter()
    port.kernel_library()
    return time.perf_counter() - t0


def run_cell(spec, name: str, seed: int, seconds: float, traced: bool, device, t_process: float,
             *, model: dict | None = None, settings: dict | None = None,
             mix: dict | None = None) -> dict:
    """The result of one run; ``model``, ``settings`` and ``mix`` replace the
    cell's own (tests run the harness on a small model on the CPU)."""
    import torch

    from . import check, loop, port, trace, traffic, weights

    cell = spec.cell(name)
    model = model or spec.config(cell["config"])["model"]
    settings = settings or spec.cell_settings(name)
    mix = mix or spec.traffic(cell["traffic"])
    metrics = spec.metrics(name, traced)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    spans = {}
    for r in readers.values():
        spans.update(getattr(r, "SPANS", {}))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    build_s = build_kernels(on_card)
    cfg = port.model_config(model)
    w = weights.make(model, seed, device)
    srv = port.server(cfg, port.params(cfg, w), settings["max_batch"], device)
    drv = loop.Driver(srv)
    warm_up(drv, mix, model, settings, seed)
    sync()
    gc.collect()
    gc.freeze()        # the window's collections skip what set-up made
    stream = traffic.Stream(mix, model["vocab"], seed, settings["max_batch"])

    traced_run = trace.Traced(TRACED_S, sync) if traced else None
    with trace.patched(spans if traced else {}):
        if traced_run is not None:
            traced_run.start()     # before the window: the profiler takes seconds to start
        t_start = time.perf_counter()
        setup_s = t_start - t_process
        rounds = drv.closed_loop(stream, settings["max_batch"], t_start, t_start + seconds,
                                 after_round=traced_run.after_round if traced_run else None)
        sync()
        if traced_run is not None:
            traced_run.stop(rounds)
    window = loop.Window(rounds, t_start, t_start + seconds)
    tr = spanned = None
    if traced_run is not None:
        names = ["LMServer.serve_round", "lm.prefill", "lm.decode_step", *spans]
        dev_alone, with_spans = traced_run.device, traced_run.spans
        tr = trace.read(dev_alone.prof, dev_alone.window_s, names)
        window = loop.Window(rounds[:dev_alone.last], dev_alone.t0,
                             dev_alone.t0 + dev_alone.window_s)
        if with_spans.window_s is not None:
            spanned = (trace.read(with_spans.prof, with_spans.window_s, names),
                       loop.Window(rounds[with_spans.first:with_spans.last], with_spans.t0,
                                   with_spans.t0 + with_spans.window_s))
    del traced_run
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)

    gc.unfreeze()
    del drv, srv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check.judge(model, w, rounds, seed, settings, device)
    run = Run(model, window, setup_s, tr, peaks_of(spec, kind), spanned)
    out = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": check.passed(checks),
              "attempted": sum(len(r.reqs) for r in rounds),
              "failed": checks["bad_answers"]["value"],
              "metrics": out, "device": dev, "build_s": build_s}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["step_ms"] = step_quantiles(run.window)
    result["check"] = checks
    return result


def step_quantiles(window) -> dict:
    """The decode steps' wall times in the window at a few quantiles, in ms:
    where a tail such as ``itl_p95_ms`` comes from."""
    import numpy as np
    steps = np.asarray([dt for _, _, dt in window.decode_steps()]) * 1e3
    if not len(steps):
        return {}
    qs = (50, 90, 95, 99, 100)
    return {"steps": len(steps), **{f"p{q}": float(np.percentile(steps, q)) for q in qs}}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(t_process: float, argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec as spec_mod
    spec = spec_mod.Spec()
    cell = spec.cell(args.workload)
    build = spec.root / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / sub)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    from . import hostinfo
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_process)
    found = forbidden_modules()
    if found:
        print(f"modules that nothing run on the card may load were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps({"host": hostinfo.collect()}))
    print(json.dumps(result), flush=True)
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']} {'>=' if c.get('at_least') else '<='} {c['limit']}",
              file=sys.stderr)
    return 0
