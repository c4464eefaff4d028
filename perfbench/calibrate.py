"""The readings a cell's correctness limit is set from; run on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

In one process, for each seed: the cell's weights drawn anew, one round of
the cell's closed loop at its batch (one block of the mix, as every round
of a window), and the run's own comparison on it (`check.compare`, held to
the cell's limits by `check.held`, as `check.judge` does in a run): the
widest and the mean gap of a served token below the float32 reference's
best (``logit_gap``, ``mean_gap``) and whether the run would be
``correct``.  For each control seed also the control through the same
comparison: the reference computed in fp8 (`perfbench.reference`) in the
program's place, its first token at each position judged in place of the
served one (``control_gap``, ``control_mean_gap``, ``control_correct``).
One JSON line a seed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    controls = {int(x) for x in args.control_seeds.split(",") if x}

    import torch

    from perfbench.harness import check, cli, loop, port, spec, traffic, weights
    sp = spec.Spec()
    cell = sp.cell(args.workload)
    model = sp.config(cell["config"])["model"]
    settings = sp.cell_settings(args.workload)
    mix = sp.traffic(cell["traffic"])
    w = weights.make(model, seeds[0], "cuda")
    cfg = port.model_config(model)
    drv = loop.Driver(port.server(cfg, port.params(cfg, w), settings["max_batch"], "cuda"))
    cli.warm_up(drv, mix, model, settings, seeds[0])
    print(json.dumps({"workload": args.workload, "set_up_s": time.perf_counter() - T_PROCESS,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for seed in seeds:
        weights.refill(w, seed)
        t0 = time.perf_counter()
        stream = traffic.Stream(mix, model["vocab"], seed, settings["max_batch"])
        rnd = drv.serve(stream.take(settings["max_batch"]), t0)
        t1 = time.perf_counter()
        vals = check.compare(model, w, [rnd], seed, settings, "cuda")
        rec = {"seed": seed, **vals, "correct": check.passed(check.held(vals, settings)),
               "round_s": t1 - t0, "reference_s": time.perf_counter() - t1}
        if seed in controls:
            t2 = time.perf_counter()
            low = check.compare(model, w, [rnd], seed, settings, "cuda", control="fp8")
            rec.update(control_gap=low["logit_gap"], control_mean_gap=low["mean_gap"],
                       control_correct=check.passed(check.held(low, settings)),
                       control_s=time.perf_counter() - t2)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
