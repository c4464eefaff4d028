"""Phase 4 of ``chip_smoke.py``, the meshless serving round, timed on the
tree whose ``src`` directory is given, so two trees can be compared on one
card.

    python tools/serve_ab.py --src build/parent/src --label parent
    python tools/serve_ab.py --src src --label change

Each run builds that tree's kernels, then serves qwen2.5-3b and
mamba2-370m at full size through ``LMServer(max_batch=8, seed=0)``:
phase 4's eight requests (prompts of 64-400 tokens from seed 0), a
warm-up round of 2 new tokens, then ``--rounds`` rounds of 32 new tokens
each.  It prints one JSON line: the label, the card's name and power limit
(``nvidia-smi``), and per model the decode step p50 and p90 over all
rounds and each round's p50, in ms.  Run the trees in turn, each in its
own process (parent, change, change, parent), and compare within a call.
Needs a CUDA device.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the src directory of the tree to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.runtime.server import LMServer, Request, ServeStats

    build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    prompt_lens = np.random.default_rng(0).integers(64, 401, 8)
    out = {"label": args.label, "src": args.src, "card": smi, "rounds": args.rounds}
    for name in ("qwen2.5-3b", "mamba2-370m"):
        cfg = get_config(name)
        server = LMServer(cfg, max_batch=8, seed=0, device="cuda")
        prompts = [np.random.default_rng(n).integers(2, cfg.vocab, n).tolist()
                   for n in prompt_lens]
        server.serve([Request(uid=i, prompt=p, max_new=2) for i, p in enumerate(prompts)])
        steps, per_round = [], []
        for _ in range(args.rounds):
            server.stats = ServeStats()
            server.serve([Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)])
            s = np.array(server.stats.decode_step_s) * 1e3
            steps.extend(s)
            per_round.append(float(np.percentile(s, 50)))
        out[name] = {"decode_step_p50_ms": float(np.percentile(steps, 50)),
                     "decode_step_p90_ms": float(np.percentile(steps, 90)),
                     "round_p50_ms": per_round, "decode_steps": len(steps)}
        del server
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
