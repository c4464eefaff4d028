"""Serving launcher (CLI), ported from ``repro/launch/serve.py``: batched
prefill + decode on one device, the card unless ``--device cpu``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \\
        --device cpu --requests 16 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-coder-33b \\
        --requests 16 --max-batch 16 --max-new 32 --prompt-len 400
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs import get_config
from ..runtime.server import LMServer, Request


def main(argv=None) -> tuple[LMServer, list]:
    """Serve ``--requests`` random prompts and print the first completions
    and the server's stats; returns the server (its weights and stats) and
    the completions, for a caller in Python."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(2, cfg.vocab,
                                        rng.integers(4, args.prompt_len + 1))
                    .tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    srv = LMServer(cfg, max_batch=args.max_batch, seed=args.seed,
                   temperature=args.temperature, device=args.device)
    outs = srv.serve(reqs)
    for c in outs[:4]:
        print(f"req {c.uid}: prompt {c.prompt_len} tok -> "
              f"{len(c.tokens)} new tok   {c.tokens[:10]}...")
    print(json.dumps(srv.stats.summary(), indent=1))
    return srv, outs


if __name__ == "__main__":
    main()
