#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Each phase
prints one JSON record on a line of its own; any failure raises and the
script exits non-zero without its result line.  The phases:

 1. device and toolchain: the card and its power limit, torch, CUDA, nvcc;
 2. build: the kernels from ``src/repro_torch/kernels/csrc``, with each
    kernel's registers, shared memory and spills from ptxas;
 3. every kernel against its plain version on the card, in bf16, at the
    shapes the serving path gives it (and danube's head shapes);
 4. serving: the port's ``LMServer`` on qwen2.5-3b at full width, random
    weights from a seed, 8 requests of 64-400 prompt tokens, 32 new tokens
    each; every kernel's launch count is reset just before and read just
    after, and must be above 0;
 5. A/B: two of those requests through the oracle route (``impl="ref"``)
    and the kernel route in lockstep; logits must agree within the bf16
    tolerance at every step, tokens up to the first near-tie;
 6. times: each kernel's device time at its serving shape (from
    ``torch.profiler``, over many launches on input copies that overflow
    the L2 cache), beside its bound, its plain version and one library
    call that computes the same function, and how decode attention's
    time scales with the batch and the live cache;
 7. where a decode step's device time goes, from ``torch.profiler``;
 8. the ``kernels`` record, the card's name and power limit, and last the
    result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50 * 2 ** 20

# kernel vs plain, bf16: |kernel - plain| <= ATOL + RTOL * |plain|, two bf16
# steps at magnitude 1, since both round a float32 result to bf16
ATOL = RTOL = 2e-2
# kernel route vs oracle route, bf16 logits after 36 layers: eight bf16 steps
# at the logits' magnitude (~4); a greedy token may part where the oracle's
# top-2 margin is under twice that, since each side may move by LOGIT_TOL
LOGIT_TOL = 0.25
TIE_MARGIN = 2 * LOGIT_TOL


def emit(phase: str, **record) -> None:
    print(json.dumps({"phase": phase, **record}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Registers, shared memory and spills of each compiled kernel."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kern = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)E)?E", mangled)
            name = (f"{kern.group(1)}<{'float' if kern.group(2) == 'f' else 'bf16'}"
                    f"{',' + kern.group(3) if kern.group(3) else ''}>") if kern else mangled
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name]["stack_bytes"] = int(m.group(1))
            out[name]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.models import lm
    from repro_torch.runtime.server import LMServer, Request, ServeStats, _bucket

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    smi = nvidia_smi_line()

    # -- 1. device and toolchain ------------------------------------------
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()[-2:]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    emit("toolchain", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_v,
         python=sys.version.split()[0], triton=triton_v)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build_s = time.perf_counter() - t0
    build.library()
    emit("build", seconds=round(build_s, 3), library=str(lib_path.relative_to(ROOT)),
         flags=build.FLAGS, ptxas=ptxas_report(build.build_log()))

    # -- 3. kernels against their plain versions on the card ---------------
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errors: dict[str, float] = {}

    def check(kernel: str, case: str, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        bad = int((err > ATOL + RTOL * want.float().abs()).sum())
        emit("check", kernel=kernel, case=case, max_abs_err=float(err.max()),
             tolerance=f"|d| <= {ATOL} + {RTOL}*|plain|", ok=bad == 0)
        if bad:
            raise AssertionError(f"{kernel} {case}: {bad} elements out of tolerance")
        errors[kernel] = max(errors.get(kernel, 0.0), float(err.max()))

    for rows in (8 * 512, 8):
        x, w = randn(rows, 2048), randn(2048, dtype=torch.float32)
        check("rmsnorm", f"({rows}, 2048)", rmsnorm(x, w), rmsnorm_plain(x, w))
    for b, s, h, kv, d, window in ((8, 512, 16, 2, 128, None), (2, 512, 32, 8, 120, 64)):
        q, k, v = randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d)
        check("flash_attention", f"B{b} S{s} H{h} KV{kv} D{d} causal window={window}",
              flash_attention(q, k, v, window=window),
              flash_attention_plain(q, k, v, window=window))
    b, h, kv, hd, c = 8, 16, 2, 128, 544
    q, kc, vc = randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd)
    for lens in (1, 100, 544, [1, 37, 100, 255, 256, 400, 543, 544]):
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} cache_len={lens}",
              decode_attention(q, kc, vc, clen), decode_attention_plain(q, kc, vc, clen))
    q, kc, vc = randn(4, 32, 120), randn(4, 300, 8, 120), randn(4, 300, 8, 120)
    clen = torch.tensor([300, 120, 64, 9], dtype=torch.int32, device=dev)
    check("decode_attention", "B4 H32 KV8 hd120 C300 per-sequence lengths window=64",
          decode_attention(q, kc, vc, clen, window=64),
          decode_attention_plain(q, kc, vc, clen, window=64))

    # -- 4. serving qwen2.5-3b at full width -------------------------------
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    server = LMServer(cfg, max_batch=8, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in server.params.parameters())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, n).tolist() for n in rng.integers(64, 401, 8)]
    reqs = [Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)]
    server.serve([Request(uid=i, prompt=p, max_new=2) for i, p in enumerate(prompts)])
    server.stats = ServeStats()                      # the warm-up round is not counted
    kernels = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
               "decode_attention": decode_attention}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = server.serve(reqs)
    serve_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    steps = np.array(server.stats.decode_step_s)
    summary = server.stats.summary()
    emit("serve", config=cfg.name, params=n_params, weights_dtype=str(server.params.embed.dtype),
         init_s=round(init_s, 3), serve_s=round(serve_s, 3),
         prompt_lens=[len(p) for p in prompts], bucket=_bucket(max(map(len, prompts))),
         completion_lens=[len(o.tokens) for o in outs],
         prefill_tok_per_s=summary["prefill_tok_per_s"],
         decode_tok_per_s=summary["decode_tok_per_s"], decode_steps=len(steps),
         decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3),
         decode_step_p90_ms=float(np.percentile(steps, 90) * 1e3),
         prefill_s=server.stats.prefill_s, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches)
    for o in outs:
        if not 1 <= len(o.tokens) <= 32 or not all(0 <= t < cfg.padded_vocab for t in o.tokens):
            raise AssertionError(f"request {o.uid}: bad completion {o.tokens}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the serving path launched no {missing} kernel")

    # -- 5. A/B: oracle route vs kernel route, lockstep --------------------
    params = server.params
    ab = prompts[:2]
    bucket = _bucket(max(map(len, ab)))
    toks = np.zeros((2, bucket), np.int64)
    for i, p in enumerate(ab):
        toks[i, bucket - len(p):] = p
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    with torch.no_grad():
        runs = {impl: lm.prefill(cfg, params, batch, capacity=bucket + 8, impl=impl)
                for impl in (None, "ref")}
        diffs, margins, parted, agree = [], [], [False, False], [0, 0]
        for step in range(8):
            lk, lr = runs[None][0][:, -1].float(), runs["ref"][0][:, -1].float()
            diffs.append(float((lk - lr).abs().max()))
            top2 = torch.topk(lr, 2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            margins.append(min(margin))
            tk, tr = lk.argmax(-1).tolist(), lr.argmax(-1).tolist()
            for i in range(2):
                if parted[i]:
                    continue
                if tk[i] == tr[i]:
                    agree[i] += 1
                elif margin[i] < TIE_MARGIN:
                    parted[i] = True
                else:
                    raise AssertionError(f"A/B: row {i} step {step}: tokens {tk[i]} vs {tr[i]}"
                                         f" at top-2 margin {margin[i]}")
            if diffs[-1] > LOGIT_TOL:
                raise AssertionError(f"A/B: step {step}: logits differ by {diffs[-1]}")
            feed = torch.tensor(tr, device=dev)[:, None]     # both routes get the oracle's
            runs = {impl: lm.decode_step(cfg, params, runs[impl][1], feed, impl=impl)
                    for impl in runs}
    emit("ab", requests=2, steps=8, max_abs_logit_diff=diffs, logit_tol=LOGIT_TOL,
         min_top2_margin=margins, tie_margin=TIE_MARGIN, tokens_agreeing=agree,
         parted_at_near_tie=parted, logits_abs_max=float(lr.abs().max()))

    # -- 6. times at the serving shapes ------------------------------------
    def timed(fn, arg_sets, iters=50) -> float:
        """Device ms a call: the kernel time ``torch.profiler`` records over
        ``iters`` calls cycling through the input copies in ``arg_sets``
        (chosen to overflow the L2 cache).  Device time, not events around
        the loop: a small kernel finishes faster than the host issues the
        next, and events would time the host."""
        for args in arg_sets:
            fn(*args)
        torch.cuda.synchronize()
        for _ in range(3):          # a profiler window now and then records nothing
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for i in range(iters):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
            us = sum(e.device_time_total for e in p.key_averages()
                     if str(e.device_type).endswith("CUDA"))
            if us > 0:
                return us / iters / 1e3
        raise RuntimeError("the profiler recorded no kernel time in 3 windows")

    def copies(make, nbytes):
        return [make() for _ in range(max(2, min(32, -(-2 * L2_BYTES // nbytes))))]

    def bound(nbytes, flops, flop_rate):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    times = {}
    rows = []
    for shape in ((8, 2048), (8 * 512, 2048)):
        n = shape[0] * shape[1]
        nbytes = 2 * n * 2 + 2048 * 4
        sets = copies(lambda: (randn(*shape), randn(2048, dtype=torch.float32)), nbytes)
        b_ms, b_by = bound(nbytes, 4 * n, F32_FLOP_PER_S)
        times[f"rmsnorm {shape}"] = dict(
            ms=timed(lambda x, w: rmsnorm(x, w), sets),
            plain_ms=timed(lambda x, w: rmsnorm_plain(x, w), sets),
            library_ms=timed(lambda x, w: F.rms_norm(x, (2048,), w, 1e-5), sets),
            library_bf16_weight_ms=timed(lambda x, w: F.rms_norm(x, (2048,), w.to(bf16), 1e-5),
                                         sets),
            bound_ms=b_ms, bound_by=b_by)
    rows.append(("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11", times["rmsnorm (8, 2048)"]))

    b, s, h, kv, d = 8, 512, 16, 2, 128
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)
    sets = copies(lambda: (randn(b, s, h, d), randn(b, s, kv, d), randn(b, s, kv, d)), nbytes)
    live_pairs = s * (s + 1) // 2                       # causal
    b_ms, b_by = bound(nbytes, 4 * d * b * h * live_pairs, BF16_FLOP_PER_S)
    times["flash_attention"] = dict(
        ms=timed(lambda q, k, v: flash_attention(q, k, v), sets, iters=10),
        plain_ms=timed(lambda q, k, v: flash_attention_plain(q, k, v), sets, iters=10),
        library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True), sets, iters=10),
        bound_ms=b_ms, bound_by=b_by)
    rows.append(("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:28", times["flash_attention"]))

    b, h, kv, hd, c = 8, 16, 2, 128, 544
    clen = torch.tensor(c, dtype=torch.int32, device=dev)   # the round's last step
    nbytes = 2 * (2 * b * h * hd + 2 * b * c * kv * hd)
    sets = copies(lambda: (randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd)), nbytes)
    b_ms, b_by = bound(nbytes, 4 * hd * h * b * c, BF16_FLOP_PER_S)
    times["decode_attention"] = dict(
        ms=timed(lambda q, k, v: decode_attention(q, k, v, clen), sets),
        plain_ms=timed(lambda q, k, v: decode_attention_plain(q, k, v, clen), sets),
        library_ms=timed(lambda q, k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True), sets),
        bound_ms=b_ms, bound_by=b_by)
    rows.append(("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:45", times["decode_attention"]))
    # how decode attention scales: over the batch (blocks on the card) and
    # the live cache (32 slots is one chunk of one warp), inputs warm in L2
    scaling = {}
    for b in (8, 64):
        for n in (32, 544):
            args = (randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd),
                    torch.tensor(n, dtype=torch.int32, device=dev))
            scaling[f"B{b} cache_len {n}"] = timed(decode_attention, [args])
    emit("decode_attention_scaling", ms=scaling, shape=f"H{h} KV{kv} hd{hd} C{c} bf16")
    emit("times", shapes={"rmsnorm": "(8, 2048) decode, (4096, 2048) prefill, bf16",
                          "flash_attention": "B8 S512 H16 KV2 D128 causal bf16",
                          "decode_attention": "B8 H16 KV2 hd128 C544 cache_len 544 bf16"},
         times=times, card=smi)

    # -- 7. where a decode step's device time goes -------------------------
    with torch.no_grad():
        full = {"tokens": torch.from_numpy(
            np.stack([np.resize(p, 512) for p in prompts])).to(dev)}
        _, cache = lm.prefill(cfg, params, full, capacity=512 + 8)
        feed = torch.zeros((8, 1), dtype=torch.long, device=dev)
        lm.decode_step(cfg, params, cache, feed)
        torch.cuda.synchronize()
        n_steps = 4
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in kern) / n_steps
    top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:10]
    emit("profile", what="decode_step, qwen2.5-3b, B8, cache 520", steps=n_steps,
         wall_ms_per_step=wall_ms, device_busy_ms_per_step=busy_us / 1e3,
         device_idle_share=max(0.0, 1 - busy_us / 1e3 / wall_ms),
         top_kernels=[{"name": e.key[:90], "ms_per_step": e.device_time_total / n_steps / 1e3,
                       "calls_per_step": e.count / n_steps} for e in top])

    # -- 8. the record of the kernels, the card, the result -----------------
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"]} for name, source, replaces, t in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
