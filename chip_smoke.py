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
    shapes the serving paths give it (and danube's head shapes): the fused
    attention-sublayer chain in the growing, boundary and wrapped ring
    states, the SSD scan at mamba2-370m's prefill and at a ragged length;
 4. serving: the port's ``LMServer`` on qwen2.5-3b and on mamba2-370m, each
    at full width, random weights from a seed, 8 requests of 64-400 prompt
    tokens, 32 new tokens each; the launch counts are reset just before
    each round and read just after, and every kernel of that path must
    have launched (the qwen decode step through the fused chain, never
    through `_composed_step`);
 5. A/B, for each model: two of those requests through the oracle route
    (``impl="ref"``) and the kernel route in lockstep; logits must agree
    within the stated tolerance at every step, tokens up to the first
    near-tie (mamba2-370m in float32, beside the spread that a change of
    summation order alone gives its stack in bf16 and in float32);
 6. times: each kernel's device time at its serving shape (from
    ``torch.profiler``, over many launches on input copies that overflow
    the L2 cache), beside its bound, its plain version and one library
    call that computes the same function (for the fused chain, whose
    function no single PyTorch call computes, the yardstick is
    `_composed_step`), and how decode attention's time scales with the
    batch and the live cache;
 7. where a decode step's device time goes, for each model, from
    ``torch.profiler``, and the device's idle share against the wall time
    of unprofiled steps;
 8. the ``kernels`` record, the card's name and power limit, and last the
    result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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
# the SSD scan's float32 state against the plain version's: both sum float32
# products of the same bf16 inputs in another order, so an entry may be off by
# ~1e-4 of the largest one (STATE_ATOL is taken of the state's largest value)
STATE_ATOL = STATE_RTOL = 1e-4
# kernel route vs oracle route, bf16 logits after 36 layers: eight bf16 steps
# at the logits' magnitude (~4); a greedy token may part where the oracle's
# top-2 margin is under twice that, since each side may move by LOGIT_TOL
LOGIT_TOL = 0.25
TIE_MARGIN = 2 * LOGIT_TOL
# mamba2-370m's A/B runs its full width and depth in float32: in bf16 the
# random 48-layer stack carries a mere change of summation order into logits
# as different as the logits themselves (the oracle against itself with its
# chunk halved; phase 5 prints that spread for both dtypes).  In float32 that
# spread is ~0.006 at logits of magnitude ~2.5; the kernel route (the scan
# and norms summing in their own order) is held to 8 times it.
MAMBA_LOGIT_TOL = 0.05


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
    t_start = time.perf_counter()
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
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_decode import (fused_decode, fused_decode_plain,
                                                  out_residual, qkv_rope)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
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

    def check(kernel: str, case: str, got, want, atol=ATOL, rtol=RTOL):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        bad = int((err > atol + rtol * want.float().abs()).sum())
        emit("check", kernel=kernel, case=case, max_abs_err=float(err.max()),
             tolerance=f"|d| <= {atol} + {rtol}*|plain|", ok=bad == 0)
        if bad:
            raise AssertionError(f"{kernel} {case}: {bad} elements out of tolerance")
        errors[kernel] = max(errors.get(kernel, 0.0), float(err.max()))

    # qwen's width (2048) and mamba2-370m's (1024), whose block is half as wide
    for rows, d in ((8 * 512, 2048), (8, 2048), (8 * 512, 1024), (8, 1024)):
        x, w = randn(rows, d), randn(d, dtype=torch.float32)
        check("rmsnorm", f"({rows}, {d})", rmsnorm(x, w), rmsnorm_plain(x, w))
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

    # the fused chain: qwen's sublayer (with bias) in the growing (C544 pos
    # 300), boundary (C64 pos 64) and wrapped (C64 pos 200) ring states,
    # and danube's (no bias, hd 120)
    def sublayer(b, d, h, kv, hd, c, bias):
        def mat(*shape, fan=None):
            return (torch.randn(shape, generator=gen, device=dev) *
                    (fan ** -0.5 if fan else 1.0)).to(bf16)
        w = dict(norm=1.0 + 0.1 * randn(d, dtype=torch.float32),
                 wq=mat(d, h * hd, fan=d), wk=mat(d, kv * hd, fan=d), wv=mat(d, kv * hd, fan=d),
                 wo=mat(h * hd, d, fan=h * hd), bq=mat(h * hd, fan=100) if bias else None,
                 bk=mat(kv * hd, fan=100) if bias else None,
                 bv=mat(kv * hd, fan=100) if bias else None)
        return (randn(b, 1, d), randn(b, c, kv, hd), randn(b, c, kv, hd),
                dict(w, n_heads=h, head_dim=hd, eps=1e-6, theta=1e6, scale=hd ** -0.5))

    for label, (d, h, kv, hd, bias) in (("qwen", (2048, 16, 2, 128, True)),
                                         ("danube", (3840, 32, 8, 120, False))):
        for c, pos in ((544, 300), (64, 64), (64, 200)):
            x, kc, vc, kw = sublayer(8, d, h, kv, hd, c, bias)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            want, k_new, v_new = fused_decode_plain(x[:, 0], kc, vc, p, **kw)
            k0, v0 = kc.clone(), vc.clone()
            got = fused_decode(x, kc, vc, p, **kw)
            case = f"{label} B8 D{d} H{h} KV{kv} hd{hd} bias={bias} C{c} pos {pos}"
            check("fused_decode", case + ": out", got[:, 0], want)
            check("fused_decode", case + ": slot k", kc[:, pos % c], k_new)
            check("fused_decode", case + ": slot v", vc[:, pos % c], v_new)
            rest = [i for i in range(c) if i != pos % c]
            if not (torch.equal(kc[:, rest], k0[:, rest]) and torch.equal(vc[:, rest], v0[:, rest])):
                raise AssertionError(f"fused_decode {case}: a slot other than pos % C changed")

    # the SSD scan at mamba2-370m's prefill (B8 L512 H32 P64 N128) and a
    # ragged length; b and c are strided slices of one projection, as there.
    # Short memory (dt ~ 0.8, a ~ -1: the state decays ~e^-50 over a chunk of
    # 64) checks the work within a chunk; long memory (dt ~ 0.02, a ~ -0.14,
    # as trained Mamba2 steps are: the state lives for hundreds of tokens)
    # checks the state carried from chunk to chunk.
    def ssd_inputs(b, L, h=32, p=64, n=128, memory="short"):
        bc = randn(b, L, 2 * n + h)
        shift, log_a = (0.0, 0.0) if memory == "short" else (4.0, -2.0)
        return (randn(b, L, h, p), F.softplus(randn(b, L, h, dtype=torch.float32) - shift),
                -torch.exp(log_a + 0.5 * randn(h, dtype=torch.float32)), bc[..., :n],
                bc[..., n:2 * n])

    for L, memory in ((512, "short"), (300, "short"), (512, "long")):
        args = ssd_inputs(8, L, memory=memory)
        (y, s), (want_y, want_s) = ssd_scan(*args), ssd_scan_plain(*args, chunk=128)
        case = f"B8 L{L} H32 P64 N128 bf16, chunk 128, {memory} memory"
        check("ssd_scan", case + ": y", y, want_y)
        check("ssd_scan", case + ": state (float32)", s, want_s, STATE_ATOL * float(
            want_s.abs().max()), STATE_RTOL)

    # -- 4. serving at full width -------------------------------------------
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 401, 8)

    def serve(name, kernels):
        """A warm-up round, then one counted round with every launch count
        reset just before and read just after; each must be above 0."""
        cfg = get_config(name)
        t0 = time.perf_counter()
        server = LMServer(cfg, max_batch=8, seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in server.params.parameters())
        prompts = [np.random.default_rng(n).integers(2, cfg.vocab, n).tolist()
                   for n in prompt_lens]
        reqs = [Request(uid=i, prompt=p, max_new=32) for i, p in enumerate(prompts)]
        server.serve([Request(uid=i, prompt=p, max_new=2) for i, p in enumerate(prompts)])
        server.stats = ServeStats()                  # the warm-up round is not counted
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = server.serve(reqs)
        serve_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        steps = np.array(server.stats.decode_step_s)
        summary = server.stats.summary()
        emit("serve", config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
             params=n_params, weights_dtype=str(server.params.embed.dtype),
             init_s=round(init_s, 3), serve_s=round(serve_s, 3),
             prompt_lens=[len(p) for p in prompts], bucket=_bucket(max(map(len, prompts))),
             completion_lens=[len(o.tokens) for o in outs],
             prefill_tok_per_s=summary["prefill_tok_per_s"],
             decode_tok_per_s=summary["decode_tok_per_s"], decode_steps=len(steps),
             decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3),
             decode_step_p90_ms=float(np.percentile(steps, 90) * 1e3),
             prefill_s=server.stats.prefill_s,
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
        for o in outs:
            if not 1 <= len(o.tokens) <= 32 or not all(0 <= t < cfg.padded_vocab
                                                         for t in o.tokens):
                raise AssertionError(f"{name} request {o.uid}: bad completion {o.tokens}")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"the {name} serving path launched no {missing} kernel")
        return cfg, server.params, prompts, launches

    # `_composed_step` counts its own calls: both qwen rounds must make none
    fd._composed_step.calls = 0
    cfg, params, prompts, launches = serve("qwen2.5-3b", {
        "rmsnorm": rmsnorm, "flash_attention": flash_attention,
        "fused_qkv_rope": qkv_rope, "decode_attention": decode_attention,
        "fused_out_residual": out_residual})
    emit("composed_step", config=cfg.name, calls=fd._composed_step.calls)
    if fd._composed_step.calls or launches["fused_qkv_rope"] != launches["fused_out_residual"]:
        raise AssertionError(f"the qwen decode step left the fused chain: {launches}, "
                             f"_composed_step called {fd._composed_step.calls} times")
    m_cfg, m_params, m_prompts, m_launches = serve(
        "mamba2-370m", {"rmsnorm": rmsnorm, "ssd_scan": ssd_scan})

    # -- 5. A/B: oracle route vs kernel route, lockstep --------------------
    def ab(cfg, params, prompts, tol_of):
        """Prefill and 8 decode steps of two requests through both routes,
        each fed the oracle's tokens; ``tol_of(ref_logits)`` is the bound on
        the logits' difference at a step, twice it the near-tie margin."""
        ab = prompts[:2]
        bucket = _bucket(max(map(len, ab)))
        toks = np.zeros((2, bucket), np.int64)
        for i, p in enumerate(ab):
            toks[i, bucket - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        with torch.no_grad():
            runs = {impl: lm.prefill(cfg, params, batch, capacity=bucket + 8, impl=impl)
                    for impl in (None, "ref")}
            diffs, tols, margins, parted, agree = [], [], [], [False, False], [0, 0]
            for step in range(8):
                lk, lr = runs[None][0][:, -1].float(), runs["ref"][0][:, -1].float()
                diffs.append(float((lk - lr).abs().max()))
                tols.append(tol_of(lr))
                top2 = torch.topk(lr, 2, dim=-1).values
                margin = (top2[:, 0] - top2[:, 1]).tolist()
                margins.append(min(margin))
                tk, tr = lk.argmax(-1).tolist(), lr.argmax(-1).tolist()
                for i in range(2):
                    if parted[i]:
                        continue
                    if tk[i] == tr[i]:
                        agree[i] += 1
                    elif margin[i] < 2 * tols[-1]:
                        parted[i] = True
                    else:
                        raise AssertionError(f"A/B {cfg.name}: row {i} step {step}: tokens "
                                             f"{tk[i]} vs {tr[i]} at top-2 margin {margin[i]}")
                if diffs[-1] > tols[-1]:
                    raise AssertionError(f"A/B {cfg.name}: step {step}: logits differ by "
                                         f"{diffs[-1]} > {tols[-1]}")
                feed = torch.tensor(tr, device=dev)[:, None]  # both routes get the oracle's
                runs = {impl: lm.decode_step(cfg, params, runs[impl][1], feed, impl=impl)
                        for impl in runs}
        emit("ab", config=cfg.name, requests=2, steps=8, max_abs_logit_diff=diffs,
             logit_tol=tols, min_top2_margin=margins, tie_margin=[2 * t for t in tols],
             tokens_agreeing=agree, parted_at_near_tie=parted,
             logits_abs_max=float(lr.abs().max()))

    ab(cfg, params, prompts, lambda ref_logits: LOGIT_TOL)

    def order_only_spread(cfg, params, prompts):
        """Largest prefill-logit difference between the oracle route and the
        same route with the chunk of its scan halved (64): what a change of
        summation order alone does to this stack."""
        bucket = _bucket(max(map(len, prompts[:2])))
        toks = np.zeros((2, bucket), np.int64)
        for i, p in enumerate(prompts[:2]):
            toks[i, bucket - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        ssd = ops.ssd
        with torch.no_grad():
            want, _ = lm.prefill(cfg, params, batch, impl="ref")
            ops.ssd = lambda *a, impl=None, chunk=128: ssd(*a, impl=impl, chunk=64)
            try:
                got, _ = lm.prefill(cfg, params, batch, impl="ref")
            finally:
                ops.ssd = ssd
        return float((got.float() - want.float()).abs().max()), float(want.abs().max())

    m32_cfg = dataclasses.replace(m_cfg, compute_dtype="float32")
    m32_params = lm.init_params(m32_cfg, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0))
    spread = {name: order_only_spread(c, p, m_prompts)
              for name, c, p in (("bfloat16", m_cfg, m_params),
                                 ("float32", m32_cfg, m32_params))}
    emit("order_only_spread", config=m_cfg.name, what="oracle route, scan chunk 64 vs 128, "
         "prefill logits of 2 requests", max_abs_logit_diff_and_logits_abs_max=spread)
    ab(m32_cfg, m32_params, m_prompts, lambda ref_logits: MAMBA_LOGIT_TOL)
    del m32_params

    # -- 6. times at the serving shapes ------------------------------------
    def timed_by_kernel(fn, arg_sets, iters=50) -> dict:
        """Device ms a call, by kernel name: the kernel time ``torch.profiler``
        records over ``iters`` calls cycling through the input copies in
        ``arg_sets`` (chosen to overflow the L2 cache).  Device time, not
        events around the loop: a small kernel finishes faster than the
        host launches the next, and events would time the host."""
        for args in arg_sets:
            fn(*args)
        torch.cuda.synchronize()
        for _ in range(3):          # a profiler window now and then records nothing
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for i in range(iters):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
            by = {e.key[:80]: e.device_time_total / iters / 1e3 for e in p.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.device_time_total > 0}
            if by:
                return by
        raise RuntimeError("the profiler recorded no kernel time in 3 windows")

    def timed(fn, arg_sets, iters=50) -> float:
        return sum(timed_by_kernel(fn, arg_sets, iters).values())

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

    # the fused chain at qwen's decode, the round's last step (pos 543, so
    # cache_len 544 of C 544); the bound reads the weights, the biases and
    # the live cache once, x in, out and the new rows out
    d, b, h, kv, hd, c = 2048, 8, 16, 2, 128, 544
    n_w = d * (h + 2 * kv) * hd + h * hd * d
    nbytes = 2 * (n_w + (h + 2 * kv) * hd + 2 * b * c * kv * hd + 2 * b * d + 2 * b * kv * hd)
    sets = copies(lambda: sublayer(b, d, h, kv, hd, c, True), nbytes)
    pos = torch.tensor(c - 1, dtype=torch.int32, device=dev)
    b_ms, b_by = bound(nbytes, 2 * b * n_w + 4 * b * h * hd * c, BF16_FLOP_PER_S)
    chain = timed_by_kernel(lambda x, k, v, kw: fused_decode(x, k, v, pos, **kw), sets)
    times["fused_decode"] = dict(
        ms=sum(chain.values()), ms_by_kernel=chain,
        plain_ms=timed(lambda x, k, v, kw: fused_decode_plain(x[:, 0], k, v, pos, **kw), sets),
        library_ms=None,
        yardstick_ms=timed(lambda x, k, v, kw: fd._composed_step(x, k, v, pos, **kw), sets),
        yardstick="_composed_step: cuBLAS GEMVs and torch elementwise ops around the port's "
                  "rmsnorm and decode-attention kernels (no single PyTorch call computes "
                  "the sublayer)",
        bound_ms=b_ms, bound_by=b_by)
    rows.append(("fused_decode", "src/repro_torch/kernels/csrc/fused_decode.cu",
                 "src/repro/kernels/fused_decode.py:91", times["fused_decode"]))

    # the SSD scan at mamba2-370m's prefill; operations as the kernel's
    # chunks of 64 need them: C.B^T, W x, C S^T and the state update
    b, L, h, p, n, q = 8, 512, 32, 64, 128, 64
    nbytes = 2 * (2 * b * L * h * p + 2 * b * L * n) + 4 * (b * L * h + h + b * h * p * n)
    sets = copies(lambda: ssd_inputs(b, L), nbytes)
    flops = 2 * b * h * (L // q) * (q * q * n + q * q * p + 2 * q * p * n)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    times["ssd_scan"] = dict(
        ms=timed(lambda *a: ssd_scan(*a), sets, iters=10),
        plain_ms=timed(lambda *a: ssd_scan_plain(*a, chunk=128), sets, iters=10),
        library_ms=None, library="none: no PyTorch call computes the SSD scan",
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    rows.append(("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:27", times["ssd_scan"]))
    emit("times", shapes={"rmsnorm": "(8, 2048) decode, (4096, 2048) prefill, bf16",
                          "flash_attention": "B8 S512 H16 KV2 D128 causal bf16",
                          "decode_attention": "B8 H16 KV2 hd128 C544 cache_len 544 bf16",
                          "fused_decode": "qwen sublayer B8 D2048 H16 KV2 hd128 bias C544 "
                                          "pos 543 bf16",
                          "ssd_scan": "B8 L512 H32 P64 N128 bf16"},
         times=times, card=smi)

    # -- 7. where a decode step's device time goes -------------------------
    def profile_decode(cfg, params, prompts):
        """Device busy a step from ``torch.profiler`` (the card alone, so the
        profiler adds no host work to the steps), and the idle share against
        the wall time of as many steps run with no profiler at all."""
        with torch.no_grad():
            full = {"tokens": torch.from_numpy(
                np.stack([np.resize(p, 512) for p in prompts])).to(dev)}
            _, cache = lm.prefill(cfg, params, full, capacity=512 + 8)
            feed = torch.zeros((8, 1), dtype=torch.long, device=dev)
            lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            n_steps = 8
            t0 = time.perf_counter()
            for _ in range(n_steps):
                lm.decode_step(cfg, params, cache, feed)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    lm.decode_step(cfg, params, cache, feed)
                torch.cuda.synchronize()
                profiled_wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.device_time_total for e in kern) / n_steps
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:10]
        emit("profile", what=f"decode_step, {cfg.name}, B8, cache 520", steps=n_steps,
             wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_wall_ms,
             device_busy_ms_per_step=busy_us / 1e3,
             device_idle_share=max(0.0, 1 - busy_us / 1e3 / wall_ms),
             kernel_launches_per_step=sum(e.count for e in kern) / n_steps,
             top_kernels=[{"name": e.key[:90],
                           "ms_per_step": e.device_time_total / n_steps / 1e3,
                           "calls_per_step": e.count / n_steps} for e in top])

    profile_decode(cfg, params, prompts)
    profile_decode(m_cfg, m_params, m_prompts)

    # -- 8. the record of the kernels, the card, the result -----------------
    # launches from the serving round that runs each kernel: qwen's for the
    # attention kernels and the chain (counted once a chain, by its first
    # kernel; its other two launched as often), mamba2-370m's for the scan
    cuda_kernels = {
        "rmsnorm": ["rmsnorm_kernel"], "flash_attention": ["flash_attention_kernel"],
        "decode_attention": ["decode_attention_kernel"],
        "fused_decode": ["fused_qkv_rope_kernel", "decode_attention_kernel",
                         "fused_out_residual_kernel"],
        "ssd_scan": ["ssd_scan_kernel"]}
    served = dict(launches, fused_decode=launches["fused_qkv_rope"],
                  ssd_scan=m_launches["ssd_scan"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "cuda_kernels": cuda_kernels[name], "launches": served[name],
         "max_abs_err": errors[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         **({"yardstick_ms": t["yardstick_ms"]} if "yardstick_ms" in t else {})}
        for name, source, replaces, t in rows]}), flush=True)
    emit("elapsed", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
