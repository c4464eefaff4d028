#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one CUDA card and checks it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Each phase
prints one JSON record on a line of its own; any failure raises and the
script exits non-zero without its result line.  The phases:

 1. device and toolchain: the card and its power limit, torch, CUDA, nvcc,
    scipy (the planner's ILP engine);
 2. build: the kernels from ``src/repro_torch/kernels/csrc``, with each
    kernel's registers, shared memory and spills from ptxas;
 3. every kernel against its plain version on the card, in bf16, at the
    shapes the serving paths give it (and danube's head shapes): rmsnorm
    in bf16 and float32 at widths 1024, 2048, 3840 and 1000 with 8, 4096
    and 5000 rows (5000: off its persistent grid), at a width off 16 bytes,
    one beyond its row kernel and an input off 16 bytes, and its gated form
    at mamba2-370m's decode and prefill with z strided as ``torch.chunk``
    gives it; flash
    attention also at a ragged length (S 129) and GQA 7, decode attention
    also at the edges of its cache splits, with splits left empty, calls
    back to back and calls on two streams at once (each stream has its own
    workspace), the fused attention-sublayer chain in the growing,
    boundary and wrapped ring states, the SSD scan at mamba2-370m's
    prefill, at a ragged length, at the edges of its own chunk of 64
    tokens (L 1, L 65) and at the reduced config's widths (P8 N16);
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
    summation order alone gives its stack in bf16 and in float32); and one
    mamba2-370m block at full width in bf16, prefill at the serving bucket
    and 4 decode steps, both routes;
 6. times: each kernel's device time at its serving shape (from
    ``torch.profiler``, over many launches on input copies that overflow
    the L2 cache), beside its bound, its plain version and one library
    call that computes the same function (for the fused chain, whose
    function no single PyTorch call computes, the yardstick is
    `_composed_step`); the chain's two GEMV launches as rows of their own
    (out_residual beside ``torch.addmm``, qkv_rope beside ``F.rms_norm`` +
    ``torch.addmm``); how decode attention's time scales with the batch and
    the live cache, with its split plan; and how the GEMVs' time scales
    with the batch, the width, one block alone, the split and the tile
    width (``gemv_scaling``); the SSD scan's time at B 1 and 8 and L 512
    and 2048, with the blocks an SM (``ssd_scaling``); rmsnorm at (8,
    1024), (8, 2048) and (4096, 2048) and its gated form at (8, 2048) and
    (4096, 2048), each beside an empty kernel on the same grid (the launch
    floor), and rmsnorm's time with other plans (``rmsnorm_scaling``);
 7. where a decode step's device time goes, for each model, from
    ``torch.profiler``, and the device's idle share against the wall time
    of unprofiled steps; the same for one mamba2-370m prefill at the
    serving bucket, with the scan's share of the device time;
 8. pipeline: the same 8 requests through ``LMServer(max_batch=4,
    pipeline=DecodePipeline(...))`` on the same weights, the plan from the
    port's planner on a decode shape (B 4, 512 tokens) priced on the H100,
    every slice placed on the one card: qwen2.5-3b with 9 layers a stage
    (embed, four block stages, head), unfused, fused (``"auto"``) and
    unfused with ``overlap=False``; mamba2-370m with 12 layers a stage.
    Each serve must give the tokens of the single-device
    ``LMServer(max_batch=4)`` exactly, run no program at a new (shape,
    thread, stream) inside the serve (``compile_stats.late == 0``: the
    warm-up ran each on the worker thread and stream its ops run on),
    launch every kernel of its path (counts reset just before the serve,
    read just after) and, overlapped, run on more than one stream.
    Printed beside the single-device serve: tok/s, wall time, ``slo()``,
    the engine's in-flight high water, stage seconds and firings,
    launches a generated token, peak memory and the memory a serve leaves
    allocated; for qwen2.5-3b's unfused pipeline, one more serve,
    profiled (the device's busy time, the union of kernel intervals over
    all streams, and idle share) and traced (each stage's waits); and the
    phase's own seconds (this phase runs after 6 and 7: run before them,
    it left the profiler recording less kernel time there);
 9. the ``kernels`` record, the card's name and power limit, and last the
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
# the same in float32 (the norms): both sum float32 squares in another order
F32_TOL = 2e-5
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
# one mamba2-370m block in bf16, kernel route vs oracle route: its output
# within ATOL + RTOL |ref|, two bf16 steps at its magnitude.  Both routes
# round it once to bf16; what differs inside (the order of the scan's and
# the norms' sums, moving single bf16 roundings of y and of the normalised
# gate) reaches it through w_out, a sum of 2048 inputs at weights ~2048^-1/2.


def emit(phase: str, **record) -> None:
    print(json.dumps({"phase": phase, **record}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """``decode_attention_kernel<bf16,4>`` from an Itanium-mangled kernel
    name (nested in nvcc's per-file anonymous namespace), with its template
    arguments (float, bf16, an int or a bool as 0/1); the mangled name where
    it does not parse."""
    i, name = 3, None
    if not mangled.startswith("_ZN"):
        return mangled
    while (m := re.match(r"\d+", mangled[i:])):       # <length><identifier> ...
        start = i + m.end()
        name, i = mangled[start:start + int(m.group())], start + int(m.group())
    if name is None or not mangled.startswith("I", i):
        return name or mangled
    args, i = [], i + 1
    while (t := re.match(r"L[ib](-?\d+)E|f|13__nv_bfloat16", mangled[i:])):
        args.append(t.group(1) or {"f": "float"}.get(t.group(0), "bf16"))
        i += t.end()
    return f"{name}<{','.join(args)}>" if mangled.startswith("E", i) else mangled


def ptxas_report(log: str) -> dict:
    """Registers, shared memory and spills of each compiled kernel."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fused_decode as fd
    from repro_torch.kernels.decode_attention import (decode_attention, decode_attention_plain,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_decode import (fused_decode, fused_decode_plain,
                                                  out_residual, qkv_rope)
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_gated, rmsnorm_gated_plain,
                                             rmsnorm_plain)
    from repro_torch.kernels.ssd_scan import blocks_per_sm, ssd_scan, ssd_scan_plain
    from repro_torch.analysis.roofline import HW_H100
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    from repro_torch.models import blocks, lm
    from repro_torch.runtime.pipeline import DecodePipeline, Tracer, stall_bottleneck
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
    try:
        import scipy
        scipy_v = scipy.__version__
    except ImportError:
        scipy_v = None
    emit("toolchain", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_v,
         python=sys.version.split()[0], triton=triton_v, scipy=scipy_v)

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

    # the norms: mamba2-370m's width (1024), qwen's (2048), danube's (3840)
    # and 1000 (a ragged number of 16-byte pieces a lane) at decode and
    # prefill rows and at 5000 (rows off the persistent grid); widths off 16
    # bytes (1001) and beyond the row kernel (20000), an input off 16 bytes
    def norm_check(case, x, w):
        tol = ATOL if x.dtype == bf16 else F32_TOL
        check("rmsnorm", f"{case} {x.dtype}", rmsnorm(x, w), rmsnorm_plain(x, w), tol, tol)

    for dtype in (bf16, torch.float32):
        for d in (1024, 2048, 3840, 1000):
            for rows in (8, 8 * 512, 5000):
                norm_check(f"({rows}, {d})", randn(rows, d, dtype=dtype),
                           randn(d, dtype=torch.float32))
        for rows, d in ((3, 1001), (2, 20000)):
            norm_check(f"({rows}, {d})", randn(rows, d, dtype=dtype), randn(d, dtype=torch.float32))
        norm_check("(8, 2048) off 16 bytes", randn(8 * 2048 + 1, dtype=dtype)[1:].view(8, 2048),
                   randn(2048, dtype=torch.float32))

    # the gated form at mamba2-370m's decode (8 rows) and prefill (8 x 512),
    # H32 P64, z the second half of the in-projection (rows 4096 apart); and
    # mamba2-2.7b's width (5120), beyond the row kernel
    def gated_inputs(lead, h=32, p=64, dtype=bf16):
        return (randn(*lead, h, p, dtype=dtype), randn(*lead, h, p, dtype=dtype),
                1.0 + 0.1 * randn(h, dtype=torch.float32),
                torch.chunk(randn(*lead, 2 * h * p, dtype=dtype), 2, dim=-1)[1],
                1.0 + 0.1 * randn(h * p, dtype=torch.float32))

    for dtype in (bf16, torch.float32):
        tol = ATOL if dtype == bf16 else F32_TOL
        for lead, h in (((8,), 32), ((8, 512), 32), ((2, 3), 80)):
            args = gated_inputs(lead, h, dtype=dtype)
            check("rmsnorm_gated", f"{lead} H{h} P64 {dtype}, z rows {args[3].stride(-2)} apart",
                  rmsnorm_gated(*args), rmsnorm_gated_plain(*args), tol, tol)
    # qwen's and danube's prefill, then a length off every tile (Sq 129) and GQA 7
    for b, s, h, kv, d, window in ((8, 512, 16, 2, 128, None), (2, 512, 32, 8, 120, 64),
                                   (2, 129, 16, 2, 128, None), (2, 200, 14, 2, 128, None)):
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
    # the split edges of this shape's plan (L slots a split): cache_len at L -
    # 1, L and L + 1, a window straddling splits 1 and 2, per-sequence lengths
    # that leave whole splits empty; then those calls back to back on one
    # workspace, each result checked after the last (the merge counters reset)
    L = split_plan(b, kv, c, torch.cuda.get_device_properties(dev).multi_processor_count).length
    split_cases = [(L - 1, None), (L, None), (L + 1, None), (2 * L + 10, L),
                   ([1, L, 3 * L + 5, c, 2, L + 1, 100, 7 * L], None)]
    for lens, window in split_cases:
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} split {L}: cache_len={lens} "
              f"window={window}", decode_attention(q, kc, vc, clen, window=window),
              decode_attention_plain(q, kc, vc, clen, window=window))
    lens = [torch.tensor(n, dtype=torch.int32, device=dev) for n, _ in split_cases]
    outs = [decode_attention(q, kc, vc, n, window=w) for n, (_, w) in zip(lens, split_cases)]
    for n, (_, w), got in zip(lens, split_cases, outs):
        check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} back to back: "
              f"cache_len={n.tolist()} window={w}", got,
              decode_attention_plain(q, kc, vc, n, window=w))
    # two streams at once at this shape (the pipeline's stages and replicas
    # run decode attention so): each stream has its own partial sums and
    # merge counters; calls alternate between the streams, and every
    # result is checked after the last
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    calls = [[(randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd),
               torch.tensor(n, dtype=torch.int32, device=dev)) for n, _ in split_cases]
             for _ in streams]
    torch.cuda.synchronize()
    outs = [[], []]
    for i in range(len(split_cases)):
        for s_, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[s_].append(decode_attention(*calls[s_][i]))
    torch.cuda.synchronize()
    for s_ in range(2):
        for args, got in zip(calls[s_], outs[s_]):
            check("decode_attention", f"B{b} H{h} KV{kv} hd{hd} C{c} two streams at once, "
                  f"stream {s_}: cache_len={args[3].tolist()}", got,
                  decode_attention_plain(*args))
    del streams, calls, outs
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

    # then the edges of the kernel's own chunk of 64 tokens (L 1, L 65: a
    # second chunk of one token) and the reduced config's widths (H16 P8
    # N16: b and c rows 48 elements apart, padded inside one mma tile)
    for (b, L, h, p, n), memory in (((8, 512, 32, 64, 128), "short"),
                                    ((8, 300, 32, 64, 128), "short"),
                                    ((8, 512, 32, 64, 128), "long"),
                                    ((8, 1, 32, 64, 128), "long"),
                                    ((8, 65, 32, 64, 128), "long"),
                                    ((2, 100, 16, 8, 16), "long")):
        args = ssd_inputs(b, L, h, p, n, memory=memory)
        (y, s), (want_y, want_s) = ssd_scan(*args), ssd_scan_plain(*args, chunk=128)
        case = f"B{b} L{L} H{h} P{p} N{n} bf16, chunk 128, {memory} memory"
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
        "mamba2-370m", {"rmsnorm": rmsnorm, "rmsnorm_gated": rmsnorm_gated, "ssd_scan": ssd_scan})

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

    # one mamba2-370m block at full width in bf16: a prefill of 8 sequences
    # at the serving bucket, then 4 decode steps, each route on its own caches
    layer = blocks.Mamba(m_cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    bucket = _bucket(max(map(len, m_prompts)))
    xs = [randn(8, bucket, m_cfg.d_model)] + [randn(8, 1, m_cfg.d_model) for _ in range(4)]
    outs = {}
    with torch.no_grad():
        for impl in (None, "ref"):
            y, (conv, ssm) = layer(xs[0], impl=impl)
            cache = {"conv": conv.clone(), "ssm": ssm.clone()}
            outs[impl] = [y] + [layer.decode(t, cache, impl=impl)[0] for t in xs[1:]]
    diffs, bad = [], []
    for step, (got, want) in enumerate(zip(outs[None], outs["ref"])):
        err = (got.float() - want.float()).abs()
        diffs.append(float(err.max()))
        if (err > ATOL + RTOL * want.float().abs()).any():
            bad.append(step)
    emit("ab_layer", config=m_cfg.name, block="Mamba", dtype="bfloat16", batch=8,
         prefill_tokens=bucket, decode_steps=4, max_abs_diff=diffs,
         out_abs_max=[float(o.float().abs().max()) for o in outs["ref"]],
         tolerance=f"|d| <= {ATOL} + {RTOL}*|ref|", ok=not bad)
    if bad:
        raise AssertionError(f"A/B of one {m_cfg.name} block in bf16: steps {bad} (0: the "
                             f"prefill) out of tolerance, largest differences {diffs}")
    del layer, outs

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

    def timed_with_norm_plan(plan, fn, arg_sets):
        """Device ms of ``fn`` with `norm_plan` swapped for one that returns
        ``plan``."""
        norm_plan = rn.norm_plan
        rn.norm_plan = lambda *_, **__: plan
        try:
            return timed(fn, arg_sets)
        finally:
            rn.norm_plan = norm_plan

    # the norms at the serving shapes: mamba2-370m's and qwen's decode rows,
    # qwen's prefill; each beside an empty kernel on the grid its plan takes.
    # The bound reads the rows and the weight once and writes the rows.
    card = rn.card_of(torch.cuda.current_device())
    times = {}
    rows = []
    norm_times = {}
    for shape in ((8, 1024), (8, 2048), (8 * 512, 2048)):
        n, d = shape[0] * shape[1], shape[1]
        nbytes = 2 * n * 2 + d * 4
        sets = copies(lambda: (randn(*shape), randn(d, dtype=torch.float32)), nbytes)
        plan = rn.norm_plan(*shape, 2, gated=False, aligned=True, card=card)
        b_ms, b_by = bound(nbytes, 4 * n, F32_FLOP_PER_S)
        norm_times[str(shape)] = dict(
            ms=timed(lambda x, w: rmsnorm(x, w), sets),
            plain_ms=timed(lambda x, w: rmsnorm_plain(x, w), sets),
            library_ms=timed(lambda x, w: F.rms_norm(x, (d,), w, 1e-5), sets),
            library_bf16_weight_ms=timed(lambda x, w: F.rms_norm(x, (d,), w.to(bf16), 1e-5),
                                         sets),
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets),
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(), bytes=nbytes)
    times["rmsnorm"] = dict(norm_times["(8, 2048)"], by_shape=norm_times)
    rows.append(("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11", times["rmsnorm"]))

    # the gated form at mamba2-370m's decode and prefill: the bound reads y,
    # xh, z (half of its projection's row), d_skip and the weight once and
    # writes the rows; the yardstick is what the block ran before it: the
    # torch ops of the body, then the norm kernel
    def unfused(y, xh, ds, z, w):
        g = y + xh * ds[:, None].to(xh.dtype)
        return rmsnorm(g.reshape(z.shape) * F.silu(z), w)

    gated_times = {}
    for lead in ((8,), (8, 512)):
        n_rows = int(np.prod(lead))
        n = n_rows * 2048
        nbytes = 4 * n * 2 + 2048 * 4 + 32 * 4
        sets = copies(lambda: gated_inputs(lead), nbytes + n * 2)
        plan = rn.norm_plan(n_rows, 2048, 2, gated=True, aligned=True, card=card)
        b_ms, b_by = bound(nbytes, 11 * n, F32_FLOP_PER_S)
        gated_times[f"({n_rows}, 2048)"] = dict(
            ms=timed(lambda *a: rmsnorm_gated(*a), sets),
            plain_ms=timed(lambda *a: rmsnorm_gated_plain(*a), sets), library_ms=None,
            yardstick_ms=timed(unfused, sets),
            yardstick="the op-by-op torch body (5 launches) then the rmsnorm kernel",
            floor_ms=timed(lambda *_: rn.launch_floor(plan), sets),
            bound_ms=b_ms, bound_by=b_by, plan=plan._asdict(), bytes=nbytes)
    times["rmsnorm_gated"] = dict(gated_times["(8, 2048)"], by_shape=gated_times)
    rows.append(("rmsnorm_gated", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                 "src/repro/kernels/rmsnorm.py:11", times["rmsnorm_gated"]))

    # what sets the norm's time: the decode rows of mamba2-370m, qwen and the
    # gated form split over other warps a row (a block a row); qwen's prefill
    # with 1 and 2 blocks an SM and with no grid stride (1024 blocks of 4
    # rows, four waves), and with 4 and 8 warps a row; beside it a copy of
    # the same rows (``copy_``: the rate the memory gives one read and one
    # write stream of these bytes)
    norm_ms = {}
    for d, warps in ((1024, (1, 2, 4)), (2048, (2, 4, 8))):
        x_dec = [(randn(8, d), randn(d, dtype=torch.float32))]
        for w in warps:
            norm_ms[f"(8, {d}) {w} warps a row"] = timed_with_norm_plan(
                rn.NormPlan(w, d // 256 // w, 1, 8), rmsnorm, x_dec)
    g_dec = [gated_inputs((8,))]
    for w, u in ((4, 2), (8, 1)):
        norm_ms[f"gated (8, 2048) {w} warps a row"] = timed_with_norm_plan(
            rn.NormPlan(w, u, 1, 8), lambda *a: rmsnorm_gated(*a), g_dec)
    x_pre = copies(lambda: (randn(4096, 2048), randn(2048, dtype=torch.float32)), 2 * 4096 * 4096)
    for plan in ((2, 4, 4, card.sms), (2, 4, 4, 2 * card.sms), (2, 4, 4, 1024),
                 (4, 2, 2, 2 * card.sms), (8, 1, 1, 2 * card.sms)):
        norm_ms[f"(4096, 2048) {rn.NormPlan(*plan)}"] = timed_with_norm_plan(
            rn.NormPlan(*plan), rmsnorm, x_pre)
    norm_ms["(4096, 2048) copy_ of the rows"] = timed(
        lambda x, w: torch.empty_like(x).copy_(x), x_pre)
    # the same with every output kept, so no call writes where the last one
    # did (above, the allocator hands each call the block the last one
    # freed, whose lines may still sit in L2)
    kept = []
    norm_ms["(4096, 2048) outputs kept"] = timed(lambda x, w: kept.append(rmsnorm(x, w)), x_pre)
    kept.clear()
    norm_ms["(4096, 2048) copy_ of the rows, outputs kept"] = timed(
        lambda x, w: kept.append(torch.empty_like(x).copy_(x)), x_pre)
    kept.clear()
    gkept, g_pre = [], copies(lambda: gated_inputs((8, 512)), 4 * 4096 * 2048 * 2)
    norm_ms["gated (4096, 2048) outputs kept"] = timed(
        lambda *a: gkept.append(rmsnorm_gated(*a)), g_pre)
    emit("rmsnorm_scaling", ms=norm_ms, sms=card.sms, card=smi)
    del x_pre, g_pre, gkept

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
    # what sets its time: twice the key tiles (not causal); one head of one
    # sequence, 8 blocks whose longest walks 8 key tiles; one block, one tile
    lone = [tuple(randn(1, n, 1, d) for _ in range(3)) for n in (512, 64)]
    emit("flash_attention_scaling", ms={
        "B8 S512 H16 KV2 D128 not causal": timed(
            lambda q, k, v: flash_attention(q, k, v, causal=False), sets, iters=10),
        "B1 S512 H1 KV1 D128 causal": timed(flash_attention, lone[:1], iters=10),
        "B1 S64 H1 KV1 D128 causal": timed(flash_attention, lone[1:], iters=10)})

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
    # the live cache (32 slots: one stage of one split), inputs warm in L2,
    # and at cache_len 544 with the plan's split length halved and doubled
    def timed_with_plan(plan, args):
        """Device ms of decode attention with `split_plan` swapped for one
        that returns ``plan``."""
        da.split_plan = lambda *_: plan
        try:
            return timed(decode_attention, [args])
        finally:
            da.split_plan = split_plan

    scaling, splits, other_plans = {}, {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (8, 64):
        plan = split_plan(b, kv, c, sms)
        splits[f"B{b}"] = {"length": plan.length, "splits": plan.splits,
                           "blocks": b * kv * plan.splits}
        for n in (32, 544):
            args = (randn(b, h, hd), randn(b, c, kv, hd), randn(b, c, kv, hd),
                    torch.tensor(n, dtype=torch.int32, device=dev))
            scaling[f"B{b} cache_len {n}"] = timed(decode_attention, [args])
        for length in (plan.length // 2, plan.length * 2):
            other = da.SplitPlan(length, -(-c // length))
            if da.MIN_SPLIT <= length and other.splits <= da.MAX_SPLITS:
                other_plans[f"B{b} cache_len 544 L{length} S{other.splits}"] = \
                    timed_with_plan(other, args)
    # a lone split per (sequence, KV head) streaming 1 to 8 stages of 32 slots
    # (B8, splits of 256 slots, only the first live): a stage's time and the
    # fixed cost of a call
    qkv = (randn(8, h, hd), randn(8, c, kv, hd), randn(8, c, kv, hd))
    by_stages = {f"B8 L256 cache_len {n}": timed_with_plan(
        da.SplitPlan(256, -(-c // 256)), (*qkv, torch.tensor(n, dtype=torch.int32, device=dev)))
        for n in (1, 32, 64, 128, 256)}
    emit("decode_attention_scaling", ms=scaling, splits=splits, sms=sms,
         ms_other_splits=other_plans, ms_lone_split=by_stages,
         shape=f"H{h} KV{kv} hd{hd} C{c} bf16")

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

    # the chain's two GEMVs as rows of their own at the same shapes: qkv_rope
    # reads x, norm, the Q/K/V weights and biases once and writes q and the
    # new k and v rows; out_residual reads o, wo and x once and writes out
    def gemv_sets(b, d, h, kv, hd, bias=True):
        """qkv_rope's and out_residual's inputs, copies that overflow L2."""
        n_qkv = (h + 2 * kv) * hd
        qkv_bytes = 2 * (d * n_qkv + (n_qkv if bias else 0) + b * d + b * n_qkv) + 4 * d
        out_bytes = 2 * (h * hd * d + b * h * hd + 2 * b * d)

        def qkv_set():
            x, kc, vc, kw = sublayer(b, d, h, kv, hd, 64, bias)
            return x[:, 0], kc, vc, kw
        qkv = copies(qkv_set, qkv_bytes)
        out = copies(lambda: (randn(b, h * hd), randn(h * hd, d) * (h * hd) ** -0.5,
                              randn(b, d)), out_bytes)
        return qkv, qkv_bytes, out, out_bytes

    def run_qkv(x2, kc, vc, kw):
        return qkv_rope(x2, kc, vc, pos, norm=kw["norm"], wq=kw["wq"], wk=kw["wk"],
                        wv=kw["wv"], bq=kw["bq"], bk=kw["bk"], bv=kw["bv"],
                        n_heads=kw["n_heads"], eps=kw["eps"], theta=kw["theta"])

    def plain_qkv(x2, kc, vc, kw):
        return fd.qkv_plain(x2, pos, **{n: kw[n] for n in (
            "norm", "wq", "wk", "wv", "bq", "bk", "bv", "n_heads", "head_dim", "eps", "theta")})

    qkv_sets, qkv_bytes, out_sets, out_bytes = gemv_sets(b, d, h, kv, hd)
    # yardstick: F.rms_norm and one addmm over the concatenated weights
    # (two PyTorch calls; the rope and the slot write are left out)
    cat_sets = [(x2, kw["norm"].to(bf16), torch.cat([kw["wq"], kw["wk"], kw["wv"]], 1),
                 torch.cat([kw["bq"], kw["bk"], kw["bv"]])) for x2, _, _, kw in qkv_sets]
    qkv_b_ms, qkv_b_by = bound(qkv_bytes, 2 * b * d * (h + 2 * kv) * hd, BF16_FLOP_PER_S)
    out_b_ms, out_b_by = bound(out_bytes, 2 * b * h * hd * d, BF16_FLOP_PER_S)
    chain_parts = {
        "fused_qkv_rope": dict(
            ms=timed(run_qkv, qkv_sets), plain_ms=timed(plain_qkv, qkv_sets), library_ms=None,
            yardstick_ms=timed(lambda x2, nw, w, bb: torch.addmm(
                bb, F.rms_norm(x2, (d,), nw, 1e-6), w), cat_sets),
            yardstick="F.rms_norm + torch.addmm over wq|wk|wv (no rope, no slot write)",
            bound_ms=qkv_b_ms, bound_by=qkv_b_by, bytes=qkv_bytes),
        "fused_out_residual": dict(
            ms=timed(out_residual, out_sets), plain_ms=timed(fd.out_residual_plain, out_sets),
            library_ms=timed(lambda o, wo, x2: torch.addmm(x2, o, wo), out_sets),
            library="torch.addmm(x, o, wo)", bound_ms=out_b_ms, bound_by=out_b_by,
            bytes=out_bytes)}
    times["fused_decode"]["parts"] = chain_parts

    # what sets the GEMVs' time: qwen's and danube's widths at B 1 and 8,
    # with the split plans taken; one block alone streaming a 128-column
    # tile of 256 and of 2048 rows (out_residual, its plan swapped for one
    # split); qwen's B 8 with other split counts (clusters) than the plan's
    gemv_ms, gemv_plans = {}, {}
    for label, (d_, h_, kv_, hd_, bias_) in (("qwen", (2048, 16, 2, 128, True)),
                                             ("danube", (3840, 32, 8, 120, False))):
        for b_ in (1, 8):
            q_sets, _, o_sets, _ = gemv_sets(b_, d_, h_, kv_, hd_, bias_)
            key = f"{label} B{b_} D{d_}"
            gemv_ms[f"qkv_rope {key}"] = timed(run_qkv, q_sets)
            gemv_ms[f"out_residual {key}"] = timed(out_residual, o_sets)
            gemv_plans[f"qkv_rope {key}"] = dict(fd.gemv_plan(
                h_ + 2 * kv_, fd.tile_width(hd_), d_, 1, sms)._asdict(), tiles=h_ + 2 * kv_)
            gemv_plans[f"out_residual {key}"] = dict(fd.gemv_plan(
                -(-d_ // fd.OUT_WIDTH), fd.OUT_WIDTH, h_ * hd_, 1, sms)._asdict(),
                tiles=-(-d_ // fd.OUT_WIDTH))
            del q_sets, o_sets
    def timed_with_splits(splits, fn, arg_sets):
        """Device ms of ``fn`` with `gemv_plan` swapped for one of ``splits``
        splits."""
        plan = fd.gemv_plan

        def forced(tiles, width, rows, groups, sm_count):
            slice_ = -(-rows // splits)
            return fd.GemvPlan(width, -(-slice_ // 16) * 16 if splits > 1 else rows, splits)
        fd.gemv_plan = forced
        try:
            return timed(fn, arg_sets)
        finally:
            fd.gemv_plan = plan

    for k_ in (256, 2048):
        lone = [(randn(8, k_), randn(k_, fd.OUT_WIDTH) * k_ ** -0.5, randn(8, fd.OUT_WIDTH))]
        gemv_ms[f"out_residual one block B8 K{k_} N{fd.OUT_WIDTH}"] = timed_with_splits(
            1, out_residual, lone)
    # out_residual's tiles at 64 columns (128-byte rows: one L1 line; 32
    # tiles x 4 splits) and 32, against the 128 taken
    out_width = fd.OUT_WIDTH
    for width_ in (64, 32):
        fd.OUT_WIDTH = width_
        try:
            gemv_ms[f"out_residual qwen B8 D2048 width {width_}"] = timed(out_residual, out_sets)
        finally:
            fd.OUT_WIDTH = out_width
    for splits_ in (4, 6, 8):
        gemv_ms[f"out_residual qwen B8 D2048 splits {splits_}"] = timed_with_splits(
            splits_, out_residual, out_sets)
        gemv_ms[f"qkv_rope qwen B8 D2048 splits {splits_}"] = timed_with_splits(
            splits_, run_qkv, qkv_sets)
    emit("gemv_scaling", ms=gemv_ms, plans=gemv_plans, sms=sms, dtype="bf16", card=smi)

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
    # how the scan's time scales: the batch (blocks: H x B, 1 or 2 waves'
    # worth of SMs) and the length (chunks walked in order by each block)
    ssd_ms = {}
    for b_, L_ in ((1, 512), (8, 512), (1, 2048), (8, 2048)):
        nb = nbytes * b_ * L_ // (b * L)
        ssd_ms[f"B{b_} L{L_}"] = timed(lambda *a: ssd_scan(*a),
                                      copies(lambda: ssd_inputs(b_, L_), nb), iters=10)
    emit("ssd_scaling", ms=ssd_ms, shape=f"H{h} P{p} N{n} bf16", sms=sms,
         blocks_per_sm=blocks_per_sm(bf16), blocks_per_sm_float32=blocks_per_sm(torch.float32),
         card=smi)
    emit("times", shapes={"rmsnorm": "(8, 2048) decode (by_shape: also (8, 1024) and "
                                     "(4096, 2048) prefill), bf16, float32 weight",
                          "rmsnorm_gated": "(8, 2048) decode (by_shape: also (4096, 2048) "
                                           "prefill), H32 P64, bf16, z rows 4096 apart",
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

    def profile_prefill(cfg, params, prompts, scan="ssd_scan_kernel"):
        """One prefill of the serving round's 8 prompts at its bucket: device
        busy from ``torch.profiler`` against the wall time of unprofiled
        prefills, and the scan's share of the busy time."""
        bucket = _bucket(max(map(len, prompts)))
        toks = np.zeros((len(prompts), bucket), np.int64)
        for i, p_ in enumerate(prompts):
            toks[i, bucket - len(p_):] = p_
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        n_runs = 4
        with torch.no_grad():
            lm.prefill(cfg, params, batch, capacity=bucket + 32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_runs):
                lm.prefill(cfg, params, batch, capacity=bucket + 32)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_runs
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n_runs):
                    lm.prefill(cfg, params, batch, capacity=bucket + 32)
                torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(e.device_time_total for e in kern) / n_runs / 1e3
        scan_ms = sum(e.device_time_total for e in kern if scan in e.key) / n_runs / 1e3
        top = sorted(kern, key=lambda e: e.device_time_total, reverse=True)[:8]
        emit("profile", what=f"prefill, {cfg.name}, B{len(prompts)}, bucket {bucket}",
             runs=n_runs, wall_ms=wall_ms, device_busy_ms=busy_ms,
             device_idle_share=max(0.0, 1 - busy_ms / wall_ms), scan_ms=scan_ms,
             scan_share_of_busy=scan_ms / busy_ms if busy_ms else None,
             kernel_launches=sum(e.count for e in kern) / n_runs,
             top_kernels=[{"name": e.key[:90], "ms": e.device_time_total / n_runs / 1e3,
                           "calls": e.count / n_runs} for e in top])

    profile_prefill(m_cfg, m_params, m_prompts)

    # -- 8. pipelined serving on the same weights ---------------------------
    # after the timing and profiling phases: run before them (right after
    # phase 4), it left torch.profiler recording less kernel time in
    # phase 6 (flash attention 0.013-0.032 ms where it takes 0.065, the
    # SSD scan 0.010-0.025 ms, under its bytes bound); the cause is not
    # known
    def kernel_busy(prof):
        """Device ms with a kernel running on any stream (the union of the
        kernel intervals), the sum of kernel times, and the kernel count."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if str(e.device_type).endswith("CUDA"))
        union, end = 0.0, float("-inf")
        for a, b_ in spans:
            if b_ > end:
                union += b_ - max(a, end)
                end = b_
        return union / 1e3, sum(b_ - a for a, b_ in spans) / 1e3, len(spans)

    def timed_serve(server, reqs, kernels, profile=False):
        """One counted serve: launch counts and the peak-memory mark reset
        just before it, read just after (the peak, the peak over what was
        allocated before: the other model's weights stay resident, and
        what the serve left allocated: the pipeline's last logits a
        group); with ``profile`` under ``torch.profiler`` (the card
        alone)."""
        server.stats = ServeStats()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
            if profile else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        outs = server.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = {k: fn.launches for k, fn in kernels.items()}
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"a {server.cfg.name} serve launched no {missing} kernel")
        gen = sum(len(o.tokens) for o in outs)
        summary = server.stats.summary()
        rec = dict(wall_s=wall, prefill_tok_per_s=summary["prefill_tok_per_s"],
                   decode_tok_per_s=summary["decode_tok_per_s"], generated_tokens=gen,
                   launches=launches, port_kernel_launches_per_token=sum(launches.values()) / gen,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   peak_over_start=torch.cuda.max_memory_allocated() - before,
                   left_allocated=torch.cuda.memory_allocated() - before)
        if prof is not None:
            busy, total, n_kern = kernel_busy(prof)
            if not n_kern:          # a profiler window now and then records nothing
                busy = total = None
            rec.update(profiled_wall_s=wall, device_busy_ms=busy, kernel_ms_summed=total,
                       device_idle_share=None if busy is None
                       else max(0.0, 1 - busy / 1e3 / wall),
                       kernel_launches_per_token=n_kern / gen)
        return outs, rec

    def pipelined(name, params, prompts, pps, kernels, variants, profile=False):
        """The requests through the single-device server at max_batch 4,
        then through the pipeline in each variant: tokens must be equal.
        ``profile``: serve the first variant once more, profiled and
        traced (the profiler's events take seconds to read back)."""
        cfg = get_config(name)
        shape = ShapeCfg("serve_decode", 512, 4, "decode")
        t0 = time.perf_counter()
        # one card: no node can split across cards (max_tp 1); the budget is
        # the card, and the plan still takes a chip a node, all on this one
        plan = planner.plan(cfg, shape, chips=1, hw=HW_H100, max_tp=1)
        stg, _ = lm_graph.build_stg(cfg, shape, hw=HW_H100, max_tp=1)
        plan_s = time.perf_counter() - t0
        reqs = [Request(uid=i, prompt=p_, max_new=32) for i, p_ in enumerate(prompts)]
        warm = [Request(uid=i, prompt=p_, max_new=2) for i, p_ in enumerate(prompts)]
        single = LMServer(cfg, max_batch=4, params=params, device="cuda")
        single.serve(warm)
        want, rec = timed_serve(single, reqs, kernels)
        want_tokens = [o.tokens for o in want]
        steps = np.array(single.stats.decode_step_s)
        emit("pipeline", config=cfg.name, backend="single-device LMServer(max_batch=4)",
             decode_step_p50_ms=float(np.percentile(steps, 50) * 1e3), **rec)
        emit("plan", config=cfg.name, shape="decode B4 512 tokens", hw=HW_H100.name,
             chips=1, max_tp=1, seconds=plan_s, summary=plan.summary().splitlines()[0],
             choices=sorted({(s_.impl, s_.replicas) for s_ in plan.stages}),
             nodes=len(plan.stages))
        for i, variant in enumerate(variants):
            pipe = DecodePipeline(cfg, stg, plan, params=params, periods_per_stage=pps,
                                  device="cuda", **variant)
            server = LMServer(cfg, max_batch=4, pipeline=pipe, device="cuda")
            pipe.warm([r.prompt for r in reqs], 32, group_size=4)
            warm_compiles = pipe.compile_stats.compiles
            got, rec = timed_serve(server, reqs, kernels)
            run = server.last_run
            late = pipe.compile_stats.late
            emit("pipeline", config=cfg.name, backend="DecodePipeline", periods_per_stage=pps,
                 variant={k: str(v) for k, v in variant.items()}, stages=pipe.stage_names,
                 replicas=[len(d) for d in pipe.stage_devices], groups=len(run.groups),
                 streams_used=run.streams_used, max_inflight=run.max_inflight,
                 stage_seconds=run.stage_seconds, stage_firings=run.stage_firings,
                 stage_host_us={n: run.stage_host_us(n) for n in pipe.stage_names},
                 slo=run.slo(), compile_stats=pipe.compile_stats.summary(), late=late,
                 compiles_in_serve=pipe.compile_stats.compiles - warm_compiles,
                 tokens_equal=[o.tokens for o in got] == want_tokens, **rec)
            if [o.tokens for o in got] != want_tokens:
                bad = [j for j, o in enumerate(got) if o.tokens != want_tokens[j]]
                raise AssertionError(f"{cfg.name} pipelined {variant}: requests {bad} differ "
                                     f"from the single-device server")
            if late:
                raise AssertionError(f"{cfg.name} pipelined {variant}: {late} first launches "
                                     f"inside the serve")
            if pipe.overlap and run.streams_used < 2:
                raise AssertionError(f"{cfg.name} pipelined {variant}: ops ran on "
                                     f"{run.streams_used} stream(s)")
            if i == 0:
                first = rec["launches"]
            if i == 0 and profile:
                # profiled and traced: how long each stage waited, and on what
                server.tracer = Tracer()
                _, rec = timed_serve(server, reqs, kernels, profile=True)
                run = server.last_run
                emit("pipeline_profile", config=cfg.name, backend="DecodePipeline",
                     periods_per_stage=pps, variant={}, traced=True, **rec)
                emit("pipeline_trace", config=cfg.name, periods_per_stage=pps, variant={},
                     wall_s=rec["wall_s"], stage_wait_s=run.stage_wait_s,
                     stall_share={n: sum(w.values()) / run.wall_s
                                  for n, w in run.stage_wait_s.items()},
                     busy_share={n: t / run.wall_s for n, t in run.stage_seconds.items()},
                     bottleneck=stall_bottleneck(server.tracer))
                server.tracer = None
            pipe.close()
            del pipe, server
        return first

    t_phase = time.perf_counter()
    fd._composed_step.calls = 0
    qwen_kernels = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                    "fused_qkv_rope": qkv_rope, "decode_attention": decode_attention,
                    "fused_out_residual": out_residual}
    pipe_launches = pipelined("qwen2.5-3b", params, prompts, 9, qwen_kernels,
                              [{}, {"fusion_plan": "auto"}, {"overlap": False}], profile=True)
    if fd._composed_step.calls:
        raise AssertionError(f"a pipelined qwen decode step left the fused chain: "
                             f"_composed_step called {fd._composed_step.calls} times")
    m_pipe_launches = pipelined("mamba2-370m", m_params, m_prompts, 12,
                                {"rmsnorm": rmsnorm, "rmsnorm_gated": rmsnorm_gated,
                                 "ssd_scan": ssd_scan}, [{}])
    emit("pipeline_phase", seconds=time.perf_counter() - t_phase)

    # -- 9. the record of the kernels, the card, the result -----------------
    # launches from the serving round that runs each kernel: qwen's for the
    # attention kernels, rmsnorm and the chain (counted once a chain, by its
    # first kernel; its other two launched as often), mamba2-370m's for the
    # scan and the gated norm; ``pipeline_launches`` the same from the
    # first pipelined serve of each model (phase 8)
    cuda_kernels = {
        "rmsnorm": ["rmsnorm_rows_kernel", "rmsnorm_wide_kernel"],
        "rmsnorm_gated": ["rmsnorm_rows_kernel", "rmsnorm_wide_kernel"],
        "flash_attention": ["flash_attention_mma_kernel"],
        "decode_attention": ["decode_attention_kernel"],
        "fused_decode": ["fused_qkv_rope_kernel", "decode_attention_kernel",
                         "fused_out_residual_kernel"],
        "ssd_scan": ["ssd_scan_kernel"]}
    served = dict(launches, fused_decode=launches["fused_qkv_rope"],
                  ssd_scan=m_launches["ssd_scan"], rmsnorm_gated=m_launches["rmsnorm_gated"])
    piped = dict(pipe_launches, fused_decode=pipe_launches["fused_qkv_rope"],
                 ssd_scan=m_pipe_launches["ssd_scan"],
                 rmsnorm_gated=m_pipe_launches["rmsnorm_gated"])
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "cuda_kernels": cuda_kernels[name], "launches": served[name],
         "pipeline_launches": piped[name],
         "max_abs_err": errors[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         **({"yardstick_ms": t["yardstick_ms"]} if "yardstick_ms" in t else {}),
         **({"floor_ms": t["floor_ms"], "by_shape": {s: {k: v[k] for k in (
             "ms", "floor_ms", "plain_ms", "bound_ms", "library_ms")} for s, v in
             t["by_shape"].items()}} if "by_shape" in t else {}),
         **({"parts": [dict(name=part, launches=launches[part], **{
             k: p[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             **({"yardstick_ms": p["yardstick_ms"]} if "yardstick_ms" in p else {}))
             for part, p in t["parts"].items()]} if "parts" in t else {})}
        for name, source, replaces, t in rows]}), flush=True)
    emit("elapsed", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
