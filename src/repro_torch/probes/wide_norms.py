"""The norms past the row kernel, at the widths the main path gives them.

The plain norm's gradient at (8192, D) bf16 for D 5120 (the llama4
decoders), 6144 (nemotron-4-15b, internvl2-26b), 7168 (deepseek-coder-33b)
and 8192 (jamba-1.5-large), beside ``F.rms_norm``'s backward through
autograd at the same shape; the gated norm's gradient at jamba's Mamba2
width (H 256, P 64: 16384) over 8 and 4096 rows, z rows 32768 apart as
``torch.chunk`` gives them, and at (8192, 4096) (H 64, P 64: past the row
kernel, within a CTA of 16 warps).  The forwards past the row kernel, at 8
and 4096 rows: the gated norm at jamba's 16384 in bf16 and float32, beside
the yardstick ``chip_smoke.py`` holds it to (the op-by-op torch body, then
the norm); the plain norm at 16384 bf16 and 8192 float32, beside
``F.rms_norm`` with the float32 weight and with the weight in the rows'
dtype.
Each as device ms a call from CUDA events around calls that cycle through
input copies that overflow L2, queued behind a spin of the card
(`train_bwd._timed`), beside its bound (each input read once, each output
written once, over 3.35 TB/s) and its plan; a cluster plan's record also
names the clusters its kernel launches (as many as the card holds at
once).  Each option times the norms again, in the same call, so that
the designs meet on one card: ``--wide`` with the plans forced to the wide
element kernels (``wide_ms``; the forwards too); ``--layouts`` on
`rmsnorm.cluster_plan`'s layout forced to CTAs of 8 warps and of 16
(``ctas_of_8_warps_ms``, ``ctas_of_16_warps_ms``), and each forward over
4096 rows on CTAs of 16 warps, of 8, and of 8 with one piece a lane,
where 8 CTAs hold the row so, with the plain norm at (4096, 32768) bf16
besides (``layouts_ms``); ``--forwards-only`` times the
forwards alone; ``--ablate N ...`` with
``rmsnorm.cu`` built with ``-DCLUSTER_ABLATE=N`` (the cluster kernels
without the exchange of a row's sums, 1, without the element math, 2, or
both, 3: wrong results, to find what bounds them; ``variant_ms``); and
``--against FILE`` with another version of ``rmsnorm.cu`` (the same entry
points; ``against_ms``).  Prints one JSON record with the card's name and
power limit, and the registers and spills ptxas gave the norms' kernels.

Run on a card: ``PYTHONPATH=src python -m repro_torch.probes.wide_norms
[--wide] [--layouts] [--forwards-only] [--ablate 1 2 3] [--against FILE]``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..kernels import build
from ..kernels import rmsnorm as rn
from .train_bwd import _copies, _ptxas, _timed, _with_library

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
PLAIN_WIDTHS = (5120, 6144, 7168, 8192)
JAMBA_H, JAMBA_P = 256, 64


@contextlib.contextmanager
def wide_plans():
    """The norms' plans forced to the wide element kernels."""
    saved = rn.norm_plan, rn.norm_bwd_plan
    rn.norm_plan = lambda *_, **__: rn.WIDE
    rn.norm_bwd_plan = lambda rows, *_, card, **__: rn.NormPlan(0, 0, 0, min(rows, 2 * card.sms))
    try:
        yield
    finally:
        rn.norm_plan, rn.norm_bwd_plan = saved


@contextlib.contextmanager
def forced_plan(plan):
    """The forwards' plan forced to ``plan``."""
    saved = rn.norm_plan
    rn.norm_plan = lambda *_, **__: plan
    try:
        yield plan
    finally:
        rn.norm_plan = saved


def variant_library(name: str, source, defines=()):
    """``source`` (a version of ``rmsnorm.cu``, with the error strings)
    built with ``defines`` into the probes' directory."""
    out = build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / f"librmsnorm_{name}.so"
    subprocess.run([build.nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-I", str(build.CSRC), *defines, "-shared", "-o", str(lib_path), str(source),
                    str(build.CSRC / "errors.cu")], check=True)
    return lib_path


def main() -> int:
    if not torch.cuda.is_available():
        print("wide_norms: needs a CUDA card", file=sys.stderr)
        return 1
    argv = sys.argv[1:]
    also_wide = "--wide" in argv
    ablate = ([int(a) for a in argv[argv.index("--ablate") + 1:] if a.isdigit()]
              if "--ablate" in argv else [])
    libraries = {n: variant_library(f"ablate{n}", build.CSRC / "rmsnorm.cu",
                                    [f"-DCLUSTER_ABLATE={n}"]) for n in ablate}
    against = (variant_library("against", argv[argv.index("--against") + 1])
               if "--against" in argv else None)
    layouts = "--layouts" in argv
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    card = rn.card_of(0)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def timed(fn, sets, extra=None, variants=False):
        out = dict(ms=_timed(fn, sets))
        if also_wide:
            with wide_plans():
                out["wide_ms"] = _timed(fn, sets)
        if variants and libraries:
            out["variant_ms"] = {n: _with_library(lib, lambda _: _timed(fn, sets))
                                 for n, lib in libraries.items()}
        if variants and against:
            out["against_ms"] = _with_library(against, lambda _: _timed(fn, sets))
        if variants and layouts:
            saved = rn.norm_bwd_plan
            for warps in (8, 16):
                def forced(rows, d, elem, *, aligned, card, gated=False):
                    limit = rn.GATED_BWD_UNITS if gated else rn.MAX_UNITS[True]
                    return rn.cluster_plan(rows, d * elem // 16, limit, card, warps=warps)
                rn.norm_bwd_plan = forced
                try:
                    out[f"ctas_of_{warps}_warps_ms"] = _timed(fn, sets)
                finally:
                    rn.norm_bwd_plan = saved
        return {**out, **(extra or {})}

    def planned(plan, gated):
        return dict(plan=plan._asdict(), **({"clusters": rn.clusters_launched(
            plan, 2, gated=gated, backward=True)} if plan.cluster else {}))

    def with_graph(fn, *inputs):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return out, leaves, randn(*out.shape, dtype=out.dtype)

    def backward_only(out, leaves, dout):
        torch.autograd.grad(out, leaves, dout, retain_graph=True)

    records = {}
    forwards_only = "--forwards-only" in argv
    n = 8192
    for d in () if forwards_only else PLAIN_WIDTHS:
        nbytes = 3 * 2 * n * d + 2 * 4 * d        # x, g read, dx written; w read, dw written
        sets = _copies(lambda: (randn(n, d), 1.0 + 0.1 * randn(d, dtype=f32), randn(n, d)),
                       nbytes)
        records[f"rmsnorm_backward ({n}, {d})"] = timed(rn.rmsnorm_backward, sets, dict(
            library_ms=_timed(backward_only, [with_graph(
                lambda x_, w_: F.rms_norm(x_, (d,), w_, 1e-5), x, w.to(bf16))
                for x, w, _ in sets]),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            **planned(rn.norm_bwd_plan(n, d, 2, aligned=True, card=card), False)), variants=True)
        del sets

    def gate_set(rows, h=JAMBA_H, p=JAMBA_P, dtype=bf16):
        d = h * p
        xz = randn(rows, 2 * d, dtype=dtype)
        return (randn(rows, h, p, dtype=dtype), randn(rows, h, p, dtype=dtype),
                1.0 + 0.1 * randn(h, dtype=f32), torch.chunk(xz, 2, dim=-1)[1],
                1.0 + 0.1 * randn(d, dtype=f32), randn(rows, d, dtype=dtype))

    for rows, h, p in () if forwards_only else ((8, JAMBA_H, JAMBA_P), (4096, JAMBA_H, JAMBA_P),
                                                (8192, 64, 64)):
        d = h * p
        # y, xh, z, g read, dy, dxh, dz written; w, d_skip read, dw, dd_skip written
        nbytes = 7 * 2 * rows * d + 2 * 4 * d + 2 * 4 * h
        sets = _copies(lambda: gate_set(rows, h, p), 8 * 2 * rows * d)
        records[f"rmsnorm_gated_backward ({rows}, {d})"] = timed(
            rn.rmsnorm_gated_backward, sets,
            dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
                 **planned(rn.norm_bwd_plan(rows, d, 2, aligned=True, card=card, gated=True),
                           True),
                 **{f"{name}_ms": _timed(lambda *a: rn.rmsnorm_gated_backward(*a, passes=mask),
                                         sets)
                    for name, mask in (("rows", rn.GATED_ROWS_PASS),
                                       ("tail", rn.GATED_TAIL_PASS))}), variants=True)
        del sets

    def unfused(y, xh, ds, z, w, _g=None):
        """The gated forward's yardstick: the op-by-op torch body, then the norm."""
        g = y + xh * ds[:, None].to(xh.dtype)
        return rn.rmsnorm(g.reshape(z.shape) * F.silu(z), w)

    def forward_layouts(fn, sets, rows, pieces, limit):
        """The forward on the layouts of `rmsnorm.cluster_plan` with CTAs of
        16 warps, of 8, and of 8 with one piece a lane, in this call."""
        out = {}
        for name, warps, units in (("CTAs of 16 warps", 16, limit), ("CTAs of 8 warps", 8, limit),
                                   ("CTAs of 8 warps, one piece a lane", 8, 1)):
            plan = rn.cluster_plan(rows, pieces, units, card, warps=warps)
            if plan.cluster:
                with forced_plan(plan):
                    out[name] = dict(ms=_timed(fn, sets), plan=plan._asdict())
        return out

    # the forwards past the row kernel: (gated, width, dtype) at 8 and 4096
    # rows; with --layouts, also the plain norm at (4096, 32768) bf16, whose
    # row two CTAs of 16 warps or four of 8 hold
    forwards = [(gated, d, dtype, rows) for gated, d, dtype in (
        (True, JAMBA_H * JAMBA_P, bf16), (True, JAMBA_H * JAMBA_P, f32), (False, 16384, bf16),
        (False, 8192, f32)) for rows in (8, 4096)]
    for gated, d, dtype, rows in forwards + ([(False, 32768, bf16, 4096)] if layouts else []):
        elem = 2 if dtype == bf16 else 4
        if gated:   # y, xh, z read, out written; w, d_skip read
            nbytes = 4 * elem * rows * d + 4 * d + 4 * JAMBA_H
            sets = _copies(lambda: gate_set(rows, dtype=dtype), nbytes + elem * rows * d)
            fn, extra = (lambda *a: rn.rmsnorm_gated(*a[:5])), dict(
                yardstick_ms=_timed(unfused, sets),
                yardstick="the op-by-op torch body, then the norm")
        else:       # x read, out written; w read
            nbytes = 2 * elem * rows * d + 4 * d
            sets = _copies(lambda: (randn(rows, d, dtype=dtype),
                                    1.0 + 0.1 * randn(d, dtype=f32)), nbytes)
            fn, extra = rn.rmsnorm, dict(
                library_ms=_timed(lambda x, w: F.rms_norm(x, (d,), w, 1e-5), sets),
                library_same_dtype_weight_ms=_timed(
                    lambda x, w: F.rms_norm(x, (d,), w.to(x.dtype), 1e-5), sets))
        plan = rn.norm_plan(rows, d, elem, gated=gated, aligned=True, card=card)
        if layouts and rows == 4096 and plan.cluster:
            extra["layouts_ms"] = forward_layouts(fn, sets, rows, d * elem // 16,
                                                  rn.MAX_UNITS[gated])
        name = "rmsnorm_gated" if gated else "rmsnorm"
        records[f"{name} ({rows}, {d}) {str(dtype)[6:]}"] = timed(fn, sets, dict(
            extra, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            **(dict(plan=plan._asdict(), clusters=rn.clusters_launched(
                plan, elem, gated=gated, backward=False)) if plan.cluster
               else dict(plan=plan._asdict()))))
        del sets

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"probe": "wide_norms", "card": smi, "torch": torch.__version__,
                      "times": records, "ptxas": _ptxas(r"rmsnorm")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
