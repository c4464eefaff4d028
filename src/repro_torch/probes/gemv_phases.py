"""Where a block of the GEMV kernels spends its time, on the card.

Builds a copy of ``kernels/csrc/fused_decode.cu`` in which every ``//
phase-stamp N`` mark records ``%globaltimer`` (thread 0 of each block) into
a device buffer, runs qkv_rope and out_residual at qwen2.5-3b's decode
shapes (B 8, D 2048, inputs cycled to overflow L2) and danube's, plus one
block alone, and prints for each case the median over launches of each
phase's end, in ns from the block's entry (the median and the largest
over blocks):

  0 entry, 1 weights requested, 2 x (times norm) in shared memory, 3 first
  stage stored, 4 last stage used, 5 cluster barrier passed, 6 totals
  added, 7 stores done.

Run on a card: ``PYTHONPATH=src python -m repro_torch.probes.gemv_phases``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from ..kernels import build
from ..kernels import fused_decode as fd

STAMPS = 8
MAX_BLOCKS = 4096

_PRELUDE = f"""
__device__ unsigned long long g_stamps[{MAX_BLOCKS} * {STAMPS}];
__device__ __forceinline__ void stamp(int i) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[(blockIdx.x + blockIdx.y * gridDim.x) * {STAMPS} + i] = t;
  }}
}}
extern "C" int probe_read(unsigned long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, g_stamps, n * sizeof(unsigned long long));
}}
"""


def stamped_source(src: str) -> str:
    """The kernel source with a timestamp at every phase mark."""
    def mark(m):
        n, cond, synced = m.group(2), m.group(3), m.group(4)
        if cond:
            return f"{m.group(1)}if ({cond}) stamp({n});"
        return f"{m.group(1)}{'__syncthreads(); ' if synced else ''}stamp({n});"
    out, n = re.subn(r"^( *)// phase-stamp (\d+)(?: when (.+?))?( synced)?$", mark, src,
                     flags=re.M)
    if n < STAMPS:
        raise RuntimeError(f"fused_decode.cu has {n} phase marks, expected {STAMPS} or more")
    return out.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + _PRELUDE, 1)


def _library():
    out = build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "fused_phases.cu"
    src.write_text(stamped_source((build.CSRC / "fused_decode.cu").read_text()))
    lib_path = out / "libfused_phases.so"
    subprocess.run([build.nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-I", str(build.CSRC), "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.fused_out_residual_bf16.argtypes = fd._OUT_ARGS
    lib.fused_qkv_rope_bf16.argtypes = fd._QKV_ARGS
    lib.probe_read.argtypes = [build.P, build.I]
    return lib


def _phases(lib, blocks, launch, sets, label, launches=40, warm=10):
    host = np.zeros(MAX_BLOCKS * STAMPS, np.uint64)
    rows = []
    for it in range(launches):
        launch(*sets[it % len(sets)])
        torch.cuda.synchronize()
        if it < warm:
            continue
        if lib.probe_read(host.ctypes.data, blocks * STAMPS):
            raise RuntimeError("probe_read failed")
        s = host[:blocks * STAMPS].reshape(blocks, STAMPS).astype(np.int64)
        rows.append(s - s[:, 0].min())
    med = np.median(np.stack(rows), axis=0)          # blocks x STAMPS, ns from first entry
    from_entry = med[:, 1:] - med[:, :1]
    return {"case": label, "blocks": blocks,
            "entry_ns_p50_max": [float(np.median(med[:, 0])), float(med[:, 0].max())],
            "phase_end_ns_p50": [float(v) for v in np.median(from_entry, axis=0)],
            "phase_end_ns_max": [float(v) for v in from_entry.max(axis=0)],
            "last_block_end_ns": float(med[:, -1].max())}


def main() -> int:
    if not torch.cuda.is_available():
        print("gemv_phases: needs a CUDA card", file=sys.stderr)
        return 1
    lib = _library()
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = build.stream(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def out_case(B, K, D, splits=None, copies=8, label=""):
        sets = [(randn(B, K), randn(K, D) * K ** -0.5, randn(B, D),
                 torch.empty(B, D, device=dev, dtype=bf)) for _ in range(copies)]
        width = min(fd.OUT_WIDTH, fd.tile_width(D))
        tiles = -(-D // width)
        plan = fd.gemv_plan(tiles, width, K, 1, sms, dtype=bf, norm=False)
        if splits is not None:
            plan = fd.GemvPlan(width, K if splits == 1 else -(-(-(-K // splits)) // 16) * 16,
                               splits)

        def launch(o, wo, x, out):
            err = lib.fused_out_residual_bf16(o.data_ptr(), wo.data_ptr(), x.data_ptr(),
                                              out.data_ptr(), B, K, D, *plan, stream)
            if err:
                raise RuntimeError(f"out_residual: CUDA error {err}")
        return _phases(lib, tiles * plan.splits, launch, sets,
                       f"out_residual B{B} K{K} D{D} {tuple(plan)} {label}".strip())

    def qkv_case(B, D, H, KV, hd, copies=8):
        def one():
            return dict(x=randn(B, D), norm=torch.ones(D, device=dev), wq=randn(D, H * hd),
                        wk=randn(D, KV * hd), wv=randn(D, KV * hd), bq=randn(H * hd),
                        bk=randn(KV * hd), bv=randn(KV * hd),
                        pos=torch.tensor(30, dtype=torch.int32, device=dev),
                        q=torch.empty(B, H, hd, device=dev, dtype=bf),
                        kc=torch.zeros(B, 64, KV, hd, device=dev, dtype=bf),
                        vc=torch.zeros(B, 64, KV, hd, device=dev, dtype=bf),
                        clen=torch.empty((), dtype=torch.int32, device=dev))
        sets = [(one(),) for _ in range(copies)]
        tiles = H + 2 * KV
        plan = fd.gemv_plan(tiles, fd.tile_width(hd), D, 1, sms, dtype=bf, norm=True)
        names = ("x", "norm", "wq", "wk", "wv", "bq", "bk", "bv", "pos", "q", "kc", "vc", "clen")

        def launch(t):
            err = lib.fused_qkv_rope_bf16(*(t[n].data_ptr() for n in names), B, D, H, KV, hd, 64,
                                          *plan, 1e-6, 1e6, stream)
            if err:
                raise RuntimeError(f"qkv_rope: CUDA error {err}")
        return _phases(lib, tiles * plan.splits, launch, sets,
                       f"qkv_rope B{B} D{D} H{H} KV{KV} hd{hd} {tuple(plan)}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cases = [out_case(8, 2048, 2048), qkv_case(8, 2048, 16, 2, 128),
             out_case(8, 2048, 128, splits=1, copies=1, label="one block"),
             out_case(8, 2048, 2048, splits=4, label="4 splits"),
             out_case(8, 3840, 3840), qkv_case(8, 3840, 32, 8, 120)]
    for c in cases:
        print(json.dumps(dict(c, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
