"""Where a block of the bf16 SSD scan spends its time, and what the hi + lo
split of its y products costs, on the card.

Phases: builds a copy of ``kernels/csrc/ssd_scan.cu`` in which every ``//
phase-stamp N`` mark adds the SM clocks since the previous mark to phase N
of its block (thread 0, so warp 0's view; summed over the chunks), runs the
scan at mamba2-370m's prefill (B 8, L 512, H 32, P 64, N 128, inputs
cycled to overflow L2) and at B 1, and prints for each case the mean and
the largest over blocks of each phase, in clocks:

  1 first barrier (the chunk's dt is in, every warp is done with the
  last), 2 issue the next chunk's copies and wait for this one's, 3 W's
  tile products and the cumsum, 4 W's decay and stores, 5 y from the state
  (S C^T), 6 second barrier (W whole), 7 y within the chunk (x^T W^T), 8 y
  stores, 9 state update; 10 the final state's store.
  ``block_ns`` is a block's time from entry to its last store
  (``%globaltimer``).

Split: builds ``ssd_scan.cu`` with ``-DSSD_SPLIT_Y=0`` (W and S rounded
once to bf16 in the y products, not split in two) beside the default, and
prints each build's device time a call (CUDA events over back-to-back
launches at the serving shape) and its largest error against the plain
version, for y and the float32 state, in chip_smoke's short- and
long-memory cases.

Run on a card: ``PYTHONPATH=src python -m repro_torch.probes.ssd_phases``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build
from ..kernels import ssd_scan as ss

STAMPS = 11
MAX_BLOCKS = 4096

_PRELUDE = f"""
__device__ long long g_phase[{MAX_BLOCKS} * {STAMPS}];
__device__ __forceinline__ void stamp(int i) {{
  __shared__ long long last, total[{STAMPS}];
  if (threadIdx.x != 0) return;
  long long t = clock64();
  if (i == 0) {{
    for (int k = 1; k < {STAMPS}; ++k) total[k] = 0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(total[0]));
  }} else {{
    total[i] += t - last;
  }}
  last = clock64();
  if (i == {STAMPS} - 1) {{
    long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    long long* out = g_phase + (blockIdx.x + blockIdx.y * gridDim.x) * {STAMPS};
    out[0] = ns - total[0];
    for (int k = 1; k < {STAMPS}; ++k) out[k] = total[k];
  }}
}}
extern "C" int probe_read(long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, g_phase, n * sizeof(long long));
}}
"""


def stamped_source(src: str) -> str:
    """The scan's source with a clock stamp at every phase mark."""
    out, n = re.subn(r"^( *)// phase-stamp (\d+)$", r"\1stamp(\2);", src, flags=re.M)
    if n != STAMPS:
        raise RuntimeError(f"ssd_scan.cu has {n} phase marks, expected {STAMPS}")
    return out.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + _PRELUDE, 1)


def _library(name: str, src: str, defines=()) -> ctypes.CDLL:
    out = build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.cu"
    path.write_text(src)
    lib_path = out / f"lib{name}.so"
    subprocess.run([build.nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    *defines, "-shared", "-I", str(build.CSRC), "-o", str(lib_path), str(path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.ssd_scan_bf16.argtypes = ss._ARGS
    return lib


def _inputs(gen, b, L, memory, h=32, p=64, n=128):
    """chip_smoke's scan inputs: b and c strided slices of one projection."""
    dev = gen.device

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    bc = randn(b, L, 2 * n + h)
    shift, log_a = (0.0, 0.0) if memory == "short" else (4.0, -2.0)
    return (randn(b, L, h, p), F.softplus(randn(b, L, h, dtype=torch.float32) - shift),
            -torch.exp(log_a + 0.5 * randn(h, dtype=torch.float32)), bc[..., :n],
            bc[..., n:2 * n])


def _launch(lib, x, dt, a, b, c):
    B, L, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = lib.ssd_scan_bf16(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                            c.data_ptr(), y.data_ptr(), state.data_ptr(), B, L, H, P, N,
                            x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
                            dt.stride(2), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                            build.stream(x.device))
    if err:
        raise RuntimeError(f"ssd_scan_bf16: CUDA error {err}")
    return y, state


def _phases(lib, sets, label, launches=30, warm=5):
    B, _, H, _ = sets[0][0].shape
    blocks = B * H
    host = np.zeros(MAX_BLOCKS * STAMPS, np.int64)
    rows = []
    for it in range(launches):
        _launch(lib, *sets[it % len(sets)])
        torch.cuda.synchronize()
        if it < warm:
            continue
        if lib.probe_read(host.ctypes.data, blocks * STAMPS):
            raise RuntimeError("probe_read failed")
        rows.append(host[:blocks * STAMPS].reshape(blocks, STAMPS).copy())
    med = np.median(np.stack(rows), axis=0)            # blocks x STAMPS
    return {"case": label, "blocks": blocks,
            "block_ns_mean_max": [float(med[:, 0].mean()), float(med[:, 0].max())],
            "phase_clocks_mean": [float(v) for v in med[:, 1:].mean(axis=0)],
            "phase_clocks_max": [float(v) for v in med[:, 1:].max(axis=0)]}


def _event_ms(fn, sets, iters=40):
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_phases: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    source = (build.CSRC / "ssd_scan.cu").read_text()
    stamped = _library("ssd_phases", stamped_source(source))
    serving = [_inputs(gen, 8, 512, "short") for _ in range(4)]     # 4 x 11 MB: past L2
    for sets, label in ((serving, "B8 L512 H32 P64 N128"),
                        ([_inputs(gen, 1, 512, "short")], "B1 L512 H32 P64 N128")):
        print(json.dumps(dict(_phases(stamped, sets, label), card=card)), flush=True)

    builds = {"split": _library("ssd_split", source),
              "no_split": _library("ssd_no_split", source, ["-DSSD_SPLIT_Y=0"])}
    record = {"what": "y products with W and S split in hi + lo vs rounded once",
              "shape": "B8 L512 H32 P64 N128 bf16", "card": card}
    for name, lib in builds.items():
        errs = {}
        for memory in ("short", "long"):
            args = _inputs(gen, 8, 512, memory)
            (y, s), (want_y, want_s) = _launch(lib, *args), ss.ssd_scan_plain(*args, chunk=128)
            dy = (y.float() - want_y.float()).abs()
            errs[memory] = {
                "y_max_abs_err": float(dy.max()),
                "y_worst_ratio_to_tol": float((dy / (0.02 + 0.02 * want_y.float().abs())).max()),
                "state_max_abs_err": float((s - want_s).abs().max()),
                "state_err_over_max": float((s - want_s).abs().max() / want_s.abs().max())}
        record[name] = dict(errs, ms=_event_ms(lambda *a: _launch(lib, *a), serving))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
