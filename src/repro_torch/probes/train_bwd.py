"""The two Mamba2 training backward kernels at mamba2-370m's training
shapes, launch by launch.

The SSD scan's backward at B 2, L 4096, H 32, P 64, N 128 bf16 (b and c
strided as `Mamba._proj` slices them) and the gated norm's at (8192, 2048)
bf16 (H 32, P 64, z rows 4096 apart as ``torch.chunk`` gives them): each
whole call and each of its launches alone (``passes``), as device ms a
call from CUDA events around calls that cycle through input copies that
overflow L2, queued behind a spin of the card so that they run back to
back (the gate's row kernel also built with ``-DGATED_BWD_NO_MATH=1``,
its loads and stores alone); then the registers, shared memory and
spills ptxas gave their kernels.  Prints one JSON record with the card's
name and power limit.

``--calls-only`` times the whole calls alone, through nothing but the
two public functions, so that the same measurement can be taken of
another version of the package: put this file into that version's
``repro_torch/probes/`` and run it there with the flag.

Phases: then builds a copy of ``kernels/csrc/ssd_scan.cu`` in which every
``// bwd-stamp N`` mark of the chunk kernel adds the SM clocks since the
previous mark to phase N of its block (thread 0, so warp 0's view, summed
over the block's heads), runs the chunk kernel at the same shape, and
prints the mean and the largest over blocks of each phase, in clocks:
1 the loop, 2 the cumsum and the wait for x and dy, 3 G, W and M, 4 M
and W stored, behind a barrier, 5 the wait for S and dS and <dS, S>, 6
db's or dc's product from dS or S (warp 0: and the last head's scan), 7
dS B^T, 8 a barrier and the next states' copies, 9 dx and x.(M^T dy),
x.(dS B), 10 a barrier, x and dy two heads on, dx's tile, 11 db's or dc's
products from W, 12 a barrier, 13 dx's store; 14 the last head's scan and
db and dc written.  ``block_ns`` is a block's time from entry
to exit (``%globaltimer``).

Run on a card: ``PYTHONPATH=src python -m repro_torch.probes.train_bwd
[--calls-only]``.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build
from ..kernels import rmsnorm as rn
from ..kernels import ssd_scan as ss

L2_BYTES = 50 * 2 ** 20
SPIN_HZ = 2e9                   # clocks a second of `torch.cuda._sleep`: at least the H100's 1.98 GHz
STAMPS = 15
MAX_BLOCKS = 4096

_PRELUDE = f"""
__device__ long long g_bwd_phase[{MAX_BLOCKS} * {STAMPS}];
__device__ __forceinline__ void bwd_stamp(int i) {{
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
    long long* out = g_bwd_phase + (blockIdx.x + blockIdx.y * gridDim.x) * {STAMPS};
    out[0] = ns - total[0];
    for (int k = 1; k < {STAMPS}; ++k) out[k] = total[k];
  }}
}}
extern "C" int probe_bwd_read(long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, g_bwd_phase, n * sizeof(long long));
}}
"""


def stamped_source(src: str) -> str:
    """The scan's source with a clock stamp at every mark of the chunk kernel."""
    out, n = re.subn(r"^( *)// bwd-stamp (\d+)$", r"\1bwd_stamp(\2);", src, flags=re.M)
    if n != STAMPS:
        raise RuntimeError(f"ssd_scan.cu has {n} bwd-stamp marks, expected {STAMPS}")
    return out.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + _PRELUDE, 1)


def _with_library(lib_path, fn):
    """``fn()`` with the kernels' library swapped for the one at ``lib_path``."""
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    saved = build._lib, dict(build._fns)
    try:
        build._lib, build._fns = lib, {}
        return fn(lib)
    finally:
        build._lib, build._fns = saved[0], saved[1]


def _variant(name: str, defines: list) -> str:
    """The kernels built with ``defines`` into the probes' directory."""
    out = build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / f"lib{name}.so"
    subprocess.run([build.nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    *defines, "-shared", "-o", str(lib_path),
                    *map(str, sorted(build.CSRC.glob("*.cu")))], check=True)
    return lib_path


def _chunk_phases(sets, launches=12, warm=2) -> dict:
    """The chunk kernel's phases (see the module's note), through a stamped
    build swapped in for the wrapper's library during the calls."""
    out = build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "ssd_bwd_phases.cu"
    src.write_text(stamped_source((build.CSRC / "ssd_scan.cu").read_text()))
    lib_path = out / "libssd_bwd_phases.so"
    subprocess.run([build.nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                    "-shared", "-I", str(build.CSRC), "-o", str(lib_path), str(src),
                    str(build.CSRC / "errors.cu")], check=True)
    B, L, H = sets[0][0].shape[:3]
    blocks = -(-L // ss.CHUNK) * B
    host = np.zeros(MAX_BLOCKS * STAMPS, np.int64)

    def run(lib):
        rows = []
        for it in range(launches):
            ss.ssd_scan_backward(*sets[it % len(sets)], passes=ss.CHUNK_PASS)
            torch.cuda.synchronize()
            if it < warm:
                continue
            if lib.probe_bwd_read(host.ctypes.data, blocks * STAMPS):
                raise RuntimeError("probe_bwd_read failed")
            rows.append(host[:blocks * STAMPS].reshape(blocks, STAMPS).copy())
        return rows

    rows = _with_library(lib_path, run)
    med = np.median(np.stack(rows), axis=0)            # blocks x STAMPS
    return {"blocks": blocks,
            "block_ns_mean_max": [float(med[:, 0].mean()), float(med[:, 0].max())],
            "phase_clocks_mean": [round(float(v)) for v in med[:, 1:].mean(axis=0)],
            "phase_clocks_max": [round(float(v)) for v in med[:, 1:].max(axis=0)]}


def _timed(fn, sets, iters=20) -> float:
    """Device ms a call: the calls queued while the card spins for twice the
    time the host took to issue them, then run back to back (as
    `chip_smoke.py` phase 10 times them)."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_HZ))
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _copies(make, nbytes):
    return [make() for _ in range(max(2, min(16, -(-2 * L2_BYTES // nbytes))))]


def _ptxas(pattern: str) -> dict:
    out, name = {}, None
    for line in build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        if name and re.search(pattern, name):
            rec = out.setdefault(name, {})
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                rec["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                rec["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    calls_only = "--calls-only" in sys.argv[1:]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    B, L, H, P, N = 2, 4096, 32, 64, 128

    def scan_set():
        bc = randn(B, L, 2 * N + H)
        return (randn(B, L, H, P), F.softplus(randn(B, L, H, dtype=f32) - 4.0),
                -torch.exp(-2.0 + 0.5 * randn(H, dtype=f32)), bc[..., :N], bc[..., N:2 * N],
                randn(B, L, H, P))

    sets = _copies(scan_set, 4 * 2 * B * L * H * P + 2 * B * L * (2 * N + H))
    scan = {"ms": _timed(ss.ssd_scan_backward, sets)}
    if not calls_only:
        for name, mask in (("states", ss.STATES_PASS), ("chunk", ss.CHUNK_PASS),
                           ("da", ss.DA_PASS)):
            scan[f"{name}_ms"] = _timed(lambda *a: ss.ssd_scan_backward(*a, passes=mask), sets)
        scan["chunk_phases"] = _chunk_phases(sets)
    del sets

    rows, h, p = 8192, 32, 64
    d = h * p

    def gate_set():
        xz = randn(rows, 2 * d)
        return (randn(rows, h, p), randn(rows, h, p), 1.0 + 0.1 * randn(h, dtype=f32),
                torch.chunk(xz, 2, dim=-1)[1], 1.0 + 0.1 * randn(d, dtype=f32), randn(rows, d))

    sets = _copies(gate_set, 2 * 8 * rows * d)
    gate = {"ms": _timed(rn.rmsnorm_gated_backward, sets)}
    if not calls_only:
        gate["plan"] = rn.norm_bwd_plan(rows, d, 2, aligned=True, card=rn.card_of(0),
                                        gated=True)._asdict()
        for name, mask in (("rows", rn.GATED_ROWS_PASS), ("tail", rn.GATED_TAIL_PASS)):
            gate[f"{name}_ms"] = _timed(
                lambda *a: rn.rmsnorm_gated_backward(*a, passes=mask), sets)
        # the row kernel's memory side alone: built with GATED_BWD_NO_MATH
        gate["rows_no_math_ms"] = _with_library(
            _variant("gated_no_math", ["-DGATED_BWD_NO_MATH=1"]),
            lambda lib: _timed(
                lambda *a: rn.rmsnorm_gated_backward(*a, passes=rn.GATED_ROWS_PASS), sets))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"probe": "train_bwd", "calls_only": calls_only, "card": card,
                      "ssd_scan_backward": dict(shape=f"B{B} L{L} H{H} P{P} N{N} bf16", **scan),
                      "rmsnorm_gated_backward": dict(shape=f"({rows}, {d}) bf16", **gate),
                      "ptxas": _ptxas(r"ssd_bwd|gated_bwd|gated_tail")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
