"""How fast the card reads a GEMV's weights, by the width of the column
strip a block streams.

A read-only kernel: 128 blocks of 256 threads each read their own 64 KB of
one (2048, 2048) bf16 weight (qwen2.5-3b's wo), a strip of `width`
columns by 32768 / width rows, as 16-byte loads with 16 in flight a
thread; copies cycle to overflow L2.  Beside it, at the same weights, the
port's out_residual and ``torch.addmm(x, o, wo)``.  Device time a call
from ``torch.profiler``.

Run on a card: ``PYTHONPATH=src python -m repro_torch.probes.read_pattern``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..kernels import build
from ..kernels import fused_decode as fd

_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) read_strips(const uint4* __restrict__ w, long ld16,
                                                   int width16, int rows, int strips_per_band,
                                                   uint4* sink) {
  const int band = blockIdx.x / strips_per_band, strip = blockIdx.x % strips_per_band;
  const uint4* base =
      w + static_cast<long>(band) * rows * ld16 + static_cast<long>(strip) * width16;
  const int total = rows * width16;
  uint4 acc = make_uint4(0, 0, 0, 0);
  constexpr int U = 16;
  for (int i0 = threadIdx.x; i0 < total; i0 += U * 256) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 256, r = i / width16, c = i - r * width16;
      v[u] = i < total ? __ldcs(base + r * ld16 + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc.x ^= v[u].x, acc.y ^= v[u].y, acc.z ^= v[u].z, acc.w ^= v[u].w;
  }
  if (acc.x == 0x12345678u) sink[0] = acc;          // keeps the loads
}
extern "C" int read_strips(const void* w, long ld, int width, int rows, int blocks,
                           int strips_per_band, void* sink, void* stream) {
  read_strips<<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint4*)w, ld / 8, width / 8, rows,
                                                       strips_per_band, (uint4*)sink);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("read_pattern: needs a CUDA card", file=sys.stderr)
        return 1
    out = build.BUILD_ROOT / "probes"
    out.mkdir(parents=True, exist_ok=True)
    (out / "read_pattern.cu").write_text(_SOURCE)
    subprocess.run([build.nvcc(), *build.ARCH, "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
                    str(out / "libread_pattern.so"), str(out / "read_pattern.cu")], check=True)
    lib = ctypes.CDLL(str(out / "libread_pattern.so"))
    lib.read_strips.argtypes = [build.P, build.L, build.I, build.I, build.I, build.I, build.P,
                                build.P]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = [torch.randn(2048, 2048, generator=gen, device=dev).to(torch.bfloat16) for _ in range(8)]
    sink = torch.zeros(16, dtype=torch.int32, device=dev)
    stream = build.stream(dev)

    def timed(fn, iters=64):
        for i in range(8):
            fn(ws[i % 8])
        torch.cuda.synchronize()
        for _ in range(3):          # a profiler window now and then records nothing
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for i in range(iters):
                    fn(ws[i % 8])
                torch.cuda.synchronize()
            total = sum(e.device_time_total for e in p.key_averages()
                        if str(e.device_type).endswith("CUDA"))
            if total > 0:
                return total / iters / 1e3
        raise RuntimeError("the profiler recorded no kernel time in 3 windows")

    ms = {}
    for width in (16, 32, 64, 128, 512, 2048):
        rows, per_band = 32768 // width, 2048 // width
        blocks = 2048 // rows * per_band                 # 128 blocks of 64 KB
        ms[f"strips {width} wide ({2 * width} B a row), {rows} rows, {blocks} blocks"] = timed(
            lambda w: lib.read_strips(w.data_ptr(), 2048, width, rows, blocks, per_band,
                                      sink.data_ptr(), stream))
    o = torch.randn(8, 2048, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn(8, 2048, generator=gen, device=dev).to(torch.bfloat16)
    ms["out_residual B8 K2048 D2048"] = timed(lambda w: fd.out_residual(o, w, x))
    ms["torch.addmm B8 K2048 D2048"] = timed(lambda w: torch.addmm(x, o, w))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"ms": ms, "bytes": 2048 * 2048 * 2, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
