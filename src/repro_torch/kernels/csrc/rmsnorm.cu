// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, in float32, cast back
// to the input type.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` (repro/kernels/rmsnorm.py).
// Bound on the H100: bytes.  Each element is read, squared and written once,
// a handful of float operations per 2 or 4 bytes moved, far below the
// card's ~295 operations per byte; the time is the row's bytes over the
// memory rate.  Design: one block per row, so a row is reduced without any
// cross-block step; 16-byte loads and stores where the row length allows
// (8 bf16 or 4 float values a thread), one warp-shuffle reduction per warp
// and one across warps in shared memory, all in float32.  The second pass
// reads the row again; at model widths (8 KB a row in bf16) it comes from
// L1/L2, not from device memory.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               T* __restrict__ out, int D, float eps, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + static_cast<long>(blockIdx.x) * D;
  T* outr = out + static_cast<long>(blockIdx.x) * D;
  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * VEC; i < D; i += blockDim.x * VEC) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_float(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float f = to_float(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(repro::block_sum(ss) / D + eps);
  if (vec) {
    for (int i = threadIdx.x * VEC; i < D; i += blockDim.x * VEC) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = from_float<T>(to_float(e[j]) * r * w[i + j]);
      *reinterpret_cast<uint4*>(outr + i) = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      outr[i] = from_float<T>(to_float(xr[i]) * r * w[i]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int D, float eps,
           void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = D % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int per_thread = vec ? VEC : 1;
  int threads = ((D + per_thread - 1) / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<T><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), D,
      eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* out, int rows, int D,
                            float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, rows, D, eps, stream);
}

extern "C" int rmsnorm_f32(const void* x, const void* w, void* out, int rows, int D,
                           float eps, void* stream) {
  return launch<float>(x, w, out, rows, D, eps, stream);
}
