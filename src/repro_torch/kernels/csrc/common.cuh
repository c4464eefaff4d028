// Helpers shared by the port's kernels: element conversion, warp and block
// reductions, and the tile load from device memory into float shared memory.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as JAX's astype(bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; every thread gets the result.  Call it at most
// once per kernel: it reuses one static shared buffer.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = warp_sum(lane < nwarps ? partial[lane] : 0.f);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  return partial[0];
}

// Copies a (rows, cols) tile whose rows lie `src_stride` elements apart in
// device memory into float shared memory with row stride `dst_stride`,
// multiplied by `mul`.  Rows at or past `valid_rows` do not exist in memory
// and are zero-filled.  Loads are 16 bytes a thread when the row length,
// the stride and the base allow it, else one element a thread; neighbouring
// threads read neighbouring addresses either way.  Each thread issues up to
// LOADS_IN_FLIGHT loads before it stores any, so a tile costs one or two
// device-memory round trips instead of one per load.
constexpr int LOADS_IN_FLIGHT = 8;

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long src_stride, int rows, int valid_rows,
                                          int cols, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = LOADS_IN_FLIGHT;
  const bool vec = cols % VEC == 0 && src_stride % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int nv = cols / VEC, total = rows * nv;
    for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
      uint4 u[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = base + k * blockDim.x, r = i / nv, c = (i - r * nv) * VEC;
        u[k] = i < total && r < valid_rows
                   ? *reinterpret_cast<const uint4*>(src + r * src_stride + c)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = base + k * blockDim.x, r = i / nv, c = (i - r * nv) * VEC;
        if (i < total) {
          const T* e = reinterpret_cast<const T*>(&u[k]);
          float* o = dst + r * dst_stride + c;
#pragma unroll
          for (int j = 0; j < VEC; ++j) o[j] = to_float(e[j]) * mul;
        }
      }
    }
  } else {
    const int total = rows * cols;
    for (int base = threadIdx.x; base < total; base += U * blockDim.x) {
      float v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = base + k * blockDim.x, r = i / cols, c = i - r * cols;
        v[k] = i < total && r < valid_rows ? to_float(src[r * src_stride + c]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = base + k * blockDim.x, r = i / cols, c = i - r * cols;
        if (i < total) dst[r * dst_stride + c] = v[k] * mul;
      }
    }
  }
}

// Allows `bytes` of dynamic shared memory for `kernel` where it needs more
// than the 48 KB a launch gets without asking.
template <typename K>
inline cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
