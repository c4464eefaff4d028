// Helpers shared by the port's kernels: element conversion, warp and block
// reductions, the tile load from device memory into float shared memory,
// and the PTX of cp.async, tensor copies and mbarriers, ldmatrix, stmatrix
// and the bf16 mma.sync.
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

// -- asynchronous copies, ldmatrix and the bf16 tensor-core product --------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from device memory to shared memory without passing
// through registers.  With `src_bytes` 0 nothing is read and the 16 bytes
// are zero-filled (rows past the end, head-dim padding); `src` must still
// be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 4 bytes (a float of a strided row), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i in the mma
// fragment layout (lane l: row l / 4, columns 2 (l % 4), +1).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed (lane l: rows 2 (l % 4), +1 of column l / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Four 8x8 bf16 matrices to shared memory, each transposed: register i
// holds matrix i in the mma fragment layout (lane l: row l / 4, columns
// 2 (l % 4), +1), and lanes 8i..8i+7 give the addresses of the stored rows
// of matrix i, which are its columns.
__device__ __forceinline__ void stmatrix_x4_trans(void* p, unsigned r0, unsigned r1, unsigned r2,
                                                  unsigned r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
                   smem_addr(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// -- bulk copies by the copy engine, completed on an mbarrier --------------

// An mbarrier in shared memory whose phase completes after `count` arrivals
// (and the bytes its arrivals announce).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes mbarrier initialisations visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on `bar`, announcing `bytes` more of copies that complete on it.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier shared-memory writes before later accesses
// of the copy engine to the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of a 3-d or 4-d tensor (coordinates innermost first, in elements)
// from device memory to shared memory by the copy engine, as the tensor
// map `map` (in kernel parameter space) lays it out, counted on `bar`;
// elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tensor_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tensor_load_4d(void* dst, const void* map, int c0, int c1, int c2,
                                               int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A box of a 4-d tensor from shared memory to device memory by the copy
// engine, as `map` lays it out; elements outside the tensor are not
// written.  Committed to this thread's bulk group.
__device__ __forceinline__ void tensor_store_4d(const void* map, const void* src, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// c (16x8, float32) += a (16x16, bf16, row-major) * b (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (round to nearest even).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
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
