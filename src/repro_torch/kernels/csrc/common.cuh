// Helpers shared by the port's kernels: element conversion, warp and block
// reductions, the tile load from device memory into float shared memory,
// and the PTX of cp.async, tensor copies and mbarriers, ldmatrix, stmatrix,
// the bf16 mma.sync and wgmma, named and cluster barriers, and the host's
// tensor-map encoder.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda.h>   // the tensor map types (the driver is reached through the runtime)
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

// The same, but a wait that lasts about 10 s (2e10 clocks) traps: a fault
// in a pipeline of copies then ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  if (done) return;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// Arrives on `bar` (one of the arrivals its phase counts).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// `bytes` (a multiple of 16) from device memory at `src` (16-byte aligned)
// to shared memory by the copy engine, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
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

// `bytes` (a multiple of 16) from shared memory at `src` to device memory at
// `dst` (both 16-byte aligned) by the copy engine, committed to this
// thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
      : "memory");
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

// -- warpgroup products (wgmma), for sm_90a -----------------------------
//
// A warpgroup is 4 warps (128 threads) that issue one product together.
// The accumulator of an m64nN product is N/2 floats a thread: warp w holds
// rows 16w + lane/4 (elements 4i, 4i+1) and 16w + lane/4 + 8 (4i+2, 4i+3)
// at columns 8i + 2(lane%4), +1.  An A operand in registers is 4 words a
// thread a k-step of 16, in mma.sync's A fragment layout for the warp's 16
// rows.  Operands in shared memory are tiles of rows of 64 bf16 (128
// bytes) in the copy engine's 128-byte swizzle, 1024-byte aligned, read
// through a descriptor.

// The descriptor of a 128-byte-swizzled operand at shared address `addr`:
// `lbo` bytes between its 64-column halves (MN-major operands), `sbo`
// bytes between its groups of 8 rows.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Orders earlier register and shared-memory accesses before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed product groups run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of `d` across this point (an
// accumulator is written by a product the compiler does not see finish).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64n64, float32) = A B (+ d if `accumulate`), A and B bf16 in shared memory,
// both K-major, by their descriptors
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (m64n64, float32) += A B, A (64 x 16 bf16) in registers as `a`, B bf16 in
// shared memory, MN-major (transposed), by its descriptor
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const unsigned (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (m64n128, float32) += A B, A (64 x 16 bf16) in registers as `a`, B bf16 in
// shared memory, MN-major (transposed), by its descriptor
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const unsigned (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Lowers (dec) or raises (inc) this warpgroup's registers a thread to N.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Waits until `threads` threads (whole warps) have reached barrier `id`
// (1-15; 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Waits until every non-exited thread of the cluster has arrived; shared
// memory written before it is visible to every block of the cluster after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no driver library), or null
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Makes the current device's context current on this thread, as the
// driver's tensor-map encoder needs: a thread that has not yet called the
// runtime may not have it (autograd's device thread at a backward's first
// call there, which only allocated from PyTorch's cache).
inline void bind_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
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
