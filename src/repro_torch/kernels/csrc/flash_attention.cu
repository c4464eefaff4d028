// Forward attention for the prompt pass (prefill): causal or not, GQA, an
// optional sliding window and a key offset.
//
//   q (B, Sq, H, D); k, v (B, Sk, KV, D); out (B, Sq, H, D), D <= 128.
//   With qpos = q index + kv_offset, key kpos takes part when kpos < Sk,
//   kpos <= qpos if causal, and kpos > qpos - window with a window.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (repro/kernels/flash_attention.py).  Bound on the H100: at qwen2.5-3b's
// serving prompt (B 8, S 512, 16 heads on 2 KV heads, D 128, causal) the
// call needs ~8.6 GFLOP and ~38 MB, ~9 us at the bf16 tensor-core rate and
// ~11 us at the memory rate, so the two bounds are about even.  This first
// kernel does its products with float32 FMAs on the CUDA cores (67 TFLOP/s
// at most), so its own floor is ~130 us; `mma.sync` or `wgmma` on bf16
// tiles is the next step.
//
// Design: one block per (q tile of 64 rows, head, sequence), reading q, k
// and v in place through their strides, without transposes.  The block
// loops over k tiles of 64 keys in shared memory, computes S = Q K^T and
// P V itself, and keeps the online softmax (running max and sum per row)
// and the output accumulators in float32 registers.  Tiles wholly outside
// the causal and window bounds of the q tile are never loaded.  A head
// dim below 128 (120 for h2o-danube) is handled by bounds, not by padding
// in memory.  Each of the 128 threads owns 4 rows: an 8-column slice of
// the 64 scores and a 16-column slice of the 128 outputs; the 8 threads
// that share rows are neighbouring lanes, so row reductions are 3 shuffles.
#include "common.cuh"

namespace {

using repro::from_float;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups of 4 rows x 8 column lanes
constexpr int DMAX = 128;
constexpr int OC = DMAX / 8;  // output columns per thread

size_t shared_bytes(int D) {
  // Q, K and V tiles with rows padded to D + 1 (conflict-free column reads)
  // and the probabilities (BQ x BK + 1)
  return sizeof(float) * (3 * BQ * (D + 1) + BQ * (BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                       int H, int KV, int D, float scale, int causal, int window,
                       int kv_offset) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int ds = D + 1, ps = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * ds;
  float* Vs = Ks + BK * ds;
  float* Ps = Vs + BK * ds;
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;

  const int nq = min(BQ, Sq - q0);
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  // keys [kbeg, kend) cover every row of this q tile
  const int kend = causal ? min(Sk, q0 + nq + kv_offset) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;

  repro::load_tile(Qs, ds, q + (static_cast<long>(b) * Sq + q0) * q_row + h * D, q_row, BQ,
                   nq, D, scale);
  const T* kb = k + static_cast<long>(b) * Sk * kv_row + g * D;
  const T* vb = v + static_cast<long>(b) * Sk * kv_row + g * D;

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg / BK * BK; k0 < kend; k0 += BK) {
    __syncthreads();                 // the previous tile has been consumed
    const int rows = min(BK, Sk - k0);
    repro::load_tile(Ks, ds, kb + k0 * kv_row, kv_row, BK, rows, D, 1.f);
    repro::load_tile(Vs, ds, vb + k0 * kv_row, kv_row, BK, rows, D, 1.f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr * 4 + i) * ds + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = Ks[(tc + 8 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += a[i] * bk[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i + kv_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool live = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        if (!live) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(tr * 4 + i) * ps + tc + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();   // a row's probabilities come from the 8 lanes that own it

    for (int kk = 0; kk < rows; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr * 4 + i) * ps + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int d = tc + 8 * c;
        if (d < D) {
          const float vv = Vs[kk * ds + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= nq) continue;
    T* orow = out + ((static_cast<long>(b) * Sq + q0 + r) * H + h) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tc + 8 * c;
      if (d < D) orow[d] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KV, int D, float scale, int causal, int window, int kv_offset,
           void* stream) {
  if (D > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(D);
  cudaError_t err = repro::allow_shared(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, D, scale, causal, window, kv_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Sk, int H, int KV, int D, float scale,
                                    int causal, int window, int kv_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, D, scale, causal, window,
                               kv_offset, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Sq, int Sk, int H, int KV, int D, float scale,
                                   int causal, int window, int kv_offset, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, D, scale, causal, window, kv_offset,
                       stream);
}
