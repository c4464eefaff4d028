// One decode token through an attention sublayer, as a chain of three
// launches on one stream:
//
//   (i)   fused_qkv_rope_kernel: rmsnorm of x, the Q/K/V projections
//         (+ bias), rope at `pos`; writes the new k and v rows into ring
//         slot pos % C of the caches, q to a buffer, and
//         cache_len = min(pos + 1, C) to a device int;
//   (ii)  decode_attention (decode_attention.cu) over the updated caches
//         at that cache_len;
//   (iii) fused_out_residual_kernel: out = x + o @ wo.
//
//   x (B, D) in T; norm (D,) float32; wq (D, H*hd), wk, wv (D, KV*hd),
//   wo (H*hd, D) and the optional biases in T; pos a device int32;
//   caches (B, C, KV, hd) in T.  Everything between the loads and the
//   stores is float32.
//
// Replaces the Pallas TPU kernel `_fused_kernel` (repro/kernels/
// fused_decode.py), which runs the whole sublayer in one kernel, one grid
// step per batch row, and so streams the weights once per row; and masks
// the stale slot pos % C while adding the fresh token as an extra column,
// because its cache write happens outside the kernel.  Here the slot is
// written in place first, so (ii) is attention over the updated cache,
// which is the same function.  Bound on the H100: bytes.  At qwen2.5-3b's
// decode (B 8) the weights (18.9 MB) and the live cache are read once a
// step and each weight meets B rows: 2 B operations per 2 bytes, far below
// the card's ~295 operations per byte.
//
// Design of (i) and (iii), hand-written GEMVs: every block loads the B
// rows it serves (at most 8) into shared memory as float32, normalised in
// (i), which is B x D of recomputation per block and cheap.  A block owns
// 16 output columns (32 bytes of a bf16 weight row: one memory sector) and
// its 8 warps split the rows of the weight; a thread owns VEC adjacent
// columns (16-byte loads: 8 bf16 or 4 float32, where the layout allows,
// else 1) and keeps 8 loads in flight, and each weight element it loads
// meets every batch row from shared memory.  The partial sums meet by warp
// shuffles and then across warps in shared memory.  In (i) a block's 16
// columns are 8 rope pairs (i, i + hd/2) of one head, so the rotation
// needs no second pass: after the reduction lane s holds column p0 + s and
// lane s + 8 its partner.  The grid is (heads x pair tiles, batch groups):
// 160 blocks at qwen (20 Q/K/V heads x 8 tiles), 128 for (iii) at D 2048,
// enough to give every one of the 132 SMs a block.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLOTS = 16;       // output columns a block
constexpr int BG = 8;           // batch rows a block, at most
constexpr int PAIRS = SLOTS / 2;  // rope pairs a block in (i)
constexpr size_t SMEM_BUDGET = 200 * 1024;

size_t red_floats() { return WARPS * BG * SLOTS + BG; }

// Rows a block may hold in shared memory, for rows of length K.
int batch_group(int K) {
  const long fit = (static_cast<long>(SMEM_BUDGET) / sizeof(float) - red_floats()) / K;
  return static_cast<int>(fit < BG ? fit : BG);
}

// VEC elements of a weight row as loaded, converted to float at use, so a
// load in flight holds 4 registers (16 bytes), not VEC floats.
template <typename T, int VEC>
struct Vec {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "1 element or 16 bytes");
  uint4 u;
  __device__ __forceinline__ void load(const T* p, bool ok) {
    if constexpr (VEC == 1) {
      reinterpret_cast<T*>(&u)[0] = ok ? *p : from_float<T>(0.f);
    } else {
      u = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ float operator[](int e) const {
    return to_float(reinterpret_cast<const T*>(&u)[e]);
  }
};

// Rows [0, bg) of `src` (row length K, contiguous) into hs[bg][K] as
// float32; with `norm`, each row times rsqrt(mean(x^2) + eps) times norm.
template <typename T>
__device__ void load_rows(float* hs, float* rscale, const T* src, int K, int bg,
                          const float* norm, float eps) {
  repro::load_tile(hs, K, src, K, bg, bg, K, 1.f);
  __syncthreads();
  if (norm == nullptr) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < bg; r += WARPS) {
    float ss = 0.f;
    for (int k = lane; k < K; k += 32) ss += hs[r * K + k] * hs[r * K + k];
    ss = repro::warp_sum(ss);
    if (lane == 0) rscale[r] = rsqrtf(ss / K + eps);
  }
  __syncthreads();
  // each thread loads its columns of `norm` at once, then scales every row
  constexpr int U = 8;
  for (int k0 = threadIdx.x; k0 < K; k0 += U * THREADS) {
    float w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * THREADS;
      w[u] = k < K ? norm[k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * THREADS;
      if (k >= K) break;
      for (int r = 0; r < bg; ++r) hs[r * K + k] = hs[r * K + k] * rscale[r] * w[u];
    }
  }
  __syncthreads();
}

// y[b][s] = sum_k hs[b][k] * W[k][col(s)] for the block's SLOTS column
// slots; `wcol` points at row 0 of this thread's first column, `ld` is the
// row stride.  Thread (warp w, lane) owns slots [(lane % TPR) * VEC, +VEC)
// and rows w * RPW + lane / TPR + i * WARPS * RPW.  Returns, in warp
// b < bg, lane s < SLOTS, the sum for batch row b and slot s (0 elsewhere).
template <typename T, int VEC>
__device__ float gemv(const float* hs, float* red, int K, int bg, const T* wcol, long ld,
                      bool valid) {
  constexpr int TPR = SLOTS / VEC;      // threads a row
  constexpr int RPW = 32 / TPR;         // rows a warp covers at once
  constexpr int U = 8;                  // loads in flight a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ro = lane / TPR, sbase = (lane % TPR) * VEC;
  float acc[BG][VEC];
#pragma unroll
  for (int b = 0; b < BG; ++b)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[b][e] = 0.f;

  for (int k0 = warp * RPW + ro; k0 < K; k0 += U * WARPS * RPW) {
    Vec<T, VEC> w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * WARPS * RPW;
      w[u].load(wcol + k * ld, valid && k < K);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * WARPS * RPW;
      if (k >= K) break;
      float wf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) wf[e] = w[u][e];
#pragma unroll
      for (int b = 0; b < BG; ++b) {
        if (b < bg) {
          const float hb = hs[b * K + k];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[b][e] += hb * wf[e];
        }
      }
    }
  }
  // the lanes of one slot differ by multiples of TPR
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
    for (int b = 0; b < BG; ++b)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[b][e] += __shfl_xor_sync(0xffffffffu, acc[b][e], o);
  if (ro == 0) {
#pragma unroll
    for (int b = 0; b < BG; ++b)
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[(warp * BG + b) * SLOTS + sbase + e] = acc[b][e];
  }
  __syncthreads();
  float y = 0.f;
  if (warp < bg && lane < SLOTS) {
    for (int w = 0; w < WARPS; ++w) y += red[(w * BG + warp) * SLOTS + lane];
  }
  return y;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fused_qkv_rope_kernel(const T* __restrict__ x, const float* __restrict__ norm,
                      const T* __restrict__ wq, const T* __restrict__ wk,
                      const T* __restrict__ wv, const T* __restrict__ bq,
                      const T* __restrict__ bk, const T* __restrict__ bv,
                      const int* __restrict__ pos_ptr, T* __restrict__ q_out,
                      T* __restrict__ k_cache, T* __restrict__ v_cache,
                      int* __restrict__ clen_out, int B, int D, int H, int KV, int hd, int C,
                      int tiles, int bgmax, float eps, float theta) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hh = blockIdx.x / tiles, tile = blockIdx.x - hh * tiles;
  const int b0 = blockIdx.y * bgmax, bg = min(bgmax, B - b0);
  const int d2 = hd / 2, pair_tiles = (d2 + PAIRS - 1) / PAIRS;
  const bool tail = tile >= pair_tiles;          // the odd head-dim column, unrotated
  const int p0 = tile * PAIRS;
  const int pos = *pos_ptr, slot = pos % C;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) clen_out[0] = min(pos + 1, C);

  const T* w;
  const T* bias;
  int ncols, mh, kind;                           // kind 0 q, 1 k, 2 v
  if (hh < H) {
    w = wq, bias = bq, ncols = H * hd, mh = hh, kind = 0;
  } else if (hh < H + KV) {
    w = wk, bias = bk, ncols = KV * hd, mh = hh - H, kind = 1;
  } else {
    w = wv, bias = bv, ncols = KV * hd, mh = hh - H - KV, kind = 2;
  }

  float* hs = smem;                              // [bg][D]
  float* red = hs + bgmax * D;                   // [WARPS][BG][SLOTS]
  float* rscale = red + WARPS * BG * SLOTS;      // [BG]
  load_rows(hs, rscale, x + static_cast<long>(b0) * D, D, bg, norm, eps);

  // this thread's first column slot, as a column of the head
  constexpr int TPR = SLOTS / VEC;
  const int sbase = (lane % TPR) * VEC;
  const int half = sbase / PAIRS, e0 = sbase - half * PAIRS;
  const bool valid = tail ? sbase == 0 : p0 + e0 < d2;
  const int col = tail ? 2 * d2 : half * d2 + p0 + e0;
  const float y = gemv<T, VEC>(hs, red, D, bg, w + mh * hd + col, ncols, valid);

  if (warp >= bg) return;
  // lane s: slot s of batch row b0 + warp
  const int s = lane, sh = s / PAIRS, se = s - sh * PAIRS;
  const bool live = s < SLOTS && (tail ? s == 0 : p0 + se < d2);
  const int c = tail ? 2 * d2 : sh * d2 + p0 + se;
  float v = y;
  if (live && bias != nullptr) v += to_float(bias[mh * hd + c]);
  const float partner = __shfl_xor_sync(0xffffffffu, v, PAIRS);
  if (!live) return;
  if (kind < 2 && !tail) {
    const float freq = powf(theta, -(static_cast<float>(p0 + se) / static_cast<float>(d2)));
    const float ang = static_cast<float>(pos) * freq;
    const float cs = cosf(ang), sn = sinf(ang);
    v = sh == 0 ? v * cs - partner * sn : partner * sn + v * cs;
  }
  const int b = b0 + warp;
  if (kind == 0) {
    q_out[(static_cast<long>(b) * H + mh) * hd + c] = from_float<T>(v);
  } else {
    T* cache = kind == 1 ? k_cache : v_cache;
    cache[((static_cast<long>(b) * C + slot) * KV + mh) * hd + c] = from_float<T>(v);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fused_out_residual_kernel(const T* __restrict__ o, const T* __restrict__ wo,
                          const T* __restrict__ x, T* __restrict__ out, int B, int K, int D,
                          int bgmax) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * SLOTS;
  const int b0 = blockIdx.y * bgmax, bg = min(bgmax, B - b0);
  float* hs = smem;
  float* red = hs + bgmax * K;
  load_rows(hs, red, o + static_cast<long>(b0) * K, K, bg, static_cast<const float*>(nullptr),
            0.f);
  constexpr int TPR = SLOTS / VEC;
  const int n = n0 + (lane % TPR) * VEC;
  const float y = gemv<T, VEC>(hs, red, K, bg, wo + n, D, n < D);
  if (warp >= bg || lane >= SLOTS || n0 + lane >= D) return;
  const long i = static_cast<long>(b0 + warp) * D + n0 + lane;
  out[i] = from_float<T>(to_float(x[i]) + y);
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_qkv(const void* x, const void* norm, const void* wq, const void* wk, const void* wv,
               const void* bq, const void* bk, const void* bv, const void* pos, void* q_out,
               void* k_cache, void* v_cache, void* clen, int B, int D, int H, int KV, int hd,
               int C, float eps, float theta, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int d2 = hd / 2;
  const int tiles = (d2 + PAIRS - 1) / PAIRS + (hd % 2);
  const int bgmax = min(batch_group(D), B);
  if (bgmax < 1 || hd < 1 || H < 1 || KV < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = hd % V == 0 && d2 % V == 0 && aligned(wq) && aligned(wk) && aligned(wv);
  const size_t smem = (bgmax * static_cast<size_t>(D) + red_floats()) * sizeof(float);
  const dim3 grid(tiles * (H + 2 * KV), (B + bgmax - 1) / bgmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    cudaError_t err = repro::allow_shared(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(norm), static_cast<const T*>(wq),
        static_cast<const T*>(wk), static_cast<const T*>(wv), static_cast<const T*>(bq),
        static_cast<const T*>(bk), static_cast<const T*>(bv), static_cast<const int*>(pos),
        static_cast<T*>(q_out), static_cast<T*>(k_cache), static_cast<T*>(v_cache),
        static_cast<int*>(clen), B, D, H, KV, hd, C, tiles, bgmax, eps, theta);
    return static_cast<int>(cudaGetLastError());
  };
  return vec ? run(fused_qkv_rope_kernel<T, V>) : run(fused_qkv_rope_kernel<T, 1>);
}

template <typename T>
int launch_out(const void* o, const void* wo, const void* x, void* out, int B, int K, int D,
               void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int bgmax = min(batch_group(K), B);
  if (bgmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % V == 0 && aligned(wo);
  const size_t smem = (bgmax * static_cast<size_t>(K) + red_floats()) * sizeof(float);
  const dim3 grid((D + SLOTS - 1) / SLOTS, (B + bgmax - 1) / bgmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    cudaError_t err = repro::allow_shared(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, smem, st>>>(static_cast<const T*>(o), static_cast<const T*>(wo),
                                        static_cast<const T*>(x), static_cast<T*>(out), B, K,
                                        D, bgmax);
    return static_cast<int>(cudaGetLastError());
  };
  return vec ? run(fused_out_residual_kernel<T, V>) : run(fused_out_residual_kernel<T, 1>);
}

}  // namespace

#define QKV_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* x, const void* norm, const void* wq, const void* wk,       \
                      const void* wv, const void* bq, const void* bk, const void* bv,        \
                      const void* pos, void* q_out, void* k_cache, void* v_cache, void* clen, \
                      int B, int D, int H, int KV, int hd, int C, float eps, float theta,    \
                      void* stream) {                                                        \
    return launch_qkv<T>(x, norm, wq, wk, wv, bq, bk, bv, pos, q_out, k_cache, v_cache, clen, \
                         B, D, H, KV, hd, C, eps, theta, stream);                            \
  }

#define OUT_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* o, const void* wo, const void* x, void* out, int B, int K, \
                      int D, void* stream) {                                                 \
    return launch_out<T>(o, wo, x, out, B, K, D, stream);                                    \
  }

QKV_ENTRY(fused_qkv_rope_bf16, __nv_bfloat16)
QKV_ENTRY(fused_qkv_rope_f32, float)
OUT_ENTRY(fused_out_residual_bf16, __nv_bfloat16)
OUT_ENTRY(fused_out_residual_f32, float)
