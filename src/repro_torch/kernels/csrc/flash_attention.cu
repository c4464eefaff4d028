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
// call needs ~8.6 GFLOP and ~38 MB: ~9 us at the bf16 tensor-core rate
// (989 TFLOP/s) and ~11 us at the memory rate (3.35 TB/s), about even.
// The products have to run on the tensor cores to come near either:
// float32 FMAs on the CUDA cores (67 TFLOP/s) alone take ~130 us.
//
// bf16, `flash_attention_mma_kernel` (FlashAttention-2's forward): one
// block of 4 warps per (q tile of 64 rows, head, sequence), each warp
// owning 16 query rows.  Q, K and V stay bf16 in shared memory, in tiles
// of 64 rows by D rounded up to 16 (a template), whose 16-byte chunks are
// XOR-swizzled by row so that `ldmatrix` meets no bank conflicts.  Tiles
// arrive by 16-byte `cp.async`, zero-filled past Sq or Sk and in the
// head-dim padding (120 -> 128 for h2o-danube), in a ring of two stages:
// the next K/V tile is in flight while this one is used.  S = Q K^T and
// O += P V are `mma.sync.m16n8k16` bf16 products with float32 sums; the Q
// fragments stay in registers for the whole key loop, K comes in through
// `ldmatrix.x4`, V through `ldmatrix.x4.trans`.  The online softmax runs on
// the accumulator fragments (row max and sum over a quad: two shuffles
// each), with the scale folded into exp2f (scale * log2 e), so q is never
// rounded after scaling; P becomes the bf16 A fragments of P V in
// registers; m, l and O stay float32.  Key tiles wholly outside the causal
// or window bounds of the q tile are never loaded, only tiles that cross
// the diagonal, the window's edge or Sk compute a mask, and the q tiles
// run in reverse so the longest causal rows start first.
//
// float32, `flash_attention_f32_kernel`: the CUDA-core kernel, with q, k
// and v widened in shared memory.  A bf16 tensor-core product cannot hold
// float32 inputs to the 1e-4 that the float32 model tests ask; every
// served model runs bf16.  One block per (q tile of 64 rows, head,
// sequence); each of 128 threads owns 4 rows: an 8-column slice of the 64
// scores and a 16-column slice of the 128 outputs; row reductions are 3
// shuffles among 8 neighbouring lanes.
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// -- float32: CUDA cores ----------------------------------------------------

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

__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H, int KV, int D,
                           float scale, int causal, int window, int kv_offset) {
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
  const float* kb = k + static_cast<long>(b) * Sk * kv_row + g * D;
  const float* vb = v + static_cast<long>(b) * Sk * kv_row + g * D;

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
    float* orow = out + ((static_cast<long>(b) * Sq + q0 + r) * H + h) * D;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tc == 0)   // q was scaled on load, so m is in the softmax's units
      lse[(static_cast<long>(b) * H + h) * Sq + q0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tc + 8 * c;
      if (d < D) orow[d] = acc[i][c] / denom;
    }
  }
}


// -- bf16: tensor cores -----------------------------------------------------

constexpr int TILE_ROWS = 64;   // query rows a block and keys a tile (BQ = BK)
constexpr int WARPS = 4;        // 16 query rows each
constexpr int STAGES = 2;       // K/V tiles in flight

// Element offset of 16-byte chunk `chunk` of tile row `row`, for rows of
// CH chunks.  The chunk index is XORed with bits of the row so that the 8
// rows an ldmatrix reads at one column fall in 8 different bank groups.
template <int CH>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (CH >= 8) return (row * CH + (chunk ^ (row & 7))) * 8;
  else return (row * CH + (chunk ^ ((row / (8 / CH)) & (CH - 1)))) * 8;
}

// One 64-row tile (rows `stride` elements apart from `src`) into swizzled
// shared memory, as cp.async copies the caller commits.  Rows at or past
// `valid_rows` and columns at or past D are zero.  `safe` is any valid
// address, given to the copies that read nothing.  Without `vec` (D not a
// multiple of 8, or a base off 16 bytes) the tile is stored element by
// element, synchronously.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, const bf16* safe,
                                               long stride, int valid_rows, int D, bool vec) {
  constexpr int CH = DP / 8;
  if (vec) {
#pragma unroll
    for (int i = 0; i < TILE_ROWS * CH / (WARPS * 32); ++i) {
      const int idx = threadIdx.x + i * WARPS * 32, row = idx / CH, ch = idx % CH;
      const bool ok = row < valid_rows && ch * 8 < D;
      repro::cp_async16(dst + swz<CH>(row, ch), ok ? src + row * stride + ch * 8 : safe,
                        ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < TILE_ROWS * DP; idx += WARPS * 32) {
      const int row = idx / DP, col = idx % DP;
      dst[swz<CH>(row, col / 8) + col % 8] =
          row < valid_rows && col < D ? src[row * stride + col] : __float2bfloat16_rn(0.f);
    }
  }
}

// DP: the head dim rounded up to 16 (16, 32, 64 or 128).
template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H, int KV, int D,
                           float scale_log2, int causal, int window, int kv_offset, int vec) {
  constexpr int CH = DP / 8;            // 16-byte chunks a tile row
  constexpr int KSTEPS = DP / 16;       // k steps of Q K^T
  constexpr int NT = TILE_ROWS / 8;     // 8-key column tiles of S
  constexpr int DT = DP / 8;            // 8-dim column tiles of O
  constexpr int TILE = TILE_ROWS * DP;  // elements a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;                 // [STAGES][TILE]
  bf16* Vs = Ks + STAGES * TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE_ROWS;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;   // fragment row and column pair
  const int nq = min(TILE_ROWS, Sq - q0);
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  // keys [kbeg, kend) cover every row of this q tile
  const int kend = causal ? min(Sk, q0 + nq + kv_offset) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;
  const int t0 = kbeg / TILE_ROWS;
  const int ntiles = kend > kbeg ? (kend - 1) / TILE_ROWS - t0 + 1 : 0;

  const bf16* qb = q + (static_cast<long>(b) * Sq + q0) * q_row + static_cast<long>(h) * D;
  const bf16* kb = k + static_cast<long>(b) * Sk * kv_row + static_cast<long>(g) * D;
  const bf16* vb = v + static_cast<long>(b) * Sk * kv_row + static_cast<long>(g) * D;

  load_tile_bf16<DP>(Qs, qb, qb, q_row, nq, D, vec);
  if (ntiles > 0) {
    const int k0 = t0 * TILE_ROWS;
    load_tile_bf16<DP>(Ks, kb + k0 * kv_row, kb, kv_row, Sk - k0, D, vec);
    load_tile_bf16<DP>(Vs, vb + k0 * kv_row, vb, kv_row, Sk - k0, D, vec);
  }
  repro::cp_async_commit();

  float o[DT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  unsigned qf[KSTEPS][4];

  for (int i = 0; i < ntiles; ++i) {
    const int st = i & 1, k0 = (t0 + i) * TILE_ROWS;
    if (i + 1 < ntiles) {   // the next tile into the other stage, freed at the end of i - 1
      const int kn = k0 + TILE_ROWS;
      load_tile_bf16<DP>(Ks + (st ^ 1) * TILE, kb + kn * kv_row, kb, kv_row, Sk - kn, D, vec);
      load_tile_bf16<DP>(Vs + (st ^ 1) * TILE, vb + kn * kv_row, vb, kv_row, Sk - kn, D, vec);
    }
    repro::cp_async_commit();      // one group an iteration, empty or not
    repro::cp_async_wait<1>();     // all but the newest: Q and tile i have landed
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        repro::ldmatrix_x4(qf[kk], Qs + swz<CH>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                kk * 2 + (lane >> 4)));
    }
    const bf16* Kt = Ks + st * TILE;
    const bf16* Vt = Vs + st * TILE;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        unsigned kf[4];
        repro::ldmatrix_x4(kf, Kt + swz<CH>(jj * 16 + (lane & 7) + (lane >> 4) * 8,
                                            kk * 2 + ((lane >> 3) & 1)));
        repro::mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
        repro::mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const bool edge = k0 + TILE_ROWS > Sk ||
                      (causal && k0 + TILE_ROWS - 1 > q0 + kv_offset) ||
                      (window > 0 && k0 <= q0 + TILE_ROWS - 1 + kv_offset - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + warp * 16 + gr + (e >> 1) * 8 + kv_offset;
          const int kpos = k0 + j * 8 + tq * 2 + (e & 1);
          const bool live = kpos < Sk && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
          if (!live) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments: this lane holds rows gr (e 0, 1) and
    // gr + 8 (e 2, 3); the quad of lanes gr * 4 .. + 3 holds the rest of them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float alpha = exp2f(m[r] * scale_log2 - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(fmaf(s[j][2 * r + c], scale_log2, -base));
          s[j][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * alpha + sum;     // this lane's part; the quad's sum at the end
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P's A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const unsigned pa[4] = {repro::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              repro::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              repro::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              repro::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DT / 2; ++dd) {
        unsigned vf[4];
        repro::ldmatrix_x4_trans(vf, Vt + swz<CH>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                  dd * 2 + (lane >> 4)));
        repro::mma_bf16(o[2 * dd], pa, vf[0], vf[1]);
        repro::mma_bf16(o[2 * dd + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // stage st is free for the load two tiles on
  }
  repro::cp_async_wait<0>();   // no copy outlives the block (Q alone, when no tile is live)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = warp * 16 + gr + r * 8;
    if (row >= nq) continue;
    if (lse != nullptr && tq == 0)   // natural log of the row's sum of exp(scale * s)
      lse[(static_cast<long>(b) * H + h) * Sq + q0 + row] =
          sum > 0.f ? (m[r] * scale_log2 + log2f(sum)) * 0.6931471805599453f : INFINITY;
    bf16* orow = out + (static_cast<long>(b) * Sq + q0 + row) * q_row + static_cast<long>(h) * D;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + tq * 2;
      const float x = o[d][2 * r] * inv, y = o[d][2 * r + 1] * inv;
      if (col + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < D) orow[col] = __float2bfloat16_rn(x);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
               int Sk, int H, int KV, int D, float scale, int causal, int window, int kv_offset,
               void* stream) {
  const size_t smem = (1 + 2 * STAGES) * TILE_ROWS * DP * sizeof(bf16);
  cudaError_t err = repro::allow_shared(flash_attention_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = D % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((Sq + TILE_ROWS - 1) / TILE_ROWS, H, B);
  flash_attention_mma_kernel<DP><<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, D,
      scale * 1.4426950408889634f, causal, window, kv_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

// -- the backward pass ------------------------------------------------------
//
// Given q, k, v, the forward's output o and row logsumexp lse (natural log
// of the sum of exp(scale * q.k) over the live keys), and dO: three passes,
// with no atomics, so that two calls on the same inputs give the same bits.
// The JAX package has no backward kernel (it differentiates its composed
// tiers); these compute the gradient of the function that the Pallas TPU
// kernel `_flash_kernel` (repro/kernels/flash_attention.py) computes.
//  (1) Dv = rowsum(dO * o), float32, a row each;
//  (2) dK and dV by key tile: the block keeps its K and V rows in shared
//      memory and dK, dV in registers, and walks every q tile that sees one
//      of its keys: P^T = exp(scale K Q^T - lse), dP^T = V dO^T, dS^T = P^T
//      (dP^T - Dv), dV += P^T dO, dK += scale dS^T Q.  GQA's sum over the
//      H/KV query heads of a KV head is taken in head order; K and V are
//      never repeated;
//  (3) dQ by query tile: Q and dO in shared memory, dQ in registers, over
//      the key tiles its rows see: dQ += scale dS K.
// Both recompute the scores: seven products a live (q, key) pair where the
// bound counts five.  Bound on the H100 at qwen2.5-3b's training shape (B
// 2, S 4096, H 16, KV 2, D 128, causal; 2.68e8 live pairs): operations,
// 4.8e11 FLOP, 0.35 ms at the bf16 tensor-core rate; the bytes (0.15 GB)
// take 0.05 ms.  Only wgmma reaches that rate: bf16 runs on it
// (`flash_bwd_*_wgmma_kernel`, below), fed by tensor copies into a ring of
// stages, with GQA's sum in a thread block cluster's distributed shared
// memory, so that no per-head partials go through device memory.  Shapes
// they do not take (D % 8, an input off 16 bytes, more than 8 query heads
// a KV head) and float32 run on the CUDA cores (`flash_bwd_dkdv_kernel`, a
// block per (64 keys, KV head) walking its query heads, and
// `flash_bwd_dq_kernel`): each
// thread holds a 4 x 4 patch of the 64 x 64 score tile (rows tr*4..,
// columns tc + 16 j) and a 4 x 8 patch of the 64 x D accumulators (columns
// tc + 16 c), all in float32 shared memory.

constexpr int BWD_THREADS = 256;
constexpr int BWD_TILE = 64;
constexpr int BWD_COLS = DMAX / 16;   // accumulator columns a thread

size_t bwd_shared_bytes(int D) {
  // four 64-row tiles (rows padded to D + 1), the 64 x 64 probability or dS
  // tiles (rows padded to 65) and lse, Dv of the 64 query rows
  return sizeof(float) * (4 * BWD_TILE * (D + 1) + 2 * BWD_TILE * (BWD_TILE + 1) +
                          2 * BWD_TILE);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dv_rows, int rows, int Sq, int H, int D) {
  const long row = static_cast<long>(blockIdx.x) * (BWD_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += repro::to_float(o[row * D + d]) * repro::to_float(dout[row * D + d]);
  acc = repro::warp_sum(acc);
  // row = (b * Sq + i) * H + h  ->  (b * H + h) * Sq + i
  const long h = row % H, bi = row / H, i = bi % Sq, b = bi / Sq;
  if (lane == 0) dv_rows[(b * H + h) * Sq + i] = acc;
}

// Scores of one 64 x 64 tile for this thread's 4 x 4 patch: s = A_r . B_c
// and t = C_r . E_c over D, where rows r index A and C, columns c B and E.
__device__ __forceinline__ void bwd_products(float (&s)[4][4], float (&t)[4][4], const float* A,
                                             const float* Bm, const float* C, const float* E,
                                             int ds, int D, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(tr * 4 + i) * ds + d];
      c[i] = C[(tr * 4 + i) * ds + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = Bm[(tc + 16 * j) * ds + d];
      e[j] = E[(tc + 16 * j) * ds + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * b[j];
        t[i][j] += c[i] * e[j];
      }
  }
}

__device__ __forceinline__ bool bwd_live(int kpos, int qi, int Sk, int Sq, int causal,
                                         int window, int kv_offset) {
  const int qpos = qi + kv_offset;
  return kpos < Sk && qi < Sq && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ dv_rows, T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Sk, int H, int KV, int D, float scale, int causal, int window,
                      int kv_offset) {
  extern __shared__ float smem[];
  const int ds = D + 1, ps = BWD_TILE + 1;
  float* Ks = smem;
  float* Vs = Ks + BWD_TILE * ds;
  float* Qs = Vs + BWD_TILE * ds;
  float* dOs = Qs + BWD_TILE * ds;
  float* Ps = dOs + BWD_TILE * ds;       // P^T: rows keys, columns queries
  float* dSs = Ps + BWD_TILE * ps;       // dS^T, the same
  float* lse_s = dSs + BWD_TILE * ps;
  float* dv_s = lse_s + BWD_TILE;
  const int k0 = blockIdx.x * BWD_TILE, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV, tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int nk = min(BWD_TILE, Sk - k0);
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  const float scale_log2 = scale * 1.4426950408889634f;

  const long kv_base = (static_cast<long>(b) * Sk + k0) * kv_row + static_cast<long>(g) * D;
  repro::load_tile(Ks, ds, k + kv_base, kv_row, BWD_TILE, nk, D, 1.f);
  repro::load_tile(Vs, ds, v + kv_base, kv_row, BWD_TILE, nk, D, 1.f);

  // the q rows that see a key of this tile: qpos >= k0 if causal, and
  // qpos <= (last key) + window - 1 with a window
  const int qbeg = causal ? max(0, k0 - kv_offset) : 0;
  const int qend = window > 0 ? min(Sq, k0 + nk - 1 + window - kv_offset) : Sq;

  float gk[4][BWD_COLS], gv[4][BWD_COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < BWD_COLS; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    for (int q0 = qbeg / BWD_TILE * BWD_TILE; q0 < qend; q0 += BWD_TILE) {
      const int nq = min(BWD_TILE, Sq - q0);
      __syncthreads();   // the previous q tile has been consumed
      const long q_base = (static_cast<long>(b) * Sq + q0) * q_row + static_cast<long>(h) * D;
      repro::load_tile(Qs, ds, q + q_base, q_row, BWD_TILE, nq, D, 1.f);
      repro::load_tile(dOs, ds, dout + q_base, q_row, BWD_TILE, nq, D, 1.f);
      if (tid < BWD_TILE) {
        const long r = (static_cast<long>(b) * H + h) * Sq + q0 + tid;
        lse_s[tid] = tid < nq ? lse[r] : INFINITY;
        dv_s[tid] = tid < nq ? dv_rows[r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      bwd_products(s, dp, Ks, Qs, Vs, dOs, ds, D, tr, tc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tr * 4 + i, c = tc + 16 * j;
          const bool live = bwd_live(k0 + r, q0 + c, Sk, Sq, causal, window, kv_offset);
          const float p = live ? exp2f(s[i][j] * scale_log2 - lse_s[c] * 1.4426950408889634f)
                               : 0.f;
          Ps[r * ps + c] = p;
          dSs[r * ps + c] = p * (dp[i][j] - dv_s[c]);
        }
      __syncthreads();

      for (int c = 0; c < nq; ++c) {
        float pr[4], sr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = Ps[(tr * 4 + i) * ps + c];
          sr[i] = dSs[(tr * 4 + i) * ps + c];
        }
#pragma unroll
        for (int cc = 0; cc < BWD_COLS; ++cc) {
          const int d = tc + 16 * cc;
          if (d < D) {
            const float o = dOs[c * ds + d], qq = Qs[c * ds + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gv[i][cc] += pr[i] * o;
              gk[i][cc] += sr[i] * qq;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= nk) continue;
    const long base = kv_base + static_cast<long>(r) * kv_row;
#pragma unroll
    for (int cc = 0; cc < BWD_COLS; ++cc) {
      const int d = tc + 16 * cc;
      if (d < D) {
        dk[base + d] = repro::from_float<T>(gk[i][cc] * scale);
        dv[base + d] = repro::from_float<T>(gv[i][cc]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dv_rows, T* __restrict__ dq, int Sq, int Sk, int H,
                    int KV, int D, float scale, int causal, int window, int kv_offset) {
  extern __shared__ float smem[];
  const int ds = D + 1, ps = BWD_TILE + 1;
  float* Qs = smem;
  float* dOs = Qs + BWD_TILE * ds;
  float* Ks = dOs + BWD_TILE * ds;
  float* Vs = Ks + BWD_TILE * ds;
  float* dSs = Vs + BWD_TILE * ds;       // rows queries, columns keys
  float* lse_s = dSs + 2 * BWD_TILE * ps;
  float* dv_s = lse_s + BWD_TILE;
  const int q0 = blockIdx.x * BWD_TILE, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV), tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int nq = min(BWD_TILE, Sq - q0);
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  const float scale_log2 = scale * 1.4426950408889634f;

  const long q_base = (static_cast<long>(b) * Sq + q0) * q_row + static_cast<long>(h) * D;
  repro::load_tile(Qs, ds, q + q_base, q_row, BWD_TILE, nq, D, 1.f);
  repro::load_tile(dOs, ds, dout + q_base, q_row, BWD_TILE, nq, D, 1.f);
  if (tid < BWD_TILE) {
    const long r = (static_cast<long>(b) * H + h) * Sq + q0 + tid;
    lse_s[tid] = tid < nq ? lse[r] : INFINITY;
    dv_s[tid] = tid < nq ? dv_rows[r] : 0.f;
  }
  // keys [kbeg, kend) cover every row of this q tile, as in the forward
  const int kend = causal ? min(Sk, q0 + nq + kv_offset) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;
  const long kv_base = static_cast<long>(b) * Sk * kv_row + static_cast<long>(g) * D;

  float gq[4][BWD_COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < BWD_COLS; ++c) gq[i][c] = 0.f;

  for (int k0 = kbeg / BWD_TILE * BWD_TILE; k0 < kend; k0 += BWD_TILE) {
    const int nk = min(BWD_TILE, Sk - k0);
    __syncthreads();   // the previous key tile has been consumed
    repro::load_tile(Ks, ds, k + kv_base + k0 * kv_row, kv_row, BWD_TILE, nk, D, 1.f);
    repro::load_tile(Vs, ds, v + kv_base + k0 * kv_row, kv_row, BWD_TILE, nk, D, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    bwd_products(s, dp, Qs, Ks, dOs, Vs, ds, D, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr * 4 + i, c = tc + 16 * j;
        const bool live = bwd_live(k0 + c, q0 + r, Sk, Sq, causal, window, kv_offset);
        const float p = live ? exp2f(s[i][j] * scale_log2 - lse_s[r] * 1.4426950408889634f)
                             : 0.f;
        dSs[r * ps + c] = p * (dp[i][j] - dv_s[r]);
      }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      float sr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = dSs[(tr * 4 + i) * ps + c];
#pragma unroll
      for (int cc = 0; cc < BWD_COLS; ++cc) {
        const int d = tc + 16 * cc;
        if (d < D) {
          const float kk = Ks[c * ds + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) gq[i][cc] += sr[i] * kk;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= nq) continue;
    T* row = dq + q_base + static_cast<long>(r) * q_row;
#pragma unroll
    for (int cc = 0; cc < BWD_COLS; ++cc) {
      const int d = tc + 16 * cc;
      if (d < D) row[d] = repro::from_float<T>(gq[i][cc] * scale);
    }
  }
}

// -- the bf16 backward on wgmma -------------------------------------------
//
// flash_bwd_rows_kernel writes each row's Dv and logsumexp (in log2 units)
// into float32 (B, H, Sqp) arrays padded to whole 64-row slices.  Then two
// kernels whose products are wgmma (m64nNk16, bf16, float32 sums) fed by
// tensor copies into a ring of RING stages, counted on full/empty
// mbarriers.  Tiles are 64-column halves of 128-byte rows in the copy
// engine's 128-byte swizzle, 1024-byte aligned, as wgmma's descriptors read
// them; the copy engine zero-fills rows past Sq or Sk and the head-dim
// padding (16, 32 -> 64; 120 -> 128).
//
// flash_bwd_dkdv_wgmma_kernel: a block per (128 keys, query head) of two
// warpgroups, K and V resident in shared memory, warpgroup w owning keys
// [64 w, +64) and its dK, dV (64 x DP float32 each) in registers for the
// whole query loop.  Per 64-query tile: S^T = K Q^T and dP^T = V dO^T
// (m64n64k16, both operands K-major in shared memory); P^T = exp2(S^T
// scale log2e - lse) and dS^T = P^T (dP^T - Dv) on the accumulators,
// packed to bf16 A operands in registers; dV += P^T dO and dK += dS^T Q
// (m64nDPk16, B read MN-major from the same Q and dO tiles).  Thread 0
// issues the copies: K, V and the first RING tiles at the start, and each
// later tile once every warp is done with its stage.  The H/KV blocks of
// one (key tile, KV head) run as one thread block cluster: each writes its
// float32 dK, dV into its own shared memory, and after a cluster barrier
// block r sums its 1/(H/KV) of the rows over the cluster's blocks in head
// order through distributed shared memory and stores them as bf16.  Key
// tile 0, the longest under a causal mask, is first in the grid.  No
// producer warpgroup: with one, whose `setmaxnreg` gave these warpgroups
// 240 registers, ptxas spilled hundreds of bytes a thread and serialised
// every wgmma at DP 128, and the kernel ran slower; with 255 a thread and
// no `setmaxnreg` it spills nothing (the build record shows its
// registers and spills).
//
// flash_bwd_dq_wgmma_kernel: a block per (128 queries, head), Q and dO
// resident, two consumer warpgroups, warpgroup w owning queries [64 w,
// +64) and dQ in registers, over the 64-key tiles of K and V its rows see:
// S and dP again, then dQ += dS K (K read MN-major).  A producer warpgroup,
// lowered by `setmaxnreg` to 24 registers (the consumers raised to 240),
// one thread of which issues every copy: with its 64 accumulators nothing
// spills, and it measured faster than thread 0 issuing the copies.  The
// last query tiles, the longest under a causal mask, first.

constexpr int WG = 128;                        // threads a warpgroup
constexpr int CONSUMERS = 2;                   // warpgroups that compute
constexpr int WG_BLOCK = (CONSUMERS + 1) * WG; // and one that loads
constexpr int KB = 128;                        // keys a dK/dV block, 64 a warpgroup
constexpr int KT = 128;                        // queries a dQ block
constexpr int QT = 64;                         // queries a dK/dV step; keys a dQ step
constexpr int RING = 2;                        // stages of the copy ring
constexpr int MAX_CLUSTER = 8;                 // query heads a KV head: a portable cluster
constexpr int ROW_BYTES = 128;                 // a swizzled row: 64 bf16
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;   // 168 x 384 at launch
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the dK/dV kernel for head dim DP (64 or 128), in bytes
// from a 1024-byte aligned base: K and V (KB rows each), a ring of Q and dO
// tiles (QT rows each) with their rows' lse and Dv, and, once the loop is
// done, over all of these, the float32 dK and dV (KB rows of DP + 8
// floats); the barriers after both.  `bwd_plan` in flash_attention.py
// mirrors this and DqLayout.
template <int DP>
struct DkdvLayout {
  static constexpr int KV_TILE = KB * DP * 2, Q_TILE = QT * DP * 2;
  static constexpr int K = 0, V = KV_TILE, RING0 = 2 * KV_TILE, STAGE = 2 * Q_TILE;
  static constexpr int ROWS0 = RING0 + RING * STAGE;   // lse, Dv: 2 x QT floats a stage
  static constexpr int LOOP = ROWS0 + RING * 2 * QT * 4;
  static constexpr int RED_STRIDE = DP + 8;             // floats a row of dK, dV
  static constexpr int RED = 2 * KB * RED_STRIDE * 4;
  static constexpr int BARS = LOOP > RED ? LOOP : RED;
  static constexpr int BYTES = BARS + (2 * RING + 1) * 8 + 1024;   // + the alignment
};

// The dQ kernel's: Q and dO (KT rows each), a ring of K and V tiles (QT
// rows each), the barriers.
template <int DP>
struct DqLayout {
  static constexpr int Q_TILE = KT * DP * 2, KV_TILE = QT * DP * 2;
  static constexpr int Q = 0, DO = Q_TILE, RING0 = 2 * Q_TILE, STAGE = 2 * KV_TILE;
  static constexpr int BARS = RING0 + RING * STAGE;
  static constexpr int BYTES = BARS + (2 * RING + 1) * 8 + 1024;
};

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (repro::smem_addr(p) & 1023)) & 1023);
}

// ROWS rows (a multiple of 64) of head `head` from row `row0` of sequence
// `b`, all DP columns, by the copy engine: column half c lands at c * ROWS
// rows, each 64-row box 64 rows after the last.
template <int DP, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, int head,
                                         int row0, int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int j = 0; j < ROWS / 64; ++j)
      repro::tensor_load_4d(dst + (c * ROWS + j * 64) * ROW_BYTES, map, c * 64, head,
                            row0 + j * 64, b, bar);
}

// A K-major operand: rows [r0, r0 + 64) of a tile of `rows` rows at shared
// address `tile`, columns [16 kk, +16).
__device__ __forceinline__ uint64_t desc_k(unsigned tile, int rows, int r0, int kk) {
  return repro::wgmma_desc(tile + ((kk / 4) * rows + r0) * ROW_BYTES + (kk % 4) * 32, 16, 1024);
}

// An MN-major (transposed) B operand: rows [16 kk, +16) of a tile of
// `rows` rows as its k-step, all its columns as N.
__device__ __forceinline__ uint64_t desc_mn(unsigned tile, int rows, int kk) {
  return repro::wgmma_desc(tile + kk * 16 * ROW_BYTES, rows * ROW_BYTES, 1024);
}

// `v`, which the compiler may not look through: a value made from it in a
// loop is made where it is used, not hoisted and kept in a register for
// every unrolled use across the loop.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The descriptor offset of k-step kk of a K-major tile of `rows` rows.
__host__ __device__ constexpr unsigned k_step(int rows, int kk) {
  return static_cast<unsigned>(((kk / 4) * rows * ROW_BYTES + (kk % 4) * 32) >> 4);
}

// ... and of an MN-major one.
__host__ __device__ constexpr unsigned mn_step(int kk) {
  return static_cast<unsigned>(kk * 16 * ROW_BYTES >> 4);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const unsigned (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 64) repro::wgmma_rs_m64n64_tb(d, a, desc_b);
  else repro::wgmma_rs_m64n128_tb(d, a, desc_b);
}

// The bf16 A operand of a product over a 64-column tile (4 k-steps of 16),
// from an m64n64 accumulator.
__device__ __forceinline__ void to_a(unsigned (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = repro::pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = repro::pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = repro::pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = repro::pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Element i of the m64n64 accumulator that `to_a` packed into `a`, as the
// bf16 it was rounded to.
__device__ __forceinline__ float from_a(const unsigned (&a)[4][4], int i) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[i / 8][(i % 8) / 2]);
  return (i & 1) ? __high2float(v) : __low2float(v);
}

// Dv = rowsum(dO * o) and the logsumexp in log2 units, float32 (B, H, Sqp)
// each; rows Sq to Sqp are padding (Dv 0, lse +inf, so that their P is 0).
// A warp a row, 16 bytes a lane (D % 8 == 0, D <= 128).
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ dvr, long rows, int Sq, int Sqp, int H, int D) {
  const long row = static_cast<long>(blockIdx.x) * (BWD_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long bh = row / Sqp;
  const int i = static_cast<int>(row - bh * Sqp);
  float acc = 0.f;
  if (i < Sq && lane * 8 < D) {
    const long b = bh / H, h = bh - b * H;
    const long at = ((b * Sq + i) * H + h) * D + lane * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(o + at);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + at);
    const bf16* xe = reinterpret_cast<const bf16*>(&x);
    const bf16* ye = reinterpret_cast<const bf16*>(&y);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(xe[j]) * __bfloat162float(ye[j]);
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    dvr[row] = acc;
    lse2[row] = i < Sq ? lse[bh * Sq + i] * LOG2E : INFINITY;
  }
}

// Issues the copies of q tile i (from t0) into stage i % RING.
template <int DP>
__device__ __forceinline__ void dkdv_load(unsigned char* sm, const BwdMaps& maps,
                                          const float* lse2, const float* dvr, long at, int i,
                                          int t0, int h, int b, uint64_t* full) {
  using L = DkdvLayout<DP>;
  const int s = i % RING, q0 = (t0 + i) * QT;
  unsigned char* st = sm + L::RING0 + s * L::STAGE;
  float* rows = reinterpret_cast<float*>(sm + L::ROWS0 + s * 2 * QT * 4);
  repro::mbar_arrive_expect_tx(&full[s], L::STAGE + 2 * QT * 4);
  tma_tile<DP, QT>(st, &maps.q, h, q0, b, &full[s]);
  tma_tile<DP, QT>(st + L::Q_TILE, &maps.dout, h, q0, b, &full[s]);
  repro::bulk_load(rows, lse2 + at + q0, QT * 4, &full[s]);
  repro::bulk_load(rows + QT, dvr + at + q0, QT * 4, &full[s]);
}

template <int DP>
__global__ void __launch_bounds__(CONSUMERS * WG, 1)
flash_bwd_dkdv_wgmma_kernel(const float* __restrict__ lse2, const float* __restrict__ dvr,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sqp,
                            int Sk, int H, int KV, int D, float scale, int causal, int window,
                            int kv_offset, const __grid_constant__ BwdMaps maps) {
  using L = DkdvLayout<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + RING;
  uint64_t* kv_full = empty + RING;
  const int rep = H / KV, bh = blockIdx.x, b = bh / H, h = bh - b * H, g = h / rep;
  const int k0 = blockIdx.y * KB, nk = min(KB, Sk - k0);
  // the q tiles that see a key of this tile: qpos >= k0 if causal, and
  // qpos <= (last key) + window - 1 with a window
  const int qbeg = causal ? max(0, k0 - kv_offset) : 0;
  const int qend = window > 0 ? min(Sq, k0 + nk - 1 + window - kv_offset) : Sq;
  const int t0 = qbeg / QT, ntiles = qend > qbeg ? (qend - 1) / QT - t0 + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], CONSUMERS * 4);   // every consumer warp
    }
    repro::mbar_init(kv_full, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  const long at = static_cast<long>(bh) * Sqp;

  if (threadIdx.x == 0) {   // K, V and the first tiles; later tiles as stages free up
    repro::mbar_arrive_expect_tx(kv_full, 2 * L::KV_TILE);
    tma_tile<DP, KB>(sm + L::K, &maps.k, g, k0, b, kv_full);
    tma_tile<DP, KB>(sm + L::V, &maps.v, g, k0, b, kv_full);
    for (int i = 0; i < min(RING, ntiles); ++i) dkdv_load<DP>(sm, maps, lse2, dvr, at, i, t0, h, b, full);
  }
  const int tid = threadIdx.x - wg * WG, warp = tid >> 5, lane = tid & 31;
  const int kw = k0 + wg * 64;                  // this warpgroup's first key
  const int key = kw + warp * 16 + lane / 4;    // this thread's keys: key, key + 8
  const int cq = (lane % 4) * 2;                // and its query columns: 8 j + cq, +1
  const float scale_log2 = scale * LOG2E;
  const unsigned base = repro::smem_addr(sm);
  float gk[DP / 2], gv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) gk[i] = gv[i] = 0.f;
  repro::mbar_wait_or_trap(kv_full, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % RING, q0 = (t0 + i) * QT;
    repro::mbar_wait_or_trap(&full[s], (i / RING) & 1);
    // no pair of this warpgroup's 64 keys and the tile's 64 queries is live
    const bool dead = kw >= Sk || (causal && kw > q0 + QT - 1 + kv_offset) ||
                      (window > 0 && kw + 63 <= q0 + kv_offset - window);
    if (!dead) {
      const unsigned qs = base + L::RING0 + s * L::STAGE, dos = qs + L::Q_TILE;
      const float* rows = reinterpret_cast<const float*>(sm + L::ROWS0 + s * 2 * QT * 4);
      float st[32], dpt[32];   // S^T, dP^T: this warpgroup's 64 keys x the 64 queries
      repro::fence_regs(st);
      repro::fence_regs(dpt);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        repro::wgmma_ss_m64n64(st, desc_k(base + L::K, KB, wg * 64, kk), desc_k(qs, QT, 0, kk),
                               kk > 0);
      repro::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        repro::wgmma_ss_m64n64(dpt, desc_k(base + L::V, KB, wg * 64, kk),
                               desc_k(dos, QT, 0, kk), kk > 0);
      repro::wgmma_commit();
      repro::wgmma_wait<1>();   // S^T is in
      repro::fence_regs(st);
      const bool edge = (causal && kw + 63 > q0 + kv_offset) ||
                        (window > 0 && kw <= q0 + QT - 1 + kv_offset - window);
      const int dk0 = opaque(key - cq - q0 - kv_offset);
#pragma unroll
      for (int j = 0; j < 8; ++j) {   // P^T, in place; query rows past Sq have lse +inf
        const float2 l2 = *reinterpret_cast<const float2*>(rows + j * 8 + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(st[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
          const int d = dk0 + (e >> 1) * 8 - j * 8 - (e & 1);   // key - qpos
          if (edge && ((causal && d > 0) || (window > 0 && d <= -window))) p = 0.f;
          st[4 * j + e] = p;
        }
      }
      // P^T as bf16 A operands; dS^T from those, so that S^T's registers
      // are free while dP^T's are live
      unsigned pa[4][4], da[4][4];
      to_a(pa, st);
      repro::wgmma_wait<0>();   // dP^T is in
      repro::fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {   // dS^T = P^T (dP^T - Dv), P^T as rounded for dV
        const float2 d2 = *reinterpret_cast<const float2*>(rows + QT + j * 8 + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = from_a(pa, 4 * j + e) * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      to_a(da, dpt);
      repro::fence_regs(gk);
      repro::fence_regs(gv);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<DP>(gv, pa[kk], desc_mn(dos, QT, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<DP>(gk, da[kk], desc_mn(qs, QT, kk));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(gk);
      repro::fence_regs(gv);
    }
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(&empty[s]);   // this warp is done with stage s
    if (threadIdx.x == 0 && i + RING < ntiles) {   // stage s again, once every warp is done
      repro::mbar_wait_or_trap(&empty[s], (i / RING) & 1);
      dkdv_load<DP>(sm, maps, lse2, dvr, at, i + RING, t0, h, b, full);
    }
    __syncwarp();
  }

  // dK (unscaled) and dV of the block's 128 keys, float32, over K, V and
  // the ring, once both warpgroups are done with them
  repro::named_barrier(1, CONSUMERS * WG);
  float* red = reinterpret_cast<float*>(sm);
  const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    float* at = red + r * L::RED_STRIDE + j * 8 + cq;
    *reinterpret_cast<float2*>(at) = make_float2(gk[4 * j], gk[4 * j + 1]);
    *reinterpret_cast<float2*>(at + 8 * L::RED_STRIDE) = make_float2(gk[4 * j + 2], gk[4 * j + 3]);
    at += KB * L::RED_STRIDE;
    *reinterpret_cast<float2*>(at) = make_float2(gv[4 * j], gv[4 * j + 1]);
    *reinterpret_cast<float2*>(at + 8 * L::RED_STRIDE) = make_float2(gv[4 * j + 2], gv[4 * j + 3]);
  }
  repro::cluster_sync();

  // this block's share of the rows, summed over the cluster (rank j is
  // query head g * rep + j) in head order, as bf16
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (KB + rep - 1) / rep, r0 = static_cast<int>(cluster.block_rank()) * per;
  const int nr = max(0, min(KB, r0 + per) - r0), chunks = DP / 8;
  for (int it = threadIdx.x; it < 2 * nr * chunks; it += CONSUMERS * WG) {
    const int which = it / (nr * chunks), rem = it - which * nr * chunks;
    const int row = r0 + rem / chunks, c = (rem % chunks) * 8;
    if (k0 + row >= Sk || c >= D) continue;
    const int off = (which * KB + row) * L::RED_STRIDE + c;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < rep; ++j) {
      const float* src = cluster.map_shared_rank(red, j) + off;
      const float4 x = *reinterpret_cast<const float4*>(src);
      const float4 y = *reinterpret_cast<const float4*>(src + 4);
      sum[0] += x.x, sum[1] += x.y, sum[2] += x.z, sum[3] += x.w;
      sum[4] += y.x, sum[5] += y.y, sum[6] += y.z, sum[7] += y.w;
    }
    const float mul = which == 0 ? scale : 1.f;
    const uint4 out = make_uint4(repro::pack_bf16(sum[0] * mul, sum[1] * mul),
                                 repro::pack_bf16(sum[2] * mul, sum[3] * mul),
                                 repro::pack_bf16(sum[4] * mul, sum[5] * mul),
                                 repro::pack_bf16(sum[6] * mul, sum[7] * mul));
    *reinterpret_cast<uint4*>((which == 0 ? dk : dv) +
                              ((static_cast<long>(b) * Sk + k0 + row) * KV + g) * D + c) = out;
  }
  repro::cluster_sync();
}

// Issues the copies of key tile i (from t0) into stage i % RING.
template <int DP>
__device__ __forceinline__ void dq_load(unsigned char* sm, const BwdMaps& maps, int i, int t0,
                                        int g, int b, uint64_t* full) {
  using L = DqLayout<DP>;
  const int s = i % RING, kt0 = (t0 + i) * QT;
  unsigned char* st = sm + L::RING0 + s * L::STAGE;
  repro::mbar_arrive_expect_tx(&full[s], L::STAGE);
  tma_tile<DP, QT>(st, &maps.k, g, kt0, b, &full[s]);
  tma_tile<DP, QT>(st + L::KV_TILE, &maps.v, g, kt0, b, &full[s]);
}

template <int DP>
__global__ void __launch_bounds__(WG_BLOCK, 1)
flash_bwd_dq_wgmma_kernel(const float* __restrict__ lse2, const float* __restrict__ dvr,
                          bf16* __restrict__ dq, int Sq, int Sqp, int Sk, int H, int KV, int D,
                          float scale, int causal, int window, int kv_offset,
                          const __grid_constant__ BwdMaps maps) {
  using L = DqLayout<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + RING;
  uint64_t* q_full = empty + RING;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * KT;   // the longest causal rows first
  const int nq = min(KT, Sq - q0);
  // keys [kbeg, kend) cover every row of this q tile, as in the forward
  const int kend = causal ? min(Sk, q0 + nq + kv_offset) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;
  const int t0 = kbeg / QT, ntiles = kend > kbeg ? (kend - 1) / QT - t0 + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], CONSUMERS * 4);
    }
    repro::mbar_init(q_full, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;

  if (wg == CONSUMERS) {
    repro::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      repro::mbar_arrive_expect_tx(q_full, 2 * L::Q_TILE);
      tma_tile<DP, KT>(sm + L::Q, &maps.q, h, q0, b, q_full);
      tma_tile<DP, KT>(sm + L::DO, &maps.dout, h, q0, b, q_full);
      for (int i = 0; i < ntiles; ++i) {
        repro::mbar_wait_or_trap(&empty[i % RING], ((i / RING) & 1) ^ 1);
        dq_load<DP>(sm, maps, i, t0, g, b, full);
      }
    }
    return;
  }

  repro::setmaxnreg_inc<CONSUMER_REGS>();
  const int tid = threadIdx.x - wg * WG, warp = tid >> 5, lane = tid & 31;
  const int qw = q0 + wg * 64;                  // this warpgroup's first query
  const int row = qw + warp * 16 + lane / 4;    // this thread's rows: row, row + 8
  const int ck = (lane % 4) * 2;                // and its key columns: 8 j + ck, +1
  const float scale_log2 = scale * LOG2E;
  const unsigned base = repro::smem_addr(sm);
  float lr[2], dr[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {   // rows past the padding: P 0
    const int rr = row + e * 8;
    lr[e] = rr < Sqp ? lse2[static_cast<long>(bh) * Sqp + rr] : INFINITY;
    dr[e] = rr < Sqp ? dvr[static_cast<long>(bh) * Sqp + rr] : 0.f;
  }
  float gq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) gq[i] = 0.f;
  repro::mbar_wait_or_trap(q_full, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % RING, kt0 = (t0 + i) * QT;
    repro::mbar_wait_or_trap(&full[s], (i / RING) & 1);
    const bool dead = qw >= Sq || (causal && kt0 > qw + 63 + kv_offset) ||
                      (window > 0 && kt0 + QT - 1 <= qw + kv_offset - window);
    if (!dead) {
      const unsigned ks = base + L::RING0 + s * L::STAGE, vs = ks + L::KV_TILE;
      const uint64_t d_q = desc_k(base + L::Q, KT, wg * 64, 0);
      const uint64_t d_do = desc_k(base + L::DO, KT, wg * 64, 0);
      const uint64_t d_k = desc_k(ks, QT, 0, 0), d_v = desc_k(vs, QT, 0, 0);
      float sc[32], dp[32];   // S, dP: this warpgroup's 64 queries x the tile's 64 keys
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        repro::wgmma_ss_m64n64(sc, d_q + k_step(KT, kk), d_k + k_step(QT, kk), kk > 0);
      repro::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        repro::wgmma_ss_m64n64(dp, d_do + k_step(KT, kk), d_v + k_step(QT, kk), kk > 0);
      repro::wgmma_commit();
      repro::wgmma_wait<1>();
      repro::fence_regs(sc);
      const bool edge = kt0 + QT > Sk || (causal && kt0 + QT - 1 > qw + kv_offset) ||
                        (window > 0 && kt0 <= qw + 63 + kv_offset - window);
      const int dq0 = opaque(kt0 + ck - row - kv_offset), sk0 = opaque(kt0 + ck - Sk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -lr[e >> 1]));
          const int d = dq0 + j * 8 + (e & 1) - (e >> 1) * 8;   // kpos - qpos
          if (edge && (sk0 + j * 8 + (e & 1) >= 0 || (causal && d > 0) ||
                       (window > 0 && d <= -window)))
            p = 0.f;
          sc[4 * j + e] = p;
        }
      repro::wgmma_wait<0>();
      repro::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dr[e >> 1]);
      unsigned da[4][4];
      to_a(da, dp);
      const uint64_t d_kt = desc_mn(ks, QT, 0);
      repro::fence_regs(gq);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tb<DP>(gq, da[kk], d_kt + mn_step(kk));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(gq);
    }
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = row + e * 8;
    if (rr >= Sq) continue;
    bf16* out = dq + ((static_cast<long>(b) * Sq + rr) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + ck;
      if (c < D)
        *reinterpret_cast<unsigned*>(out + c) =
            repro::pack_bf16(gq[4 * j + 2 * e] * scale, gq[4 * j + 2 * e + 1] * scale);
    }
  }
}

// A map of a bf16 (B, S, heads, D) tensor, D % 8 == 0, 16-byte aligned:
// boxes of 64 rows of one head by 64 columns (128 bytes, the 128-byte
// swizzle), zeros past S and D.
bool bwd_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D) {
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, 64, 1}, estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// which of a backward call's launches run (chip_smoke times them apart)
constexpr int ROWS_PASS = 1, DKDV_PASS = 2, DQ_PASS = 4;

template <int DP>
int launch_bwd_wgmma(const BwdMaps& maps, const float* lse2, const float* dvr, void* dq,
                     void* dk, void* dv, int B, int Sq, int Sqp, int Sk, int H, int KV, int D,
                     float scale, int causal, int window, int kv_offset, int parts,
                     cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (parts & DKDV_PASS) {
    err = repro::allow_shared(flash_bwd_dkdv_wgmma_kernel<DP>, DkdvLayout<DP>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * H, (Sk + KB - 1) / KB);
    cfg.blockDim = dim3(CONSUMERS * WG);
    cfg.dynamicSmemBytes = DkdvLayout<DP>::BYTES;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = H / KV;   // the query heads of one KV head
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma_kernel<DP>, lse2, dvr,
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sqp, Sk, H, KV,
                             D, scale, causal, window, kv_offset, maps);
    if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (parts & DQ_PASS) {
    err = repro::allow_shared(flash_bwd_dq_wgmma_kernel<DP>, DqLayout<DP>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_wgmma_kernel<DP><<<dim3(B * H, (Sq + KT - 1) / KT), WG_BLOCK,
                                    DqLayout<DP>::BYTES, s>>>(
        lse2, dvr, static_cast<bf16*>(dq), Sq, Sqp, Sk, H, KV, D, scale, causal, window,
        kv_offset, maps);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// route WGMMA (bf16): the wgmma kernels, for D % 8 == 0, H / KV <= 8 and
// 16-byte aligned inputs (flash_attention.bwd_plan); rows: float32
// scratch of 2 x (B, H, Sqp), Sqp = Sq rounded up to 64.  Route
// CUDA_CORES (float32, and bf16 otherwise): the CUDA-core kernels; rows:
// (B, H, Sq) of it.
constexpr int CUDA_CORES = 0, WGMMA = 1;

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* rows, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
               int H, int KV, int D, float scale, int causal, int window, int kv_offset,
               int route, int parts, void* stream) {
  if (D > DMAX || KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  cudaError_t err = cudaSuccess;
  if (route == WGMMA) {
    if (!std::is_same_v<T, bf16> || D % 8 || H / KV > MAX_CLUSTER || !aligned16(q) ||
        !aligned16(k) || !aligned16(v) || !aligned16(o) || !aligned16(dout))
      return static_cast<int>(cudaErrorInvalidValue);
    BwdMaps maps;
    repro::bind_context();
    if (!bwd_map(&maps.q, q, B, Sq, H, D) || !bwd_map(&maps.k, k, B, Sk, KV, D) ||
        !bwd_map(&maps.v, v, B, Sk, KV, D) || !bwd_map(&maps.dout, dout, B, Sq, H, D))
      return static_cast<int>(cudaErrorInvalidValue);
    const int Sqp = (Sq + QT - 1) / QT * QT;
    const long n = static_cast<long>(B) * H * Sqp;
    float* lse2 = static_cast<float*>(rows);
    float* dvr = lse2 + n;
    if (parts & ROWS_PASS) {
      const int per_block = BWD_THREADS / 32;
      flash_bwd_rows_kernel<<<static_cast<unsigned>((n + per_block - 1) / per_block),
                              BWD_THREADS, 0, s>>>(static_cast<const bf16*>(o),
                                                   static_cast<const bf16*>(dout), lt, lse2,
                                                   dvr, n, Sq, Sqp, H, D);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    return D <= 64 ? launch_bwd_wgmma<64>(maps, lse2, dvr, dq, dk, dv, B, Sq, Sqp, Sk, H, KV, D,
                                          scale, causal, window, kv_offset, parts, s)
                   : launch_bwd_wgmma<128>(maps, lse2, dvr, dq, dk, dv, B, Sq, Sqp, Sk, H, KV,
                                           D, scale, causal, window, kv_offset, parts, s);
  }
  if (route != CUDA_CORES) return static_cast<int>(cudaErrorInvalidValue);
  float* dvr = static_cast<float*>(rows);
  if (parts & ROWS_PASS) {
    const int n = B * Sq * H, per_block = BWD_THREADS / 32;
    flash_bwd_dot_kernel<T><<<(n + per_block - 1) / per_block, BWD_THREADS, 0, s>>>(
        static_cast<const T*>(o), dot, dvr, n, Sq, H, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = bwd_shared_bytes(D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (parts & DKDV_PASS) {
    if ((err = repro::allow_shared(flash_bwd_dkdv_kernel<T>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid_kv((Sk + BWD_TILE - 1) / BWD_TILE, KV, B);
    flash_bwd_dkdv_kernel<T><<<grid_kv, BWD_THREADS, smem, s>>>(
        qt, kt, vt, dot, lt, dvr, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, D,
        scale, causal, window, kv_offset);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & DQ_PASS) {
    if ((err = repro::allow_shared(flash_bwd_dq_kernel<T>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid_q((Sq + BWD_TILE - 1) / BWD_TILE, H, B);
    flash_bwd_dq_kernel<T><<<grid_q, BWD_THREADS, smem, s>>>(
        qt, kt, vt, dot, lt, dvr, static_cast<T*>(dq), Sq, Sk, H, KV, D, scale, causal, window,
        kv_offset);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// lse: null, or float32 (B, H, Sq) for the row logsumexp the backward needs
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int B, int Sq, int Sk, int H, int KV, int D,
                                    float scale, int causal, int window, int kv_offset,
                                    void* stream) {
  if (D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16)
    return launch_mma<16>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, scale, causal, window,
                          kv_offset, stream);
  if (D <= 32)
    return launch_mma<32>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, scale, causal, window,
                          kv_offset, stream);
  if (D <= 64)
    return launch_mma<64>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, scale, causal, window,
                          kv_offset, stream);
  return launch_mma<128>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, scale, causal, window,
                         kv_offset, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int Sq, int Sk, int H, int KV, int D,
                                   float scale, int causal, int window, int kv_offset,
                                   void* stream) {
  if (D > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(D);
  cudaError_t err = repro::allow_shared(flash_attention_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, D, scale, causal,
      window, kv_offset);
  return static_cast<int>(cudaGetLastError());
}

// dq, dk, dv laid out as q, k, v; rows: float32 scratch of 2 x (B, H, Sq
// rounded up to 64); route: CUDA_CORES or WGMMA (bf16); parts: which
// launches run (ROWS_PASS | DKDV_PASS | DQ_PASS for the whole backward)
#define FLASH_BWD_ENTRY(SUFFIX, T)                                                             \
  extern "C" int flash_attention_bwd_##SUFFIX(                                                 \
      const void* q, const void* k, const void* v, const void* o, const void* dout,            \
      const void* lse, void* rows, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, \
      int KV, int D, float scale, int causal, int window, int kv_offset, int route, int parts, \
      void* stream) {                                                                          \
    return launch_bwd<T>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, Sq, Sk, H, KV, D, scale,  \
                         causal, window, kv_offset, route, parts, stream);                     \
  }

FLASH_BWD_ENTRY(bf16, bf16)
FLASH_BWD_ENTRY(f32, float)
