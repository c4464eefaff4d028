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
#include <type_traits>

#include "common.cuh"

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
// tiers); these compute the gradient of the function `_flash_kernel`
// computes.
//  (1) flash_bwd_dot_kernel: Dv = rowsum(dO * o), float32 (B, H, Sq);
//  (2) dK and dV, a block per 64 keys: it keeps its K and V rows in shared
//      memory and dK, dV in registers, and walks every q tile that sees one
//      of its keys: P^T = exp(scale K Q^T - lse), dP^T = V dO^T, dS^T = P^T
//      (dP^T - Dv), dV += P^T dO, dK += scale dS^T Q.  GQA's sum over the
//      H/KV query heads of a KV head is taken in one order: in the
//      registers of a block per KV head (float32), or by a second kernel
//      over each query head's float32 share (bf16, below); K and V are
//      never repeated;
//  (3) dQ, a block per (64 queries, head, sequence): Q and dO in shared
//      memory, dQ in registers, over the key tiles its rows see: dQ +=
//      scale dS K.
// Both recompute the scores.  Bound on the H100 at qwen2.5-3b's training
// shape: operations (five products a live (q, key) pair).  bf16 runs the
// products on the tensor cores (`flash_bwd_*_mma_kernel`, below); float32
// on the CUDA cores (`flash_bwd_dkdv_kernel`, `flash_bwd_dq_kernel`): each
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

// -- the bf16 backward on the tensor cores ------------------------------
//
// The same passes, the products on `mma.sync` with the forward's tiles and
// fragments (64-row tiles, swizzled bf16 in shared memory, `ldmatrix`,
// float32 sums).  flash_bwd_dkdv_mma_kernel: a block per (64 keys, query
// head, sequence), 4 warps each owning 16 of its keys, dK and dV (16 x DP
// each) in registers; for each q tile S^T = K Q^T and dP^T = V dO^T come
// from the K and V rows as A operands and the Q and dO rows as B operands,
// exactly as the forward's S = Q K^T; P^T becomes the bf16 A fragments of
// dV += P^T dO in registers (dO through `ldmatrix.trans`, as the forward's
// V), and dS^T = P^T (dP^T - Dv), from those bf16 P^T, the A fragments of
// dK += dS^T Q.  Each query head writes its share of dK and dV in float32,
// and flash_bwd_kv_reduce_kernel sums a KV head's H/KV shares in head
// order: a block a KV head walking all its query heads (the CUDA-core
// kernels' layout) made the first key tile's block, 8 heads x 64 q tiles
// at qwen2.5-3b's training shape, the critical path of the launch.
// flash_bwd_dq_mma_kernel: 4 warps of 16 queries, dQ in registers, S and
// dP per key tile, dQ += dS K with K through `ldmatrix.trans`.  Loads are
// 16-byte cp.async, one stage: a tile lands, then is used.

// A value of a packed bf16 A fragment built from accumulator tile j,
// element e (as the forward packs P): the inverse of that packing.
template <int NT>
__device__ __forceinline__ float unpack_frag(const unsigned (&pa)[NT / 2][4], int j, int e) {
  const unsigned w = pa[j >> 1][(j & 1) * 2 + (e >> 1)];
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  return (e & 1) ? __high2float(v) : __low2float(v);
}

template <int NT>
__device__ __forceinline__ void pack_frags(unsigned (&pa)[NT / 2][4], const float (&s)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    pa[kk][0] = repro::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = repro::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = repro::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = repro::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc (16 rows of this warp x 64 columns) = A rows [warp*16, +16) of `At`
// times the 64 rows of `Bt`, both tiles 64 x DP, over DP
template <int DP>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[TILE_ROWS / 8][4], const bf16* At,
                                                 const bf16* Bt, int warp, int lane) {
  constexpr int CH = DP / 8, KSTEPS = DP / 16, NT = TILE_ROWS / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    unsigned af[4];
    repro::ldmatrix_x4(af, At + swz<CH>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        kk * 2 + (lane >> 4)));
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      unsigned bfr[4];
      repro::ldmatrix_x4(bfr, Bt + swz<CH>(jj * 16 + (lane & 7) + (lane >> 4) * 8,
                                           kk * 2 + ((lane >> 3) & 1)));
      repro::mma_bf16(acc[2 * jj], af, bfr[0], bfr[1]);
      repro::mma_bf16(acc[2 * jj + 1], af, bfr[2], bfr[3]);
    }
  }
}

// out (16 x DP) += the A fragments `pa` (16 x 64) times the 64 x DP tile
// `Bt` taken as (rows = k, columns = n) through ldmatrix.trans
template <int DP>
__device__ __forceinline__ void mma_frags_by_tile(float (&out)[DP / 8][4],
                                                  const unsigned (&pa)[TILE_ROWS / 16][4],
                                                  const bf16* Bt, int lane) {
  constexpr int CH = DP / 8, DT = DP / 8;
#pragma unroll
  for (int kk = 0; kk < TILE_ROWS / 16; ++kk)
#pragma unroll
    for (int dd = 0; dd < DT / 2; ++dd) {
      unsigned bfr[4];
      repro::ldmatrix_x4_trans(bfr, Bt + swz<CH>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                 dd * 2 + (lane >> 4)));
      repro::mma_bf16(out[2 * dd], pa[kk], bfr[0], bfr[1]);
      repro::mma_bf16(out[2 * dd + 1], pa[kk], bfr[2], bfr[3]);
    }
}

// Writes a warp's 16 x DP accumulator, times `mul`, to rows [row0, row0 +
// 16) of a (rows, D) slab `stride` elements a row, rows below `nrows`.
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* base, long stride, const float (&acc)[DP / 8][4],
                                           int row0, int nrows, int D, float mul, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + r * 8;
    if (row >= nrows) continue;
    T* out = base + static_cast<long>(row) * stride;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int col = d * 8 + tq * 2;
      const float x = acc[d][2 * r] * mul, y = acc[d][2 * r + 1] * mul;
      if constexpr (std::is_same_v<T, float>) {
        if (col < D) out[col] = x;
        if (col + 1 < D) out[col + 1] = y;
      } else if (col + 1 < D && (D & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < D) out[col] = __float2bfloat16_rn(x);
        if (col + 1 < D) out[col + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dv_rows,
                          float* __restrict__ pk, float* __restrict__ pv, int Sq, int Sk, int H,
                          int KV, int D, float scale, int causal, int window, int kv_offset,
                          int vec) {
  constexpr int NT = TILE_ROWS / 8, DT = DP / 8, TILE = TILE_ROWS * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;
  bf16* dOs = Qs + TILE;
  float* lse_s = reinterpret_cast<float*>(dOs + TILE);
  float* dv_s = lse_s + TILE_ROWS;
  const int k0 = blockIdx.x * TILE_ROWS, h = blockIdx.y, b = blockIdx.z, g = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int nk = min(TILE_ROWS, Sk - k0);
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  const float scale_log2 = scale * 1.4426950408889634f;
  const long kv_base = (static_cast<long>(b) * Sk + k0) * kv_row + static_cast<long>(g) * D;
  load_tile_bf16<DP>(Ks, k + kv_base, k + kv_base, kv_row, nk, D, vec);
  load_tile_bf16<DP>(Vs, v + kv_base, v + kv_base, kv_row, nk, D, vec);
  repro::cp_async_commit();
  // the q rows that see a key of this tile, as the CUDA-core kernel's
  const int qbeg = causal ? max(0, k0 - kv_offset) : 0;
  const int qend = window > 0 ? min(Sq, k0 + nk - 1 + window - kv_offset) : Sq;

  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[d][e] = gv[d][e] = 0.f;

  for (int q0 = qbeg / TILE_ROWS * TILE_ROWS; q0 < qend; q0 += TILE_ROWS) {
    const int nq = min(TILE_ROWS, Sq - q0);
    __syncthreads();   // the previous q tile has been consumed
    const long q_base = (static_cast<long>(b) * Sq + q0) * q_row + static_cast<long>(h) * D;
    load_tile_bf16<DP>(Qs, q + q_base, q + q_base, q_row, nq, D, vec);
    load_tile_bf16<DP>(dOs, dout + q_base, dout + q_base, q_row, nq, D, vec);
    repro::cp_async_commit();
    if (threadIdx.x < TILE_ROWS) {
      const int t = threadIdx.x;
      const long r = (static_cast<long>(b) * H + h) * Sq + q0 + t;
      lse_s[t] = t < nq ? lse[r] * 1.4426950408889634f : INFINITY;   // log2 units
      dv_s[t] = t < nq ? dv_rows[r] : 0.f;
    }
    repro::cp_async_wait<0>();
    __syncthreads();

    // P^T (this warp's 16 keys x the tile's 64 queries), as bf16 fragments
    float s[NT][4];
    mma_rows_by_rows<DP>(s, Ks, Qs, warp, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + gr + (e >> 1) * 8, c = j * 8 + tq * 2 + (e & 1);
        s[j][e] = bwd_live(key, q0 + c, Sk, Sq, causal, window, kv_offset)
                      ? exp2f(fmaf(s[j][e], scale_log2, -lse_s[c])) : 0.f;
      }
    unsigned pa[NT / 2][4];
    pack_frags<NT>(pa, s);
    mma_frags_by_tile<DP>(gv, pa, dOs, lane);               // dV += P^T dO
    mma_rows_by_rows<DP>(s, Vs, dOs, warp, lane);           // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = unpack_frag<NT>(pa, j, e) * (s[j][e] - dv_s[j * 8 + tq * 2 + (e & 1)]);
    pack_frags<NT>(pa, s);
    mma_frags_by_tile<DP>(gk, pa, Qs, lane);                // dK += dS^T Q
  }
  repro::cp_async_wait<0>();   // no copy outlives the block (K, V alone when no q tile sees it)
  // this head's share of dK (unscaled) and dV, float32 (B, Sk, H, D)
  const long p_base = (static_cast<long>(b) * Sk + k0) * q_row + static_cast<long>(h) * D;
  store_rows<DP>(pk + p_base, q_row, gk, warp * 16, nk, D, 1.f, lane);
  store_rows<DP>(pv + p_base, q_row, gv, warp * 16, nk, D, 1.f, lane);
}

// dK = scale * (the H/KV query heads' shares of it summed in head order),
// dV the same unscaled, both cast to bf16; a thread an element.
__global__ void flash_bwd_kv_reduce_kernel(const float* __restrict__ pk,
                                           const float* __restrict__ pv, bf16* __restrict__ dk,
                                           bf16* __restrict__ dv, long elems, int H, int KV,
                                           int D, float scale) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= elems) return;   // i = (row * KV + g) * D + d, row = b * Sk + key
  const int d = static_cast<int>(i % D), rep = H / KV;
  const long rg = i / D, row = rg / KV;
  const int g = static_cast<int>(rg % KV);
  const long base = (row * H + static_cast<long>(g) * rep) * D + d;
  float sk = 0.f, sv = 0.f;
  for (int r = 0; r < rep; ++r) {
    sk += pk[base + static_cast<long>(r) * D];
    sv += pv[base + static_cast<long>(r) * D];
  }
  dk[i] = __float2bfloat16_rn(sk * scale);
  dv[i] = __float2bfloat16_rn(sv);
}

template <int DP>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dv_rows,
                        bf16* __restrict__ dq, int Sq, int Sk, int H, int KV, int D, float scale,
                        int causal, int window, int kv_offset, int vec) {
  constexpr int NT = TILE_ROWS / 8, DT = DP / 8, TILE = TILE_ROWS * DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;
  bf16* Vs = Ks + TILE;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE_ROWS;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int nq = min(TILE_ROWS, Sq - q0);
  const long q_row = static_cast<long>(H) * D, kv_row = static_cast<long>(KV) * D;
  const float scale_log2 = scale * 1.4426950408889634f;
  const long q_base = (static_cast<long>(b) * Sq + q0) * q_row + static_cast<long>(h) * D;
  load_tile_bf16<DP>(Qs, q + q_base, q + q_base, q_row, nq, D, vec);
  load_tile_bf16<DP>(dOs, dout + q_base, dout + q_base, q_row, nq, D, vec);
  repro::cp_async_commit();
  float lse_r[2], dv_r[2];   // this lane's two rows: gr and gr + 8 of the warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gr + r * 8;
    const long i = (static_cast<long>(b) * H + h) * Sq + q0 + row;
    lse_r[r] = row < nq ? lse[i] * 1.4426950408889634f : INFINITY;
    dv_r[r] = row < nq ? dv_rows[i] : 0.f;
  }
  // keys [kbeg, kend) cover every row of this q tile, as in the forward
  const int kend = causal ? min(Sk, q0 + nq + kv_offset) : Sk;
  const int kbeg = window > 0 ? max(0, q0 + kv_offset - window + 1) : 0;
  const long kv_base = static_cast<long>(b) * Sk * kv_row + static_cast<long>(g) * D;

  float gq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[d][e] = 0.f;

  for (int k0 = kbeg / TILE_ROWS * TILE_ROWS; k0 < kend; k0 += TILE_ROWS) {
    __syncthreads();   // the previous key tile has been consumed
    load_tile_bf16<DP>(Ks, k + kv_base + k0 * kv_row, k + kv_base, kv_row, Sk - k0, D, vec);
    load_tile_bf16<DP>(Vs, v + kv_base + k0 * kv_row, v + kv_base, kv_row, Sk - k0, D, vec);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    float s[NT][4], dp[NT][4];
    mma_rows_by_rows<DP>(s, Qs, Ks, warp, lane);             // S = Q K^T
    mma_rows_by_rows<DP>(dp, dOs, Vs, warp, lane);           // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + gr + (e >> 1) * 8, key = k0 + j * 8 + tq * 2 + (e & 1);
        const float p = bwd_live(key, q0 + row, Sk, Sq, causal, window, kv_offset)
                            ? exp2f(fmaf(s[j][e], scale_log2, -lse_r[e >> 1])) : 0.f;
        s[j][e] = p * (dp[j][e] - dv_r[e >> 1]);
      }
    unsigned ds[NT / 2][4];
    pack_frags<NT>(ds, s);
    mma_frags_by_tile<DP>(gq, ds, Ks, lane);                 // dQ += dS K
  }
  repro::cp_async_wait<0>();
  store_rows<DP>(dq + q_base, q_row, gq, warp * 16, nq, D, scale, lane);
}

template <int DP>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const float* dv_rows, float* kv_part, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int H, int KV, int D, float scale, int causal,
                   int window, int kv_offset, cudaStream_t s) {
  const size_t smem = 4 * TILE_ROWS * DP * sizeof(bf16) + 2 * TILE_ROWS * sizeof(float);
  cudaError_t err = repro::allow_shared(flash_bwd_dkdv_mma_kernel<DP>, smem);
  if (err == cudaSuccess) err = repro::allow_shared(flash_bwd_dq_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = D % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const long part = static_cast<long>(B) * Sk * H * D;
  const dim3 grid_kv((Sk + TILE_ROWS - 1) / TILE_ROWS, H, B);
  flash_bwd_dkdv_mma_kernel<DP><<<grid_kv, WARPS * 32, smem, s>>>(
      qt, kt, vt, dot, lt, dv_rows, kv_part, kv_part + part, Sq, Sk, H, KV, D, scale, causal,
      window, kv_offset, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long elems = static_cast<long>(B) * Sk * KV * D;
  flash_bwd_kv_reduce_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0, s>>>(
      kv_part, kv_part + part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), elems, H, KV, D,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((Sq + TILE_ROWS - 1) / TILE_ROWS, H, B);
  flash_bwd_dq_mma_kernel<DP><<<grid_q, WARPS * 32, smem, s>>>(
      qt, kt, vt, dot, lt, dv_rows, static_cast<bf16*>(dq), Sq, Sk, H, KV, D, scale, causal,
      window, kv_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dv_rows, void* kv_part, void* dq, void* dk, void* dv, int B,
               int Sq, int Sk, int H, int KV, int D, float scale, int causal, int window,
               int kv_offset, void* stream) {
  if (D > DMAX || KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* dot = static_cast<const T*>(dout);
  float* dvr = static_cast<float*>(dv_rows);
  const int rows = B * Sq * H, per_block = BWD_THREADS / 32;
  flash_bwd_dot_kernel<T><<<(rows + per_block - 1) / per_block, BWD_THREADS, 0, s>>>(
      static_cast<const T*>(o), dot, dvr, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<T, bf16>) {
    float* part = static_cast<float*>(kv_part);
    if (D <= 16)
      return launch_bwd_mma<16>(q, k, v, dout, lse, dvr, part, dq, dk, dv, B, Sq, Sk, H, KV, D,
                                scale, causal, window, kv_offset, s);
    if (D <= 32)
      return launch_bwd_mma<32>(q, k, v, dout, lse, dvr, part, dq, dk, dv, B, Sq, Sk, H, KV, D,
                                scale, causal, window, kv_offset, s);
    if (D <= 64)
      return launch_bwd_mma<64>(q, k, v, dout, lse, dvr, part, dq, dk, dv, B, Sq, Sk, H, KV, D,
                                scale, causal, window, kv_offset, s);
    return launch_bwd_mma<128>(q, k, v, dout, lse, dvr, part, dq, dk, dv, B, Sq, Sk, H, KV, D,
                               scale, causal, window, kv_offset, s);
  } else {   // float32: the CUDA-core kernels
    const size_t smem = bwd_shared_bytes(D);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const float* lt = static_cast<const float*>(lse);
    err = repro::allow_shared(flash_bwd_dkdv_kernel<T>, smem);
    if (err == cudaSuccess) err = repro::allow_shared(flash_bwd_dq_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_kv((Sk + BWD_TILE - 1) / BWD_TILE, KV, B);
    flash_bwd_dkdv_kernel<T><<<grid_kv, BWD_THREADS, smem, s>>>(
        qt, kt, vt, dot, lt, dvr, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, D,
        scale, causal, window, kv_offset);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_q((Sq + BWD_TILE - 1) / BWD_TILE, H, B);
    flash_bwd_dq_kernel<T><<<grid_q, BWD_THREADS, smem, s>>>(
        qt, kt, vt, dot, lt, dvr, static_cast<T*>(dq), Sq, Sk, H, KV, D, scale, causal, window,
        kv_offset);
    return static_cast<int>(cudaGetLastError());
  }
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

// dq, dk, dv laid out as q, k, v; dv_rows: float32 (B, H, Sq) scratch; kv_part
// (bf16 only): float32 scratch for two (B, Sk, H, D) tensors, each query
// head's share of dK and dV
#define FLASH_BWD_ENTRY(SUFFIX, T)                                                             \
  extern "C" int flash_attention_bwd_##SUFFIX(                                                 \
      const void* q, const void* k, const void* v, const void* o, const void* dout,            \
      const void* lse, void* dv_rows, void* kv_part, void* dq, void* dk, void* dv, int B,      \
      int Sq, int Sk, int H, int KV, int D, float scale, int causal, int window,               \
      int kv_offset, void* stream) {                                                           \
    return launch_bwd<T>(q, k, v, o, dout, lse, dv_rows, kv_part, dq, dk, dv, B, Sq, Sk, H,    \
                         KV, D, scale, causal, window, kv_offset, stream);                     \
  }

FLASH_BWD_ENTRY(bf16, bf16)
FLASH_BWD_ENTRY(f32, float)
