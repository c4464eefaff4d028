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
                           const float* __restrict__ v, float* __restrict__ out, int Sq,
                           int Sk, int H, int KV, int D, float scale, int causal, int window,
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
                           const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk,
                           int H, int KV, int D, float scale_log2, int causal, int window,
                           int kv_offset, int vec) {
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
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
               int H, int KV, int D, float scale, int causal, int window, int kv_offset,
               void* stream) {
  const size_t smem = (1 + 2 * STAGES) * TILE_ROWS * DP * sizeof(bf16);
  cudaError_t err = repro::allow_shared(flash_attention_mma_kernel<DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = D % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((Sq + TILE_ROWS - 1) / TILE_ROWS, H, B);
  flash_attention_mma_kernel<DP><<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Sk, H, KV, D, scale * 1.4426950408889634f, causal, window,
      kv_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Sk, int H, int KV, int D, float scale,
                                    int causal, int window, int kv_offset, void* stream) {
  if (D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16)
    return launch_mma<16>(q, k, v, out, B, Sq, Sk, H, KV, D, scale, causal, window, kv_offset,
                          stream);
  if (D <= 32)
    return launch_mma<32>(q, k, v, out, B, Sq, Sk, H, KV, D, scale, causal, window, kv_offset,
                          stream);
  if (D <= 64)
    return launch_mma<64>(q, k, v, out, B, Sq, Sk, H, KV, D, scale, causal, window, kv_offset,
                          stream);
  return launch_mma<128>(q, k, v, out, B, Sq, Sk, H, KV, D, scale, causal, window, kv_offset,
                         stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Sq, int Sk, int H, int KV, int D, float scale,
                                   int causal, int window, int kv_offset, void* stream) {
  if (D > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(D);
  cudaError_t err = repro::allow_shared(flash_attention_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_f32_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, KV, D, scale, causal, window, kv_offset);
  return static_cast<int>(cudaGetLastError());
}
