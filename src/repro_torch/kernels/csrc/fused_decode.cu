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
//   caches (B, C, KV, hd) in T.  Sums are float32.
//
// Replaces the Pallas TPU kernel `_fused_kernel` (repro/kernels/
// fused_decode.py), which runs the whole sublayer in one kernel, one grid
// step per batch row, and so streams the weights once per row; and masks
// the stale slot pos % C while adding the fresh token as an extra column,
// because its cache write happens outside the kernel.  Here the slot is
// written in place first, so (ii) is attention over the updated cache,
// which is the same function.
//
// Bound on the H100: bytes.  (i) and (iii) are GEMVs: each weight element
// is read once and meets B <= 8 rows, 2 B operations per 2 bytes, far
// below the card's ~295 operations per byte.  At qwen2.5-3b's decode (B 8)
// (i) streams 10.5 MB (3.1 us at 3.35 TB/s) and (iii) 8.4 MB (2.5 us).
// What held the first version back: too few bytes in flight an SM, a
// prologue (every block normalising all of x) before the first weight
// load, and an epilogue of 256 shuffles a thread.  What still holds this
// one back, from timestamps taken inside the blocks on the card
// (`repro_torch.probes.gemv_phases`): at qwen's out_residual a block has
// used its last stage ~5 us after its start (the slowest block ~7 us),
// against ~4.3 us for a kernel that only reads the same bytes; then the
// cluster merge costs ~2 us (the slowest of 8 blocks, one barrier).
//
// Design, one GEMV core for both kernels:
//  * Tiles and splits.  A tile is a range of output columns: one head of
//    Q, K or V in (i) (hd rounded up to a power of two, so a rope pair
//    (c, c + hd/2) lands in one tile), 128 columns of D in (iii).  The
//    weight rows of a tile are cut into `splits` slices (`gemv_plan` in
//    fused_decode.py, from the shapes and the SM count: at qwen 20 x 8 =
//    160 blocks for (i), 16 x 8 = 128 for (iii)).
//  * Small loads first, then the weights.  A block requests x's rows of its
//    slice (and the norm's) by cp.async, and the epilogue's operands (bias
//    or residual) into registers, before any weight: requested after the
//    weights they wait ~3 us behind them.  Then it requests its weights
//    into a ring of 16 KB stages (a stage is 64 rows of a 128-column tile;
//    ~88 KB, at qwen the whole slice) by 16-byte cp.async, each thread
//    copying one column chunk of every 1/cpr-th row, so that its addresses
//    advance by constants: with addresses computed afresh a copy cost ~40
//    instructions, and the issue, not the memory, set a block's rate.
//    (Register staging and tensor copies were tried and were slower.)
//  * The norm off the critical path.  rscale[b] = rsqrt(mean(x_b^2) + eps)
//    is one scalar a row, so (i) computes y = rscale * sum_k (x*norm)_k W_k:
//    a block needs only x*norm on its own rows of the slice, and sums the
//    squares of those rows; the blocks of a tile add their sums.
//  * bf16 products on the tensor cores: mma.sync.m16n8k16 with a 16-column
//    x 16-row weight tile as A (ldmatrix.trans from the K-major stage) and
//    the 8 batch rows as the n = 8 side, float32 accumulators.  Warp w owns
//    16 columns (and, for tiles narrower than 128, every (128/width)th
//    k-step).  No per-element conversion, no shuffle reduction.  x*norm is
//    rounded to bf16 for the mma (one bf16 step a term, ~2e-3 at q's
//    magnitude).  float32 keeps CUDA-core FMAs on the same stages: bf16
//    operands cannot meet the float32 model tests' 1e-4.
//  * The splits of a tile run as one thread block cluster.  Each block
//    stores the sums of batch row b into the shared memory of block b %
//    splits (distributed shared memory), one cluster barrier, and each
//    block adds what it received in rank order, so the sums do not depend
//    on timing, and finishes its rows: rscale, bias, rope and the q or
//    slot stores, or the residual.  No workspace, no atomics, one launch.
//  * Shapes whose columns are not whole 16-byte chunks (an odd hd, a
//    misaligned weight) take the same kernel with plain element loads.
//
// The `// phase-stamp N` comments mark the phases of a block that
// `repro_torch.probes.gemv_phases` times, in a copy of this file that it
// builds with a timestamp at each mark.
#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::from_float;
using repro::to_float;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BG = 8;              // batch rows a block: the n = 8 side of the mma
constexpr int STAGE_BYTES = 16 * 1024;   // weights a stage: 64 rows of 128 bf16 columns
constexpr int RING_BYTES = 88 * 1024;    // the stages in flight
constexpr int TN_MAX = 128;        // columns a tile, at most
constexpr int RED_FLOATS = 2048;   // the warps' partial sums before they meet
constexpr int EPI = BG * TN_MAX / THREADS;   // epilogue items a thread, at most
constexpr int MAX_SPLITS = 8;      // blocks a cluster, the portable most
constexpr int RECV_ROWS = 16;      // >= splits * ceil(BG / splits) for splits <= 8
static_assert(BG == WARPS, "warp b reads batch row b of x");

// elements of 16 bytes: the row padding of the ring and of x's rows, which
// keeps ldmatrix's 8 row addresses and the mma's B fragments off one bank
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / static_cast<int>(sizeof(T));
}

// stages in the ring: RING_BYTES of stages of STAGE_BYTES, rows padded
template <typename T>
__host__ __device__ constexpr int ring_stages() {
  return RING_BYTES / (STAGE_BYTES + STAGE_BYTES / TN_MAX * pad<T>());
}

// weight rows a stage: STAGE_BYTES of a tile tn columns wide
template <typename T>
__host__ __device__ inline int stage_rows(int tn) {
  return STAGE_BYTES / (tn * static_cast<int>(sizeof(T)));
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The block's shared memory: the ring of stages (reused, once the last
// stage is used, for the warps' partial sums and then the totals of the
// block's batch rows), x's rows of the slice, the norm's slice (float32,
// where there is a norm), the sums of squares (own 8, received 16, totals
// 8: 32 floats), and the sums the cluster's blocks send this one (splits x
// ceil(BG / splits) rows of tn floats, at most RECV_ROWS rows).
// `shared_bytes` in fused_decode.py mirrors this.
template <typename T>
struct Layout {
  int srow, sr, ksp;
  size_t ring, xs, bytes;
  __host__ __device__ Layout(int tn, int slice, bool with_norm)
      : srow(tn + pad<T>()), sr(stage_rows<T>(tn)) {
    ksp = round_up(slice, sr) + pad<T>();
    const size_t stages = static_cast<size_t>(ring_stages<T>()) * sr * srow * sizeof(T);
    const size_t red = RED_FLOATS * sizeof(float);
    ring = round_up(static_cast<int>(stages > red ? stages : red), 16);
    xs = static_cast<size_t>(BG) * ksp * sizeof(T) + (with_norm ? ksp * sizeof(float) : 0);
    bytes = ring + xs + (32 + RECV_ROWS * tn) * sizeof(float);
  }
};

// Columns [col0, col0 + nvalid) of the row-major weight `w` (row stride
// `ld`), a tile of `tn` columns.
template <typename T>
struct Tile {
  const T* w;
  long ld;
  int col0, nvalid;
};

// The GEMV core: y[b][c] = sum_k xn[b][k] w[k][col0 + c] over all K rows,
// b < bg, c < tn, with xn = x * norm (x where norm is null), and ss[b] =
// sum_k x[b][k]^2.  The `splits` blocks of a tile form one thread block
// cluster; block `split` sums the rows [split * slice, +slice), and sends
// the sums of batch row b to block b % splits, into its shared memory.
// Block r ends with the totals of the batch rows b = r (mod splits), in
// `tot` (BG x tn floats, those rows only) and `sst` (BG).  `prefetch` runs
// before the weights are requested: the caller's loads for its epilogue,
// which would wait behind the weights if requested after them.
template <typename T, bool VEC, typename Prefetch>
__device__ void gemv_core(const Tile<T>& tl, const T* __restrict__ x, long xld,
                          const float* __restrict__ norm, int K, int bg, int tn, int slice,
                          int splits, int split, unsigned char* smem, float*& tot,
                          float*& sst, Prefetch prefetch) {
  // phase-stamp 0
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const Layout<T> lay(tn, slice, norm != nullptr);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* ring = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + lay.ring);
  float* nrm = reinterpret_cast<float*>(xs + BG * lay.ksp);   // norm[k0 + i]
  float* ss = reinterpret_cast<float*>(smem + lay.ring + lay.xs);
  float* rss = ss + BG;                          // [splits][per] received, 16 at most
  sst = ss + 24;
  float* recv = ss + 32;                         // [splits][per][tn] received
  const int k0 = split * slice, k1 = min(k0 + slice, K);
  const int KR = lay.sr;                         // weight rows a stage
  const int nst = k1 > k0 ? (k1 - k0 + KR - 1) / KR : 0;   // a split past K is empty
  const int stage_elems = KR * lay.srow;

  // stage st: weight rows [k0 + st KR, +KR) of the slice, zero past the
  // slice and past the live columns; 16-byte cp.async where the layout
  // allows (VEC), else plain loads.  With VEC a thread always copies the
  // same 16-byte column chunk cc of rows r0, r0 + rstep, ...: its source and
  // destination addresses advance by constants, so a copy costs a compare,
  // two adds and the cp.async (with the addresses computed afresh, the
  // issue and not the memory set a block's rate)
  constexpr int R = ring_stages<T>();
  const int cpr = tn / E, rstep = THREADS / cpr, r0 = tid / cpr, cc = (tid % cpr) * E;
  const bool col_ok = cc < tl.nvalid;
  const T* src0 = tl.w + tl.col0 + cc + static_cast<long>(k0 + r0) * tl.ld;
  const long src_rstep = static_cast<long>(rstep) * tl.ld;
  const unsigned dst0 = repro::smem_addr(ring + r0 * lay.srow + cc);
  const unsigned dst_rstep = rstep * lay.srow * sizeof(T);
  auto load_stage = [&](int slot, int st) {
    const int kb = k0 + st * KR;
    if constexpr (VEC) {
      const T* src = src0 + static_cast<long>(st) * KR * tl.ld;
      unsigned dst = dst0 + slot * stage_elems * sizeof(T);
      for (int k = kb + r0; k < kb + KR; k += rstep, src += src_rstep, dst += dst_rstep) {
        const bool ok = col_ok && k < k1;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                     "l"(ok ? src : tl.w), "r"(ok ? 16 : 0)
                     : "memory");
      }
    } else {
      T* dst = ring + slot * stage_elems;
      for (int i = tid; i < KR * tn; i += THREADS) {
        const int r = i / tn, col = i - r * tn, k = kb + r;
        dst[r * lay.srow + col] = k < k1 && col < tl.nvalid
                                      ? tl.w[static_cast<long>(k) * tl.ld + tl.col0 + col]
                                      : from_float<T>(0.f);
      }
    }
  };

  // x's rows of the slice into xs[b][0, nst*KR) and the norm's slice into
  // nrm, by cp.async, requested first: these few small loads must not queue
  // behind the weights' bytes (~3 us at full load).  Zero past the slice
  // and for rows past bg.
  const int nch = nst * KR / E;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && xld % E == 0;
  for (int i = tid; i < BG * nch; i += THREADS) {
    const int b = i / nch, c = i - b * nch, k = k0 + c * E;
    T* dst = xs + b * lay.ksp + c * E;
    if (xvec && (k + E <= k1 || k >= k1)) {      // a whole chunk, or zeros
      const bool ok = b < bg && k < k1;
      repro::cp_async16(dst, ok ? x + b * xld + k : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = b < bg && k + e < k1 ? x[b * xld + k + e] : from_float<T>(0.f);
    }
  }
  if (norm != nullptr) {
    const bool nvec = (reinterpret_cast<uintptr_t>(norm) & 15) == 0;
    for (int c = tid; c < nst * KR / 4; c += THREADS) {
      const int k = k0 + c * 4;
      if (nvec && k + 4 <= k1) {
        repro::cp_async16(nrm + c * 4, norm + k, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) nrm[c * 4 + e] = k + e < k1 ? norm[k + e] : 0.f;
      }
    }
  }
  repro::cp_async_commit();
  prefetch();

  // then the weights: the whole ring requested before x is used, a group
  // a stage
#pragma unroll 1
  for (int st = 0; st < R; ++st) {
    if (st < nst) load_stage(st, st);
    repro::cp_async_commit();
  }
  // phase-stamp 1

  // with a norm: x * norm in place, rounded to T, and the sum of squares
  // of x, warp b for batch row b (x's group is the oldest)
  repro::cp_async_wait<R>();
  __syncthreads();
  {
    const int b = warp;
    T* row = xs + b * lay.ksp;
    float s2 = 0.f;
    for (int k = lane; norm != nullptr && k < nst * KR; k += 32) {
      const float f = to_float(row[k]);
      s2 += f * f;
      row[k] = from_float<T>(f * nrm[k]);
    }
    s2 = repro::warp_sum(s2);
    if (lane == 0) ss[b] = s2;
  }

  // phase-stamp 2
  float acc[BG];
#pragma unroll
  for (int i = 0; i < BG; ++i) acc[i] = 0.f;
  const int mts = tn / 16, mt = warp % mts, kg = warp / mts, kgs = WARPS / mts;  // mma
  const int col = tid % tn, kp = tid / tn, kps = THREADS / tn;                    // float32
  // the ring: wait for stage st, use it, refill its slot with st + R
#pragma unroll 1
  for (int st = 0; st < nst; ++st) {
    repro::cp_async_wait<R - 1>();
    __syncthreads();
    // phase-stamp 3 when st == 0
    const T* ws = ring + (st % R) * stage_elems;
    const T* xk = xs + st * KR;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int i = lane >> 3;
#pragma unroll
      for (int j = 0; j < KR / 16; ++j) {
        if (j % kgs != kg) continue;
        unsigned a[4];
        repro::ldmatrix_x4_trans(
            a, ws + (j * 16 + (i >> 1) * 8 + (lane & 7)) * lay.srow + mt * 16 + (i & 1) * 8);
        const T* xb = xk + (lane >> 2) * lay.ksp + j * 16 + 2 * (lane & 3);
        float c4[4] = {acc[0], acc[1], acc[2], acc[3]};
        repro::mma_bf16(c4, a, *reinterpret_cast<const unsigned*>(xb),
                        *reinterpret_cast<const unsigned*>(xb + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = c4[e];
      }
    } else {
      for (int r = kp; r < KR; r += kps) {
        const float wv = to_float(ws[r * lay.srow + col]);
#pragma unroll
        for (int b = 0; b < BG; ++b) acc[b] += to_float(xk[b * lay.ksp + r]) * wv;
      }
    }
    __syncthreads();                             // the slot is free again
    if (st + R < nst) load_stage(st % R, st + R);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
  __syncthreads();                               // x's rows are written even where nst is 0
  // phase-stamp 4

  // the warps' partial sums meet in the freed slots, then go to the block
  // of the cluster that owns their batch row
  float* red = reinterpret_cast<float*>(smem);
  int parts;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // acc[e]: column mt*16 + lane/4 (+8 for e >= 2), batch row 2 (lane%4) + e%2
    const int c = mt * 16 + (lane >> 2), b = 2 * (lane & 3);
    red[(kg * BG + b) * tn + c] = acc[0];
    red[(kg * BG + b + 1) * tn + c] = acc[1];
    red[(kg * BG + b) * tn + c + 8] = acc[2];
    red[(kg * BG + b + 1) * tn + c + 8] = acc[3];
    parts = kgs;
  } else {
#pragma unroll
    for (int b = 0; b < BG; ++b) red[(kp * BG + b) * tn + col] = acc[b];
    parts = kps;
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (BG + splits - 1) / splits;    // batch rows a block owns, at most
  for (int i = tid; i < BG * tn; i += THREADS) {
    float y = 0.f;
    for (int p = 0; p < parts; ++p) y += red[p * BG * tn + i];
    const int b = i / tn, c = i - b * tn;
    cluster.map_shared_rank(recv, b % splits)[(split * per + b / splits) * tn + c] = y;
  }
  if (tid < BG) cluster.map_shared_rank(rss, tid % splits)[split * per + tid / splits] = ss[tid];
  cluster.sync();                                // every block's sums have landed
  // phase-stamp 5
  // the totals of this block's rows, adding the blocks' sums in rank order
  tot = red;
  for (int i = tid; i < per * tn; i += THREADS) {
    const int j = i / tn, c = i - j * tn;
    if (split + j * splits >= BG) continue;
    float y = 0.f;
    for (int r = 0; r < splits; ++r) y += recv[(r * per + j) * tn + c];
    tot[(split + j * splits) * tn + c] = y;
  }
  if (tid < per && split + tid * splits < BG) {
    float y = 0.f;
    for (int r = 0; r < splits; ++r) y += rss[r * per + tid];
    sst[split + tid * splits] = y;
  }
  __syncthreads();
  // phase-stamp 6
}

// Grid (tiles x splits, batch groups), clusters of `splits` blocks; tile t
// is head t of Q (t < H), of K (t < H + KV) or of V.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_qkv_rope_kernel(const T* __restrict__ x, const float* __restrict__ norm,
                      const T* __restrict__ wq, const T* __restrict__ wk,
                      const T* __restrict__ wv, const T* __restrict__ bq,
                      const T* __restrict__ bk, const T* __restrict__ bv,
                      const int* __restrict__ pos_ptr, T* __restrict__ q_out,
                      T* __restrict__ k_cache, T* __restrict__ v_cache,
                      int* __restrict__ clen_out, int B, int D, int H, int KV, int hd, int C,
                      int tn, int slice, int splits, float eps, float theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / splits, split = blockIdx.x - tile * splits;
  const int g = blockIdx.y, b0 = g * BG, bg = min(BG, B - b0);
  if (blockIdx.x == 0 && g == 0 && threadIdx.x == 0) clen_out[0] = min(*pos_ptr + 1, C);

  const T* w;
  const T* bias;
  int ncols, mh, kind;                           // kind 0 q, 1 k, 2 v
  if (tile < H) {
    w = wq, bias = bq, ncols = H * hd, mh = tile, kind = 0;
  } else if (tile < H + KV) {
    w = wk, bias = bk, ncols = KV * hd, mh = tile - H, kind = 1;
  } else {
    w = wv, bias = bv, ncols = KV * hd, mh = tile - H - KV, kind = 2;
  }
  const Tile<T> tl{w, ncols, mh * hd, hd};
  // the epilogue's items: batch rows b = split (mod splits) x the head's
  // columns, EPI at most a thread; their bias (and the rope partner's) and
  // pos are requested before the weights
  const int d2 = hd / 2, nb = (bg - split + splits - 1) / splits;
  float bias_c[EPI], bias_p[EPI];
  int pos = 0;
  auto prefetch = [&] {
    pos = *pos_ptr;
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      const int i = threadIdx.x + u * THREADS, c = i % hd;
      const bool live = i < nb * hd && bias != nullptr;
      const int pc = c < d2 ? c + d2 : c < 2 * d2 ? c - d2 : c;
      bias_c[u] = live ? to_float(bias[mh * hd + c]) : 0.f;
      bias_p[u] = live ? to_float(bias[mh * hd + pc]) : 0.f;
    }
  };
  float *tot, *sst;
  gemv_core<T, VEC>(tl, x + static_cast<long>(b0) * D, D, norm, D, bg, tn, slice, splits, split,
                    smem, tot, sst, prefetch);

  // rscale, bias, rope, the stores
  const int slot = pos % C;
#pragma unroll
  for (int u = 0; u < EPI; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i >= nb * hd) break;
    const int b = split + (i / hd) * splits, c = i % hd;
    const float rs = rsqrtf(sst[b] / D + eps);
    float v = tot[b * tn + c] * rs + bias_c[u];
    if (kind < 2 && c < 2 * d2) {                // rope; an odd tail column passes
      const int p = c < d2 ? c : c - d2, pc = c < d2 ? c + d2 : c - d2;
      const float partner = tot[b * tn + pc] * rs + bias_p[u];
      const float freq = powf(theta, -(static_cast<float>(p) / static_cast<float>(d2)));
      const float ang = static_cast<float>(pos) * freq;
      const float cs = cosf(ang), sn = sinf(ang);
      v = c < d2 ? v * cs - partner * sn : partner * sn + v * cs;
    }
    const long bb = b0 + b;
    if (kind == 0) {
      q_out[(bb * H + mh) * hd + c] = from_float<T>(v);
    } else {
      T* cache = kind == 1 ? k_cache : v_cache;
      cache[((bb * C + slot) * KV + mh) * hd + c] = from_float<T>(v);
    }
  }
  // phase-stamp 7 synced
}

// Grid (tiles x splits, batch groups), clusters of `splits` blocks; tile t
// is columns [t tn, t tn + tn) of wo.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
fused_out_residual_kernel(const T* __restrict__ o, const T* __restrict__ wo,
                          const T* __restrict__ x, T* __restrict__ out, int B, int K, int D,
                          int tn, int slice, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / splits, split = blockIdx.x - tile * splits;
  const int g = blockIdx.y, b0 = g * BG, bg = min(BG, B - b0);
  const int n0 = tile * tn, nvalid = min(tn, D - n0);
  const Tile<T> tl{wo, D, n0, nvalid};
  // the epilogue's items: batch rows b = split (mod splits) x the tile's
  // columns, EPI at most a thread; their residual is requested before the
  // weights
  const int nb = (bg - split + splits - 1) / splits;
  float res[EPI];
  auto prefetch = [&] {
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int b = split + (i / nvalid) * splits, c = i % nvalid;
      res[u] = i < nb * nvalid ? to_float(x[static_cast<long>(b0 + b) * D + n0 + c]) : 0.f;
    }
  };
  float *tot, *sst;
  gemv_core<T, VEC>(tl, o + static_cast<long>(b0) * K, K, nullptr, K, bg, tn, slice, splits,
                    split, smem, tot, sst, prefetch);
#pragma unroll
  for (int u = 0; u < EPI; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i >= nb * nvalid) break;
    const int b = split + (i / nvalid) * splits, c = i % nvalid;
    out[static_cast<long>(b0 + b) * D + n0 + c] = from_float<T>(res[u] + tot[b * tn + c]);
  }
  // phase-stamp 7 synced
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// up to 8 splits (a portable cluster), slices of whole mma steps that
// cover the K rows
bool plan_ok(int tn, int slice, int splits, int K) {
  return tn >= 16 && tn <= TN_MAX && (tn & (tn - 1)) == 0 && slice >= 1 && splits >= 1 &&
         splits <= MAX_SPLITS && (splits == 1 || slice % 16 == 0) &&
         static_cast<long>(slice) * splits >= K;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int splits, size_t smem, void* stream, Args... args) {
  cudaError_t err = repro::allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_qkv(const void* x, const void* norm, const void* wq, const void* wk, const void* wv,
               const void* bq, const void* bk, const void* bv, const void* pos, void* q_out,
               void* k_cache, void* v_cache, void* clen, int B, int D, int H, int KV, int hd,
               int C, int tn, int slice, int splits, float eps, float theta, void* stream) {
  if (B < 1 || hd < 1 || hd > tn || H < 1 || KV < 1 || C < 1 || !plan_ok(tn, slice, splits, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout<T> lay(tn, slice, true);
  const dim3 grid((H + 2 * KV) * splits, (B + BG - 1) / BG);
  const bool vec = hd % pad<T>() == 0 && aligned(wq) && aligned(wk) && aligned(wv);
  auto run = [&](auto kernel) {
    return launch(kernel, grid, splits, lay.bytes, stream, static_cast<const T*>(x),
                  static_cast<const float*>(norm), static_cast<const T*>(wq),
                  static_cast<const T*>(wk), static_cast<const T*>(wv), static_cast<const T*>(bq),
                  static_cast<const T*>(bk), static_cast<const T*>(bv),
                  static_cast<const int*>(pos), static_cast<T*>(q_out), static_cast<T*>(k_cache),
                  static_cast<T*>(v_cache), static_cast<int*>(clen), B, D, H, KV, hd, C, tn,
                  slice, splits, eps, theta);
  };
  return vec ? run(fused_qkv_rope_kernel<T, true>) : run(fused_qkv_rope_kernel<T, false>);
}

template <typename T>
int launch_out(const void* o, const void* wo, const void* x, void* out, int B, int K, int D,
               int tn, int slice, int splits, void* stream) {
  if (B < 1 || D < 1 || !plan_ok(tn, slice, splits, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout<T> lay(tn, slice, false);
  const dim3 grid((D + tn - 1) / tn * splits, (B + BG - 1) / BG);
  const bool vec = D % pad<T>() == 0 && aligned(wo);
  auto run = [&](auto kernel) {
    return launch(kernel, grid, splits, lay.bytes, stream, static_cast<const T*>(o),
                  static_cast<const T*>(wo), static_cast<const T*>(x), static_cast<T*>(out), B, K,
                  D, tn, slice, splits);
  };
  return vec ? run(fused_out_residual_kernel<T, true>) : run(fused_out_residual_kernel<T, false>);
}

}  // namespace

#define QKV_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* x, const void* norm, const void* wq, const void* wk,       \
                      const void* wv, const void* bq, const void* bk, const void* bv,        \
                      const void* pos, void* q_out, void* k_cache, void* v_cache, void* clen, \
                      int B, int D, int H, int KV, int hd, int C, int tn, int slice,         \
                      int splits, float eps, float theta, void* stream) {                    \
    return launch_qkv<T>(x, norm, wq, wk, wv, bq, bk, bv, pos, q_out, k_cache, v_cache, clen, \
                         B, D, H, KV, hd, C, tn, slice, splits, eps, theta, stream);         \
  }

#define OUT_ENTRY(NAME, T)                                                                   \
  extern "C" int NAME(const void* o, const void* wo, const void* x, void* out, int B, int K, \
                      int D, int tn, int slice, int splits, void* stream) {                  \
    return launch_out<T>(o, wo, x, out, B, K, D, tn, slice, splits, stream);                 \
  }

QKV_ENTRY(fused_qkv_rope_bf16, __nv_bfloat16)
QKV_ENTRY(fused_qkv_rope_f32, float)
OUT_ENTRY(fused_out_residual_bf16, __nv_bfloat16)
OUT_ENTRY(fused_out_residual_f32, float)
