// Mamba2 SSD (state-space duality) scan: within a chunk of tokens the
// decay-masked quadratic form (C . B^T o exp(segsum) o dt) @ x, across
// chunks a carried (P, N) float32 state.
//
//   x (B, L, H, P) in T, read through its strides (p contiguous);
//   dt (B, L, H) float32, through its strides; a (H,) float32;
//   b, c (B, L, N) in T, through their strides (n contiguous), one group
//   shared by the heads;
//   y (B, L, H, P) in T, contiguous; state (B, H, P, N) float32, contiguous.
//   P <= 64, N <= 128, any L >= 1.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (repro/kernels/ssd_scan.py).
// Both instances walk a sequence in chunks of Q = 64 tokens, the kernel's
// own blocking: a loop inside the block takes the place of the TPU's
// sequential chunk axis, and a chunked scan gives the same function for
// any chunk length, summed in another order.  A chunk's cumsum of dt * a
// is one warp's shuffle scan, two tokens a lane.  Rows past the end of the
// sequence load as zeros (x, b, c and dt = 0), which leaves the state
// unchanged, as the TPU wrapper's zero padding does.
//
// Bound on the H100: bytes.  At mamba2-370m's prefill (B8 L512 H32 P64
// N128) the call moves ~44.6 MB (x and y, b and c, dt, the state: ~13 us
// at 3.35 TB/s) against ~7.5 GFLOP of chunk products (~8 us at the bf16
// tensor-core rate).  On the CUDA cores alone those products take >= 110
// us, so the bf16 instance runs them on the tensor cores.
//
// bf16, `ssd_scan_kernel<bf16>`: one block of 4 warps per (head,
// sequence), ~109 KB of shared memory, two blocks an SM, so mamba2-370m's
// 256 (head, sequence) pairs run in one wave on 132 SMs.  (One block per
// pair of heads, which would load b and c once for both, was not taken:
// C.B^T is a tenth of the products, W differs by head anyway, and a block
// of one head needs no odd-H case.)  A chunk's c, b and x tiles stay bf16
// in shared memory, in a ring of two stages: thread 0 asks the copy engine
// for chunk k + 1's tiles (2-d tensor copies, one box of 64 rows by 64
// columns each, rows past L zero-filled, completing on the stage's
// mbarrier) while chunk k computes, and its dt comes by cp.async.  The
// boxes land in the 128-byte swizzle (16-byte chunk c of row r at c ^ r %
// 8), so `ldmatrix` meets no bank conflicts.  (Copies issued by the
// threads stalled them ~1500 clocks a chunk; one bulk copy a row, ~200
// small copies a chunk, outran the copy engine.)  Where a base or stride
// is off 16 bytes, the tiles load element by element.  Every product is
// `mma.sync.m16n8k16` in bf16 with float32 sums; warp w owns rows
// p0 = 16w .. p0 + 15 of the head dim (P zero-padded to 64, N to 128):
//   1. W = (C B^T) o exp(cs_i - cs_j) o dt_j on the 10 16x16 tiles on or
//      below the diagonal only (C B^T is exact: bf16 inputs, float32
//      sums), three tiles a warp side by side, stored as bf16 hi + lo
//      after all of the warp's elements are computed;
//   2. y^T[p][i] = exp(cs_i) * sum_n S[p][n] C[i][n]: the carried state S
//      is the A operand straight from this warp's accumulator registers,
//      as hi + lo, C the B operand; it needs no W, so it runs before the
//      barrier that waits for W;
//   3. y^T += x^T W^T, x^T through `ldmatrix.trans`, W's lower tiles;
//   4. y through a per-warp tile (stmatrix transposes the fragments into
//      rows) and one tensor store of its 64 rows by 16 columns;
//   5. S = S exp(cs_last) + (rem o x)^T B, rem_j = exp(cs_last - cs_j) dt_j,
//      with (rem o x)^T built from x^T's fragments in registers as hi + lo
//      and B through `ldmatrix.trans`; S stays float32 in registers for the
//      whole sequence and is never rounded.
// Precision: x, b and c are exact in bf16; W, S and rem o x are float32
// values, and one bf16 rounding (2^-9 of a term) would break the state's
// 1e-4 check, so each is split as hi = bf16(v), lo = bf16(v - hi) and
// multiplied twice (~2^-17 of a term).  With W and S rounded once, y
// misses its 0.02 + 0.02 |y| check by up to 7.6x (`probes.ssd_phases`).
// Two block barriers a chunk: chunk k - 1 is done with the other stage,
// W is whole.  What bounds it now: the mma.sync products at two warps an
// SM sub-partition (steps 2 and 5 take ~15 clocks a product a warp), and
// the tails around them (W's decay, the barriers): ~3.8x the bytes bound.
//
// float32, `ssd_scan_kernel<float>`: the CUDA-core body of the port's first
// version, unchanged but for moving into a function; it serves the float32 A/B and tests (a bf16
// tensor-core product cannot hold float32 inputs to 1e-4).  One block per
// (head, sequence); a chunk's b, c and x tiles go to shared memory as
// float32, then three register-tiled passes, 256 threads each holding a
// 4 x 4 (or 4 x 8) tile: W, y = W x + exp(cs) (C S^T), and the state
// update.  Tiles have one float of padding a row, so the threads of a
// warp, which read 16 different rows at one column, hit 16 different
// banks.  The blocks of one sequence sit next to each other in the grid
// (both instances), so b and c, read by every head, come from L2 after
// the first.
//
// The backward pass (dx, ddt, da, db and dc, for training) is at the end of
// this file.
#include <type_traits>

#include "common.cuh"

// 0 drops the lo halves of W and S in the y products (steps 2 and 3 below):
// a variant that `repro_torch.probes.ssd_phases` builds to measure what the
// split costs and what it saves in error.
#ifndef SSD_SPLIT_Y
#define SSD_SPLIT_Y 1
#endif

namespace {

using repro::from_float;
using bf16 = __nv_bfloat16;

constexpr int Q = 64;           // tokens a chunk
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;

// -- float32: CUDA cores ----------------------------------------------------

constexpr int THREADS = 256;    // 16 x 16 thread tile

size_t shared_floats(int P, int N) {
  // Cs, Bs [Q][N+1]; Xs [Q][P+1]; Ws [Q][Q+1]; Ss [P][N+1]; dt, cs, exp(cs), rem [Q]
  return 2 * Q * (N + 1) + Q * (P + 1) + Q * (Q + 1) + P * (N + 1) + 4 * Q;
}

template <typename T>
__device__ __forceinline__ void scan_fma(const T* __restrict__ x, const float* __restrict__ dt,
                                         const float* __restrict__ a, const T* __restrict__ bm,
                                         const T* __restrict__ cm, T* __restrict__ y,
                                         float* __restrict__ state, int L, int H, int P, int N,
                                         long xs_b, long xs_l, long xs_h, long ds_b, long ds_l,
                                         long ds_h, long bs_b, long bs_l, long cs_b, long cs_l) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ns = N + 1, ps = P + 1, qs = Q + 1;
  float* Cs = smem;                 // [Q][N+1]
  float* Bs = Cs + Q * ns;          // [Q][N+1]
  float* Xs = Bs + Q * ns;          // [Q][P+1]
  float* Ws = Xs + Q * ps;          // [Q][Q+1]
  float* Ss = Ws + Q * qs;          // [P][N+1]
  float* dts = Ss + P * ns;         // [Q]
  float* css = dts + Q;             // [Q] inclusive cumsum of dt * a
  float* ecs = css + Q;             // [Q] exp(cs)
  float* rem = ecs + Q;             // [Q] exp(cs_last - cs) * dt

  const float ah = a[h];
  for (int i = tid; i < P * ns; i += THREADS) Ss[i] = 0.f;

  const T* xb = x + b * xs_b + h * xs_h;
  const float* db = dt + b * ds_b + h * ds_h;
  const T* bb = bm + b * bs_b;
  const T* cb = cm + b * cs_b;
  for (int l0 = 0; l0 < L; l0 += Q) {
    const int valid = min(Q, L - l0);
    repro::load_tile(Cs, ns, cb + l0 * cs_l, cs_l, Q, valid, N, 1.f);
    repro::load_tile(Bs, ns, bb + l0 * bs_l, bs_l, Q, valid, N, 1.f);
    repro::load_tile(Xs, ps, xb + l0 * xs_l, xs_l, Q, valid, P, 1.f);
    if (tid < Q) dts[tid] = tid < valid ? db[(l0 + tid) * ds_l] : 0.f;
    __syncthreads();

    if (tid < 32) {  // inclusive cumsum of dt * a over the chunk: two tokens a lane
      const float v0 = dts[2 * tid] * ah, v1 = dts[2 * tid + 1] * ah;
      float run = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, o);
        if (tid >= o) run += u;
      }
      const float c1 = run, c0 = run - v1;
      const float tot = __shfl_sync(0xffffffffu, run, 31);
      css[2 * tid] = c0;
      css[2 * tid + 1] = c1;
      ecs[2 * tid] = expf(c0);
      ecs[2 * tid + 1] = expf(c1);
      rem[2 * tid] = expf(tot - c0) * dts[2 * tid];
      rem[2 * tid + 1] = expf(tot - c1) * dts[2 * tid + 1];
    }
    __syncthreads();

    // 1. W = (C B^T) o decay o dt, lower triangle
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ns + n];
#pragma unroll
        for (int s = 0; s < 4; ++s) bv[s] = Bs[(tx + 16 * s) * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] += cv[r] * bv[s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = tx + 16 * s;
          Ws[i * qs + j] = j <= i ? acc[r][s] * expf(css[i] - css[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. y = W x + exp(cs) (C S^T)
    {
      float acc[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < valid; ++j) {
        float wv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = Ws[(ty + 16 * r) * qs + j];
#pragma unroll
        for (int s = 0; s < 4; ++s) xv[s] = tx + 16 * s < P ? Xs[j * ps + tx + 16 * s] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] += wv[r] * xv[s];
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ns + n];
#pragma unroll
        for (int s = 0; s < 4; ++s) sv[s] = tx + 16 * s < P ? Ss[(tx + 16 * s) * ns + n] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) inter[r][s] += cv[r] * sv[s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= valid) continue;
        T* yr = y + ((static_cast<long>(b) * L + l0 + i) * H + h) * P;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int p = tx + 16 * s;
          if (p < P) yr[p] = from_float<T>(acc[r][s] + ecs[i] * inter[r][s]);
        }
      }
    }
    __syncthreads();

    // 3. S = S exp(cs_last) + sum_j x_j^T (rem_j B_j)
    {
      const float decay = expf(css[Q - 1]);
      float acc[4][8] = {};
      for (int j = 0; j < valid; ++j) {
        const float rj = rem[j];
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = ty + 16 * r < P ? Xs[j * ps + ty + 16 * r] * rj : 0.f;
#pragma unroll
        for (int s = 0; s < 8; ++s) bv[s] = tx + 16 * s < N ? Bs[j * ns + tx + 16 * s] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 8; ++s) acc[r][s] += xv[r] * bv[s];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = ty + 16 * r;
        if (p >= P) continue;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int n = tx + 16 * s;
          if (n < N) Ss[p * ns + n] = Ss[p * ns + n] * decay + acc[r][s];
        }
      }
    }
    __syncthreads();
  }

  float* sb = state + (static_cast<long>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    sb[i] = Ss[p * ns + n];
  }
}

// -- bf16: tensor cores -----------------------------------------------------

constexpr int WARPS = 4;                  // 16 rows of the head dim each
constexpr int MMA_THREADS = WARPS * 32;
constexpr int NCH = MAX_N / 8;            // 16-byte chunks a row of b and c
constexpr int QT = Q / 16;                // 16-token tiles a chunk
constexpr int TILES = QT * (QT + 1) / 2;  // W's tiles on or below the diagonal
constexpr int TILES_A_WARP = (TILES + WARPS - 1) / WARPS;
// The tiles are boxes of 64 rows by 64 columns (128 bytes) as the copy
// engine's 128-byte swizzle lays them out: 16-byte chunk c of row r at
// chunk c ^ (r % 8), so that the 8 rows an ldmatrix reads at one chunk fall
// in 8 different bank groups.  c and b take two boxes (N up to 128), x and
// W one.
constexpr int BOX = 64 * 64;              // elements
constexpr int BOX_BYTES = BOX * 2;
// a stage: c, b (two boxes each), x (one), all bf16
constexpr int STAGE_BYTES = 5 * BOX_BYTES;
// then W hi and lo (a box each); each warp's y tile [Q][16] bf16; dt of
// each stage and each warp's cs log2(e), exp(cs), rem [Q] float32; an
// mbarrier a stage.  The boxes need 1024-byte alignment: room to align the base.
constexpr int W_OFF = 2 * STAGE_BYTES;
constexpr int YS_OFF = W_OFF + 2 * BOX_BYTES;
constexpr int DT_OFF = YS_OFF + WARPS * Q * 16 * 2;
constexpr int CS_OFF = DT_OFF + 2 * Q * 4;
constexpr int BAR_OFF = CS_OFF + WARPS * 3 * Q * 4;
constexpr size_t MMA_SMEM = BAR_OFF + 2 * sizeof(uint64_t) + 1024;

// which tensors go by tensor copies (the host could make their maps)
constexpr int TMA_X = 1, TMA_BC = 2, TMA_Y = 4;
constexpr float LOG2E = 1.4426950408889634f;

// The tensor maps of c, b, x and y (made on the host for each call); the
// float32 instance takes none.
struct Maps {
  CUtensorMap c, b, x, y;
};

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of boxes.
__device__ __forceinline__ int sw_at(int row, int chunk) {
  return (chunk >> 3) * BOX + row * 64 + ((chunk & 7) ^ (row & 7)) * 8;
}

// Element offset of row i's 8-column half `half` in a warp's y tile: the
// halves of rows 4..7 of every 8 swap places (the copy engine's 32-byte
// swizzle), so that the 8 rows one stmatrix writes fall in 8 different
// bank groups.
__device__ __forceinline__ int ys_at(int i, int half) {
  return i * 16 + (half ^ ((i >> 2) & 1)) * 8;
}

// v0, v1 ~ hi + lo, each a bf16 pair (v0 in the low halves): one bf16
// holds a float32 value to 2^-9 of itself, the pair to ~2^-17.
__device__ __forceinline__ void split_bf16(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = repro::pack_bf16(v0 - f.x, v1 - f.y);
}

// A tile's rows [0, valid) into its boxes element by element, zero past
// `cols` and `valid`: the path for tensors the copy engine cannot map.
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long stride, int valid,
                                          int cols, int width) {
  for (int idx = threadIdx.x; idx < Q * width; idx += MMA_THREADS) {
    const int row = idx / width, col = idx % width;
    dst[sw_at(row, col / 8) + col % 8] =
        row < valid && col < cols ? src[row * stride + col] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void scan_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                                         const float* __restrict__ a, const bf16* __restrict__ bm,
                                         const bf16* __restrict__ cm, bf16* __restrict__ y,
                                         float* __restrict__ state, int L, int H, int P, int N,
                                         long xs_b, long xs_l, long xs_h, long ds_b, long ds_l,
                                         long ds_h, long bs_b, long bs_l, long cs_b, long cs_l,
                                         int flags, const Maps& maps) {
  extern __shared__ __align__(1024) unsigned char ssd_smem_raw[];
  unsigned char* smem = ssd_smem_raw + ((1024 - (repro::smem_addr(ssd_smem_raw) & 1023)) & 1023);
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;   // fragment row and column pair
  const int p0 = warp * 16;
  bf16* Whi = reinterpret_cast<bf16*>(smem + W_OFF);          // a box each
  bf16* Wlo = Whi + BOX;
  bf16* Ys = reinterpret_cast<bf16*>(smem + YS_OFF) + warp * Q * 16;   // [Q][16], ys_at
  float* cs2 = reinterpret_cast<float*>(smem + CS_OFF) + warp * 3 * Q;   // cs log2(e)
  float* ecs = cs2 + Q;      // exp(cs)
  float* rem = ecs + Q;      // exp(cs_last - cs) * dt
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);   // a stage's tensor copies

  const bf16* xb = x + b * xs_b + h * xs_h;
  const float* db = dt + b * ds_b + h * ds_h;
  const bf16* bb = bm + b * bs_b;
  const bf16* cb = cm + b * cs_b;
  const float ah = a[h];
  const int chunks = (L + Q - 1) / Q;
  const bool tma_bc = flags & TMA_BC, tma_x = flags & TMA_X;
  const int bc_boxes = N > 64 ? 2 : 1;     // a second box of c and b only where N needs it

  if (threadIdx.x == 0) {
    repro::mbar_init(&full[0], 1);
    repro::mbar_init(&full[1], 1);
    repro::mbar_fence_init();
  }
  if (bc_boxes == 1) {                     // the box no copy writes stays zero
    for (int st = 0; st < 2; ++st)
      for (int i = threadIdx.x; i < BOX_BYTES / 16; i += MMA_THREADS) {
        unsigned char* stage = smem + st * STAGE_BYTES;
        reinterpret_cast<uint4*>(stage + BOX_BYTES)[i] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(stage + 3 * BOX_BYTES)[i] = make_uint4(0, 0, 0, 0);
      }
    repro::fence_proxy_async();
  }
  __syncthreads();

  // Chunk k's c, b and x into stage k % 2 (tensor copies, rows past L
  // zero-filled, issued by thread 0; or element loads by every thread),
  // and its dt by cp.async, committed as one group
  auto issue = [&](int k) {
    unsigned char* stage = smem + (k & 1) * STAGE_BYTES;
    bf16* Cs = reinterpret_cast<bf16*>(stage);
    bf16* Bs = Cs + 2 * BOX;
    bf16* Xs = Bs + 2 * BOX;
    const int l0 = k * Q, valid = min(Q, L - l0);
    uint64_t* bar = &full[k & 1];
    if (threadIdx.x == 0) {
      repro::mbar_arrive_expect_tx(
          bar, (tma_bc ? 2 * bc_boxes * BOX_BYTES : 0) + (tma_x ? BOX_BYTES : 0));
      if (tma_bc)
        for (int box = 0; box < bc_boxes; ++box) {
          repro::tensor_load_3d(Cs + box * BOX, &maps.c, box * 64, l0, b, bar);
          repro::tensor_load_3d(Bs + box * BOX, &maps.b, box * 64, l0, b, bar);
        }
      if (tma_x) repro::tensor_load_4d(Xs, &maps.x, 0, h, l0, b, bar);
    }
    if (!tma_bc) {
      copy_rows(Cs, cb + l0 * cs_l, cs_l, valid, N, MAX_N);
      copy_rows(Bs, bb + l0 * bs_l, bs_l, valid, N, MAX_N);
    }
    if (!tma_x) copy_rows(Xs, xb + l0 * xs_l, xs_l, valid, P, MAX_P);
    float* dts = reinterpret_cast<float*>(smem + DT_OFF) + (k & 1) * Q;
    if (threadIdx.x < Q) {
      const bool ok = static_cast<int>(threadIdx.x) < valid;
      repro::cp_async4(dts + threadIdx.x, ok ? db + (l0 + threadIdx.x) * ds_l : db, ok ? 4 : 0);
    }
    repro::cp_async_commit();
  };

  // W's tiles this warp computes: w, w + 4, w + 8 of the row-major lower
  // triangle; a warp with fewer computes its first again in the last slot
  // and does not store it (it would wait for the others at the barrier)
  int tile_i[TILES_A_WARP], tile_j[TILES_A_WARP];
  bool tile_own[TILES_A_WARP];
#pragma unroll
  for (int u = 0; u < TILES_A_WARP; ++u) {
    const int t0 = warp + u * WARPS;
    tile_own[u] = t0 < TILES;
    const int t = tile_own[u] ? t0 : warp;
    tile_i[u] = t < 1 ? 0 : t < 3 ? 1 : t < 6 ? 2 : 3;
    tile_j[u] = t - tile_i[u] * (tile_i[u] + 1) / 2;
  }

  // S rows p0 + gr (e 0, 1) and p0 + gr + 8 (e 2, 3), columns 8 nt + 2 tq
  // (+1): the accumulator layout of the state update
  float s[MAX_N / 8][4];
#pragma unroll
  for (int nt = 0; nt < MAX_N / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  // phase-stamp 0
  issue(0);
  for (int k = 0; k < chunks; ++k) {
    const int l0 = k * Q, valid = min(Q, L - l0);
    const bf16* Cs = reinterpret_cast<const bf16*>(smem + (k & 1) * STAGE_BYTES);
    const bf16* Bs = Cs + 2 * BOX;
    const bf16* Xs = Bs + 2 * BOX;
    const float* dts = reinterpret_cast<const float*>(smem + DT_OFF) + (k & 1) * Q;
    repro::cp_async_wait<0>();
    __syncthreads();               // chunk k's dt and element loads are in; chunk k - 1 is done
    // phase-stamp 1
    if (k + 1 < chunks) issue(k + 1);
    repro::mbar_wait(&full[k & 1], (k >> 1) & 1);   // chunk k's tensor copies are in
    // phase-stamp 2

    // 1. W = (C B^T) o exp(cs_i - cs_j) o dt_j on the tiles on or below the
    //    diagonal (zero above it), as bf16 hi + lo; this warp's tiles side
    //    by side, so that their products interleave
    float g[TILES_A_WARP][2][4];
#pragma unroll
    for (int u = 0; u < TILES_A_WARP; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) g[u][e / 4][e % 4] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NCH / 2; ++kk) {
#pragma unroll
      for (int u = 0; u < TILES_A_WARP; ++u) {
        unsigned fa[4], fb[4];
        repro::ldmatrix_x4(fa, Cs + sw_at(tile_i[u] * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          kk * 2 + (lane >> 4)));
        repro::ldmatrix_x4(fb, Bs + sw_at(tile_j[u] * 16 + (lane & 7) + (lane >> 4) * 8,
                                          kk * 2 + ((lane >> 3) & 1)));
        repro::mma_bf16(g[u][0], fa, fb[0], fb[1]);
        repro::mma_bf16(g[u][1], fa, fb[2], fb[3]);
      }
    }

    // 0. the chunk's inclusive cumsum cs of dt * a, each warp its own copy
    //    (a shuffle scan, two tokens a lane), while the products run
    float tot;
    {
      const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
      const float v0 = d0 * ah, v1 = d1 * ah;
      float run = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += u;
      }
      const float c1 = run, c0 = run - v1;
      tot = __shfl_sync(0xffffffffu, run, 31);
      cs2[2 * lane] = c0 * LOG2E;
      cs2[2 * lane + 1] = c1 * LOG2E;
      ecs[2 * lane] = expf(c0);
      ecs[2 * lane + 1] = expf(c1);
      rem[2 * lane] = expf(tot - c0) * d0;
      rem[2 * lane + 1] = expf(tot - c1) * d1;
    }
    __syncwarp();
    // phase-stamp 3

    // every element of this warp's tiles first, then the stores: a store
    // to W might alias a later read of cs, which would chain each element
    // after the last one's store; no branch either (exp of a clamped
    // argument, which overflows above the diagonal, times a 0/1 mask)
    unsigned w_hi[TILES_A_WARP][2][2], w_lo[TILES_A_WARP][2][2];
#pragma unroll
    for (int u = 0; u < TILES_A_WARP; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = tile_i[u] * 16 + gr + r * 8;
        const float ci = cs2[i];
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const int j = tile_j[u] * 16 + jt * 8 + 2 * tq;
          const float w0 = g[u][jt][2 * r] * exp2f(fminf(ci - cs2[j], 0.f)) * dts[j] *
                           static_cast<float>(j <= i);
          const float w1 = g[u][jt][2 * r + 1] * exp2f(fminf(ci - cs2[j + 1], 0.f)) *
                           dts[j + 1] * static_cast<float>(j < i);
          split_bf16(w0, w1, w_hi[u][r][jt], w_lo[u][r][jt]);
        }
      }
#pragma unroll
    for (int u = 0; u < TILES_A_WARP; ++u) {
      if (!tile_own[u]) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const int o = sw_at(tile_i[u] * 16 + gr + r * 8, tile_j[u] * 2 + jt) + 2 * tq;
          *reinterpret_cast<unsigned*>(Whi + o) = w_hi[u][r][jt];
          *reinterpret_cast<unsigned*>(Wlo + o) = w_lo[u][r][jt];
        }
    }
    // phase-stamp 4

    // y^T: rows p0 + gr (e 0, 1) and p0 + gr + 8 (e 2, 3), columns (tokens)
    // 8 it + 2 tq (+1)
    float acc[QT * 2][4];
#pragma unroll
    for (int it = 0; it < QT * 2; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[it][e] = 0.f;
    const bool active = p0 < P;    // the rest is this warp's rows alone

    // 2. y^T = exp(cs_i) (S C^T), S's A fragments from its accumulators; it
    //    needs no W, so it runs before the barrier that waits for W
    if (active) {
#pragma unroll
      for (int kk = 0; kk < NCH / 2; ++kk) {
        unsigned hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int I = 0; I < QT; ++I) {
          unsigned fc[4];
          repro::ldmatrix_x4(fc, Cs + sw_at(I * 16 + (lane & 7) + (lane >> 4) * 8,
                                            kk * 2 + ((lane >> 3) & 1)));
          repro::mma_bf16(acc[2 * I], hi, fc[0], fc[1]);
          repro::mma_bf16(acc[2 * I + 1], hi, fc[2], fc[3]);
          if constexpr (SSD_SPLIT_Y) {
            repro::mma_bf16(acc[2 * I], lo, fc[0], fc[1]);
            repro::mma_bf16(acc[2 * I + 1], lo, fc[2], fc[3]);
          }
        }
      }
#pragma unroll
      for (int it = 0; it < QT * 2; ++it)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[it][e] *= ecs[it * 8 + 2 * tq + (e & 1)];
    }
    // phase-stamp 5
    __syncthreads();               // W is whole
    // phase-stamp 6

    if (active) {
      // 3. y^T += x^T W^T over W's tiles on or below the diagonal
      unsigned xa[QT][4];          // x^T's A fragments, token tile J
#pragma unroll
      for (int J = 0; J < QT; ++J) {
        repro::ldmatrix_x4_trans(xa[J], Xs + sw_at(J * 16 + (lane & 7) + (lane >> 4) * 8,
                                                   2 * warp + ((lane >> 3) & 1)));
#pragma unroll
        for (int I = J; I < QT; ++I) {
          unsigned wh[4], wl[4];
          const int o = sw_at(I * 16 + (lane & 7) + (lane >> 4) * 8, J * 2 + ((lane >> 3) & 1));
          repro::ldmatrix_x4(wh, Whi + o);
          repro::ldmatrix_x4(wl, Wlo + o);
          repro::mma_bf16(acc[2 * I], xa[J], wh[0], wh[1]);
          repro::mma_bf16(acc[2 * I + 1], xa[J], wh[2], wh[3]);
          if constexpr (SSD_SPLIT_Y) {
            repro::mma_bf16(acc[2 * I], xa[J], wl[0], wl[1]);
            repro::mma_bf16(acc[2 * I + 1], xa[J], wl[2], wl[3]);
          }
        }
      }
      // phase-stamp 7

      // 4. y: this warp's 16 columns of each row through its tile (stmatrix
      //    transposes the fragments into rows), then a tensor store (rows
      //    past L are not written) or 16 bytes a lane
      if (lane == 0) repro::bulk_wait_read();   // the last chunk's store has read the tile
      __syncwarp();
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const int m = lane >> 3;
        repro::stmatrix_x4_trans(
            Ys + ys_at((2 * q + (m >> 1)) * 8 + (lane & 7), m & 1),
            repro::pack_bf16(acc[2 * q][0], acc[2 * q][1]),
            repro::pack_bf16(acc[2 * q][2], acc[2 * q][3]),
            repro::pack_bf16(acc[2 * q + 1][0], acc[2 * q + 1][1]),
            repro::pack_bf16(acc[2 * q + 1][2], acc[2 * q + 1][3]));
      }
      if (flags & TMA_Y) {
        repro::fence_proxy_async();
        __syncwarp();
        if (lane == 0) repro::tensor_store_4d(&maps.y, Ys, p0, h, l0, b);
      } else {
        __syncwarp();
        for (int c = lane; c < Q * 2; c += 32) {
          const int i = c >> 1, pl = p0 + (c & 1) * 8;
          if (i < valid && pl < P) {
            bf16* yr = y + ((static_cast<long>(b) * L + l0 + i) * H + h) * P + pl;
            const bf16* src = Ys + ys_at(i, c & 1);
            for (int e = 0; e < 8 && pl + e < P; ++e) yr[e] = src[e];
          }
        }
        __syncwarp();
      }
      // phase-stamp 8

      // 5. S = S exp(cs_last) + (rem o x)^T B
      const float decay = expf(tot);
#pragma unroll
      for (int nt = 0; nt < MAX_N / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= decay;
#pragma unroll
      for (int J = 0; J < QT; ++J) {
        // xa[J]: registers 0, 1 hold tokens J16 + 2 tq (+1), 2, 3 those + 8
        const int j = J * 16 + 2 * tq;
        const float r0 = rem[j], r1 = rem[j + 1], r2 = rem[j + 8], r3 = rem[j + 9];
        unsigned hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[J][q]));
          split_bf16(v.x * (q < 2 ? r0 : r2), v.y * (q < 2 ? r1 : r3), hi[q], lo[q]);
        }
#pragma unroll
        for (int nb = 0; nb < NCH / 2; ++nb) {
          unsigned fb[4];
          repro::ldmatrix_x4_trans(fb, Bs + sw_at(J * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                  nb * 2 + (lane >> 4)));
          repro::mma_bf16(s[2 * nb], hi, fb[0], fb[1]);
          repro::mma_bf16(s[2 * nb + 1], hi, fb[2], fb[3]);
          repro::mma_bf16(s[2 * nb], lo, fb[0], fb[1]);
          repro::mma_bf16(s[2 * nb + 1], lo, fb[2], fb[3]);
        }
      }
      // phase-stamp 9
    }
  }

  if (lane == 0) repro::bulk_wait();   // y's last tensor store is done
  if (p0 < P) {
    float* sb = state + (static_cast<long>(b) * H + h) * P * N;
#pragma unroll
    for (int nt = 0; nt < MAX_N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gr + (e >> 1) * 8, n = nt * 8 + 2 * tq + (e & 1);
        if (p < P && n < N) sb[p * N + n] = s[nt][e];
      }
  }
  // phase-stamp 10
}

// -- the kernel: one template, an instance for each dtype --------------------

template <typename T>
struct Shape {               // float32: the CUDA-core body
  static constexpr int threads = THREADS, min_blocks = 1;
};
template <>
struct Shape<bf16> {         // bf16: the tensor-core body, two blocks an SM
  static constexpr int threads = MMA_THREADS, min_blocks = 2;
};

template <typename T>
__global__ void __launch_bounds__(Shape<T>::threads, Shape<T>::min_blocks)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ state,
                int L, int H, int P, int N, long xs_b, long xs_l, long xs_h, long ds_b,
                long ds_l, long ds_h, long bs_b, long bs_l, long cs_b, long cs_l, int flags,
                const __grid_constant__ Maps maps) {
  if constexpr (std::is_same_v<T, bf16>)
    scan_mma(x, dt, a, bm, cm, y, state, L, H, P, N, xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b,
             bs_l, cs_b, cs_l, flags, maps);
  else
    scan_fma(x, dt, a, bm, cm, y, state, L, H, P, N, xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b,
             bs_l, cs_b, cs_l);
}

template <typename T>
size_t smem_bytes(int P, int N) {
  return std::is_same_v<T, bf16> ? MMA_SMEM : shared_floats(P, N) * sizeof(float);
}

template <typename T>
cudaError_t prepare(int P, int N) {
  cudaError_t err = repro::allow_shared(ssd_scan_kernel<T>, smem_bytes<T>(P, N));
  if (err == cudaSuccess && std::is_same_v<T, bf16>)   // room for two blocks an SM
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// A map of a bf16 tensor whose dims (innermost first) lie strides[i - 1]
// elements apart, in boxes of `box_dims` elements with the 128-byte swizzle
// (32-byte where a box row is 32 bytes);
// false where the copy engine cannot take it (a base or a stride off 16
// bytes), and the caller loads element by element.
bool make_map(CUtensorMap* map, const void* base, int rank, const long* dims,
              const long* strides, const unsigned* box_dims) {
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (!encode || (reinterpret_cast<uintptr_t>(base) & 15)) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t box[4], estride[4];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = box_dims[i];
    estride[i] = 1;
    if (i > 0) {
      if ((strides[i - 1] * 2) % 16) return false;
      gstride[i - 1] = static_cast<cuuint64_t>(strides[i - 1] * 2);
    }
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), gdim,
                gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box[0] == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           void* y, void* state, int B, int L, int H, int P, int N, long xs_b, long xs_l,
           long xs_h, long ds_b, long ds_l, long ds_h, long bs_b, long bs_l, long cs_b,
           long cs_l, void* stream) {
  if (P > MAX_P || N > MAX_N || P < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>(P, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps = {};
  int flags = 0;
  if (std::is_same_v<T, bf16> && L > 0) {
    repro::bind_context();
    // c, b: (n, l, b), a box 64 columns by the chunk's 64 rows; x: (p, h,
    // l, b), a box of one head's 64 columns by 64 rows
    const long bc_dims[3] = {N, L, B}, c_strides[2] = {cs_l, cs_b}, b_strides[2] = {bs_l, bs_b};
    const long x_dims[4] = {P, H, L, B}, x_strides[3] = {xs_h, xs_l, xs_b};
    const unsigned bc_box[3] = {64, Q, 1}, x_box[4] = {64, 1, Q, 1}, y_box[4] = {16, 1, Q, 1};
    const long y_strides[3] = {P, static_cast<long>(H) * P, static_cast<long>(L) * H * P};
    if (make_map(&maps.c, c, 3, bc_dims, c_strides, bc_box) &&
        make_map(&maps.b, b, 3, bc_dims, b_strides, bc_box))
      flags |= TMA_BC;
    if (make_map(&maps.x, x, 4, x_dims, x_strides, x_box)) flags |= TMA_X;
    if (make_map(&maps.y, y, 4, x_dims, y_strides, y_box)) flags |= TMA_Y;   // y: contiguous
  }
  ssd_scan_kernel<T><<<dim3(H, B), Shape<T>::threads, smem_bytes<T>(P, N),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, N, xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b, bs_l,
      cs_b, cs_l, flags, maps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int P, int N, int* blocks) {
  cudaError_t err = prepare<T>(P, N);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ssd_scan_kernel<T>,
                                                        Shape<T>::threads, smem_bytes<T>(P, N));
  return static_cast<int>(err);
}

// -- the backward pass ------------------------------------------------------
//
// The gradient of the scan (the JAX package has no backward kernel; jax.grad
// differentiates its XLA path): dx, ddt, da, db and dc for dy and an
// optional gradient of the final state.  `ref.ssd_chunked_backward` is the
// same algorithm in plain PyTorch, step by step.  With cs the chunk's
// inclusive cumsum of dt a, S the state entering a chunk and dS the
// gradient of the state leaving it, M_ij = (C_i.B_j) e^(cs_i - cs_j) (i >= j),
// G_ij = dy_i.x_j, W_ij = e^(cs_i - cs_j) dt_j G_ij and rem_j = e^(cs_last -
// cs_j):
//   dx_j = dt_j (sum_i M_ij dy_i + rem_j dS B_j)
//   db_j = sum_h (sum_i W_ij C_i + rem_j dt_j dS^T x_j)
//   dc_i = sum_h (sum_j W_ij B_j + e^(cs_i) S^T dy_i)
//   d(cs)_i = sum_j (C B^T o W)_ij - sum_j (C B^T o W)_ji + e^(cs_i) C_i.(S^T dy_i)
//             - dt_i rem_i x_i.(dS B_i), and at the chunk's last token also
//             e^(cs_last) <dS, S> + sum_j dt_j rem_j x_j.(dS B_j)
//   ddt_j = x_j.(sum_i M_ij dy_i) + rem_j x_j.(dS B_j) + a R_j,
//   da += sum_j dt_j R_j, with R_j = sum_{i >= j} d(cs)_i within the chunk.
// Only differences of cs are exponentiated, as in the forward.
//
// Bound on the H100: at mamba2-370m's training shape (B2 L4096 H32 P64 N128,
// bf16) the call must read x, dy, b, c, dt and write dx, db, dc, ddt: ~111 MB,
// 0.033 ms; its products, ~28 GFLOP, take 0.028 ms at the bf16 tensor-core
// rate.  Bytes bound it; the float32 states this design keeps between its
// launches add ~0.8 GB of traffic.
//
// Four launches, every product on the tensor cores in TF32 (mma.sync
// m16n8k8, float32 sums).  In the bf16 instance x, dy, b and c are exact in
// TF32 and the float32 operands (M, W, S, dS, x rem dt) round to its 10-bit
// mantissa, 2^-11 of a term, below the gradients' own bf16 rounding (2^-9).
// The float32 instance splits every operand into a TF32 hi + lo pair and
// takes three products (~2^-22 of a term), to hold its 2e-4 checks.
//  1. `ssd_bwd_deltas_kernel`: one block of 256 threads per (chunk,
//     sequence, head): each chunk's own state increment,
//     sum_j rem_j dt_j x_j B_j^T, and its own share of the state gradient,
//     sum_i e^(cs_i) dy_i C_i^T, into float32 scratch (B, H, chunks, P, N),
//     and the chunk's total cs_last.
//  2. `ssd_bwd_pass_kernel`: the states passed from chunk to chunk, S' =
//     e^(cs_last) S + increment in order and dS' = e^(cs_last) dS + share in
//     reverse, a thread an element, 16 chunks' loads in flight, in place:
//     the scratch then holds the state entering and the gradient leaving
//     every chunk.  (A block a (head, sequence) sweeping the chunks in order
//     took 0.92 ms at the training shape, waiting on each chunk's loads.)
//  3. `ssd_bwd_chunk_kernel`: one block of 512 threads per (chunk,
//     sequence), walking the heads in order.  C B^T is the same for every
//     head and is formed once; db and dc, shared by the heads, are summed
//     over them in the block's registers and written once, so no per-head
//     partial of them reaches device memory and two calls give the same
//     bits (no atomics).  The chunk's d(cs) suffix sum is one warp's
//     shuffle scan; each head's share of da goes to a (B, chunks, H) row.
//  4. `ssd_bwd_da_kernel`: da summed over those rows in a fixed order.
// In the tile kernels a warp owns 16 output rows of every product and half
// (deltas) or a quarter (chunk) of its columns; its fragments are read from float32
// shared memory element by element.  Tiles are padded 4 floats a row, so the
// 8 rows by 4 columns of a fragment load fall in 32 different banks where
// the row index is the fragment's, two-way where it is the reduction's.

constexpr int PAD = 4;

struct BwdArgs {
  const void *x, *b, *c, *dy;             // dy (B, L, H, P) contiguous
  const float *dt, *a, *d_state;          // d_state (B, H, P, N), or null for zero
  float *starts, *dstates;                // scratch (B, H, chunks, P, N)
  float *tots, *da_part;                  // scratch (B, H, chunks), (B, chunks, H)
  void *dx, *db, *dc;                     // dx (B, L, H, P), db, dc (B, L, N) contiguous
  float *ddt, *da;                        // ddt (B, L, H) contiguous, da (H,)
  int B, L, H, P, N, chunks;
  long xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b, bs_l, cs_b, cs_l;
};

// The chunk's inclusive cumsum of dt * a into cs, by one warp, two tokens a
// lane; every lane gets the chunk's total.
__device__ __forceinline__ float chunk_cumsum(const float* dts, float ah, float* cs, int lane) {
  const float v0 = dts[2 * lane] * ah, v1 = dts[2 * lane + 1] * ah;
  float run = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += u;
  }
  cs[2 * lane] = run - v1;
  cs[2 * lane + 1] = run;
  return __shfl_sync(0xffffffffu, run, 31);
}

// The 4 lanes of a quad (the tq of a fragment row) add v.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[t] += A (16 rows, K deep) x B (K deep, columns 8 t .. 8 t + 7), K a
// multiple of 8; a(r, k) and b(k, c) read the operands.  acc[t]'s element e
// is row gr + 8 (e / 2), column 8 t + 2 tq + e % 2 (gr = lane / 4, tq =
// lane % 4).  SPLIT: each operand as TF32 hi + lo, three products.
template <bool SPLIT, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a(gr, k0 + tq), a(gr + 8, k0 + tq), a(gr, k0 + tq + 4),
                         a(gr + 8, k0 + tq + 4)};
    unsigned hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = to_tf32(av[q]);
      lo[q] = SPLIT ? to_tf32(av[q] - __uint_as_float(hi[q])) : 0u;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float b0 = b(k0 + tq, 8 * t + gr), b1 = b(k0 + tq + 4, 8 * t + gr);
      const unsigned h0 = to_tf32(b0), h1 = to_tf32(b1);
      mma_tf32(acc[t], hi, h0, h1);
      if constexpr (SPLIT) {
        mma_tf32(acc[t], lo, h0, h1);
        mma_tf32(acc[t], hi, to_tf32(b0 - __uint_as_float(h0)), to_tf32(b1 - __uint_as_float(h1)));
      }
    }
  }
}

// A head's dt for chunk k (zero past L), then warp 0's cumsum and the
// chunk's e^(cs_i), rem_i and rem_i dt_i; returns the total (warp 0 only).
// Two block barriers: the caller's tiles and dt are in, and so are these.
__device__ __forceinline__ float chunk_decay(const BwdArgs& g, int b, int h, int l0, int valid,
                                             float* dts, float* cs, float* ecs, float* rem,
                                             float* sc) {
  const int tid = threadIdx.x;
  if (tid < Q) dts[tid] = tid < valid ? g.dt[b * g.ds_b + (l0 + tid) * g.ds_l + h * g.ds_h] : 0.f;
  __syncthreads();
  float tot = 0.f;
  if (tid < 32) {
    tot = chunk_cumsum(dts, g.a[h], cs, tid);
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * tid + e;
      ecs[i] = expf(cs[i]);
      rem[i] = expf(tot - cs[i]);
      sc[i] = rem[i] * dts[i];
    }
  }
  __syncthreads();
  return tot;
}

size_t deltas_shared_floats(int P, int N) {
  // Cs, Bs [Q][N+4]; Xs, Ys [Q][P+4]; dt, cs, e^cs, rem, rem dt [Q]
  return 2 * Q * (N + PAD) + 2 * Q * (P + PAD) + 5 * Q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_deltas_kernel(const BwdArgs g) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  extern __shared__ float deltas_smem[];
  const int k = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3, r0 = 16 * (warp >> 1), ch = warp & 1;
  const int P = g.P, N = g.N, ns = N + PAD, ps = P + PAD;
  const int l0 = k * Q, valid = min(Q, g.L - l0);
  float* Cs = deltas_smem;         // [Q][N+4]
  float* Bs = Cs + Q * ns;         // [Q][N+4]
  float* Xs = Bs + Q * ns;         // [Q][P+4]
  float* Ys = Xs + Q * ps;         // [Q][P+4]: dy
  float* dts = Ys + Q * ps;        // [Q] each below
  float* cs = dts + Q;
  float* ecs = cs + Q;
  float* rem = ecs + Q;
  float* sc = rem + Q;
  const long y_l = static_cast<long>(g.H) * P;
  repro::load_tile(Cs, ns, static_cast<const T*>(g.c) + b * g.cs_b + l0 * g.cs_l, g.cs_l, Q,
                   valid, N, 1.f);
  repro::load_tile(Bs, ns, static_cast<const T*>(g.b) + b * g.bs_b + l0 * g.bs_l, g.bs_l, Q,
                   valid, N, 1.f);
  repro::load_tile(Xs, ps, static_cast<const T*>(g.x) + b * g.xs_b + l0 * g.xs_l + h * g.xs_h,
                   g.xs_l, Q, valid, P, 1.f);
  repro::load_tile(Ys, ps, static_cast<const T*>(g.dy) + (static_cast<long>(b) * g.L + l0) * y_l +
                   static_cast<long>(h) * P, y_l, Q, valid, P, 1.f);
  const float tot = chunk_decay(g, b, h, l0, valid, dts, cs, ecs, rem, sc);
  const long at = (static_cast<long>(b) * g.H + h) * g.chunks + k;
  if (threadIdx.x == 0) g.tots[at] = tot;
  if (r0 >= P) return;             // rows p past P: nothing to write
  // rows p, columns n = 64 ch ..: sum_j (rem dt x)_jp B_jn and sum_i (e^cs dy)_ip C_in
  float ds[8][4] = {}, dd[8][4] = {};
  mma_rows<SPLIT>(ds, Q, [&](int r, int j) { return r0 + r < P ? Xs[j * ps + r0 + r] * sc[j] : 0.f; },
                  [&](int j, int c) { return 64 * ch + c < N ? Bs[j * ns + 64 * ch + c] : 0.f; });
  mma_rows<SPLIT>(dd, Q, [&](int r, int i) { return r0 + r < P ? Ys[i * ps + r0 + r] * ecs[i] : 0.f; },
                  [&](int i, int c) { return 64 * ch + c < N ? Cs[i * ns + 64 * ch + c] : 0.f; });
  float* s_out = g.starts + at * P * N;
  float* d_out = g.dstates + at * P * N;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + gr + 8 * (e >> 1), n = 64 * ch + 8 * t + 2 * tq + (e & 1);
      if (p < P && n < N) {
        s_out[p * N + n] = ds[t][e];
        d_out[p * N + n] = dd[t][e];
      }
    }
}

constexpr int PASS_BATCH = 16;   // chunks whose loads the pass issues before it uses any

// Each thread one element (p, n) of one (head, sequence)'s state: the
// increments become the states entering each chunk, in order, and the
// shares the gradients leaving each chunk, in reverse; a batch of chunks'
// loads in flight at a time.
__global__ void ssd_bwd_pass_kernel(const BwdArgs g) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long PN = static_cast<long>(g.P) * g.N;
  if (e >= PN) return;
  const long first = (static_cast<long>(b) * g.H + h) * g.chunks;
  float s = 0.f;
  for (int k0 = 0; k0 < g.chunks; k0 += PASS_BATCH) {
    float inc[PASS_BATCH], dec[PASS_BATCH];
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u)
      if (k0 + u < g.chunks) {
        inc[u] = g.starts[(first + k0 + u) * PN + e];
        dec[u] = expf(g.tots[first + k0 + u]);
      }
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u)
      if (k0 + u < g.chunks) {
        g.starts[(first + k0 + u) * PN + e] = s;
        s = dec[u] * s + inc[u];
      }
  }
  float d = g.d_state ? g.d_state[(static_cast<long>(b) * g.H + h) * PN + e] : 0.f;
  for (int k0 = g.chunks - 1; k0 >= 0; k0 -= PASS_BATCH) {
    float share[PASS_BATCH], dec[PASS_BATCH];
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u)
      if (k0 - u >= 0) {
        share[u] = g.dstates[(first + k0 - u) * PN + e];
        dec[u] = expf(g.tots[first + k0 - u]);
      }
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u)
      if (k0 - u >= 0) {
        g.dstates[(first + k0 - u) * PN + e] = d;
        d = dec[u] * d + share[u];
      }
  }
}

constexpr int CHUNK_THREADS = 512;   // 16 warps: a quarter of a product's columns each
constexpr int QUARTERS = 4;

size_t chunk_shared_floats(int P, int N) {
  // Cs, Bs [Q][N+4]; CB, M, W [Q][Q+4]; Xs, Ys [Q][P+4]; Ss, dSs [P][N+4];
  // dt, cs, e^cs, rem, rem dt, row and column sums [Q]; a1, a2 and y's
  // inter term, a column quarter's share each [4][Q]; a float a warp
  return 2 * Q * (N + PAD) + 3 * Q * (Q + PAD) + 2 * Q * (P + PAD) + 2 * P * (N + PAD) +
         7 * Q + 3 * QUARTERS * Q + CHUNK_THREADS / 32;
}

template <typename T>
__global__ void __launch_bounds__(CHUNK_THREADS, 1) ssd_bwd_chunk_kernel(const BwdArgs g) {
  constexpr bool SPLIT = std::is_same_v<T, float>;
  extern __shared__ float chunk_smem[];
  const int k = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp >> 2), cq = warp & 3;   // this warp's rows, column quarter
  const int P = g.P, N = g.N, ns = N + PAD, ps = P + PAD, qs = Q + PAD;
  const int KP = (P + 7) & ~7, KN = (N + 7) & ~7;   // P and N in whole k-steps of 8
  const int l0 = k * Q, valid = min(Q, g.L - l0);
  float* Cs = chunk_smem;          // [Q][N+4]
  float* Bs = Cs + Q * ns;         // [Q][N+4]
  float* CB = Bs + Q * ns;         // [Q][Q+4]: C B^T
  float* Mt = CB + Q * qs;         // [Q][Q+4]: M = C B^T o decay, lower triangle
  float* Wt = Mt + Q * qs;         // [Q][Q+4]: W = decay o dt_j o G, lower triangle
  float* Xs = Wt + Q * qs;         // [Q][P+4]
  float* Ys = Xs + Q * ps;         // [Q][P+4]: dy
  float* Ss = Ys + Q * ps;         // [P][N+4]: S entering the chunk
  float* dSs = Ss + P * ns;        // [P][N+4]: dS leaving it
  float* dts = dSs + P * ns;       // [Q] each below
  float* cs = dts + Q;
  float* ecs = cs + Q;             // e^(cs_i)
  float* rem = ecs + Q;            // e^(cs_last - cs_j)
  float* sc = rem + Q;             // rem_j dt_j
  float* rT = sc + Q;              // row sums of C B^T o W
  float* cT = rT + Q;              // column sums
  float* a1p = cT + Q;             // [4][Q]: x_j.(M^T dy)_j, a column quarter's share each
  float* a2p = a1p + QUARTERS * Q; // [4][Q]: x_j.(dS B_j)
  float* yp = a2p + QUARTERS * Q;  // [4][Q]: e^(cs_i) C_i.(S^T dy_i)
  float* red = yp + QUARTERS * Q;  // a float a warp: <dS, S>

  repro::load_tile(Cs, ns, static_cast<const T*>(g.c) + b * g.cs_b + l0 * g.cs_l, g.cs_l, Q,
                   valid, N, 1.f);
  repro::load_tile(Bs, ns, static_cast<const T*>(g.b) + b * g.bs_b + l0 * g.bs_l, g.bs_l, Q,
                   valid, N, 1.f);
  __syncthreads();
  {  // C B^T, the same for every head: rows r0 .., columns 16 cq ..
    float acc[2][4] = {};
    mma_rows<SPLIT>(acc, KN, [&](int r, int kk) { return kk < N ? Cs[(r0 + r) * ns + kk] : 0.f; },
                    [&](int kk, int c) { return kk < N ? Bs[(16 * cq + c) * ns + kk] : 0.f; });
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        CB[(r0 + gr + 8 * (e >> 1)) * qs + 16 * cq + 8 * t + 2 * tq + (e & 1)] = acc[t][e];
  }

  // db rows r0 .. (tokens), columns 32 cq ..; dc the same: summed over the heads
  float dB[4][4] = {}, dC[4][4] = {};
  const long y_l = static_cast<long>(g.H) * P;    // dy and dx are contiguous
  for (int h = 0; h < g.H; ++h) {
    __syncthreads();               // the last head is done with the tiles; C B^T is whole
    const long slot = ((static_cast<long>(b) * g.H + h) * g.chunks + k) * P * N;
    repro::load_tile(Xs, ps, static_cast<const T*>(g.x) + b * g.xs_b + l0 * g.xs_l + h * g.xs_h,
                     g.xs_l, Q, valid, P, 1.f);
    repro::load_tile(Ys, ps, static_cast<const T*>(g.dy) + (static_cast<long>(b) * g.L + l0) *
                     y_l + static_cast<long>(h) * P, y_l, Q, valid, P, 1.f);
    repro::load_tile(Ss, ns, g.starts + slot, N, P, P, N, 1.f);
    repro::load_tile(dSs, ns, g.dstates + slot, N, P, P, N, 1.f);
    const float tot = chunk_decay(g, b, h, l0, valid, dts, cs, ecs, rem, sc);   // warp 0's

    // 1. G = dy x^T (rows i, columns j); W = decay o dt_j o G and M = C B^T
    //    o decay on and below the diagonal (zero above it)
    {
      float acc[2][4] = {};
      mma_rows<SPLIT>(acc, KP, [&](int r, int kk) { return kk < P ? Ys[(r0 + r) * ps + kk] : 0.f; },
                      [&](int kk, int c) { return kk < P ? Xs[(16 * cq + c) * ps + kk] : 0.f; });
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + gr + 8 * (e >> 1), j = 16 * cq + 8 * t + 2 * tq + (e & 1);
          const float dec = j <= i ? expf(fminf(cs[i] - cs[j], 0.f)) : 0.f;
          Wt[i * qs + j] = dec * dts[j] * acc[t][e];
          Mt[i * qs + j] = CB[i * qs + j] * dec;
        }
    }
    __syncthreads();

    // 2. the row and column sums of C B^T o W: d(cs) from the chunk's own exponents
    if (tid < Q) {
      float t = 0.f;
      for (int j = 0; j < Q; ++j) t += CB[tid * qs + j] * Wt[tid * qs + j];
      rT[tid] = t;
    } else if (tid < 2 * Q) {
      const int j = tid - Q;
      float t = 0.f;
      for (int i = 0; i < Q; ++i) t += CB[i * qs + j] * Wt[i * qs + j];
      cT[j] = t;
    }

    // 3. dx = dt o (M^T dy + rem o dS B), rows j, columns p = 16 cq ..; and
    //    a token's x.(M^T dy) and x.(dS B), this column quarter's share
    {
      float in[2][4] = {}, ex[2][4] = {};
      mma_rows<SPLIT>(in, Q, [&](int r, int kk) { return Mt[kk * qs + r0 + r]; },
                      [&](int kk, int c) { return 16 * cq + c < P ? Ys[kk * ps + 16 * cq + c] : 0.f; });
      mma_rows<SPLIT>(ex, KN, [&](int r, int kk) { return kk < N ? Bs[(r0 + r) * ns + kk] : 0.f; },
                      [&](int kk, int c) {
                        return kk < N && 16 * cq + c < P ? dSs[(16 * cq + c) * ns + kk] : 0.f;
                      });
      float s1[2] = {}, s2[2] = {};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + gr + 8 * (e >> 1), p = 16 * cq + 8 * t + 2 * tq + (e & 1);
          if (p < P) {
            const float xv = Xs[j * ps + p];
            s1[e >> 1] += xv * in[t][e];
            s2[e >> 1] += xv * ex[t][e];
            if (j < valid)
              static_cast<T*>(g.dx)[(static_cast<long>(b) * g.L + l0 + j) * y_l +
                                    static_cast<long>(h) * P + p] =
                  from_float<T>(dts[j] * (in[t][e] + rem[j] * ex[t][e]));
          }
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v1 = quad_sum(s1[u]), v2 = quad_sum(s2[u]);
        if (tq == 0) {
          a1p[cq * Q + r0 + gr + 8 * u] = v1;
          a2p[cq * Q + r0 + gr + 8 * u] = v2;
        }
      }
    }

    // 4. db += W^T C + (rem dt o x) dS, rows j, columns n = 32 cq ..
    mma_rows<SPLIT>(dB, Q, [&](int r, int kk) { return Wt[kk * qs + r0 + r]; },
                    [&](int kk, int c) { return 32 * cq + c < N ? Cs[kk * ns + 32 * cq + c] : 0.f; });
    mma_rows<SPLIT>(dB, KP,
                    [&](int r, int kk) { return kk < P ? Xs[(r0 + r) * ps + kk] * sc[r0 + r] : 0.f; },
                    [&](int kk, int c) {
                      return kk < P && 32 * cq + c < N ? dSs[kk * ns + 32 * cq + c] : 0.f;
                    });

    // 5. dc += e^cs o (dy S) + W B, rows i, columns n = 32 cq ..; and y's
    //    inter term, this column quarter's share
    {
      float t4[4][4] = {};
      mma_rows<SPLIT>(t4, KP, [&](int r, int kk) { return kk < P ? Ys[(r0 + r) * ps + kk] : 0.f; },
                      [&](int kk, int c) {
                        return kk < P && 32 * cq + c < N ? Ss[kk * ns + 32 * cq + c] : 0.f;
                      });
      float u[2] = {};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + gr + 8 * (e >> 1), n = 32 * cq + 8 * t + 2 * tq + (e & 1);
          if (n < N) u[e >> 1] += Cs[i * ns + n] * t4[t][e];
          dC[t][e] += ecs[i] * t4[t][e];
        }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float w = quad_sum(u[v]);
        if (tq == 0) yp[cq * Q + r0 + gr + 8 * v] = ecs[r0 + gr + 8 * v] * w;
      }
    }
    mma_rows<SPLIT>(dC, Q, [&](int r, int kk) { return Wt[(r0 + r) * qs + kk]; },
                    [&](int kk, int c) { return 32 * cq + c < N ? Bs[kk * ns + 32 * cq + c] : 0.f; });

    // 6. <dS, S>, a warp's share each
    {
      float v = 0.f;
      for (int idx = tid; idx < P * N; idx += CHUNK_THREADS) {
        const int p = idx / N, n = idx - p * N;
        v += dSs[p * ns + n] * Ss[p * ns + n];
      }
      v = repro::warp_sum(v);
      if (lane == 0) red[warp] = v;
    }
    __syncthreads();

    // 7. d(cs), its suffix sum R within the chunk, ddt and this head's da
    if (warp == 0) {
      float dot = 0.f;
      for (int w = 0; w < CHUNK_THREADS / 32; ++w) dot += red[w];
      float a1[2] = {}, a2[2] = {}, yi[2] = {}, u[2], dcs[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e;
        for (int q = 0; q < QUARTERS; ++q) {   // the column quarters' shares, in order
          a1[e] += a1p[q * Q + i];
          a2[e] += a2p[q * Q + i];
          yi[e] += yp[q * Q + i];
        }
        u[e] = sc[i] * a2[e];
        dcs[e] = rT[i] - cT[i] + yi[e] - u[e];
      }
      const float usum = repro::warp_sum(u[0] + u[1]);
      if (lane == 31) dcs[1] += expf(tot) * dot + usum;   // the chunk's last token
      float run = dcs[0] + dcs[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, run, o);
        if (lane + o < 32) run += v;
      }
      const float R[2] = {run, run - dcs[0]};
      const float ah = g.a[h];
      float da = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e;
        if (i < valid)
          g.ddt[(static_cast<long>(b) * g.L + l0 + i) * g.H + h] = a1[e] + rem[i] * a2[e] + ah * R[e];
        da += dts[i] * R[e];
      }
      da = repro::warp_sum(da);
      if (lane == 0) g.da_part[(static_cast<long>(b) * g.chunks + k) * g.H + h] = da;
    }
  }

#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = r0 + gr + 8 * (e >> 1), n = 32 * cq + 8 * t + 2 * tq + (e & 1);
      if (j < valid && n < N) {
        const long at = (static_cast<long>(b) * g.L + l0 + j) * N + n;
        static_cast<T*>(g.db)[at] = from_float<T>(dB[t][e]);
        static_cast<T*>(g.dc)[at] = from_float<T>(dC[t][e]);
      }
    }
}

// da = the rows of da_part summed in order
__global__ void ssd_bwd_da_kernel(const float* __restrict__ part, float* __restrict__ da,
                                  int parts, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < parts; ++i) s += part[static_cast<long>(i) * H + h];
    da[h] = s;
  }
}

template <typename T>
int launch_bwd(const BwdArgs& g, void* stream) {
  if (g.P > MAX_P || g.N > MAX_N || g.P < 1 || g.N < 1 || g.L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t deltas = deltas_shared_floats(g.P, g.N) * sizeof(float);
  const size_t chunk = chunk_shared_floats(g.P, g.N) * sizeof(float);
  cudaError_t err = repro::allow_shared(ssd_bwd_deltas_kernel<T>, deltas);
  if (err == cudaSuccess) err = repro::allow_shared(ssd_bwd_chunk_kernel<T>, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_deltas_kernel<T><<<dim3(g.chunks, g.B, g.H), THREADS, deltas, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_pass_kernel<<<dim3((g.P * g.N + 255) / 256, g.H, g.B), 256, 0, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<T><<<dim3(g.chunks, g.B), CHUNK_THREADS, chunk, s>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_da_kernel<<<1, 256, 0, s>>>(g.da_part, g.da, g.B * g.chunks, g.H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SSD_ENTRY(NAME, T)                                                                    \
  extern "C" int NAME(const void* x, const void* dt, const void* a, const void* b,            \
                      const void* c, void* y, void* state, int B, int L, int H, int P, int N, \
                      long xs_b, long xs_l, long xs_h, long ds_b, long ds_l, long ds_h,       \
                      long bs_b, long bs_l, long cs_b, long cs_l, void* stream) {             \
    return launch<T>(x, dt, a, b, c, y, state, B, L, H, P, N, xs_b, xs_l, xs_h, ds_b, ds_l,   \
                     ds_h, bs_b, bs_l, cs_b, cs_l, stream);                                   \
  }                                                                                           \
  extern "C" int NAME##_blocks_per_sm(int P, int N, int* blocks) {                            \
    return occupancy<T>(P, N, blocks);                                                        \
  }

SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
SSD_ENTRY(ssd_scan_f32, float)

// starts, dstates: float32 scratch (B, H, chunks, P, N); tots (B, H, chunks)
// and da_part (B, chunks, H) float32 scratch; dy contiguous; d_state null for
// a zero gradient of the final state
#define SSD_BWD_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const void* x, const void* dt, const void* a, const void* b,            \
                      const void* c, const void* dy, const void* d_state, void* starts,       \
                      void* dstates, void* tots, void* da_part, void* dx, void* ddt,          \
                      void* da, void* db, void* dc, int B, int L, int H, int P, int N,        \
                      long xs_b, long xs_l, long xs_h, long ds_b, long ds_l, long ds_h,       \
                      long bs_b, long bs_l, long cs_b, long cs_l, void* stream) {             \
    const BwdArgs g{x, b, c, dy, static_cast<const float*>(dt), static_cast<const float*>(a), \
                    static_cast<const float*>(d_state), static_cast<float*>(starts),          \
                    static_cast<float*>(dstates), static_cast<float*>(tots),                  \
                    static_cast<float*>(da_part), dx, db, dc, static_cast<float*>(ddt),       \
                    static_cast<float*>(da), B, L, H, P, N, (L + Q - 1) / Q, xs_b, xs_l,      \
                    xs_h, ds_b, ds_l, ds_h, bs_b, bs_l, cs_b, cs_l};                          \
    return launch_bwd<T>(g, stream);                                                          \
  }

SSD_BWD_ENTRY(ssd_scan_bwd_bf16, __nv_bfloat16)
SSD_BWD_ENTRY(ssd_scan_bwd_f32, float)
