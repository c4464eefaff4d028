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
  for (int idx = threadIdx.x; idx < Q * width; idx += blockDim.x) {
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
// rate.  Bytes bound it.  This design's own floor is its float32 states:
// each chunk's S and dS (B H chunks 64 x 128 floats each, 268 MB) written
// once and read once, 0.54 GB, 0.16 ms at 3.35 TB/s.
//
// Three launches:
//  1. `ssd_bwd_states_kernel`: S entering and dS leaving every chunk.  Two
//     blocks of 8 warps a chain (S of a (sequence, head) in chunk order, dS
//     in reverse), each 64 of the state's 128 columns: 4 B H blocks, two an
//     SM.  The state stays float32 in the blocks' registers from the first
//     chunk to the last (a bf16 rounding of S breaks the forward's y,
//     above); each chunk adds its own increment (sum_j rem_j dt_j x_j B_j^T)
//     or state-gradient share (sum_i e^(cs_i) dy_i C_i^T) to the decayed
//     state, so the increments never reach device memory, and each chunk's
//     slot is written once.  The chunk's x (or dy) and the block's half of b
//     (or c) come by tensor copies into a ring of three stages, two chunks
//     ahead; the product is the forward's state update (x^T by
//     ldmatrix.trans, scaled a token each, split hi + lo).  The recurrence
//     runs in chunk order, so two calls give the same bits.  In bf16 a slot
//     holds the state split as the chunk kernel's products take it, hi + lo
//     bf16 (~2^-17 of it), laid out as its shared memory wants it: two
//     tiles of two boxes of 64 columns by 64 rows in the 128-byte swizzle
//     (`split_at`), 32 KB that one bulk copy brings and `ldmatrix` reads
//     without bank conflicts.  Each block builds its half of a slot in
//     shared memory and the copy engine stores it whole, one while the next
//     is built.  The float32 instance writes float32 rows (`slab_at`).
//     Measured at the training shape (`probes.train_bwd`): a decoupled
//     look-back across blocks, a block a chunk waiting on its predecessor's
//     flag, took 0.354 ms (64 steps of ~5.5 us); slots written from the
//     lanes' registers, 0.306-0.383 ms (32-byte sectors written in part, or
//     in two halves); one block a chain, the same time as two.
//  2. `ssd_bwd_chunk_mma_kernel` (bf16): a block of 16 warps per (chunk,
//     sequence), walking the heads in order with db (warps 0-7) and dc
//     (warps 8-15) summed in registers, so no per-head partial reaches
//     device memory and there are no atomics.  (The heads split over the
//     blocks of a thread block cluster, summed through distributed shared
//     memory, took as long or longer at the training shape, whose 128
//     blocks nearly fill the 132 SMs.)  C, B (once), x and dy stay
//     bf16 in shared memory (tensor copies in the 128-byte swizzle,
//     `ldmatrix`), x and dy in two stages, head u + 2's loading while heads
//     u and u + 1 compute; S and dS come by bulk copies into one stage,
//     refilled with head u + 1's once head u's last product that reads them
//     is done, and first read after head u + 1's G, W and M.  Every product is
//     `mma.sync.m16n8k16` in bf16 with float32 sums: C B^T and G = dy x^T
//     take their exact bf16 operands as they are; a float32 operand (M, W,
//     S, dS) is split as hi + lo bf16 and multiplied twice (~2^-17 of a
//     term, finer than TF32's 2^-11), through bf16 hi and lo tiles in shared
//     memory that every product reads by `ldmatrix`: M and W from the
//     warps' registers, S and dS as the states pass wrote them.  (Each warp
//     splitting its own fragments from float32 took the kernel 0.32 ms;
//     all the threads splitting a head's S and dS once, 0.34.)
//     The per-token scales (dt, rem dt, e^cs) multiply rows or columns of
//     results, so x, dy, b and c are never rounded.  Shared memory: C and
//     B (32 KB), two stages of x and dy (32 KB), one of S and dS (64 KB), M
//     and W hi + lo (32 KB), the per-token partial sums twice (12 KB); dx
//     goes out through M's hi tile by one tensor store.  One block of 16
//     warps an SM (128 registers a thread).  The float32 instance (`ssd_bwd_chunk_kernel<float>`,
//     tests and the float32 A/B) keeps the first version's body: a block
//     per (chunk, sequence), the heads in order, TF32 hi + lo products
//     (three each) from float32 shared memory.
//  3. `ssd_bwd_da_kernel`: da summed over the (B, chunks, H) rows of the
//     chunk kernel's shares in a fixed order.

constexpr int PAD = 4;
constexpr int SLAB = MAX_P * MAX_N;          // floats of a state slot
constexpr int SLAB_BYTES = SLAB * 4;
constexpr int STATES_PASS = 1, CHUNK_PASS = 2, DA_PASS = 4;
constexpr int BT_X = 1, BT_BC = 2, BT_DY = 4, BT_DX = 8;   // which tensors go by tensor copies

// Float offset of state element (p, n) in a float32 slot: rows of 128
// floats (512 bytes: a quad of lanes writes one whole 32-byte sector).
__device__ __forceinline__ int slab_at(int p, int n) { return p * MAX_N + n; }

// Element offset of state element (p, n) in a bf16 slot's hi tile (its lo
// tile follows, 2 BOX elements on): two boxes of 64 columns by 64 rows in the
// 128-byte swizzle, as the chunk kernel's ldmatrix reads them.
__device__ __forceinline__ int split_at(int p, int n) { return sw_at(p, n >> 3) + (n & 7); }

struct BwdArgs {
  const void *x, *b, *c, *dy;             // dy (B, L, H, P) contiguous
  const float *dt, *a, *d_state;          // d_state (B, H, P, N), or null for zero
  float *starts, *dstates;                // scratch (B, H, chunks) slots of SLAB floats
  float* da_part;                         // scratch (B, chunks, H)
  void *dx, *db, *dc;                     // dx (B, L, H, P), db, dc (B, L, N) contiguous
  float *ddt, *da;                        // ddt (B, L, H) contiguous, da (H,)
  int B, L, H, P, N, chunks;
  long xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b, bs_l, cs_b, cs_l;
};

// The tensor maps of x, dy, b, c and dx (bf16), where the host could make them.
struct BwdMaps {
  CUtensorMap x, dy, b, c, dx;
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

// The 8 lanes of a fragment column (the gr of a tq) add v.
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
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
// lane % 4).  Each operand as TF32 hi + lo, three products: the float32
// instance's precision.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a(gr, k0 + tq), a(gr + 8, k0 + tq), a(gr, k0 + tq + 4),
                         a(gr + 8, k0 + tq + 4)};
    unsigned hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = to_tf32(av[q]);
      lo[q] = to_tf32(av[q] - __uint_as_float(hi[q]));
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float b0 = b(k0 + tq, 8 * t + gr), b1 = b(k0 + tq + 4, 8 * t + gr);
      const unsigned h0 = to_tf32(b0), h1 = to_tf32(b1);
      mma_tf32(acc[t], hi, h0, h1);
      mma_tf32(acc[t], lo, h0, h1);
      mma_tf32(acc[t], hi, to_tf32(b0 - __uint_as_float(h0)), to_tf32(b1 - __uint_as_float(h1)));
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

// -- 1. the states: two blocks a chain, the state in registers -------------

constexpr int ST_THREADS = 256;   // 8 warps: rows p 16 (w % 4) .., columns n 32 (w / 4) .. of a half
constexpr int ST_STAGES = 3;      // chunks whose tiles are in flight or resident
// bf16: a ring of stages, each the block's half of the N-wide tile (b or c,
// a box) and the P-wide one (x or dy, a box); then two shared slots (the
// block's half of S or dS split: a hi box, a lo box), stored by the copy
// engine one while the other is filled; an mbarrier a stage
constexpr int ST_STAGE_BYTES = 2 * BOX_BYTES;
constexpr int ST_OUT = ST_STAGES * ST_STAGE_BYTES;
constexpr int ST_BAR = ST_OUT + 2 * 2 * BOX_BYTES;
constexpr size_t ST_SMEM_BF16 = ST_BAR + ST_STAGES * 8 + 1024;

template <typename T>
size_t states_smem(int P, int N) {
  // float32: the tiles as floats [Q][N+4], [Q][P+4], then dt, cs, e^cs, rem, rem dt [Q]
  return std::is_same_v<T, bf16> ? ST_SMEM_BF16
                                 : (Q * (N + PAD) + Q * (P + PAD) + 5 * Q) * sizeof(float);
}

// Columns [64 half, 64 half + 64) of chain `blockIdx.x / 2` (S of (sequence,
// head) c, or dS of c - B H), half = blockIdx.x % 2, over its chunks in
// order (S) or in reverse (dS): writes each chunk's slot, then adds the
// chunk's own increment (share) to the decayed state.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS, 2) ssd_bwd_states_kernel(const BwdArgs g,
                                                                       const __grid_constant__ BwdMaps maps,
                                                                       int flags) {
  constexpr bool MMA = std::is_same_v<T, bf16>;
  extern __shared__ __align__(1024) unsigned char st_raw[];
  unsigned char* smem = st_raw + (MMA ? (1024 - (repro::smem_addr(st_raw) & 1023)) & 1023 : 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int BH = g.B * g.H, P = g.P, N = g.N, chunks = g.chunks, last = chunks - 1;
  const int chain = blockIdx.x >> 1, half = blockIdx.x & 1;
  const bool grad = chain >= BH;
  const int bh = grad ? chain - BH : chain, b = bh / g.H, h = bh - b * g.H;
  float* slots = (grad ? g.dstates : g.starts) + static_cast<long>(bh) * chunks * SLAB;
  const int r0 = 16 * (warp & 3), cb = 32 * (warp >> 2), c0 = 64 * half + cb;
  // this thread's elements: tile t's half v at (r0 + gr + 8 v, c0 + 8 t + 2 tq (+1));
  // in bf16 their places in the shared slot's hi box (the lo box follows)
  int at[4][2];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int p = r0 + gr + 8 * v;
      at[t][v] = MMA ? split_at(p, cb + 8 * t + 2 * tq) : slab_at(p, c0 + 8 * t + 2 * tq);
    }
  float s[4][4];                             // S entering the chunk (0), dS leaving it (d_state)
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = r0 + gr + 8 * (e >> 1), n = c0 + 8 * t + 2 * tq + (e & 1);
      s[t][e] = grad && g.d_state && p < P && n < N
                    ? g.d_state[(static_cast<long>(bh) * P + p) * N + n] : 0.f;
    }
  const float ah = g.a[h];
  const long y_l = static_cast<long>(g.H) * P;
  auto chunk_of = [&](int i) { return grad ? last - i : i; };   // the chain's i-th chunk
  // a chunk's b (or c) rows and x (or dy) rows
  auto wide_at = [&](int k) {
    return static_cast<const T*>(grad ? g.c : g.b) + b * (grad ? g.cs_b : g.bs_b) +
           static_cast<long>(k) * Q * (grad ? g.cs_l : g.bs_l);
  };
  auto narrow_at = [&](int k) {
    return grad ? static_cast<const T*>(g.dy) + (static_cast<long>(b) * g.L + k * Q) * y_l +
                      static_cast<long>(h) * P
                : static_cast<const T*>(g.x) + b * g.xs_b + static_cast<long>(k) * Q * g.xs_l +
                      h * g.xs_h;
  };
  const long wide_l = grad ? g.cs_l : g.bs_l, narrow_l = grad ? y_l : g.xs_l;
  // the state into chunk k's slot: float32 rows straight to device memory;
  // in bf16, split into the block's hi and lo boxes (`split_at`) of shared
  // slot `out` (0 or 1), which the caller stores by the copy engine after a
  // barrier (`send`)
  auto store_slot = [&](int k, int out) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if constexpr (MMA) {
          unsigned hi, lo;
          split_bf16(s[t][2 * v], s[t][2 * v + 1], hi, lo);
          bf16* box = reinterpret_cast<bf16*>(smem + ST_OUT + out * 2 * BOX_BYTES);
          *reinterpret_cast<unsigned*>(box + at[t][v]) = hi;
          *reinterpret_cast<unsigned*>(box + BOX + at[t][v]) = lo;
        } else {
          *reinterpret_cast<float2*>(slots + static_cast<long>(k) * SLAB + at[t][v]) =
              make_float2(s[t][2 * v], s[t][2 * v + 1]);
        }
      }
    if constexpr (MMA) repro::fence_proxy_async();   // before the copy engine reads the slot
  };
  auto send = [&](int k, int out) {          // thread 0: the block's boxes of chunk k's slot
    bf16* slot = reinterpret_cast<bf16*>(slots + static_cast<long>(k) * SLAB);
    const unsigned char* box = smem + ST_OUT + out * 2 * BOX_BYTES;
    repro::bulk_store(slot + half * BOX, box, BOX_BYTES);
    repro::bulk_store(slot + 2 * BOX + half * BOX, box + BOX_BYTES, BOX_BYTES);
  };

  if constexpr (MMA) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + ST_BAR);
    const bool tma_w = flags & BT_BC, tma_n = flags & (grad ? BT_DY : BT_X);
    const bool wide_in = 64 * half < N;       // the half holds columns of b (c)
    if (tid == 0) {
      for (int i = 0; i < ST_STAGES; ++i) repro::mbar_init(&bar[i], 1);
      repro::mbar_fence_init();
    }
    if (!wide_in) {                           // a box no copy writes stays zero
      for (int st = 0; st < ST_STAGES; ++st)
        for (int i = tid; i < BOX_BYTES / 16; i += ST_THREADS)
          reinterpret_cast<uint4*>(smem + st * ST_STAGE_BYTES)[i] = make_uint4(0, 0, 0, 0);
      repro::fence_proxy_async();
    }
    __syncthreads();
    // chunk i of the chain into stage i % ST_STAGES: tensor copies by thread
    // 0, or element loads by every thread
    auto issue = [&](int i) {
      const int k = chunk_of(i), st = i % ST_STAGES, l0 = k * Q, valid = min(Q, g.L - l0);
      bf16* Ws = reinterpret_cast<bf16*>(smem + st * ST_STAGE_BYTES);
      bf16* Ns = Ws + BOX;
      const bool w_tma = tma_w && wide_in;
      if (tid == 0) {
        repro::mbar_arrive_expect_tx(&bar[st], (w_tma ? BOX_BYTES : 0) + (tma_n ? BOX_BYTES : 0));
        if (w_tma)
          repro::tensor_load_3d(Ws, grad ? &maps.c : &maps.b, 64 * half, l0, b, &bar[st]);
        if (tma_n) repro::tensor_load_4d(Ns, grad ? &maps.dy : &maps.x, 0, h, l0, b, &bar[st]);
      }
      if (!tma_w && wide_in)
        copy_rows(Ws, wide_at(k) + 64 * half, wide_l, valid, min(64, N - 64 * half), 64);
      if (!tma_n) copy_rows(Ns, narrow_at(k), narrow_l, valid, P, MAX_P);
    };
    for (int i = 0; i < ST_STAGES - 1 && i < last; ++i) issue(i);
    // dt of the chain's chunk i, tokens 2 lane and 2 lane + 1 (zero past L)
    auto load_dt = [&](int i, float& d0, float& d1) {
      const int k = chunk_of(i), t0 = k * Q + 2 * lane;
      const float* d = g.dt + b * g.ds_b + h * g.ds_h;
      d0 = t0 < g.L ? d[static_cast<long>(t0) * g.ds_l] : 0.f;
      d1 = t0 + 1 < g.L ? d[static_cast<long>(t0 + 1) * g.ds_l] : 0.f;
    };
    float nd0 = 0.f, nd1 = 0.f;
    if (last > 0) load_dt(0, nd0, nd1);
    for (int i = 0; i < chunks; ++i) {
      const int k = chunk_of(i);
      if (tid == 0) repro::bulk_wait_read();  // shared slot i % 2's last stores have read it
      __syncthreads();                        // element loads are in; stage (i - 1) % 3 is
                                              // free; shared slot (i - 1) % 2 is whole
      if (tid == 0 && i > 0) send(chunk_of(i - 1), (i - 1) & 1);
      store_slot(k, i & 1);
      if (i == last) break;                   // no next slot
      if (i + ST_STAGES - 1 < last) issue(i + ST_STAGES - 1);
      const float d0 = nd0, d1 = nd1;
      if (i + 1 < last) load_dt(i + 1, nd0, nd1);
      // the chunk's cumsum of dt a (each warp its own), then the per-token scale
      const float v1 = d1 * ah;
      float run = d0 * ah + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float w = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += w;
      }
      const float cs1 = run, cs0 = run - v1, tot = __shfl_sync(0xffffffffu, run, 31);
      const float f0 = grad ? expf(cs0) : expf(tot - cs0) * d0;   // e^cs (dS) or rem dt (S)
      const float f1 = grad ? expf(cs1) : expf(tot - cs1) * d1;
      const int st = i % ST_STAGES;
      const bf16* Ws = reinterpret_cast<const bf16*>(smem + st * ST_STAGE_BYTES);
      const bf16* Ns = Ws + BOX;
      repro::mbar_wait_or_trap(&bar[st], (i / ST_STAGES) & 1);
      // s = e^(cs_last) s + (scale o narrow)^T wide: narrow^T's A fragments
      // by ldmatrix.trans, scaled a token each, split hi + lo
      const float dec = expf(tot);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] *= dec;
      __syncwarp();                          // one warp again before ldmatrix, mma.sync
#pragma unroll
      for (int J = 0; J < QT; ++J) {
        unsigned xa[4];
        repro::ldmatrix_x4_trans(xa, Ns + sw_at(J * 16 + (lane & 7) + (lane >> 4) * 8,
                                                2 * (warp & 3) + ((lane >> 3) & 1)));
        // tokens 16 J + 2 tq (+1) and those + 8
        const int src = 8 * J + tq;
        const float g0 = __shfl_sync(0xffffffffu, f0, src), g1 = __shfl_sync(0xffffffffu, f1, src);
        const float g2 = __shfl_sync(0xffffffffu, f0, src + 4);
        const float g3 = __shfl_sync(0xffffffffu, f1, src + 4);
        unsigned hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[q]));
          split_bf16(v.x * (q < 2 ? g0 : g2), v.y * (q < 2 ? g1 : g3), hi[q], lo[q]);
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          unsigned fb[4];
          repro::ldmatrix_x4_trans(fb, Ws + sw_at(J * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                  cb / 8 + nb * 2 + (lane >> 4)));
          repro::mma_bf16(s[2 * nb], hi, fb[0], fb[1]);
          repro::mma_bf16(s[2 * nb + 1], hi, fb[2], fb[3]);
          repro::mma_bf16(s[2 * nb], lo, fb[0], fb[1]);
          repro::mma_bf16(s[2 * nb + 1], lo, fb[2], fb[3]);
        }
      }
    }
    __syncthreads();                          // the last shared slot is whole
    if (tid == 0) {
      send(chunk_of(last), last & 1);
      repro::bulk_wait();                     // every slot is stored
    }
  } else {
    float* Ws = reinterpret_cast<float*>(smem);   // [Q][N+4]
    float* Ns = Ws + Q * (N + PAD);               // [Q][P+4]
    float* dts = Ns + Q * (P + PAD);              // [Q] each below
    float *cs = dts + Q, *ecs = cs + Q, *rem = ecs + Q, *sc = rem + Q;
    const float* scale = grad ? ecs : sc;
    const int ns = N + PAD, ps = P + PAD;
    for (int i = 0; i < chunks; ++i) {
      const int k = chunk_of(i), l0 = k * Q, valid = min(Q, g.L - l0);
      store_slot(k, 0);
      if (i == last) break;
      __syncthreads();                        // the last chunk is done with the tiles
      repro::load_tile(Ws, ns, wide_at(k), wide_l, Q, valid, N, 1.f);
      repro::load_tile(Ns, ps, narrow_at(k), narrow_l, Q, valid, P, 1.f);
      chunk_decay(g, b, h, l0, valid, dts, cs, ecs, rem, sc);
      const float dec = expf(cs[Q - 1]);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] *= dec;
      mma_rows(s, Q, [&](int r, int j) { return r0 + r < P ? Ns[j * ps + r0 + r] * scale[j] : 0.f; },
               [&](int j, int c) { return c0 + c < N ? Ws[j * ns + c0 + c] : 0.f; });
    }
  }
}

// -- 2. the chunks: bf16 on the tensor cores ---------------------------------

constexpr int CK_WARPS = 16, CK_THREADS = CK_WARPS * 32;
constexpr int SPLIT_VEC = 2 * BOX * 2 / 16 / CK_THREADS;   // 16-byte pieces of a hi tile a thread reads
// shared memory, bytes from a 1024-byte aligned base: c, b (two boxes
// each), two stages of x and dy (a box each), one of S and dS slots, M hi,
// M lo, W hi, W lo (a box each), the per-token partial sums twice (by head
// parity), the mbarriers (c and b; the two x and dy stages; S and dS)
constexpr int CK_C = 0, CK_B = 2 * BOX_BYTES, CK_XY = 4 * BOX_BYTES;
constexpr int CK_ST = CK_XY + 4 * BOX_BYTES;
constexpr int CK_MW = CK_ST + 2 * SLAB_BYTES;
constexpr int CK_PART = CK_MW + 4 * BOX_BYTES;
// a set of partials: row sums of C B^T o W [4 column tiles][Q], its column
// sums [4 row tiles][Q], C_i.(S^T dy_i) [8 row tiles of n][Q], x.(M^T dy)
// and x.(dS B) [4 row tiles][Q] each, <dS, S> [16 warps]
constexpr int PT_RT = 0, PT_CT = 4 * Q, PT_YI = 8 * Q, PT_A1 = 16 * Q, PT_A2 = 20 * Q,
              PT_DOT = 24 * Q, PT_FLOATS = 24 * Q + CK_WARPS;
constexpr int CK_BAR = CK_PART + 2 * PT_FLOATS * 4;
constexpr size_t CK_SMEM = CK_BAR + 4 * 8 + 1024;
// at the end, over the x, dy and S, dS stages: the block's db^T and dc^T as
// [Q][MAX_N + 4] floats
constexpr int RED_STRIDE = MAX_N + 4;
static_assert(2 * Q * RED_STRIDE * 4 <= CK_MW - CK_XY, "the partials fit the stages");
static_assert(CK_SMEM <= 232448, "the chunk kernel's shared memory");

// Token i's value of a per-token quantity that each lane holds for two
// tokens (tokens 2 l and 2 l + 1 in lane l, as v0 and v1); every lane calls
// it.  (Tokens j, j + 1 with j even: one lane's v0 and v1, by two shuffles.)
__device__ __forceinline__ float token(float v0, float v1, int i) {
  const float a = __shfl_sync(0xffffffffu, v0, i >> 1), c = __shfl_sync(0xffffffffu, v1, i >> 1);
  return (i & 1) ? c : a;
}

// A bf16 pair as two floats.
__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Warp w: the [Q][Q] and [P][Q] products' rows 16 (w % 4) .., columns
// 16 (w / 4) .. (two n-tiles); the [N][Q] ones' rows 16 (w % 8) .., every
// column, db^T's for warps 0-7 and dc^T's for warps 8-15.
__global__ void __launch_bounds__(CK_THREADS, 1)
ssd_bwd_chunk_mma_kernel(const BwdArgs g, const __grid_constant__ BwdMaps maps, int flags) {
  // bwd-stamp 0
  extern __shared__ __align__(1024) unsigned char ck_raw[];
  unsigned char* smem = ck_raw + ((1024 - (repro::smem_addr(ck_raw) & 1023)) & 1023);
  const int k = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int mt = warp & 3, cq = warp >> 2;   // [Q][Q] and [P][Q] tiles
  const int nr = warp & 7;                    // [N][Q] tiles: rows 16 nr ..
  const bool dc_side = warp >= 8;             // warps 8-15 carry dc^T, 0-7 db^T
  const int P = g.P, N = g.N, H = g.H;
  const int l0 = k * Q, valid = min(Q, g.L - l0);
  const int nh = H;
  bf16* Cs = reinterpret_cast<bf16*>(smem + CK_C);
  bf16* Bs = reinterpret_cast<bf16*>(smem + CK_B);
  bf16* Mhi = reinterpret_cast<bf16*>(smem + CK_MW);
  bf16 *Mlo = Mhi + BOX, *Whi = Mlo + BOX, *Wlo = Whi + BOX;
  float* parts = reinterpret_cast<float*>(smem + CK_PART);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + CK_BAR);
  const bool tma_bc = flags & BT_BC, tma_x = flags & BT_X, tma_dy = flags & BT_DY;
  const int bc_boxes = N > 64 ? 2 : 1;
  const long y_l = static_cast<long>(H) * P;   // dy and dx are contiguous
  // x and dy of head u: stage u % 2
  auto xs_of = [&](int u) { return reinterpret_cast<bf16*>(smem + CK_XY + (u & 1) * 2 * BOX_BYTES); };

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) repro::mbar_init(&bar[i], 1);
    repro::mbar_fence_init();
  }
  if (bc_boxes == 1) {                       // the boxes no copy writes stay zero
    for (int i = tid; i < BOX_BYTES / 16; i += CK_THREADS) {
      reinterpret_cast<uint4*>(Cs + BOX)[i] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(Bs + BOX)[i] = make_uint4(0, 0, 0, 0);
    }
    repro::fence_proxy_async();
  }
  __syncthreads();

  auto issue_xy = [&](int u) {               // head u's x and dy into stage u % 2
    const int h = u;
    bf16* Xs = xs_of(u);
    bf16* Ys = Xs + BOX;
    uint64_t* full = &bar[1 + (u & 1)];
    if (tid == 0) {
      repro::mbar_arrive_expect_tx(full, (tma_x ? BOX_BYTES : 0) + (tma_dy ? BOX_BYTES : 0));
      if (tma_x) repro::tensor_load_4d(Xs, &maps.x, 0, h, l0, b, full);
      if (tma_dy) repro::tensor_load_4d(Ys, &maps.dy, 0, h, l0, b, full);
    }
    if (!tma_x)
      copy_rows(Xs, static_cast<const bf16*>(g.x) + b * g.xs_b + l0 * g.xs_l + h * g.xs_h,
                g.xs_l, valid, P, MAX_P);
    if (!tma_dy)
      copy_rows(Ys, static_cast<const bf16*>(g.dy) + (static_cast<long>(b) * g.L + l0) * y_l +
                        static_cast<long>(h) * P, y_l, valid, P, MAX_P);
  };
  auto issue_states = [&](int u) {           // head u's S and dS
    if (tid != 0) return;
    const int h = u;
    const long slot = ((static_cast<long>(b) * H + h) * g.chunks + k) * SLAB;
    float* st = reinterpret_cast<float*>(smem + CK_ST);
    uint64_t* full = &bar[3];
    repro::mbar_arrive_expect_tx(full, 2 * SLAB_BYTES);
    for (int half = 0; half < 2; ++half) {
      repro::bulk_load(st + half * SLAB / 2, g.starts + slot + half * SLAB / 2, SLAB_BYTES / 2, full);
      repro::bulk_load(st + SLAB + half * SLAB / 2, g.dstates + slot + half * SLAB / 2,
                       SLAB_BYTES / 2, full);
    }
  };

  float acc[8][4];              // db^T (warps 0-7) or dc^T (8-15): rows n 16 nr .., columns 8 t ..
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float cb[2][4];               // C B^T: rows i 16 mt .., columns j 16 cq + 8 t ..
  float nd0 = 0.f, nd1 = 0.f, nah = 0.f;   // the next head's dt (tokens 2 lane, 2 lane + 1), a
  auto load_dt = [&](int u) {
    const int h = u, i = 2 * lane;
    const float* d = g.dt + b * g.ds_b + l0 * g.ds_l + h * g.ds_h;
    nd0 = i < valid ? d[i * g.ds_l] : 0.f;
    nd1 = i + 1 < valid ? d[(i + 1) * g.ds_l] : 0.f;
    nah = g.a[h];
  };
  if (nh > 0) {
    if (tid == 0) {
      repro::mbar_arrive_expect_tx(&bar[0], tma_bc ? 2 * bc_boxes * BOX_BYTES : 0);
      if (tma_bc)
        for (int box = 0; box < bc_boxes; ++box) {
          repro::tensor_load_3d(Cs + box * BOX, &maps.c, box * 64, l0, b, &bar[0]);
          repro::tensor_load_3d(Bs + box * BOX, &maps.b, box * 64, l0, b, &bar[0]);
        }
    }
    if (!tma_bc) {
      copy_rows(Cs, static_cast<const bf16*>(g.c) + b * g.cs_b + l0 * g.cs_l, g.cs_l, valid, N, MAX_N);
      copy_rows(Bs, static_cast<const bf16*>(g.b) + b * g.bs_b + l0 * g.bs_l, g.bs_l, valid, N, MAX_N);
    }
    issue_xy(0);
    if (nh > 1) issue_xy(1);
    issue_states(0);
    load_dt(0);
  }
  __syncthreads();                           // the element copies are in
  if (nh > 0) {
    repro::mbar_wait_or_trap(&bar[0], 0);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NCH / 2; ++kk) {
      unsigned fa[4], fb[4];
      repro::ldmatrix_x4(fa, Cs + sw_at(16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        kk * 2 + (lane >> 4)));
      repro::ldmatrix_x4(fb, Bs + sw_at(16 * cq + (lane & 7) + (lane >> 4) * 8,
                                        kk * 2 + ((lane >> 3) & 1)));
      repro::mma_bf16(cb[0], fa, fb[0], fb[1]);
      repro::mma_bf16(cb[1], fa, fb[2], fb[3]);
    }
  }

  // 8. d(cs), its suffix sum R within the chunk, ddt and da's share of
  //    head u (its partials, and each lane's dt and cumsum of its two
  //    tokens): warp 0, two tokens a lane, in the next head's slack
  auto scan = [&](int u, float d0, float d1, float c0, float c1) {
    const int h = u;
    const float* pt = parts + (u & 1) * PT_FLOATS;
    const float ah = g.a[h], tot = __shfl_sync(0xffffffffu, c1, 31);
    float dot = 0.f;
    for (int w_ = 0; w_ < CK_WARPS; ++w_) dot += pt[PT_DOT + w_];
    const float ecs[2] = {expf(c0), expf(c1)}, rem[2] = {expf(tot - c0), expf(tot - c1)};
    const float dd[2] = {d0, d1};
    float a1[2], a2[2], u_[2], dcs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      float rt = 0.f, ct = 0.f, yi = 0.f;
      a1[e] = a2[e] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {          // the tiles' shares, in order
        rt += pt[PT_RT + q * Q + i];
        ct += pt[PT_CT + q * Q + i];
        a1[e] += pt[PT_A1 + q * Q + i];
        a2[e] += pt[PT_A2 + q * Q + i];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) yi += pt[PT_YI + q * Q + i];
      u_[e] = rem[e] * dd[e] * a2[e];
      dcs[e] = rt - ct + ecs[e] * yi - u_[e];
    }
    const float usum = repro::warp_sum(u_[0] + u_[1]);
    if (lane == 31) dcs[1] += expf(tot) * dot + usum;   // the chunk's last token
    float suf = dcs[0] + dcs[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane + o < 32) suf += v;
    }
    const float R[2] = {suf, suf - dcs[0]};
    float da = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      if (i < valid)
        g.ddt[(static_cast<long>(b) * g.L + l0 + i) * H + h] = a1[e] + rem[e] * a2[e] + ah * R[e];
      da += dd[e] * R[e];
    }
    da = repro::warp_sum(da);
    if (lane == 0) g.da_part[(static_cast<long>(b) * g.chunks + k) * H + h] = da;
  };
  float pd0 = 0.f, pd1 = 0.f, pc0 = 0.f, pc1 = 0.f;   // the last head's, for its scan

  for (int u = 0; u < nh; ++u) {
    // bwd-stamp 1
    const int h = u, par = u & 1;
    float* pt = parts + par * PT_FLOATS;
    const bf16* Xs = xs_of(u);
    const bf16* Ys = Xs + BOX;
    // S and dS as split tiles: hi, then lo 2 BOX elements on
    const bf16* Shi = reinterpret_cast<const bf16*>(smem + CK_ST);
    const bf16* dShi = Shi + 4 * BOX;
    // the chunk's cumsum of dt a, each warp its own copy, two tokens a lane
    const float d0 = nd0, d1 = nd1, ah = nah;
    if (u + 1 < nh) load_dt(u + 1);
    const float v1 = d1 * ah;
    float run = d0 * ah + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w_ = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run += w_;
    }
    const float c1 = run, c0 = run - v1, tot = __shfl_sync(0xffffffffu, run, 31);
    const float rem0 = expf(tot - c0), rem1 = expf(tot - c1);

    repro::mbar_wait_or_trap(&bar[1 + par], (u >> 1) & 1);   // x, dy
    // the warp as one again before ldmatrix and mma.sync (.aligned): the
    // waits and thread 0's copies part its lanes (below too)
    __syncwarp();
    // bwd-stamp 2
    // 1. G = dy x^T, then W = G o decay o dt_j and M = C B^T o decay on and
    //    below the diagonal (zero above it); the row and column sums of
    //    C B^T o W
    float w[2][4], m[2][4];
    {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk) {
        unsigned fa[4], fb[4];
        repro::ldmatrix_x4(fa, Ys + sw_at(16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          kk * 2 + (lane >> 4)));
        repro::ldmatrix_x4(fb, Xs + sw_at(16 * cq + (lane & 7) + (lane >> 4) * 8,
                                          kk * 2 + ((lane >> 3) & 1)));
        repro::mma_bf16(w[0], fa, fb[0], fb[1]);
        repro::mma_bf16(w[1], fa, fb[2], fb[3]);
      }
      float cj[2][2], dj[2][2];              // this thread's columns' cs log2(e) and dt
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int src = 8 * cq + 4 * t + tq;   // the lane of tokens 16 cq + 8 t + 2 tq (+1)
        cj[t][0] = __shfl_sync(0xffffffffu, c0, src) * LOG2E;
        cj[t][1] = __shfl_sync(0xffffffffu, c1, src) * LOG2E;
        dj[t][0] = __shfl_sync(0xffffffffu, d0, src);
        dj[t][1] = __shfl_sync(0xffffffffu, d1, src);
      }
      float rs[2] = {0.f, 0.f}, csum[2][2] = {};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * mt + gr + 8 * r;
        const float ci = token(c0, c1, i) * LOG2E;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * cq + 8 * t + 2 * tq;
          const float e0 = exp2f(fminf(ci - cj[t][0], 0.f)) * static_cast<float>(j <= i);
          const float e1 = exp2f(fminf(ci - cj[t][1], 0.f)) * static_cast<float>(j < i);
          w[t][2 * r] *= e0 * dj[t][0];
          w[t][2 * r + 1] *= e1 * dj[t][1];
          m[t][2 * r] = cb[t][2 * r] * e0;
          m[t][2 * r + 1] = cb[t][2 * r + 1] * e1;
          const float q0 = cb[t][2 * r] * w[t][2 * r], q1 = cb[t][2 * r + 1] * w[t][2 * r + 1];
          rs[r] += q0 + q1;
          csum[t][0] += q0;
          csum[t][1] += q1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(rs[r]);
        if (tq == 0) pt[PT_RT + cq * Q + 16 * mt + gr + 8 * r] = v;
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = column_sum(csum[t][e]);
          if (gr == 0) pt[PT_CT + mt * Q + 16 * cq + 8 * t + 2 * tq + e] = v;
        }
    }
    // bwd-stamp 3
    if (tid == 0) repro::bulk_wait_read();   // the last head's dx store has read M's hi tile
    __syncthreads();                         // M and W are free
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int o = sw_at(16 * mt + gr + 8 * r, 2 * cq + t) + 2 * tq;
        unsigned hi, lo;
        split_bf16(m[t][2 * r], m[t][2 * r + 1], hi, lo);
        *reinterpret_cast<unsigned*>(Mhi + o) = hi;
        *reinterpret_cast<unsigned*>(Mlo + o) = lo;
        split_bf16(w[t][2 * r], w[t][2 * r + 1], hi, lo);
        *reinterpret_cast<unsigned*>(Whi + o) = hi;
        *reinterpret_cast<unsigned*>(Wlo + o) = lo;
      }
    __syncthreads();                         // M and W are whole
    // bwd-stamp 4
    repro::mbar_wait_or_trap(&bar[3], u & 1);   // S, dS
    __syncwarp();
    // <dS, S> from the split tiles, this thread's 16 elements of each
    {
      float dot = 0.f;
      const uint4* s4 = reinterpret_cast<const uint4*>(Shi);
      const uint4* d4 = reinterpret_cast<const uint4*>(dShi);
#pragma unroll
      for (int q = 0; q < SPLIT_VEC; ++q) {
        const int v = tid + q * CK_THREADS;   // a piece of the hi tiles; the lo ones 2 BOX on
        const uint4 sh = s4[v], sl = s4[v + BOX / 4], dh = d4[v], dl = d4[v + BOX / 4];
        const unsigned* a = &sh.x;
        const unsigned* a2 = &sl.x;
        const unsigned* c = &dh.x;
        const unsigned* c2 = &dl.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x0 = unpack(a[e]), x1 = unpack(a2[e]), y0 = unpack(c[e]), y1 = unpack(c2[e]);
          dot += (x0.x + x1.x) * (y0.x + y1.x) + (x0.y + x1.y) * (y0.y + y1.y);
        }
      }
      dot = repro::warp_sum(dot);
      if (lane == 0) pt[PT_DOT + warp] = dot;
    }

    // bwd-stamp 5

    // 2. (warps 0-7) db^T += (dS^T x^T) o rem dt (columns), rows n 16 nr ..;
    // 3. (warps 8-15) F = S^T dy^T: dc^T += F o e^cs (columns), and
    //    C_i.F_i for d(cs)
    {
      float ee[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) ee[t][e] = 0.f;
      const bf16* src = dc_side ? Shi : dShi;
      const bf16* rows = dc_side ? Ys : Xs;
#pragma unroll
      for (int kk = 0; kk < MAX_P / 16; ++kk) {
        unsigned hi[4], lo[4];               // S^T or dS^T: rows n 16 nr .., columns p 16 kk ..
        const int o = sw_at(16 * kk + (lane & 7) + (lane >> 4) * 8, 2 * nr + ((lane >> 3) & 1));
        repro::ldmatrix_x4_trans(hi, src + o);
        repro::ldmatrix_x4_trans(lo, src + 2 * BOX + o);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          unsigned fb[4];
          repro::ldmatrix_x4(fb, rows + sw_at(16 * v + (lane & 7) + (lane >> 4) * 8,
                                              kk * 2 + ((lane >> 3) & 1)));
          repro::mma_bf16(ee[2 * v], hi, fb[0], fb[1]);
          repro::mma_bf16(ee[2 * v + 1], hi, fb[2], fb[3]);
          repro::mma_bf16(ee[2 * v], lo, fb[0], fb[1]);
          repro::mma_bf16(ee[2 * v + 1], lo, fb[2], fb[3]);
        }
      }
      // the column scale: rem dt (db) or e^cs (dc), token 8 t + 2 tq (+1)
      const float f0 = dc_side ? expf(c0) : rem0 * d0, f1 = dc_side ? expf(c1) : rem1 * d1;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float s0 = __shfl_sync(0xffffffffu, f0, 4 * t + tq);
        const float s1 = __shfl_sync(0xffffffffu, f1, 4 * t + tq);
        acc[t][0] += s0 * ee[t][0];
        acc[t][1] += s1 * ee[t][1];
        acc[t][2] += s0 * ee[t][2];
        acc[t][3] += s1 * ee[t][3];
      }
      __syncwarp();
      if (dc_side) {
        // C[i][n] at F's elements: C^T's 8 x 8 tiles by ldmatrix.trans
#pragma unroll
        for (int t = 0; t < 8; t += 2) {
          unsigned cf[4];
          const int mtx = lane >> 3;
          repro::ldmatrix_x4_trans(cf, Cs + sw_at(8 * (t + (mtx >> 1)) + (lane & 7),
                                                  2 * nr + (mtx & 1)));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float2 lo_ = unpack(cf[2 * q]), hi_ = unpack(cf[2 * q + 1]);   // rows n, n + 8
            const float y0 = column_sum(lo_.x * ee[t + q][0] + hi_.x * ee[t + q][2]);
            const float y1 = column_sum(lo_.y * ee[t + q][1] + hi_.y * ee[t + q][3]);
            if (gr == 0) {
              pt[PT_YI + nr * Q + 8 * (t + q) + 2 * tq] = y0;
              pt[PT_YI + nr * Q + 8 * (t + q) + 2 * tq + 1] = y1;
            }
          }
        }
      }
    }

    if (warp == 0 && u > 0) scan(u - 1, pd0, pd1, pc0, pc1);   // warps 0-7 wait here anyway
    // bwd-stamp 6
    // 4. ex = dS B^T: rows p 16 mt .., columns j 16 cq .. (for dx and x.(dS B))
    __syncwarp();
    float ex[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) ex[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NCH / 2; ++kk) {
      unsigned hi[4], lo[4], fb[4];          // dS: rows p 16 mt .., columns n 16 kk ..
      const int o = sw_at(16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8, kk * 2 + (lane >> 4));
      repro::ldmatrix_x4(hi, dShi + o);
      repro::ldmatrix_x4(lo, dShi + 2 * BOX + o);
      repro::ldmatrix_x4(fb, Bs + sw_at(16 * cq + (lane & 7) + (lane >> 4) * 8,
                                        kk * 2 + ((lane >> 3) & 1)));
      repro::mma_bf16(ex[0], hi, fb[0], fb[1]);
      repro::mma_bf16(ex[1], hi, fb[2], fb[3]);
      repro::mma_bf16(ex[0], lo, fb[0], fb[1]);
      repro::mma_bf16(ex[1], lo, fb[2], fb[3]);
    }

    // bwd-stamp 7
    __syncthreads();                         // S and dS are free
    if (u + 1 < nh) issue_states(u + 1);
    __syncwarp();
    // bwd-stamp 8

    // 5. dx^T = (dy^T M + ex o rem) o dt (columns), rows p 16 mt .., columns
    //    j 16 cq ..; and x_j.(M^T dy)_j, x_j.(dS B_j), this row tile's share
    unsigned dxp[4];
    {
      float in[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) in[t][e] = 0.f;
#pragma unroll
      for (int I = 0; I < QT; ++I) {
        if (I < cq) continue;                // M[i][j] = 0 for j > i
        unsigned ya[4], mh[4], ml[4];
        repro::ldmatrix_x4_trans(ya, Ys + sw_at(I * 16 + (lane & 7) + (lane >> 4) * 8,
                                                2 * mt + ((lane >> 3) & 1)));
        const int o = sw_at(I * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * cq + (lane >> 4));
        repro::ldmatrix_x4_trans(mh, Mhi + o);
        repro::ldmatrix_x4_trans(ml, Mlo + o);
        repro::mma_bf16(in[0], ya, mh[0], mh[1]);
        repro::mma_bf16(in[1], ya, mh[2], mh[3]);
        repro::mma_bf16(in[0], ya, ml[0], ml[1]);
        repro::mma_bf16(in[1], ya, ml[2], ml[3]);
      }
      // x^T at these elements: (t, rows p, p + 8) by ldmatrix.trans
      unsigned xf[4];
      {
        const int mtx = lane >> 3;
        repro::ldmatrix_x4_trans(xf, Xs + sw_at(16 * cq + 8 * (mtx >> 1) + (lane & 7),
                                                2 * mt + (mtx & 1)));
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int src = 8 * cq + 4 * t + tq, j = 16 * cq + 8 * t + 2 * tq;
        const float dj0 = __shfl_sync(0xffffffffu, d0, src), dj1 = __shfl_sync(0xffffffffu, d1, src);
        const float rj0 = __shfl_sync(0xffffffffu, rem0, src);
        const float rj1 = __shfl_sync(0xffffffffu, rem1, src);
        const float2 xa = unpack(xf[2 * t]), xb = unpack(xf[2 * t + 1]);   // rows p, p + 8
        const float a10 = column_sum(xa.x * in[t][0] + xb.x * in[t][2]);
        const float a11 = column_sum(xa.y * in[t][1] + xb.y * in[t][3]);
        const float a20 = column_sum(xa.x * ex[t][0] + xb.x * ex[t][2]);
        const float a21 = column_sum(xa.y * ex[t][1] + xb.y * ex[t][3]);
        if (gr == 0) {
          pt[PT_A1 + mt * Q + j] = a10;
          pt[PT_A1 + mt * Q + j + 1] = a11;
          pt[PT_A2 + mt * Q + j] = a20;
          pt[PT_A2 + mt * Q + j + 1] = a21;
        }
        dxp[2 * t] = repro::pack_bf16(dj0 * (in[t][0] + rj0 * ex[t][0]),
                                      dj1 * (in[t][1] + rj1 * ex[t][1]));
        dxp[2 * t + 1] = repro::pack_bf16(dj0 * (in[t][2] + rj0 * ex[t][2]),
                                          dj1 * (in[t][3] + rj1 * ex[t][3]));
      }
    }
    // bwd-stamp 9
    __syncthreads();                         // every warp is done with x, dy and M
    if (u + 2 < nh) issue_xy(u + 2);
    __syncwarp();
    // dx through M's hi tile, rows j, columns p (stmatrix transposes the
    // fragments into rows)
    {
      const int mtx = lane >> 3;
      repro::stmatrix_x4_trans(Mhi + sw_at(16 * cq + 8 * (mtx >> 1) + (lane & 7), 2 * mt + (mtx & 1)),
                               dxp[0], dxp[1], dxp[2], dxp[3]);
    }
    // bwd-stamp 10

    if (!dc_side) {
      // 6. db^T += C^T W, rows n 16 nr .., columns j
#pragma unroll
      for (int I = 0; I < QT; ++I) {
        unsigned ca[4];
        repro::ldmatrix_x4_trans(ca, Cs + sw_at(I * 16 + (lane & 7) + (lane >> 4) * 8,
                                                2 * nr + ((lane >> 3) & 1)));
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (I < v) continue;               // W[i][j] = 0 for j > i
          const int o = sw_at(I * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * v + (lane >> 4));
          unsigned wh[4], wl[4];
          repro::ldmatrix_x4_trans(wh, Whi + o);
          repro::ldmatrix_x4_trans(wl, Wlo + o);
          repro::mma_bf16(acc[2 * v], ca, wh[0], wh[1]);
          repro::mma_bf16(acc[2 * v + 1], ca, wh[2], wh[3]);
          repro::mma_bf16(acc[2 * v], ca, wl[0], wl[1]);
          repro::mma_bf16(acc[2 * v + 1], ca, wl[2], wl[3]);
        }
      }
    } else {
      // 7. dc^T += B^T W^T, rows n 16 nr .., columns i
#pragma unroll
      for (int J = 0; J < QT; ++J) {
        unsigned ba[4];
        repro::ldmatrix_x4_trans(ba, Bs + sw_at(J * 16 + (lane & 7) + (lane >> 4) * 8,
                                                2 * nr + ((lane >> 3) & 1)));
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (v < J) continue;               // W[i][j] = 0 for j > i
          const int o = sw_at(16 * v + (lane & 7) + (lane >> 4) * 8, 2 * J + ((lane >> 3) & 1));
          unsigned wh[4], wl[4];
          repro::ldmatrix_x4(wh, Whi + o);
          repro::ldmatrix_x4(wl, Wlo + o);
          repro::mma_bf16(acc[2 * v], ba, wh[0], wh[1]);
          repro::mma_bf16(acc[2 * v + 1], ba, wh[2], wh[3]);
          repro::mma_bf16(acc[2 * v], ba, wl[0], wl[1]);
          repro::mma_bf16(acc[2 * v + 1], ba, wl[2], wl[3]);
        }
      }
    }
    // bwd-stamp 11
    repro::fence_proxy_async();              // the dx tile, before its tensor store
    __syncthreads();                         // the partials and the dx tile are whole
    // bwd-stamp 12

    if (flags & BT_DX) {
      if (tid == 0) repro::tensor_store_4d(&maps.dx, Mhi, 0, h, l0, b);
    } else {
      for (int idx = tid; idx < valid * P; idx += CK_THREADS) {
        const int j = idx / P, p = idx - j * P;
        static_cast<bf16*>(g.dx)[(static_cast<long>(b) * g.L + l0 + j) * y_l +
                                 static_cast<long>(h) * P + p] = Mhi[sw_at(j, p >> 3) + (p & 7)];
      }
    }

    pd0 = d0, pd1 = d1, pc0 = c0, pc1 = c1;
    // bwd-stamp 13
  }
  if (warp == 0 && nh > 0) scan(nh - 1, pd0, pd1, pc0, pc1);

  // db and dc: summed over the heads in the warps' registers, out through
  // shared memory (as [token][n] floats over the x, dy and S, dS stages,
  // which no copy writes now) in rows of 16 bytes
  float* red = reinterpret_cast<float*>(smem + CK_XY) + (dc_side ? Q * RED_STRIDE : 0);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(8 * t + 2 * tq + (e & 1)) * RED_STRIDE + 16 * nr + gr + 8 * (e >> 1)] = acc[t][e];
  if (tid == 0) repro::bulk_wait();          // the last dx store is done
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(smem + CK_XY);
  constexpr int NC = MAX_N / 8;
  for (int it = tid; it < 2 * valid * NC; it += CK_THREADS) {
    const int which = it / (valid * NC), rest = it - which * valid * NC;
    const int j = rest / NC, n = (rest % NC) * 8;
    if (n >= N) continue;
    const float* src = all + (which * Q + j) * RED_STRIDE + n;
    const float4 x0 = *reinterpret_cast<const float4*>(src);
    const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
    const float sum[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    bf16* out = static_cast<bf16*>(which ? g.dc : g.db) + (static_cast<long>(b) * g.L + l0 + j) * N + n;
    if (N % 8 == 0) {
      *reinterpret_cast<uint4*>(out) =
          make_uint4(repro::pack_bf16(sum[0], sum[1]), repro::pack_bf16(sum[2], sum[3]),
                     repro::pack_bf16(sum[4], sum[5]), repro::pack_bf16(sum[6], sum[7]));
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e) out[e] = __float2bfloat16_rn(sum[e]);
    }
  }
  // bwd-stamp 14
}

// -- 2'. the chunks, float32: the first version's body -----------------------

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
    mma_rows(acc, KN, [&](int r, int kk) { return kk < N ? Cs[(r0 + r) * ns + kk] : 0.f; },
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
    const long slot = ((static_cast<long>(b) * g.H + h) * g.chunks + k) * SLAB;
    repro::load_tile(Xs, ps, static_cast<const T*>(g.x) + b * g.xs_b + l0 * g.xs_l + h * g.xs_h,
                     g.xs_l, Q, valid, P, 1.f);
    repro::load_tile(Ys, ps, static_cast<const T*>(g.dy) + (static_cast<long>(b) * g.L + l0) *
                     y_l + static_cast<long>(h) * P, y_l, Q, valid, P, 1.f);
    for (int idx = tid; idx < P * N; idx += CHUNK_THREADS) {
      const int p = idx / N, n = idx - p * N;
      Ss[p * ns + n] = g.starts[slot + slab_at(p, n)];
      dSs[p * ns + n] = g.dstates[slot + slab_at(p, n)];
    }
    const float tot = chunk_decay(g, b, h, l0, valid, dts, cs, ecs, rem, sc);   // warp 0's

    // 1. G = dy x^T (rows i, columns j); W = decay o dt_j o G and M = C B^T
    //    o decay on and below the diagonal (zero above it)
    {
      float acc[2][4] = {};
      mma_rows(acc, KP, [&](int r, int kk) { return kk < P ? Ys[(r0 + r) * ps + kk] : 0.f; },
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
      mma_rows(in, Q, [&](int r, int kk) { return Mt[kk * qs + r0 + r]; },
               [&](int kk, int c) { return 16 * cq + c < P ? Ys[kk * ps + 16 * cq + c] : 0.f; });
      mma_rows(ex, KN, [&](int r, int kk) { return kk < N ? Bs[(r0 + r) * ns + kk] : 0.f; },
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
    mma_rows(dB, Q, [&](int r, int kk) { return Wt[kk * qs + r0 + r]; },
             [&](int kk, int c) { return 32 * cq + c < N ? Cs[kk * ns + 32 * cq + c] : 0.f; });
    mma_rows(dB, KP, [&](int r, int kk) { return kk < P ? Xs[(r0 + r) * ps + kk] * sc[r0 + r] : 0.f; },
             [&](int kk, int c) { return kk < P && 32 * cq + c < N ? dSs[kk * ns + 32 * cq + c] : 0.f; });

    // 5. dc += e^cs o (dy S) + W B, rows i, columns n = 32 cq ..; and y's
    //    inter term, this column quarter's share
    {
      float t4[4][4] = {};
      mma_rows(t4, KP, [&](int r, int kk) { return kk < P ? Ys[(r0 + r) * ps + kk] : 0.f; },
               [&](int kk, int c) { return kk < P && 32 * cq + c < N ? Ss[kk * ns + 32 * cq + c] : 0.f; });
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
    mma_rows(dC, Q, [&](int r, int kk) { return Wt[(r0 + r) * qs + kk]; },
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

// -- 3. da = the rows of da_part summed in order ------------------------------
__global__ void ssd_bwd_da_kernel(const float* __restrict__ part, float* __restrict__ da,
                                  int parts, int H) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < parts; ++i) s += part[static_cast<long>(i) * H + h];
    da[h] = s;
  }
}

template <typename T>
int launch_bwd(const BwdArgs& g, int passes, void* stream) {
  if (g.P > MAX_P || g.N > MAX_N || g.P < 1 || g.N < 1 || g.L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr bool MMA = std::is_same_v<T, bf16>;
  BwdMaps maps = {};
  int flags = 0;
  if (MMA) {
    repro::bind_context();
    // b, c: (n, l, b) boxes of 64 columns by the chunk's 64 rows; x, dy,
    // dx: (p, h, l, b) boxes of one head's 64 columns by 64 rows
    const long bc_dims[3] = {g.N, g.L, g.B}, c_strides[2] = {g.cs_l, g.cs_b},
               b_strides[2] = {g.bs_l, g.bs_b};
    const long x_dims[4] = {g.P, g.H, g.L, g.B}, x_strides[3] = {g.xs_h, g.xs_l, g.xs_b};
    const long y_strides[3] = {g.P, static_cast<long>(g.H) * g.P,
                               static_cast<long>(g.L) * g.H * g.P};
    const unsigned bc_box[3] = {64, Q, 1}, x_box[4] = {64, 1, Q, 1};
    if (make_map(&maps.c, g.c, 3, bc_dims, c_strides, bc_box) &&
        make_map(&maps.b, g.b, 3, bc_dims, b_strides, bc_box))
      flags |= BT_BC;
    if (make_map(&maps.x, g.x, 4, x_dims, x_strides, x_box)) flags |= BT_X;
    if (make_map(&maps.dy, g.dy, 4, x_dims, y_strides, x_box)) flags |= BT_DY;
    if (make_map(&maps.dx, g.dx, 4, x_dims, y_strides, x_box)) flags |= BT_DX;
  }
  cudaError_t err = cudaSuccess;
  if (passes & STATES_PASS) {
    const size_t smem = states_smem<T>(g.P, g.N);
    if ((err = repro::allow_shared(ssd_bwd_states_kernel<T>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    ssd_bwd_states_kernel<T><<<4 * g.B * g.H, ST_THREADS, smem, s>>>(g, maps, flags);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & CHUNK_PASS) {
    if constexpr (MMA) {
      if ((err = repro::allow_shared(ssd_bwd_chunk_mma_kernel, CK_SMEM)) != cudaSuccess)
        return static_cast<int>(err);
      ssd_bwd_chunk_mma_kernel<<<dim3(g.chunks, g.B), CK_THREADS, CK_SMEM, s>>>(g, maps, flags);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    } else {
      const size_t chunk = chunk_shared_floats(g.P, g.N) * sizeof(float);
      if ((err = repro::allow_shared(ssd_bwd_chunk_kernel<T>, chunk)) != cudaSuccess)
        return static_cast<int>(err);
      ssd_bwd_chunk_kernel<T><<<dim3(g.chunks, g.B), CHUNK_THREADS, chunk, s>>>(g);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (passes & DA_PASS) {
    ssd_bwd_da_kernel<<<1, 256, 0, s>>>(g.da_part, g.da, g.B * g.chunks, g.H);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
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

// starts, dstates: float32 scratch of B H chunks slots (64 x 128 floats each);
// da_part (B, chunks, H) float32 scratch; dy contiguous; d_state null for a
// zero gradient of the final state; passes: which launches run (1 states,
// 2 chunks, 4 da)
#define SSD_BWD_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const void* x, const void* dt, const void* a, const void* b,            \
                      const void* c, const void* dy, const void* d_state, void* starts,       \
                      void* dstates, void* da_part, void* dx, void* ddt,                      \
                      void* da, void* db, void* dc, int B, int L, int H, int P, int N,        \
                      long xs_b, long xs_l, long xs_h, long ds_b, long ds_l, long ds_h,       \
                      long bs_b, long bs_l, long cs_b, long cs_l, int passes,                 \
                      void* stream) {                                                         \
    const BwdArgs g{x, b, c, dy, static_cast<const float*>(dt), static_cast<const float*>(a), \
                    static_cast<const float*>(d_state), static_cast<float*>(starts),          \
                    static_cast<float*>(dstates), static_cast<float*>(da_part),               \
                    dx, db, dc, static_cast<float*>(ddt), static_cast<float*>(da), B, L, H,   \
                    P, N, (L + Q - 1) / Q, xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b, bs_l,    \
                    cs_b, cs_l};                                                              \
    return launch_bwd<T>(g, passes, stream);                                                  \
  }

SSD_BWD_ENTRY(ssd_scan_bwd_bf16, __nv_bfloat16)
SSD_BWD_ENTRY(ssd_scan_bwd_f32, float)
