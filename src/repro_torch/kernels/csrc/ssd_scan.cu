// Mamba2 SSD (state-space duality) scan: within a chunk of tokens the
// decay-masked quadratic form (C . B^T o exp(segsum) o dt) @ x, across
// chunks a carried (P, N) float32 state.
//
//   x (B, L, H, P) in T, read through its strides (p contiguous);
//   dt (B, L, H) float32, through its strides; a (H,) float32;
//   b, c (B, L, N) in T, through their strides (n contiguous), one group
//   shared by the heads;
//   y (B, L, H, P) in T, contiguous; state (B, H, P, N) float32, contiguous.
//   P <= 64, N <= 128.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (repro/kernels/ssd_scan.py).
// Bound on the H100: bytes at the bf16 tensor-core rate (x and y, the
// state, b and c, dt: ~44 MB at mamba2-370m's prefill, B8 L512 H32 P64
// N128, against ~10 GFLOP); this first version runs its products as
// float32 FMAs on the CUDA cores, so it is bound by those operations.
//
// Design: one block per (head, sequence), walking the sequence in order
// in chunks of Q = 64 tokens: the loop inside the block takes the place
// of the TPU's sequential chunk axis, and the (P, N) state stays in
// shared memory between chunks as it stayed in VMEM scratch.  The chunk
// length is the kernel's own blocking (the TPU kernel's 128 would need
// ~256 KB of float32 tiles here); a chunked scan gives the same function
// for any chunk length, summed in another order.  A chunk's b, c and x
// tiles go to shared memory as float32; dt and the inclusive cumsum of
// dt * a (one warp's shuffle scan) sit beside them.  Then three register-
// tiled passes, 256 threads each holding a 4 x 4 (or 4 x 8) tile:
//   1. W[i][j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j for j <= i, else 0;
//   2. y[i][p] = sum_j W[i][j] x[j][p] + exp(cs_i) * (C_i . S[p]);
//   3. S[p][n] = S[p][n] * exp(cs_last) + sum_j x[j][p] rem_j B[j][n],
//      rem_j = exp(cs_last - cs_j) * dt_j.
// Tiles have one float of padding a row, so the threads of a warp, which
// read 16 different rows at one column, hit 16 different banks.  The
// blocks of one sequence sit next to each other in the grid, so b and c,
// read by every head, come from L2 after the first.  Rows past the end
// of the sequence load as zeros (x, b, c and dt), which leaves the state
// unchanged, as the TPU wrapper's zero padding does.
#include "common.cuh"

namespace {

using repro::from_float;

constexpr int Q = 64;           // tokens a chunk
constexpr int THREADS = 256;    // 16 x 16 thread tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;

size_t shared_floats(int P, int N) {
  // Cs, Bs [Q][N+1]; Xs [Q][P+1]; Ws [Q][Q+1]; Ss [P][N+1]; dt, cs, exp(cs), rem [Q]
  return 2 * Q * (N + 1) + Q * (P + 1) + Q * (Q + 1) + P * (N + 1) + 4 * Q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ state,
                int L, int H, int P, int N, long xs_b, long xs_l, long xs_h, long ds_b,
                long ds_l, long ds_h, long bs_b, long bs_l, long cs_b, long cs_l) {
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

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           void* y, void* state, int B, int L, int H, int P, int N, long xs_b, long xs_l,
           long xs_h, long ds_b, long ds_l, long ds_h, long bs_b, long bs_l, long cs_b,
           long cs_l, void* stream) {
  if (P > MAX_P || N > MAX_N || P < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_floats(P, N) * sizeof(float);
  cudaError_t err = repro::allow_shared(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(H, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, N, xs_b, xs_l, xs_h, ds_b, ds_l, ds_h, bs_b, bs_l,
      cs_b, cs_l);
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
  }

SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16)
SSD_ENTRY(ssd_scan_f32, float)
