// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, in float32, cast back
// to the input type; and its gated form, Mamba2's output norm
// rmsnorm((y + xh * d_skip) * silu(z), w), in one launch.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` (repro/kernels/rmsnorm.py)
// and, in the gated form, also the elementwise ops that the JAX package runs
// around it in `mamba_forward` / `mamba_decode` (repro/models/blocks.py),
// which XLA fuses on the TPU.
//
// Bound on the H100: bytes.  A handful of float operations for every 2 or 4
// bytes moved, far below the card's ~295 operations a byte: the least time
// is the rows in and out once, plus the weight, over the memory rate.
//
// Design of the row kernel, which takes every row whose width is a whole
// number of 16-byte pieces and whose pointers (and z's row stride) are
// 16-byte aligned:
//  - One memory round trip.  A lane holds UNITS 16-byte pieces of its row
//    in registers, issues all their loads and those of its columns' weight
//    before it reduces, and writes the row from the same registers; nothing
//    reads x twice.  One float32 accumulator a piece, so the sum of squares
//    is UNITS short chains, not one long one.
//  - `warps` warps a row (a power of two, at most 8): the fewest whose lanes
//    hold the row in UNITS <= 4 pieces (gated: 2, three inputs a piece).  A
//    warp sums by shuffles; the warps of a row add their sums in shared
//    memory behind one named barrier a row (two slots by row parity, so one
//    barrier suffices); there is no block barrier.
//  - The weight stays resident in registers: a lane's columns are the same
//    in every row it takes, so it loads their float32 weight once, beside
//    its first row, and never again.  Not in shared memory: a copy there
//    would put a wait and a block barrier between a decode step's loads and
//    its sum, and a shared-memory read of the weight into every row (both
//    measured slower on the H100, PERF.md).
//  - Persistent.  The grid is the SM count times the blocks that fit
//    (`rmsnorm.norm_plan`, on the host, from the card's properties); each
//    row group walks the rows grid-stride with two register buffers, asking
//    for its next row before it reduces and writes the current one.  With
//    few rows (a decode step) a block takes one row group, so the rows
//    spread over as many SMs.
//  - The launch bounds cap a thread at 128 registers, so two blocks of 256
//    threads fit an SM: 16 warps, each with a row in flight.
// Aligned rows that 8 warps do not hold (past 8192 bf16 / 4096 float32
// columns; the gated form past 4096 / 2048, as jamba's Mamba2 norm at 16384)
// go to rmsnorm_cluster_kernel: a lane's registers as above, on one CTA of
// 16 warps or a thread-block cluster of CTAs of 8 warps (`rmsnorm.
// cluster_plan`, the layout of the gradients' cluster kernels below), the
// row's sum through `ClusterSums`, one cluster barrier a row.  At 4096 rows
// it takes 72-87% of the bound against the wide kernel's 39-63%; jamba's
// gated rows take two CTAs of 16 warps, 4% faster than four of 8 (PERF.md).
// Rows off 16 bytes, or past 8 CTAs of 8 warps (65536 bf16 / 32768
// float32 columns; gated 32768 / 16384), go to the wide kernel: a block a
// row, element loads, two passes over the row (the second from L1/L2),
// the weight from device memory.
//
// The gated form reads y and xh (contiguous, one row a token) and z, a
// column slice of the in-projection with its own row stride, and rounds to
// the input type at the points where the op-by-op torch body stores its
// intermediates: after xh * d_skip (d_skip itself cast first), after the
// add, after silu(z) and after the product; the norm runs in float32 on the
// rounded product.  A lane keeps its columns' d_skip in registers too.
#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "common.cuh"

namespace cg = cooperative_groups;

// 1 keeps only the gated backward row kernel's loads and stores (it writes
// its pieces of y, xh and z as dy, dxh and dz): a variant that
// `repro_torch.probes.train_bwd` builds to time the kernel's memory side.
#ifndef GATED_BWD_NO_MATH
#define GATED_BWD_NO_MATH 0
#endif

// A variant that `repro_torch.probes.wide_norms` builds to find what bounds
// the cluster kernels: 1 leaves out the exchange of a row's sums between the
// cluster's CTAs (each CTA uses its own), 2 the element math (a lane writes
// its pieces back as they came), 3 both.  The results are then wrong.
#ifndef CLUSTER_ABLATE
#define CLUSTER_ABLATE 0
#endif

namespace {

using repro::from_float;
using repro::to_float;

constexpr int THREADS = 256;   // a block of the row kernel at most: 8 warps
constexpr int MIN_BLOCKS = 2;  // blocks an SM that the launch bounds keep room for
constexpr int MAX_WARPS = THREADS / 32;

struct Args {
  const void* x;        // the rows; the gated form's y
  const void* xh;       // gated: the skip input, laid out as y
  const void* z;        // gated: the gate, rows z_stride elements apart
  const float* d_skip;  // gated: one skip weight a head of P columns
  const float* w;       // (D,) float32
  void* out;            // (rows, D), contiguous
  long z_stride;
  int rows, D, P;
  float eps;
};

// A value rounded through the input type, as a stored torch intermediate is.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

// (y + xh * ds) * silu(z), rounded where the torch body rounds; ds is
// d_skip already cast to the input type.  silu by the fast exponential and
// division (a few float32 ulps from torch's, then rounded): the exact ones
// are a long chain an element, which set the gated kernel's time.
template <typename T>
__device__ __forceinline__ float gate(float y, float xh, float ds, float z) {
  return rnd<T>(rnd<T>(y + rnd<T>(xh * ds)) * rnd<T>(__fdividef(z, 1.f + __expf(-z))));
}

// A lane's pieces of one row: the row's (the gated form's y), and the gated
// form's xh and z.
template <int UNITS, bool GATED>
struct Pieces {
  uint4 a[UNITS];
  uint4 xh[GATED ? UNITS : 1];
  uint4 z[GATED ? UNITS : 1];
};

// Where a lane's pieces lie: piece k is 16-byte unit `first + k * step` of
// the row, which has `units` of them.
struct Lane {
  int first, step, units;
};

template <typename T, int UNITS, bool GATED>
__device__ __forceinline__ void load_row(Pieces<UNITS, GATED>& p, const Args& a, long row,
                                         Lane l) {
  constexpr int E = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x) + row * a.D;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
    const bool in = u < l.units;
    p.a[k] = in ? *reinterpret_cast<const uint4*>(x + u * E) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (GATED) {
      const T* xh = static_cast<const T*>(a.xh) + row * a.D;
      const T* z = static_cast<const T*>(a.z) + row * a.z_stride;
      p.xh[k] = in ? *reinterpret_cast<const uint4*>(xh + u * E) : make_uint4(0u, 0u, 0u, 0u);
      p.z[k] = in ? *reinterpret_cast<const uint4*>(z + u * E) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Normalises one row from a lane's pieces and writes it, with `w` the
// weight of the lane's columns; `sum` adds the lanes' shares of the row's
// sum of squares over the lanes that hold the row.
template <typename T, int UNITS, bool GATED, typename Sum>
__device__ __forceinline__ void norm_row(Pieces<UNITS, GATED>& p, const Args& a, long row,
                                         Lane l, const float4 (&w)[UNITS][16 / sizeof(T) / 4],
                                         const float (&ds)[GATED ? UNITS : 1][16 / sizeof(T)],
                                         Sum& sum) {
  constexpr int E = 16 / sizeof(T), H = E / 4;
  float acc[UNITS];
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    acc[k] = 0.f;
    T* e = reinterpret_cast<T*>(&p.a[k]);
    if constexpr (GATED) {
      const T* xh = reinterpret_cast<const T*>(&p.xh[k]);
      const T* z = reinterpret_cast<const T*>(&p.z[k]);
#pragma unroll
      for (int j = 0; j < E; ++j)      // a unit past the row holds zeros: gate(0,0,.,0) = 0
        e[j] = from_float<T>(gate<T>(to_float(e[j]), to_float(xh[j]), ds[k][j], to_float(z[j])));
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float f = to_float(e[j]);
      acc[k] += f * f;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) ss += acc[k];
  const float r = rsqrtf(sum(ss) / a.D + a.eps);
  T* out = static_cast<T*>(a.out) + row * a.D;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
    if (u < l.units) {
      const float* wk = reinterpret_cast<const float*>(&w[k][0]);
      const T* e = reinterpret_cast<const T*>(&p.a[k]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j) oe[j] = from_float<T>(to_float(e[j]) * r * wk[j]);
      *reinterpret_cast<uint4*>(out + u * E) = o;
    }
  }
}

// The row kernel's sum of a row's squares: shuffles within a warp, then
// the row's warps add their sums in one order behind one named barrier (two
// slots by row parity), so every lane of the row gets the same value.
struct RowSum {
  float* part;   // 2 x MAX_WARPS
  int log_warps, parity;
  __device__ __forceinline__ float operator()(float ss) {
    ss = repro::warp_sum(ss);
    if (log_warps > 0) {
      const int warp = threadIdx.x >> 5, group = warp >> log_warps;
      if ((threadIdx.x & 31) == 0) part[parity * MAX_WARPS + warp] = ss;
      repro::named_barrier(1 + group, 32 << log_warps);
      ss = 0.f;
      for (int i = group << log_warps; i < (group + 1) << log_warps; ++i)
        ss += part[parity * MAX_WARPS + i];
      parity ^= 1;
    }
    return ss;
  }
};

// The weight of a lane's columns, float32, loaded once for every row it takes.
template <typename T, int UNITS>
__device__ __forceinline__ void lane_weight(float4 (&wr)[UNITS][16 / sizeof(T) / 4],
                                            const float* __restrict__ w, Lane l) {
  constexpr int H = 16 / sizeof(T) / 4;
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
#pragma unroll
    for (int h = 0; h < H; ++h)
      wr[k][h] = u < l.units ? w4[u * H + h] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// d_skip of a lane's columns, cast to the input type as torch casts it.
template <typename T, int UNITS>
__device__ __forceinline__ void lane_skip(float (&ds)[UNITS][16 / sizeof(T)], const Args& a,
                                          Lane l) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {        // one division a piece: P may not divide E
    const int col = min(l.first + k * l.step, l.units - 1) * E;
    int head = col / a.P, c = col - head * a.P;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      ds[k][j] = rnd<T>(a.d_skip[head]);
      if (++c == a.P) c = 0, ++head;
    }
  }
}

// Rows of 2^log_warps warps each, `blockDim.x / 32 >> log_warps` row
// groups a block, grid-stride over the rows.
template <typename T, int UNITS, bool GATED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rmsnorm_rows_kernel(Args a, int log_warps) {
  constexpr int E = 16 / sizeof(T), H = E / 4;
  __shared__ float part[2 * MAX_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x >> (5 + log_warps);
  const Lane l{((warp & ((1 << log_warps) - 1)) << 5) + lane, 32 << log_warps, a.D / E};
  const long stride = static_cast<long>(gridDim.x) * groups;
  long row = static_cast<long>(blockIdx.x) * groups + (warp >> log_warps);

  Pieces<UNITS, GATED> p0, p1;
  if (row < a.rows) load_row<T>(p0, a, row, l);
  float4 w[UNITS][H];                        // for every row the lane takes
  lane_weight<T>(w, a.w, l);
  float ds[GATED ? UNITS : 1][E];
  if constexpr (GATED) lane_skip<T>(ds, a, l);

  RowSum sum{part, log_warps, 0};
  while (row < a.rows) {   // two buffers: the next row loads while this one is normalised
    long next = row + stride;
    if (next < a.rows) load_row<T>(p1, a, next, l);
    norm_row<T>(p0, a, row, l, w, ds, sum);
    row = next;
    if (row >= a.rows) break;
    next = row + stride;
    if (next < a.rows) load_row<T>(p0, a, next, l);
    norm_row<T>(p1, a, row, l, w, ds, sum);
    row = next;
  }
}

// A block a row, element by element, in two passes.
template <typename T, bool GATED>
__global__ void rmsnorm_wide_kernel(Args a) {
  const long row = blockIdx.x;
  const T* x = static_cast<const T*>(a.x) + row * a.D;
  auto elem = [&](int i) -> float {
    if constexpr (GATED)
      return gate<T>(to_float(x[i]), to_float(static_cast<const T*>(a.xh)[row * a.D + i]),
                     rnd<T>(a.d_skip[i / a.P]),
                     to_float(static_cast<const T*>(a.z)[row * a.z_stride + i]));
    else
      return to_float(x[i]);
  };
  float ss = 0.f;
  for (int i = threadIdx.x; i < a.D; i += blockDim.x) {
    const float v = elem(i);
    ss += v * v;
  }
  const float r = rsqrtf(repro::block_sum(ss) / a.D + a.eps);
  T* out = static_cast<T*>(a.out) + row * a.D;
  for (int i = threadIdx.x; i < a.D; i += blockDim.x) out[i] = from_float<T>(elem(i) * r * a.w[i]);
}

__global__ void empty_kernel() {}

template <typename T, int UNITS, bool GATED>
int launch_rows(const Args& a, int warps, int groups, int blocks, cudaStream_t stream) {
  rmsnorm_rows_kernel<T, UNITS, GATED><<<blocks, groups * warps * 32, 0, stream>>>(
      a, __builtin_ctz(warps));
  return static_cast<int>(cudaGetLastError());
}

// -- rows held across a thread-block cluster ------------------------------

constexpr int MAX_CTAS = 8;                          // a cluster, the portable most
constexpr int CLUSTER_SLOTS = MAX_CTAS * MAX_WARPS;  // a warp's pair of sums each
// a cluster kernel's CTA at most: 16 warps, at the row kernel's 128
// registers a thread (8 warps, two CTAs an SM; or 16, one)
constexpr int CLUSTER_THREADS = 2 * THREADS;

// The cluster kernels' reduction of a row's sums (a, b) over the `ctas`
// CTAs of a cluster that hold the row: shuffles within a warp; then lane r
// of each warp puts the warp's pair into slot (rank * warps + warp) of
// CTA r's shared memory (distributed shared memory), one cluster barrier
// (a CTA's barrier where the cluster is one CTA), and every warp adds the
// ctas * warps slots of its own CTA in one order (lane i slots i and i +
// 32, then shuffles), so every lane of the cluster gets the same value.
// Two sets of slots by row parity: a set is written again two rows on,
// after the barrier of the row between, which each CTA reaches only after
// it has read the set.
struct ClusterSums {
  float2* slots;   // this CTA's, 2 x CLUSTER_SLOTS
  int ctas, rank, parity;
  __device__ __forceinline__ float2 operator()(float a, float b) {
    a = repro::warp_sum(a);
    b = repro::warp_sum(b);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    if (CLUSTER_ABLATE & 1) return make_float2(a, b);
    float2* set = slots + parity * CLUSTER_SLOTS;
    if (lane < ctas)
      cg::this_cluster().map_shared_rank(set, lane)[rank * warps + warp] = make_float2(a, b);
    repro::cluster_sync();
    const int n = ctas * warps;
    const float2 s0 = lane < n ? set[lane] : make_float2(0.f, 0.f);
    const float2 s1 = lane + 32 < n ? set[lane + 32] : make_float2(0.f, 0.f);
    parity ^= 1;
    return make_float2(repro::warp_sum(s0.x + s1.x), repro::warp_sum(s0.y + s1.y));
  }
};

// The cluster kernels' reduction of one sum: `ClusterSums` with b = 0.
struct ClusterSum {
  ClusterSums sums;
  __device__ __forceinline__ float operator()(float ss) { return sums(ss, 0.f).x; }
};

// A row held across the `ctas` CTAs of a cluster (CTAs of 8 warps, or one
// of 16), in the row kernel's registers: a lane's pieces (16-byte unit
// `rank * blockDim + tid + k * blockDim * ctas`), loaded before the sum and
// written from the same registers; its columns' weight and d_skip resident;
// the next row's loads in flight while this one is reduced and written;
// the row's sum through `ClusterSum`.  The clusters walk the rows
// grid-stride.
template <typename T, int UNITS, bool GATED>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1) rmsnorm_cluster_kernel(Args a) {
  constexpr int E = 16 / sizeof(T), H = E / 4;
  __shared__ float2 slots[2 * CLUSTER_SLOTS];
  const int ctas = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const Lane l{rank * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x),
               static_cast<int>(blockDim.x) * ctas, a.D / E};
  const long stride = gridDim.x / ctas;
  long row = blockIdx.x / ctas;

  Pieces<UNITS, GATED> p0, p1;
  if (row < a.rows) load_row<T>(p0, a, row, l);
  float4 w[UNITS][H];
  lane_weight<T>(w, a.w, l);
  float ds[GATED ? UNITS : 1][E];
  if constexpr (GATED) lane_skip<T>(ds, a, l);
  repro::cluster_sync();   // every CTA of the cluster runs before its slots are written

  ClusterSum sum{{slots, ctas, rank, 0}};
  while (row < a.rows) {   // two buffers: the next row loads while this one is normalised
    long next = row + stride;
    if (next < a.rows) load_row<T>(p1, a, next, l);
    norm_row<T>(p0, a, row, l, w, ds, sum);
    row = next;
    if (row >= a.rows) break;
    next = row + stride;
    if (next < a.rows) load_row<T>(p0, a, next, l);
    norm_row<T>(p1, a, row, l, w, ds, sum);
    row = next;
  }
}

// The launch of `clusters` clusters of `ctas` CTAs of `threads` threads.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int clusters, int ctas, int threads, cudaStream_t stream) {
    cfg.gridDim = dim3(clusters * ctas);
    cfg.blockDim = dim3(threads);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Lowers `clusters` to the clusters of `kernel` that the card holds at once
// (cudaOccupancyMaxActiveClusters, asked once a kernel, device, cluster
// and block size), so that the grid is one wave; the clusters walk the
// rows grid-stride.
template <typename Kernel>
cudaError_t fit_clusters(Kernel kernel, int ctas, int threads, int& clusters) {
  if (ctas == 1) return cudaSuccess;   // a CTA a row: the plan's grid
  struct Fit {
    const void* kernel;
    int device, ctas, threads, clusters;
  };
  static std::mutex lock;
  static std::vector<Fit> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  int fit = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Fit& f : known)
      if (f.kernel == key && f.device == device && f.ctas == ctas && f.threads == threads)
        fit = f.clusters;
  }
  if (fit == 0) {
    ClusterLaunch l(1, ctas, threads, nullptr);
    if ((err = cudaOccupancyMaxActiveClusters(&fit, kernel, &l.cfg)) != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    std::lock_guard<std::mutex> hold(lock);
    known.push_back({key, device, ctas, threads, fit});
  }
  clusters = clusters < fit ? clusters : fit;
  return cudaSuccess;
}

// Launches `kernel` on `clusters` clusters of `ctas` CTAs, lowered by
// `fit_clusters` (and set to the number launched); `ctas` 1: a CTA a row,
// no cluster, `clusters` CTAs.  No fallback: a refused launch returns its
// error.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int ctas, int threads, int& clusters,
                           cudaStream_t stream, Args... args) {
  if (ctas < 1 || ctas > MAX_CTAS || threads > CLUSTER_THREADS ||
      ctas * threads / 32 > CLUSTER_SLOTS || clusters < 1)
    return cudaErrorInvalidValue;
  if (ctas == 1) {   // a CTA a row: no cluster
    kernel<<<clusters, threads, 0, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaError_t err = fit_clusters(kernel, ctas, threads, clusters);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(clusters, ctas, threads, stream);
  if ((err = cudaLaunchKernelEx(&l.cfg, kernel, args...)) != cudaSuccess) return err;
  return cudaGetLastError();
}

// The lanes of `ctas` CTAs of `warps` warps, `units` pieces of E elements
// each, hold a row of D.
bool holds(int units, int warps, int ctas, int E, int D) {
  return static_cast<long>(units) * 32 * warps * ctas * E >= D;
}

template <typename T, bool GATED>
int launch_cluster_rows(const Args& a, int warps, int units, int blocks, int ctas,
                        cudaStream_t stream) {
  if (warps > CLUSTER_THREADS / 32 || !holds(units, warps, ctas, 16 / sizeof(T), a.D))
    return static_cast<int>(cudaErrorInvalidValue);
  int clusters = blocks / ctas;
  switch (units) {
    case 1: return static_cast<int>(launch_cluster(rmsnorm_cluster_kernel<T, 1, GATED>, ctas,
                                                   warps * 32, clusters, stream, a));
    case 2: return static_cast<int>(launch_cluster(rmsnorm_cluster_kernel<T, 2, GATED>, ctas,
                                                   warps * 32, clusters, stream, a));
    case 4:
      if constexpr (!GATED)
        return static_cast<int>(launch_cluster(rmsnorm_cluster_kernel<T, 4, false>, ctas,
                                               warps * 32, clusters, stream, a));
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// warps 0: the wide kernel; ctas > 1 or warps > 8: the cluster kernel, a
// row on `ctas` CTAs of `warps` warps, `blocks / ctas` clusters at most (as
// many as the card holds at once); else the row kernel with the plan's
// units, warps a row, row groups a block and blocks (rmsnorm.norm_plan).
// No fallback: a refused launch returns its error.
template <typename T, bool GATED>
int launch(const Args& a, int warps, int units, int groups, int blocks, int ctas, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (warps == 0) {
    int threads = (a.D + 31) / 32 * 32;
    threads = threads > 1024 ? 1024 : threads;
    rmsnorm_wide_kernel<T, GATED><<<a.rows, threads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (ctas > 1 || warps > MAX_WARPS)
    return launch_cluster_rows<T, GATED>(a, warps, units, blocks, ctas, s);
  if (ctas != 1 || (warps & (warps - 1)) || groups * warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (units) {
    case 1: return launch_rows<T, 1, GATED>(a, warps, groups, blocks, s);
    case 2: return launch_rows<T, 2, GATED>(a, warps, groups, blocks, s);
    case 4: if constexpr (!GATED) return launch_rows<T, 4, false>(a, warps, groups, blocks, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- the backward pass ------------------------------------------------------
//
// The gradient of the function `_rmsnorm_kernel` computes (the JAX package
// has no backward kernel; it differentiates its composed tiers).  With r =
// rsqrt(mean(x^2) + eps) in float32 and g the output's gradient:
//   dx = r (g w) - x r^3 mean(g w x),   dw = sum over rows of g x r.
// Bound on the H100: bytes (x and g read, dx written, once each; the
// partial rows of dw are a few MB): 0.030 ms at (8192, 2048) bf16.
//
// rmsnorm_bwd_rows_kernel, for the rows the forward's row kernel takes,
// in its layout (`rmsnorm.norm_bwd_plan`: `norm_plan` for two inputs a
// piece, at most 2 pieces each a lane):
//  - A lane holds its 16-byte pieces of x and of g in registers, and issues
//    all their loads, and those of its columns' weight (once, resident),
//    before it reduces; each row is read once, and the next row's pieces
//    are in flight while this one is reduced and written.
//  - sum(x^2) and sum(g w x) are reduced together: shuffles within a warp,
//    then one named barrier a row across the row's warps.
//  - dx is written from the same registers.
//  - A lane's float32 share of dw stays in registers: its columns are the
//    same in every row it takes.  At the end the block adds its row
//    groups' shares in group order in shared memory and writes one partial
//    row.
// rmsnorm_bwd_cluster_kernel, for aligned rows that 8 warps of two pieces
// do not hold (past 4096 bf16 columns: the training of nemotron-4-15b,
// deepseek-coder-33b, internvl2-26b, the llama4 decoders and jamba; at most
// 8 CTAs of 8 warps of two pieces, 32768), the same layout on more warps
// (`rmsnorm.cluster_plan`): one CTA of 16 warps a row (one an SM, at the
// same 128 registers a thread) where it holds the row (to 8192 bf16) and
// there are at least as many rows as SMs; else the row on a thread-block
// cluster of the fewest CTAs of 8 warps that hold it, twice as many below
// the SM count.  A lane's pieces, weight and dw share live in registers as
// above; the row's two sums go warp -> CTA -> cluster through (distributed)
// shared memory, one cluster barrier a row (`ClusterSums`); the clusters
// walk the rows grid-stride, as many as the card holds at once
// (`fit_clusters`), and each writes one partial row of dw (its CTAs'
// columns are disjoint).  It replaces the wide kernel there, which read
// each element with a 2-byte load, twice: at (8192, 5120-8192) bf16 on the
// H100, 73-83% of the bound (PERF.md).  Its loads and stores alone
// (CLUSTER_ABLATE 3) take 76-80% of the bound; a CTA of 16 warps beats two
// of 8 (60-75%), whose exchange crosses SMs.  Three designs measured
// slower: each row brought into L2 ahead by a bulk prefetch; a ring of
// shared-memory stages filled by bulk copies, 2-6 rows ahead; and the sums
// sent one way, by remote mbarrier arrivals, with no cluster barrier.
// Rows off 16 bytes or past the cluster take rmsnorm_bwd_kernel: a block
// walks rows grid-stride, one at a time, element by element, in two passes
// (the second from L1/L2), the block's partial of dw in shared memory.
// rmsnorm_dw_kernel: dw = the partial rows summed in a fixed order.  No
// atomics: two calls on the same inputs give the same bits.

constexpr int BWD_UNITS = 2;   // 16-byte pieces of x (and of g) a lane, at most
constexpr int FOLD_FLOATS = MAX_WARPS * 32 * BWD_UNITS * 8;   // the widest row groups' dw

template <typename T, int UNITS>
__device__ __forceinline__ void load_pieces(uint4 (&x)[UNITS], uint4 (&g)[UNITS],
                                            const T* __restrict__ xs, const T* __restrict__ gs,
                                            long row, int D, Lane l) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
    const bool in = u < l.units;
    x[k] = in ? *reinterpret_cast<const uint4*>(xs + row * D + u * E) : make_uint4(0u, 0u, 0u, 0u);
    g[k] = in ? *reinterpret_cast<const uint4*>(gs + row * D + u * E) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A row's sums (a, b) from each lane's share: shuffles within a warp, then
// the row's warps add theirs in one order behind one named barrier (two
// slots by row parity), so every lane of the row gets the same value.
__device__ __forceinline__ float2 row_sums(float a, float b, float2* part, int log_warps,
                                           int& parity) {
  a = repro::warp_sum(a);
  b = repro::warp_sum(b);
  if (log_warps > 0) {
    const int warp = threadIdx.x >> 5, group = warp >> log_warps;
    if ((threadIdx.x & 31) == 0) part[parity * MAX_WARPS + warp] = make_float2(a, b);
    repro::named_barrier(1 + group, 32 << log_warps);
    a = b = 0.f;
    for (int i = group << log_warps; i < (group + 1) << log_warps; ++i) {
      const float2 p = part[parity * MAX_WARPS + i];
      a += p.x;
      b += p.y;
    }
    parity ^= 1;
  }
  return make_float2(a, b);
}

// The row kernels' reduction of a row's sums: `row_sums` over its row group.
struct GroupSums {
  float2* part;
  int log_warps, parity;
  __device__ __forceinline__ float2 operator()(float a, float b) {
    return row_sums(a, b, part, log_warps, parity);
  }
};


// dx of one row from a lane's pieces, and the lane's share of dw.
template <typename T, int UNITS, typename Sums>
__device__ __forceinline__ void bwd_row(const uint4 (&x)[UNITS], const uint4 (&g)[UNITS],
                                        T* __restrict__ dx, long row, int D, float eps, Lane l,
                                        const float4 (&w)[UNITS][16 / sizeof(T) / 4],
                                        float (&dw)[UNITS][16 / sizeof(T)], Sums& sums) {
  constexpr int E = 16 / sizeof(T);
  float ss = 0.f, gwx = 0.f;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const T* xe = reinterpret_cast<const T*>(&x[k]);
    const T* ge = reinterpret_cast<const T*>(&g[k]);
    const float* wk = reinterpret_cast<const float*>(&w[k][0]);
    float a = 0.f, c = 0.f;   // a sum a piece: short chains
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float xf = to_float(xe[j]);
      a += xf * xf;
      c += to_float(ge[j]) * wk[j] * xf;
    }
    ss += a;
    gwx += c;
  }
  const float2 t = sums(ss, gwx);
  const float r = rsqrtf(t.x / D + eps), c = r * r * r * t.y / D;
  T* out = dx + row * D;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
    if (u < l.units) {
      const T* xe = reinterpret_cast<const T*>(&x[k]);
      const T* ge = reinterpret_cast<const T*>(&g[k]);
      const float* wk = reinterpret_cast<const float*>(&w[k][0]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float xf = to_float(xe[j]), gf = to_float(ge[j]);
        oe[j] = from_float<T>(r * gf * wk[j] - xf * c);
        dw[k][j] += gf * xf * r;
      }
      *reinterpret_cast<uint4*>(out + u * E) = o;
    }
  }
}

// Rows of 2^log_warps warps each, `blockDim.x / 32 >> log_warps` row
// groups a block, grid-stride over the rows; dw_part: a row a block.
template <typename T, int UNITS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ dw_part, int rows, int D, float eps,
                            int log_warps) {
  constexpr int E = 16 / sizeof(T), H = E / 4;
  __shared__ float2 part[2 * MAX_WARPS];
  __shared__ float fold[FOLD_FLOATS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x >> (5 + log_warps), group = warp >> log_warps;
  const Lane l{((warp & ((1 << log_warps) - 1)) << 5) + lane, 32 << log_warps, D / E};
  const long stride = static_cast<long>(gridDim.x) * groups;
  long row = static_cast<long>(blockIdx.x) * groups + group;

  uint4 x0[UNITS], g0[UNITS], x1[UNITS], g1[UNITS];
  if (row < rows) load_pieces<T>(x0, g0, x, g, row, D, l);
  float4 wr[UNITS][H];
  lane_weight<T>(wr, w, l);
  float dw[UNITS][E];
#pragma unroll
  for (int k = 0; k < UNITS; ++k)
#pragma unroll
    for (int j = 0; j < E; ++j) dw[k][j] = 0.f;

  GroupSums sums{part, log_warps, 0};
  while (row < rows) {   // two buffers: the next row loads while this one is reduced
    long next = row + stride;
    if (next < rows) load_pieces<T>(x1, g1, x, g, next, D, l);
    bwd_row<T>(x0, g0, dx, row, D, eps, l, wr, dw, sums);
    row = next;
    if (row >= rows) break;
    next = row + stride;
    if (next < rows) load_pieces<T>(x0, g0, x, g, next, D, l);
    bwd_row<T>(x1, g1, dx, row, D, eps, l, wr, dw, sums);
    row = next;
  }

  // the block's row groups' shares of dw, added in group order
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
    if (u < l.units) {
#pragma unroll
      for (int j = 0; j < E; ++j) fold[group * D + u * E + j] = dw[k][j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < groups; ++i) s += fold[i * D + c];
    dw_part[static_cast<long>(blockIdx.x) * D + c] = s;
  }
}

// Writes a lane's float32 share of its columns (E a piece) into `out`, the
// cluster's partial row: the cluster's lanes hold disjoint columns.
template <int UNITS, int E>
__device__ __forceinline__ void store_share(float* __restrict__ out, const float (&v)[UNITS][E],
                                            Lane l) {
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    const int u = l.first + k * l.step;
    if (u < l.units) {
#pragma unroll
      for (int j = 0; j < E; j += 4)
        *reinterpret_cast<float4*>(out + u * E + j) =
            make_float4(v[k][j], v[k][j + 1], v[k][j + 2], v[k][j + 3]);
    }
  }
}

// A row of the gradient held across the `ctas` CTAs of a cluster (CTAs of
// 8 warps, or one of 16; `ClusterSums`); the clusters walk the rows
// grid-stride; dw_part: a row a cluster.
template <typename T, int UNITS>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
    rmsnorm_bwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               const T* __restrict__ g, T* __restrict__ dx,
                               float* __restrict__ dw_part, int rows, int D, float eps) {
  constexpr int E = 16 / sizeof(T), H = E / 4;
  __shared__ float2 slots[2 * CLUSTER_SLOTS];
  const int ctas = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const Lane l{rank * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x),
               static_cast<int>(blockDim.x) * ctas, D / E};
  const long stride = gridDim.x / ctas, cluster = blockIdx.x / ctas;
  long row = cluster;

  uint4 x0[UNITS], g0[UNITS], x1[UNITS], g1[UNITS];
  if (row < rows) load_pieces<T>(x0, g0, x, g, row, D, l);
  float4 wr[UNITS][H];
  lane_weight<T>(wr, w, l);
  float dw[UNITS][E];
#pragma unroll
  for (int k = 0; k < UNITS; ++k)
#pragma unroll
    for (int j = 0; j < E; ++j) dw[k][j] = 0.f;
  repro::cluster_sync();   // every CTA of the cluster runs before its slots are written

  ClusterSums sums{slots, ctas, rank, 0};
  auto step = [&](const uint4 (&xs)[UNITS], const uint4 (&gs)[UNITS], long r) {
    if constexpr ((CLUSTER_ABLATE & 2) != 0) {
      sums(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < UNITS; ++k)
        if (l.first + k * l.step < l.units)
          *reinterpret_cast<uint4*>(dx + r * D + (l.first + k * l.step) * E) = make_uint4(
              xs[k].x ^ gs[k].x, xs[k].y ^ gs[k].y, xs[k].z ^ gs[k].z, xs[k].w ^ gs[k].w);
    } else {
      bwd_row<T>(xs, gs, dx, r, D, eps, l, wr, dw, sums);
    }
  };
  while (row < rows) {   // two buffers: the next row loads while this one is reduced
    long next = row + stride;
    if (next < rows) load_pieces<T>(x1, g1, x, g, next, D, l);
    step(x0, g0, row);
    row = next;
    if (row >= rows) break;
    next = row + stride;
    if (next < rows) load_pieces<T>(x0, g0, x, g, next, D, l);
    step(x1, g1, row);
    row = next;
  }
  store_share(dw_part + cluster * D, dw, l);
}

// The pair (a, b) summed over the block; every thread gets both.  The
// leading barrier lets the buffer be reused from one row to the next.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 partial[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = repro::warp_sum(a);
  b = repro::warp_sum(b);
  __syncthreads();
  if (lane == 0) partial[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
    t.x += partial[i].x;
    t.y += partial[i].y;
  }
  return t;
}

template <typename T>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                   const T* __restrict__ g, T* __restrict__ dx,
                                   float* __restrict__ dw_part, int rows, int D, float eps) {
  extern __shared__ float acc[];   // this block's sum of g x r, a column a float
  for (int i = threadIdx.x; i < D; i += blockDim.x) acc[i] = 0.f;
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    float ss = 0.f, gwx = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xf = to_float(xr[i]);
      ss += xf * xf;
      gwx += to_float(gr[i]) * w[i] * xf;
    }
    const float2 t = block_sum2(ss, gwx);
    const float r = rsqrtf(t.x / D + eps);
    const float c = r * r * r * t.y / D;
    T* dxr = dx + row * D;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xf = to_float(xr[i]), gf = to_float(gr[i]);
      dxr[i] = from_float<T>(r * gf * w[i] - xf * c);
      acc[i] += gf * xf * r;
    }
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    dw_part[static_cast<long>(blockIdx.x) * D + i] = acc[i];
}

// dw = the partial rows summed in a fixed order: a block takes 32 columns
// and 8 slices of the rows (slice j: rows j, j + 8, ...), then adds its
// slices in order.
__global__ void __launch_bounds__(256)
rmsnorm_dw_kernel(const float* __restrict__ dw_part, float* __restrict__ dw, int parts, int D) {
  __shared__ float slice[8][33];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5, col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < D) {
#pragma unroll 4
    for (int p = j; p < parts; p += 8) s += dw_part[static_cast<long>(p) * D + col];
  }
  slice[j][lane] = s;
  __syncthreads();
  if (j == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += slice[i][lane];
    dw[col] = t;
  }
}

constexpr int BWD_THREADS = 256;



// warps 0: the wide kernel on `blocks` blocks; ctas > 1 or warps > 8: the
// cluster kernel, a row on `ctas` CTAs of `warps` warps, `blocks / ctas`
// clusters at most; else the row kernel with the plan's units, warps a row,
// row groups a block and blocks (rmsnorm.norm_bwd_plan).  dw_part: float32
// (blocks / ctas, D): a partial row a block, or a cluster.
template <typename T>
int launch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw_part, void* dw,
               int rows, int D, float eps, int warps, int units, int groups, int blocks,
               int ctas, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const float* wt = static_cast<const float*>(w);
  T* dxt = static_cast<T*>(dx);
  float* part = static_cast<float*>(dw_part);
  cudaError_t err = cudaSuccess;
  int parts = blocks;   // partial rows of dw
  if (warps == 0) {
    const size_t smem = sizeof(float) * D;
    if ((err = repro::allow_shared(rmsnorm_bwd_kernel<T>, smem)) != cudaSuccess)
      return static_cast<int>(err);
    rmsnorm_bwd_kernel<T><<<blocks, BWD_THREADS, smem, s>>>(xt, wt, gt, dxt, part, rows, D, eps);
  } else if (ctas > 1 || warps > MAX_WARPS) {
    if (warps > CLUSTER_THREADS / 32 || (units != 1 && units != 2) ||
        !holds(units, warps, ctas, 16 / sizeof(T), D))
      return static_cast<int>(cudaErrorInvalidValue);
    parts = blocks / ctas;
    err = units == 1
              ? launch_cluster(rmsnorm_bwd_cluster_kernel<T, 1>, ctas, warps * 32, parts, s, xt,
                               wt, gt, dxt, part, rows, D, eps)
              : launch_cluster(rmsnorm_bwd_cluster_kernel<T, 2>, ctas, warps * 32, parts, s, xt,
                               wt, gt, dxt, part, rows, D, eps);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    if (warps > MAX_WARPS || (warps & (warps - 1)) || groups * warps > MAX_WARPS ||
        groups * D > FOLD_FLOATS)
      return static_cast<int>(cudaErrorInvalidValue);
    const int threads = groups * warps * 32, log_warps = __builtin_ctz(warps);
    if (units == 1)
      rmsnorm_bwd_rows_kernel<T, 1><<<blocks, threads, 0, s>>>(xt, wt, gt, dxt, part, rows, D,
                                                                eps, log_warps);
    else if (units == 2)
      rmsnorm_bwd_rows_kernel<T, 2><<<blocks, threads, 0, s>>>(xt, wt, gt, dxt, part, rows, D,
                                                                eps, log_warps);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dw_kernel<<<(D + 31) / 32, 256, 0, s>>>(part, static_cast<float*>(dw), parts, D);
  return static_cast<int>(cudaGetLastError());
}

// -- the gated form's backward ---------------------------------------------
//
// For out = rmsnorm(u, w), u = (y + xh * ds) * silu(z) rounded as the
// forward rounds (ds = d_skip in the input type), and the output gradient g:
//   du = rnd(r (g w) - u r^3 mean(g w u)),   dw = sum over rows of g u r,
//   dy = rnd(du s), s = rnd(silu(z)),   dxh = rnd(dy ds),
//   dz = rnd(rnd(du g1) silu'(z)), g1 = rnd(y + rnd(xh ds)), silu'(z) =
//   sig (1 + z (1 - sig)), sig = sigmoid(z),
//   dd_skip = sum over rows and a head's P columns of dy xh,
// rounded where autograd of the op-by-op torch body rounds; dw and dd_skip
// are float32 sums.  Bound on the H100: bytes (y, xh, z and g read, dy, dxh
// and dz written, once each: 7 x 2 x 8192 x 2048 = 235 MB): 0.070 ms at
// mamba2-370m's 8192 rows of 2048 bf16.
//
// rmsnorm_gated_bwd_rows_kernel, for rows the row layout takes: the
// backward's (`rmsnorm.norm_bwd_plan`, gated), one 16-byte piece of each of
// the four inputs a lane (8 warps a row at D 2048 bf16), the next row's
// pieces in flight while this one is reduced; the gate is recomputed from
// y, xh and z in registers; u's two sums go through `row_sums`; a lane's
// float32 shares of dw and of dd_skip's columns stay in registers and are
// folded into one partial row each a block at the end.  Two blocks an SM,
// at the 128-register cap with 4 bytes of spill.  At mamba2-370m's rows
// its loads and stores alone (GATED_BWD_NO_MATH) take 85% of its time
// (`probes.train_bwd`); two redesigns ran slower: rows by bulk copies into
// a ring of three stages, three blocks an SM; and g1 and silu(z) kept
// packed with sigmoid(z) computed again after the row's sums, which ended
// the spill but added to the element arithmetic (roundings to the input
// type, exponentials and reciprocals).
// rmsnorm_gated_bwd_cluster_kernel, for aligned rows past 8 warps (2048
// bf16 columns) up to 8 CTAs of 8 warps (16384: jamba's Mamba2 norm, whose
// wide kernel kept two float32 partials a column in shared memory, 128 KB
// a block at 16384, so one block of 8 warps an SM, and computed the gate
// in both its passes): the row kernel's layout on a CTA of 16 warps or a
// cluster of CTAs, as rmsnorm_bwd_cluster_kernel takes them; a lane's dw
// and dd_skip shares go straight from registers to its cluster's partial
// rows.  At jamba's (4096, 16384) bf16, 8 CTAs a row and 30 clusters (the
// card's most at once), it takes 67-68% of its bound; its loads and stores
// alone 81%; 4 CTAs of 16 warps a row ran slower (PERF.md).  Rows off 16
// bytes or past the cluster take rmsnorm_gated_bwd_kernel: a block walks
// rows, element by element, two passes a row.  Then one launch,
// rmsnorm_gated_tail_kernel, sums the partial rows (one a block or a
// cluster) a column in a fixed order (dw, and dd_skip's columns) and
// d_skip's gradient over each head's columns: a block a head (or a few
// narrow heads), no atomics.

struct GatedBwdArgs {
  const void *y, *xh, *z, *g;   // g (rows, D) contiguous; z rows z_stride apart
  const float *d_skip, *w;
  void *dy, *dxh, *dz;          // contiguous
  float *dw_part, *dd_part;     // (blocks, D): a block's partial row of dw, of dd_skip a column
  long z_stride;
  int rows, D, P;
  float eps;
};

// One element's gate from y, xh, z and ds (in the input type): g1, s =
// silu(z) as the forward rounds them, and sigmoid(z)
template <typename T>
__device__ __forceinline__ void gate_parts(float y, float xh, float ds, float z, float& g1,
                                           float& s, float& sig) {
  const float e = __expf(-z);
  g1 = rnd<T>(y + rnd<T>(xh * ds));
  s = rnd<T>(__fdividef(z, 1.f + e));
  sig = __fdividef(1.f, 1.f + e);
}

// The outputs of one element from its gate parts, the row's r and c, its
// weight and ds; adds its shares of dw and dd_skip.
template <typename T>
__device__ __forceinline__ void gate_grads(float g1, float s, float sig, float z, float xh,
                                           float gf, float wv, float ds, float r, float c,
                                           T& dy, T& dxh, T& dz, float& dw, float& dd) {
  const float u = rnd<T>(g1 * s);
  const float du = rnd<T>(r * gf * wv - u * c);
  const float dyv = rnd<T>(du * s);
  dw += gf * u * r;
  dd += dyv * xh;
  dy = from_float<T>(dyv);
  dxh = from_float<T>(dyv * ds);
  dz = from_float<T>(rnd<T>(du * g1) * sig * (1.f + z * (1.f - sig)));
}

template <typename T>
__device__ __forceinline__ void load_gated(uint4 (&p)[4], const GatedBwdArgs& a, long row,
                                           Lane l) {
  constexpr int E = 16 / sizeof(T);
  const bool in = l.first < l.units;
  const long o = row * a.D + l.first * E;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  p[0] = in ? *reinterpret_cast<const uint4*>(static_cast<const T*>(a.y) + o) : zero;
  p[1] = in ? *reinterpret_cast<const uint4*>(static_cast<const T*>(a.xh) + o) : zero;
  p[2] = in ? *reinterpret_cast<const uint4*>(static_cast<const T*>(a.z) + row * a.z_stride +
                                              l.first * E)
            : zero;
  p[3] = in ? *reinterpret_cast<const uint4*>(static_cast<const T*>(a.g) + o) : zero;
}

// One row from a lane's piece of each input (one piece a lane).
template <typename T, typename Sums>
__device__ __forceinline__ void gated_bwd_row(const uint4 (&p)[4], const GatedBwdArgs& a,
                                              long row, Lane l, const float (&w)[16 / sizeof(T)],
                                              const float (&ds)[16 / sizeof(T)],
                                              float (&dw)[16 / sizeof(T)],
                                              float (&dd)[16 / sizeof(T)], Sums& sums) {
  constexpr int E = 16 / sizeof(T);
  const T* y = reinterpret_cast<const T*>(&p[0]);
  const T* xh = reinterpret_cast<const T*>(&p[1]);
  const T* z = reinterpret_cast<const T*>(&p[2]);
  const T* g = reinterpret_cast<const T*>(&p[3]);
  float g1[E], s[E], sig[E], ss = 0.f, guw = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) {   // a piece past the row holds zeros: its gate is 0
    gate_parts<T>(to_float(y[j]), to_float(xh[j]), ds[j], to_float(z[j]), g1[j], s[j], sig[j]);
    const float u = rnd<T>(g1[j] * s[j]);
    ss += u * u;
    guw += to_float(g[j]) * w[j] * u;
  }
  const float2 t = sums(ss, guw);
  const float r = rsqrtf(t.x / a.D + a.eps), c = r * r * r * t.y / a.D;
  if (l.first < l.units) {
    uint4 o[3];
    T* dy = reinterpret_cast<T*>(&o[0]);
    T* dxh = reinterpret_cast<T*>(&o[1]);
    T* dz = reinterpret_cast<T*>(&o[2]);
#pragma unroll
    for (int j = 0; j < E; ++j)
      gate_grads<T>(g1[j], s[j], sig[j], to_float(z[j]), to_float(xh[j]), to_float(g[j]), w[j],
                    ds[j], r, c, dy[j], dxh[j], dz[j], dw[j], dd[j]);
    const long at = row * a.D + l.first * E;
    *reinterpret_cast<uint4*>(static_cast<T*>(a.dy) + at) = o[0];
    *reinterpret_cast<uint4*>(static_cast<T*>(a.dxh) + at) = o[1];
    *reinterpret_cast<uint4*>(static_cast<T*>(a.dz) + at) = o[2];
  }
}

// Rows of 2^log_warps warps each, `blockDim.x / 32 >> log_warps` row
// groups a block, grid-stride over the rows.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    rmsnorm_gated_bwd_rows_kernel(const GatedBwdArgs a, int log_warps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float2 part[2 * MAX_WARPS];
  __shared__ float fold[FOLD_FLOATS];     // the row groups' dw, then their dd_skip columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = blockDim.x >> (5 + log_warps), group = warp >> log_warps;
  const Lane l{((warp & ((1 << log_warps) - 1)) << 5) + lane, 32 << log_warps, a.D / E};
  const long stride = static_cast<long>(gridDim.x) * groups;
  long row = static_cast<long>(blockIdx.x) * groups + group;

  uint4 p0[4], p1[4];
  if (row < a.rows) load_gated<T>(p0, a, row, l);
  float w[E], ds[E], dw[E], dd[E];
  {
    const int col = min(l.first, l.units - 1) * E;
    int head = col / a.P, c = col - head * a.P;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      w[j] = l.first < l.units ? a.w[col + j] : 0.f;
      ds[j] = rnd<T>(a.d_skip[head]);
      dw[j] = dd[j] = 0.f;
      if (++c == a.P) c = 0, ++head;
    }
  }

  GroupSums sums{part, log_warps, 0};
  auto step = [&](const uint4 (&p)[4], long r) {
    if constexpr (GATED_BWD_NO_MATH) {
      if (l.first < l.units) {
        const long o = r * a.D + l.first * E;
        *reinterpret_cast<uint4*>(static_cast<T*>(a.dy) + o) = p[0];
        *reinterpret_cast<uint4*>(static_cast<T*>(a.dxh) + o) = p[1];
        *reinterpret_cast<uint4*>(static_cast<T*>(a.dz) + o) = p[2];
      }
    } else {
      gated_bwd_row<T>(p, a, r, l, w, ds, dw, dd, sums);
    }
  };
  while (row < a.rows) {   // two buffers: the next row loads while this one is reduced
    long next = row + stride;
    if (next < a.rows) load_gated<T>(p1, a, next, l);
    step(p0, row);
    row = next;
    if (row >= a.rows) break;
    next = row + stride;
    if (next < a.rows) load_gated<T>(p0, a, next, l);
    step(p1, row);
    row = next;
  }

  // the block's row groups' shares, added in group order
  const int span = groups * a.D;
  if (l.first < l.units) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      fold[group * a.D + l.first * E + j] = dw[j];
      fold[span + group * a.D + l.first * E + j] = dd[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.D; c += blockDim.x) {
    float sw = 0.f, sd = 0.f;
    for (int i = 0; i < groups; ++i) {
      sw += fold[i * a.D + c];
      sd += fold[span + i * a.D + c];
    }
    a.dw_part[static_cast<long>(blockIdx.x) * a.D + c] = sw;
    a.dd_part[static_cast<long>(blockIdx.x) * a.D + c] = sd;
  }
}

// A row of the gated gradient held across the `ctas` CTAs of a cluster
// (CTAs of 8 warps, or one of 16; one piece of each input a lane;
// `ClusterSums`); the clusters walk the rows grid-stride; dw_part,
// dd_part: a row a cluster.
template <typename T>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
    rmsnorm_gated_bwd_cluster_kernel(const GatedBwdArgs a) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float2 slots[2 * CLUSTER_SLOTS];
  const int ctas = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const Lane l{rank * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x),
               static_cast<int>(blockDim.x) * ctas, a.D / E};
  const long stride = gridDim.x / ctas, cluster = blockIdx.x / ctas;
  long row = cluster;

  uint4 p0[4], p1[4];
  if (row < a.rows) load_gated<T>(p0, a, row, l);
  float w[E], ds[E], dw[1][E], dd[1][E];
  {
    const int col = min(l.first, l.units - 1) * E;
    int head = col / a.P, c = col - head * a.P;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      w[j] = l.first < l.units ? a.w[col + j] : 0.f;
      ds[j] = rnd<T>(a.d_skip[head]);
      dw[0][j] = dd[0][j] = 0.f;
      if (++c == a.P) c = 0, ++head;
    }
  }
  repro::cluster_sync();   // every CTA of the cluster runs before its slots are written

  ClusterSums sums{slots, ctas, rank, 0};
  auto step = [&](const uint4 (&p)[4], long r) {
    if constexpr ((CLUSTER_ABLATE & 2) != 0) {
      sums(0.f, 0.f);
      if (l.first < l.units) {
        const long o = r * a.D + l.first * E;
        *reinterpret_cast<uint4*>(static_cast<T*>(a.dy) + o) = make_uint4(
            p[0].x ^ p[3].x, p[0].y ^ p[3].y, p[0].z ^ p[3].z, p[0].w ^ p[3].w);
        *reinterpret_cast<uint4*>(static_cast<T*>(a.dxh) + o) = p[1];
        *reinterpret_cast<uint4*>(static_cast<T*>(a.dz) + o) = p[2];
      }
    } else {
      gated_bwd_row<T>(p, a, r, l, w, ds, dw[0], dd[0], sums);
    }
  };
  while (row < a.rows) {   // two buffers: the next row loads while this one is reduced
    long next = row + stride;
    if (next < a.rows) load_gated<T>(p1, a, next, l);
    step(p0, row);
    row = next;
    if (row >= a.rows) break;
    next = row + stride;
    if (next < a.rows) load_gated<T>(p0, a, next, l);
    step(p1, row);
    row = next;
  }
  store_share(a.dw_part + cluster * a.D, dw, l);
  store_share(a.dd_part + cluster * a.D, dd, l);
}

template <typename T>
__global__ void rmsnorm_gated_bwd_kernel(const GatedBwdArgs a) {
  extern __shared__ float acc[];   // this block's dw a column, then its dd_skip a column
  for (int i = threadIdx.x; i < 2 * a.D; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  const T* ys = static_cast<const T*>(a.y);
  const T* xs = static_cast<const T*>(a.xh);
  const T* zs = static_cast<const T*>(a.z);
  const T* gs = static_cast<const T*>(a.g);
  for (long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long o = row * a.D, oz = row * a.z_stride;
    float ss = 0.f, guw = 0.f;
    for (int i = threadIdx.x; i < a.D; i += blockDim.x) {
      float g1, s, sig;
      gate_parts<T>(to_float(ys[o + i]), to_float(xs[o + i]), rnd<T>(a.d_skip[i / a.P]),
                    to_float(zs[oz + i]), g1, s, sig);
      const float u = rnd<T>(g1 * s);
      ss += u * u;
      guw += to_float(gs[o + i]) * a.w[i] * u;
    }
    const float2 t = block_sum2(ss, guw);
    const float r = rsqrtf(t.x / a.D + a.eps), c = r * r * r * t.y / a.D;
    for (int i = threadIdx.x; i < a.D; i += blockDim.x) {
      const float ds = rnd<T>(a.d_skip[i / a.P]), xh = to_float(xs[o + i]);
      const float z = to_float(zs[oz + i]);
      float g1, s, sig;
      gate_parts<T>(to_float(ys[o + i]), xh, ds, z, g1, s, sig);
      gate_grads<T>(g1, s, sig, z, xh, to_float(gs[o + i]), a.w[i], ds, r, c,
                    static_cast<T*>(a.dy)[o + i], static_cast<T*>(a.dxh)[o + i],
                    static_cast<T*>(a.dz)[o + i], acc[i], acc[a.D + i]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.D; i += blockDim.x) {
    a.dw_part[static_cast<long>(blockIdx.x) * a.D + i] = acc[i];
    a.dd_part[static_cast<long>(blockIdx.x) * a.D + i] = acc[a.D + i];
  }
}

// dw, and dd_skip, from the partial rows: block b takes heads [b hpb, (b +
// 1) hpb) and their columns, 32 at a time, each summed over 32 slices of the
// parts (slice j: parts j, j + 32, ...) added in order; the dd_skip columns
// go to shared memory, and one thread a head adds its P of them in order.
constexpr int TAIL_SLICES = 32;
__global__ void __launch_bounds__(TAIL_SLICES * 32)
rmsnorm_gated_tail_kernel(const float* __restrict__ dw_part, const float* __restrict__ dd_part,
                          float* __restrict__ dw, float* __restrict__ dd, int parts, int D,
                          int H, int P, int hpb) {
  extern __shared__ float colsum[];   // hpb * P: this block's dd_skip columns
  __shared__ float slice[2][TAIL_SLICES][33];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int h0 = blockIdx.x * hpb, h1 = min(H, h0 + hpb), c0 = h0 * P, c1 = h1 * P;
  for (int base = c0; base < c1; base += 32) {
    const int col = base + lane;
    float sw = 0.f, sd = 0.f;
    if (col < c1) {
#pragma unroll 4
      for (int p = j; p < parts; p += TAIL_SLICES) {
        sw += dw_part[static_cast<long>(p) * D + col];
        sd += dd_part[static_cast<long>(p) * D + col];
      }
    }
    slice[0][j][lane] = sw;
    slice[1][j][lane] = sd;
    __syncthreads();
    if (j == 0 && col < c1) {
      float tw = 0.f, td = 0.f;
#pragma unroll
      for (int i = 0; i < TAIL_SLICES; ++i) {
        tw += slice[0][i][lane];
        td += slice[1][i][lane];
      }
      dw[col] = tw;
      colsum[col - c0] = td;
    }
    __syncthreads();
  }
  for (int h = h0 + threadIdx.x; h < h1; h += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < P; ++c) s += colsum[(h - h0) * P + c];
    dd[h] = s;
  }
}

constexpr int GATED_PASS_ROWS = 1, GATED_PASS_TAIL = 2;

// warps 0: the wide kernel on `blocks` blocks; ctas > 1 or warps > 8: the
// cluster kernel, a row on `ctas` CTAs of `warps` warps (one piece a lane),
// `blocks / ctas` clusters at most; else the row kernel (one piece a lane) with the
// plan's warps a row, row groups a block and blocks; then the tail (hpb
// heads a block) over the partial rows, one a block or a cluster.  passes:
// which of the two launch.
template <typename T>
int launch_gated_bwd(const GatedBwdArgs& a, float* dw, float* dd, int H, int hpb, int warps,
                     int units, int groups, int blocks, int ctas, int passes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  int parts = blocks;
  if (warps != 0 && (ctas > 1 || warps > MAX_WARPS)) {
    if (units != 1 || warps > CLUSTER_THREADS / 32 || !holds(1, warps, ctas, 16 / sizeof(T), a.D))
      return static_cast<int>(cudaErrorInvalidValue);
    parts = blocks / ctas;
    err = passes & GATED_PASS_ROWS
              ? launch_cluster(rmsnorm_gated_bwd_cluster_kernel<T>, ctas, warps * 32, parts, s, a)
              : fit_clusters(rmsnorm_gated_bwd_cluster_kernel<T>, ctas, warps * 32, parts);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (passes & GATED_PASS_ROWS) {
    if (warps == 0) {
      const size_t smem = 2 * sizeof(float) * a.D;
      if ((err = repro::allow_shared(rmsnorm_gated_bwd_kernel<T>, smem)) != cudaSuccess)
        return static_cast<int>(err);
      rmsnorm_gated_bwd_kernel<T><<<blocks, BWD_THREADS, smem, s>>>(a);
    } else {
      if (units != 1 || warps > MAX_WARPS || (warps & (warps - 1)) ||
          groups * warps > MAX_WARPS || 2 * groups * a.D > FOLD_FLOATS)
        return static_cast<int>(cudaErrorInvalidValue);
      rmsnorm_gated_bwd_rows_kernel<T><<<blocks, groups * warps * 32, 0, s>>>(
          a, __builtin_ctz(warps));
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & GATED_PASS_TAIL) {
    const size_t smem = sizeof(float) * hpb * a.P;
    if (hpb < 1 || (err = repro::allow_shared(rmsnorm_gated_tail_kernel, smem)) != cudaSuccess)
      return static_cast<int>(hpb < 1 ? cudaErrorInvalidValue : err);
    rmsnorm_gated_tail_kernel<<<(H + hpb - 1) / hpb, TAIL_SLICES * 32, smem, s>>>(
        a.dw_part, a.dd_part, dw, dd, parts, a.D, H, a.P, hpb);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace


#define RMSNORM_ENTRY(SUFFIX, T)                                                               \
  extern "C" int rmsnorm_##SUFFIX(const void* x, const void* w, void* out, int rows, int D,    \
                                  float eps, int warps, int units, int groups, int blocks,     \
                                  int ctas, void* stream) {                                    \
    const Args a{x, nullptr, nullptr, nullptr, static_cast<const float*>(w), out, 0, rows, D, 1, \
                 eps};                                                                         \
    return launch<T, false>(a, warps, units, groups, blocks, ctas, stream);                    \
  }                                                                                            \
  extern "C" int rmsnorm_gated_##SUFFIX(const void* y, const void* xh, const void* d_skip,     \
                                        const void* z, long z_stride, int P, const void* w,    \
                                        void* out, int rows, int D, float eps, int warps,      \
                                        int units, int groups, int blocks, int ctas,           \
                                        void* stream) {                                        \
    const Args a{y, xh, z, static_cast<const float*>(d_skip), static_cast<const float*>(w),    \
                 out, z_stride, rows, D, P, eps};                                              \
    return launch<T, true>(a, warps, units, groups, blocks, ctas, stream);                     \
  }

RMSNORM_ENTRY(bf16, __nv_bfloat16)
RMSNORM_ENTRY(f32, float)

// dx laid out as x; dw_part float32 (blocks / ctas, D) scratch; dw float32 (D,)
#define RMSNORM_BWD_ENTRY(SUFFIX, T)                                                           \
  extern "C" int rmsnorm_bwd_##SUFFIX(const void* x, const void* w, const void* g, void* dx,   \
                                      void* dw_part, void* dw, int rows, int D, float eps,     \
                                      int warps, int units, int groups, int blocks, int ctas,  \
                                      void* stream) {                                          \
    return launch_bwd<T>(x, w, g, dx, dw_part, dw, rows, D, eps, warps, units, groups, blocks, \
                         ctas, stream);                                                        \
  }

RMSNORM_BWD_ENTRY(bf16, __nv_bfloat16)
RMSNORM_BWD_ENTRY(f32, float)

// dy, dxh laid out as y; dz (rows, D) contiguous; dw_part, dd_part float32
// (blocks / ctas, D) scratch; dw (D,), dd (H,) float32; hpb: heads a tail block;
// passes: 1 the rows, 2 the tail
#define RMSNORM_GATED_BWD_ENTRY(SUFFIX, T)                                                     \
  extern "C" int rmsnorm_gated_bwd_##SUFFIX(                                                   \
      const void* y, const void* xh, const void* d_skip, const void* z, long z_stride, int P,  \
      const void* w, const void* g, void* dy, void* dxh, void* dz, void* dw_part,              \
      void* dd_part, void* dw, void* dd, int rows, int D, float eps, int H, int hpb,           \
      int warps, int units, int groups, int blocks, int ctas, int passes, void* stream) {     \
    const GatedBwdArgs a{y, xh, z, g, static_cast<const float*>(d_skip),                       \
                         static_cast<const float*>(w), dy, dxh, dz,                            \
                         static_cast<float*>(dw_part), static_cast<float*>(dd_part), z_stride, \
                         rows, D, P, eps};                                                     \
    return launch_gated_bwd<T>(a, static_cast<float*>(dw), static_cast<float*>(dd), H, hpb,    \
                               warps, units, groups, blocks, ctas, passes, stream);            \
  }

RMSNORM_GATED_BWD_ENTRY(bf16, __nv_bfloat16)
RMSNORM_GATED_BWD_ENTRY(f32, float)

namespace {

// `fit_clusters` of the cluster kernel that a launch of these arguments takes.
template <typename T>
cudaError_t cluster_fit(int backward, int gated, int units, int ctas, int threads, int& n) {
  if (backward && gated)
    return units == 1 ? fit_clusters(rmsnorm_gated_bwd_cluster_kernel<T>, ctas, threads, n)
                      : cudaErrorInvalidValue;
  if (backward)
    return units == 1   ? fit_clusters(rmsnorm_bwd_cluster_kernel<T, 1>, ctas, threads, n)
           : units == 2 ? fit_clusters(rmsnorm_bwd_cluster_kernel<T, 2>, ctas, threads, n)
                        : cudaErrorInvalidValue;
  if (gated)
    return units == 1   ? fit_clusters(rmsnorm_cluster_kernel<T, 1, true>, ctas, threads, n)
           : units == 2 ? fit_clusters(rmsnorm_cluster_kernel<T, 2, true>, ctas, threads, n)
                        : cudaErrorInvalidValue;
  return units == 1   ? fit_clusters(rmsnorm_cluster_kernel<T, 1, false>, ctas, threads, n)
         : units == 2 ? fit_clusters(rmsnorm_cluster_kernel<T, 2, false>, ctas, threads, n)
         : units == 4 ? fit_clusters(rmsnorm_cluster_kernel<T, 4, false>, ctas, threads, n)
                      : cudaErrorInvalidValue;
}

}  // namespace

// The clusters of a cluster kernel (the forward or the backward, gated or
// plain, bf16 or float32, `units` pieces a lane) of `ctas` CTAs of
// `threads` threads that the card holds at once, as its launch takes them
// (ctas 1: no bound, the plan's grid); < 0: the error.
extern "C" int rmsnorm_cluster_fit(int backward, int gated, int bf16, int units, int ctas,
                                   int threads) {
  int clusters = 1 << 30;
  const cudaError_t err =
      bf16 ? cluster_fit<__nv_bfloat16>(backward, gated, units, ctas, threads, clusters)
           : cluster_fit<float>(backward, gated, units, ctas, threads, clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// An empty kernel on a given grid, in clusters of `ctas` CTAs where ctas >
// 1: the launch floor a norm's time is held against.
extern "C" int rmsnorm_launch_floor(int blocks, int threads, int ctas, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (ctas > 1) {
    int clusters = blocks / ctas;
    return static_cast<int>(launch_cluster(empty_kernel, ctas, threads, clusters, s));
  }
  empty_kernel<<<blocks, threads, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
