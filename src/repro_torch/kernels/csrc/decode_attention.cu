// Decode attention: one query token per sequence against its (ring) KV
// cache, GQA without repeating the KV heads.
//
//   q (B, H, hd); k_cache, v_cache (B, C, KV, hd); cache_len int32, one
//   value for the batch or one per sequence; out (B, H, hd).
//   Slot idx takes part when idx < cache_len, and with a window also
//   idx >= cache_len - window.  hd <= 128, H / KV <= 8.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (repro/kernels/decode_attention.py).  Bound on the H100: bytes.  Each
// live cache row is read once and meets `rep` query rows, about rep * 4
// operations per 2 bytes, far below the card's ~295 operations per byte;
// the time is the live cache over the memory rate (1.35 us for qwen2.5-3b's
// 4.5 MB at B 8, C 544), so the kernel has to keep the whole card's memory
// system busy: B * KV blocks (16 at that shape, on 132 SMs) cannot.
//
// Design (flash-decoding): the grid is (B * KV, S).  Split s of a (sequence,
// KV head) takes the cache slots [s L, s L + L); L and S come from the host
// (`split_plan` in decode_attention.py, from B, KV, C and the SM count), and
// cache_len is read on the device, so the step needs no host sync.  A split
// wholly at or past cache_len, or wholly before cache_len - window, writes an
// empty partial (m = -inf, l = 0, acc = 0) and goes straight to the merge
// ticket.  A live split streams its rows in stages of 32 slots, key and
// value rows by 16-byte cp.async into shared memory, two stages in flight
// (32 KB at L 64, bf16), the query rows read meanwhile into registers,
// where they stay.  A stage is three steps between barriers, and each
// reads a stage's rows from shared memory once: 8 lanes score a slot
// against every query row, each lane every eighth 16-byte chunk of the key
// row, 3 shuffles summing them (the scale, times log2 e, applied to the
// sum); warp r runs the online softmax of query row r over the stage's 32
// slots, one a lane; each thread adds a quarter of the stage's values into
// two dims of every query row, the quarters summed once at the end.  m, l
// and acc stay float32 and go to a partial buffer (rep x hd floats a block).
// The merge is in the same launch: after a __threadfence each block takes a
// ticket from its (sequence, KV head)'s int32 counter, and the block that
// takes the last one merges the S partials, writes the output and resets
// the counter to 0 for the next call, so a call is one launch.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_REP = 8;       // warp r owns query row r
constexpr int STAGE = 32;        // slots a stage: one a lane in the softmax step
constexpr int STAGES = 2;
constexpr int MAX_SPLITS = 64;   // decode_attention.MAX_SPLITS: the merge walks them in turn

// the key and value stages, rows of `hdp` elements (hd rounded up to whole
// 16-byte chunks); after the last stage they hold the four quarters' sums
template <typename T>
size_t shared_bytes(int hdp) {
  return sizeof(T) * STAGES * 2 * STAGE * hdp;
}

// `rows` cache rows (`stride` elements apart from `src`) into one stage of
// STAGE rows of hdp elements, as cp.async copies the caller commits; the
// stage's other rows are zero.  Without `vec` (hd not a whole number of
// 16-byte chunks, or a base off 16 bytes) the rows are stored element by
// element, synchronously, zero past hd.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, const T* safe, long stride,
                                          int rows, int hd, int hdp, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    const int ch = hdp / VEC;
    for (int i = threadIdx.x; i < STAGE * ch; i += THREADS) {
      const int r = i / ch, c = i - r * ch;
      const bool ok = r < rows;
      repro::cp_async16(dst + r * hdp + c * VEC, ok ? src + r * stride + c * VEC : safe,
                        ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < STAGE * hdp; i += THREADS) {
      const int r = i / hdp, c = i - r * hdp;
      dst[r * hdp + c] = r < rows && c < hd ? src[r * stride + c] : from_float<T>(0.f);
    }
  }
}

// 16 bytes of a row of T from device memory; without `vec`, element by
// element, zero at or past `valid`.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int x = 0; x < VEC; ++x)
    if (x < valid) e[x] = p[x];
  return u;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int x = 0; x < 16 / static_cast<int>(sizeof(T)); ++x) f[x] = to_float(e[x]);
}

// PER: head-dim values a lane of the merge writes, hdp / 32 rounded up to 1,
// 2 or 4; lane l owns [l * PER, l * PER + PER).  In bf16 two blocks fit an
// SM (at most 128 registers a thread): at qwen2.5-3b's serving shapes the
// grid is a little more than one block an SM.
template <typename T, int PER>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ cache_len,
                        int len_stride, T* __restrict__ out, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int* __restrict__ tickets, int C, int KV,
                        int rep, int hd, int hdp, int L, float scale_log2, int window,
                        int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPL = 128 / VEC / 8;               // 16-byte chunks of a row a lane scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);          // [STAGES][STAGE][hdp]
  T* Vs = Ks + STAGES * STAGE * hdp;
  __shared__ float Ss[MAX_REP][STAGE + 1];         // a stage's scores (padded rows)
  __shared__ __align__(16) float Ps[MAX_REP][STAGE];   // and probabilities
  __shared__ float As[MAX_REP];                    // each row's rescale of acc
  __shared__ bool last;

  const int bg = blockIdx.x, b = bg / KV, g = bg - b * KV;
  const int split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int clen = min(max(cache_len[b * len_stride], 0), C);
  const int lo = window > 0 ? max(clen - window, 0) : 0;
  const int beg = max(split * L, lo), end = min(min(split * L + L, C), clen);
  const int H = KV * rep;
  const long row = static_cast<long>(KV) * hd;     // cache row stride
  const T* kb = kc + (static_cast<long>(b) * C * KV + g) * hd;
  const T* vb = vc + (static_cast<long>(b) * C * KV + g) * hd;
  // scores: thread (slot j, chunk lane l8) takes chunks l8 + 8 cc of slot j's
  // key row against every query row; values: thread (dim pair dp, quarter
  // qq) accumulates dims 2 dp, 2 dp + 1 of every query row over the stage's
  // slots 8 qq .. 8 qq + 7
  const int j = tid >> 3, l8 = tid & 7;
  const int dp = tid & 63, qq = tid >> 6, d0 = 2 * dp;

  float m_run = -INFINITY, l_run = 0.f;            // query row `warp`, if warp < rep
  float acc[MAX_REP][2];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r][0] = acc[r][1] = 0.f;

  if (beg < end) {
    const int nst = (end - beg + STAGE - 1) / STAGE;
    for (int i = 0; i < min(nst, STAGES); ++i) {
      const int s0 = beg + i * STAGE;
      load_rows(Ks + i * STAGE * hdp, kb + s0 * row, kb, row, min(STAGE, end - s0), hd, hdp,
                vec);
      load_rows(Vs + i * STAGE * hdp, vb + s0 * row, vb, row, min(STAGE, end - s0), hd, hdp,
                vec);
      repro::cp_async_commit();
    }
    if (nst == 1) repro::cp_async_commit();   // one group a stage ahead, as below
    // this thread's chunks of the query rows, in registers (as stored), read
    // while the first stages are in flight
    uint4 qr[MAX_REP][CPL];
    const T* qg = q + (static_cast<long>(b) * H + g * rep) * hd;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = (l8 + 8 * cc) * VEC;
        qr[r][cc] = r < rep && c < hd ? load_chunk(qg + r * hd + c, hd - c, vec)
                                      : make_uint4(0u, 0u, 0u, 0u);
      }

    for (int i = 0; i < nst; ++i) {
      const int st = i & 1, s0 = beg + i * STAGE, n = min(STAGE, end - s0);
      const T* Kt = Ks + st * STAGE * hdp;
      const T* Vt = Vs + st * STAGE * hdp;
      repro::cp_async_wait<1>();   // all but the newest group: stage i has landed
      __syncthreads();
      // the query chunks stay packed across stages: unpacked once, out of the
      // loop, bf16 rows would take 128 registers and spill
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
          asm volatile("" : "+r"(qr[r][cc].x), "+r"(qr[r][cc].y), "+r"(qr[r][cc].z),
                       "+r"(qr[r][cc].w));

      {  // scores, scaled to log2 units; 3 shuffles sum a slot's 8 lanes
        float s[MAX_REP];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) s[r] = 0.f;
        const uint4* kr = reinterpret_cast<const uint4*>(Kt + j * hdp);
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int c = l8 + 8 * cc;
          if (c * VEC < hdp) {
            float kf[VEC];
            unpack<T>(kr[c], kf);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
              if (r < rep) {
                float qf[VEC];
                unpack<T>(qr[r][cc], qf);
#pragma unroll
                for (int x = 0; x < VEC; ++x) s[r] = fmaf(qf[x], kf[x], s[r]);
              }
            }
          }
        }
        float mine = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          float t = s[r];
          t += __shfl_xor_sync(0xffffffffu, t, 1);
          t += __shfl_xor_sync(0xffffffffu, t, 2);
          t += __shfl_xor_sync(0xffffffffu, t, 4);
          if (r == l8) mine = t;
        }
        if (l8 < rep) Ss[l8][j] = j < n ? mine * scale_log2 : -INFINITY;
      }
      __syncthreads();

      if (warp < rep) {  // warp r: the online softmax step of query row r
        const float sv = Ss[warp][lane];
        const float m_new = fmaxf(m_run, repro::warp_max(sv));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float p = exp2f(sv - base);
        const float alpha = exp2f(m_run - base);
        l_run = l_run * alpha + repro::warp_sum(p);
        m_run = m_new;
        Ps[warp][lane] = p;
        if (lane == 0) As[warp] = alpha;
      }
      __syncthreads();

      if (d0 < hdp) {    // values: rows past n are zero, and their p is 0
        struct alignas(2 * sizeof(T)) Pair { T x, y; };
        float vx[8], vy[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const Pair v2 = *reinterpret_cast<const Pair*>(Vt + (qq * 8 + jj) * hdp + d0);
          vx[jj] = to_float(v2.x);
          vy[jj] = to_float(v2.y);
        }
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r < rep) {
            const float4 p0 = *reinterpret_cast<const float4*>(&Ps[r][qq * 8]);
            const float4 p1 = *reinterpret_cast<const float4*>(&Ps[r][qq * 8 + 4]);
            const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
            float x = acc[r][0] * As[r], y = acc[r][1] * As[r];
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              x = fmaf(pr[jj], vx[jj], x);
              y = fmaf(pr[jj], vy[jj], y);
            }
            acc[r][0] = x;
            acc[r][1] = y;
          }
        }
      }
      __syncthreads();             // stage st, Ss and Ps are free again
      if (i + STAGES < nst) {
        const int s2 = s0 + STAGES * STAGE;
        load_rows(Ks + st * STAGE * hdp, kb + s2 * row, kb, row, min(STAGE, end - s2), hd, hdp,
                  vec);
        load_rows(Vs + st * STAGE * hdp, vb + s2 * row, vb, row, min(STAGE, end - s2), hd, hdp,
                  vec);
      }
      repro::cp_async_commit();    // one group an iteration, empty or not
    }
    repro::cp_async_wait<0>();
    // the four quarters' sums, in the stage buffers (free now)
    float* red = reinterpret_cast<float*>(smem_raw);   // [4][rep][hdp]
    if (d0 < hdp)
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) *reinterpret_cast<float2*>(red + (qq * rep + r) * hdp + d0) =
                         make_float2(acc[r][0], acc[r][1]);
    __syncthreads();
  }

  // this split's partial state; an empty split leaves m = -inf, l = 0, acc = 0
  const long part = static_cast<long>(bg) * S + split;
  const float* red = reinterpret_cast<const float*>(smem_raw);
  for (int i = tid; i < rep * hdp; i += THREADS) {
    const int r = i / hdp, d = i - r * hdp;
    if (d < hd)
      part_acc[(part * rep + r) * hd + d] =
          beg < end ? red[i] + red[rep * hdp + i] + red[2 * rep * hdp + i] +
                          red[3 * rep * hdp + i]
                    : 0.f;
  }
  if (warp < rep && lane == 0) {
    part_ml[(part * rep + warp) * 2] = m_run;
    part_ml[(part * rep + warp) * 2 + 1] = l_run;
  }
  __threadfence();                 // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[bg], 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block merges the S partials of (b, g) in one pass, rescaling
  // as it goes, so every split's loads can be in flight at once; they
  // bypass L1
  if (warp < rep) {
    const int r = warp;
    float mx = -INFINITY, den = 0.f, num[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) num[i] = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const long ps = (static_cast<long>(bg) * S + s) * rep + r;
      const float ms = __ldcg(part_ml + ps * 2), ls = __ldcg(part_ml + ps * 2 + 1);
      float a[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i)
        a[i] = lane * PER + i < hd ? __ldcg(part_acc + ps * hd + lane * PER + i) : 0.f;
      const float m_new = fmaxf(mx, ms);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float f_old = exp2f(mx - base), f_new = exp2f(ms - base);
      den = den * f_old + ls * f_new;
#pragma unroll
      for (int i = 0; i < PER; ++i) num[i] = num[i] * f_old + a[i] * f_new;
      mx = m_new;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    T* ob = out + (static_cast<long>(b) * H + g * rep + r) * hd;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (lane * PER + i < hd) ob[lane * PER + i] = from_float<T>(num[i] * inv);
  }
  if (tid == 0) tickets[bg] = 0;   // ready for the next call
}

template <typename T, int PER>
int launch_per(const void* q, const void* k, const void* v, const void* cache_len,
               int len_per_batch, void* out, void* part_acc, void* part_ml, void* tickets,
               int B, int C, int KV, int rep, int hd, int hdp, int L, int S, float scale,
               int window, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = shared_bytes<T>(hdp);
  cudaError_t err = repro::allow_shared(decode_attention_kernel<T, PER>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = hd % VEC == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  decode_attention_kernel<T, PER>
      <<<dim3(B * KV, S), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(cache_len), len_per_batch ? 1 : 0, static_cast<T*>(out),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml),
          static_cast<int*>(tickets), C, KV, rep, hd, hdp, L, scale * 1.4426950408889634f,
          window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len,
           int len_per_batch, void* out, void* part_acc, void* part_ml, void* tickets, int B,
           int C, int H, int KV, int hd, int L, int S, float scale, int window, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int rep = H / KV;
  if (rep > MAX_REP || hd > 128 || S < 1 || S > MAX_SPLITS || L < 1 ||
      static_cast<long>(L) * S < C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hdp = (hd + VEC - 1) / VEC * VEC;
  if (hdp <= 32)
    return launch_per<T, 1>(q, k, v, cache_len, len_per_batch, out, part_acc, part_ml, tickets,
                            B, C, KV, rep, hd, hdp, L, S, scale, window, stream);
  if (hdp <= 64)
    return launch_per<T, 2>(q, k, v, cache_len, len_per_batch, out, part_acc, part_ml, tickets,
                            B, C, KV, rep, hd, hdp, L, S, scale, window, stream);
  return launch_per<T, 4>(q, k, v, cache_len, len_per_batch, out, part_acc, part_ml, tickets,
                          B, C, KV, rep, hd, hdp, L, S, scale, window, stream);
}

}  // namespace

// part_acc: float32 (B * KV, S, rep, hd); part_ml: float32 (B * KV, S, rep, 2);
// tickets: int32 (B * KV), all 0 between calls.  L * S >= C.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* cache_len, int len_per_batch, void* out,
                                     void* part_acc, void* part_ml, void* tickets, int B, int C,
                                     int H, int KV, int hd, int L, int S, float scale,
                                     int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_len, len_per_batch, out, part_acc, part_ml,
                               tickets, B, C, H, KV, hd, L, S, scale, window, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* cache_len, int len_per_batch, void* out,
                                    void* part_acc, void* part_ml, void* tickets, int B, int C,
                                    int H, int KV, int hd, int L, int S, float scale,
                                    int window, void* stream) {
  return launch<float>(q, k, v, cache_len, len_per_batch, out, part_acc, part_ml, tickets, B,
                       C, H, KV, hd, L, S, scale, window, stream);
}
