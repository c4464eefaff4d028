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
// the time is the live cache over the memory rate.
//
// Design: one block per (sequence, KV head), reading cache_len from device
// memory: the loop bound is the live length, so dead slots are never read
// and the step needs no host sync (the counterpart of the TPU's scalar
// prefetch plus pl.when); chunks wholly before the window are skipped the
// same way.  The group's rep query rows sit in shared memory, pre-scaled.
// The block's 8 warps take 32-slot chunks of the live cache in turn and
// work without block barriers: for a chunk each lane scores one slot
// against every query row, the warp runs the online softmax step across
// its lanes (running max and sum per row in float32), and then each lane
// accumulates its slice of the head dim over the chunk's 32 values.  At
// the end the warps' partial softmax states are merged in shared memory.
// This grid has only B * KV blocks (16 at qwen2.5-3b's serving batch of
// 8, on 132 SMs), so the kernel cannot reach the memory rate; splitting
// the cache across blocks (split-KV) is the known next step.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_REP = 8;
constexpr int KVECS = 16;     // 16-byte loads a lane keeps in flight for its key row
constexpr int VROWS = 16;     // value rows whose slices a lane loads before using them

size_t shared_bytes(int rep, int hd) {
  // Q (rep x hd); each warp's running max, sum and accumulators for the
  // merge (WARPS x rep x (hd + 2))
  return sizeof(float) * (rep * hd + WARPS * rep * (hd + 2));
}

// PER: head-dim values a lane accumulates, ceil(hd / 32) rounded up to 1,
// 2 or 4; lane l owns [l * PER, l * PER + PER).
template <typename T, int PER>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ cache_len,
                        int len_stride, T* __restrict__ out, int C, int KV, int rep,
                        int hd, float scale, int window) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Qs = smem;                              // [rep][hd]
  float* Mw = Qs + rep * hd;                     // [WARPS][rep]
  float* Lw = Mw + WARPS * rep;                  // [WARPS][rep]
  float* Aw = Lw + WARPS * rep;                  // [WARPS][rep][hd]

  const int clen = min(max(cache_len[b * len_stride], 0), C);
  const int lo = window > 0 ? max(clen - window, 0) : 0;
  const int H = KV * rep;
  const long row = static_cast<long>(KV) * hd;                // cache row stride
  const T* kb = kc + (static_cast<long>(b) * C * KV + g) * hd;
  const T* vb = vc + (static_cast<long>(b) * C * KV + g) * hd;

  repro::load_tile(Qs, hd, q + (static_cast<long>(b) * H + g * rep) * hd, hd, rep, rep,
                   hd, scale);
  __syncthreads();

  constexpr int VEC = 16 / sizeof(T);
  const bool vec = hd % VEC == 0 && row % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(kb) & 15) == 0;
  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][PER];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = lo / 32 * 32 + warp * 32; k0 < clen; k0 += WARPS * 32) {
    // scores of this lane's slot against every query row
    const int slot = k0 + lane;
    const bool live = slot >= lo && slot < clen;
    float s[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) s[r] = 0.f;
    if (live) {
      const T* kr = kb + slot * row;
      if (vec) {
        // the lane's whole key row in flight at once (up to KVECS 16-byte loads)
        for (int d0 = 0; d0 < hd; d0 += KVECS * VEC) {
          uint4 u[KVECS];
#pragma unroll
          for (int c = 0; c < KVECS; ++c) {
            const int d = d0 + c * VEC;
            u[c] = d < hd ? *reinterpret_cast<const uint4*>(kr + d) : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int c = 0; c < KVECS; ++c) {
            const int d = d0 + c * VEC;
            if (d >= hd) break;
            const T* e = reinterpret_cast<const T*>(&u[c]);
            float kf[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) kf[j] = to_float(e[j]);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
              if (r < rep) {
                const float4* qr = reinterpret_cast<const float4*>(Qs + r * hd + d);
#pragma unroll
                for (int j = 0; j < VEC / 4; ++j) {
                  const float4 qv = qr[j];
                  s[r] += qv.x * kf[4 * j] + qv.y * kf[4 * j + 1] + qv.z * kf[4 * j + 2] +
                          qv.w * kf[4 * j + 3];
                }
              }
            }
          }
        }
      } else {
        for (int d = 0; d < hd; ++d) {
          const float kf = to_float(kr[d]);
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) s[r] += Qs[r * hd + d] * kf;
        }
      }
    }
    // online softmax step over the chunk's 32 slots, per query row
    float p[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      const float sr = live ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], repro::warp_max(sr));
      p[r] = live ? expf(sr - m_new) : 0.f;
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      l[r] = l[r] * alpha + repro::warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[r][i] *= alpha;
    }
    // values: lane accumulates its head-dim slice over the chunk's slots,
    // loading VROWS slots' slices before using any
    const int n = min(32, clen - k0);
    for (int j0 = 0; j0 < n; j0 += VROWS) {
      float vf[VROWS][PER];
#pragma unroll
      for (int j = 0; j < VROWS; ++j) {
        const T* vr = vb + (k0 + j0 + j) * row + lane * PER;
#pragma unroll
        for (int i = 0; i < PER; ++i)
          vf[j][i] = j0 + j < n && lane * PER + i < hd ? to_float(vr[i]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < VROWS; ++j) {
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r < rep) {
            const float pj = __shfl_sync(0xffffffffu, p[r], j0 + j);
#pragma unroll
            for (int i = 0; i < PER; ++i) acc[r][i] += pj * vf[j][i];
          }
        }
      }
    }
  }

  // merge the warps' partial states
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      Mw[warp * rep + r] = m[r];
      Lw[warp * rep + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane * PER + i;
      if (d < hd) Aw[(warp * rep + r) * hd + d] = acc[r][i];
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<long>(b) * H + g * rep) * hd;
  for (int i = tid; i < rep * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, Mw[w * rep + r]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < WARPS; ++w) {
        const float mw = Mw[w * rep + r];
        const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
        num += Aw[(w * rep + r) * hd + d] * f;
        den += Lw[w * rep + r] * f;
      }
    }
    ob[i] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int PER>
int launch_per(const void* q, const void* k, const void* v, const void* cache_len,
               int len_per_batch, void* out, int B, int C, int KV, int rep, int hd,
               float scale, int window, void* stream) {
  const size_t smem = shared_bytes(rep, hd);
  cudaError_t err = repro::allow_shared(decode_attention_kernel<T, PER>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_kernel<T, PER>
      <<<dim3(B, KV), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const int*>(cache_len), len_per_batch ? 1 : 0, static_cast<T*>(out),
          C, KV, rep, hd, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len,
           int len_per_batch, void* out, int B, int C, int H, int KV, int hd,
           float scale, int window, void* stream) {
  const int rep = H / KV;
  if (rep > MAX_REP || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32)
    return launch_per<T, 1>(q, k, v, cache_len, len_per_batch, out, B, C, KV, rep, hd,
                            scale, window, stream);
  if (hd <= 64)
    return launch_per<T, 2>(q, k, v, cache_len, len_per_batch, out, B, C, KV, rep, hd,
                            scale, window, stream);
  return launch_per<T, 4>(q, k, v, cache_len, len_per_batch, out, B, C, KV, rep, hd, scale,
                          window, stream);
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* cache_len, int len_per_batch, void* out,
                                     int B, int C, int H, int KV, int hd, float scale,
                                     int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_len, len_per_batch, out, B, C, H, KV, hd,
                               scale, window, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* cache_len, int len_per_batch, void* out,
                                    int B, int C, int H, int KV, int hd, float scale,
                                    int window, void* stream) {
  return launch<float>(q, k, v, cache_len, len_per_batch, out, B, C, H, KV, hd, scale,
                       window, stream);
}
