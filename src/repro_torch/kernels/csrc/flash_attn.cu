// K13: online-softmax (flash) attention forward, one block per
// (batch x query head, tile of kBQ query rows).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:_attn_kernel
// (pallas_call at :118).  For each query row at absolute position
// qpos = q_offset + row it computes
//
//   s = (q . k) * scale;  s = cap * tanh(s / cap)  (if softcap);
//   mask: kpos < Skv, kpos <= qpos (causal), qpos - kpos < window (window);
//   o = sum_k p_k v_k / sum_k p_k,  p = exp(s - running max), 0 where masked
//
// with the reference's running max m (starting at -1e30, never -inf),
// normaliser l and f32 accumulator, and o = 0 for a row with no valid key
// (l = 0 is read as 1).  GQA: query head hq reads kv head hq / (Hq / Hkv).
//
// Design: four warps per block, kBQ / 4 rows per warp.  The block stages
// the q tile once and one kBK-key tile of K and V at a time in shared
// memory (converted to f32; K rows padded so that the lanes' float4 reads
// of different rows fall in different banks).  Lane l scores key l of the
// tile against each of its warp's rows; the row max and sum are warp
// shuffles; the p row goes through shared memory, and lane l then
// accumulates the output columns l, l + 32, ... of each row in registers.
// Key tiles that lie wholly outside every row's causal band or window are
// skipped: such a tile leaves m, l and the accumulator unchanged in the
// reference too (p = 0, correction exp(0) = 1), so the result is the same.
//
// Bound on this card: 4 hd flops per unmasked (query, key) pair (q.k and
// p.v), against bf16 q, k, v and o read and written once; at hd = 128 and
// thousands of keys per row the flops bound it, at the dense bf16
// tensor-core rate (989 TF/s).  This first version computes on the CUDA
// cores in f32 (67 TF/s at best) with shared-memory operands, so it sits
// far above that bound; tensor cores (mma / wgmma) and TMA are later work.
//
// D (the head size) is a template parameter, 16 or 128; T is float or
// __nv_bfloat16 for q, k, v and o.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lm {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kWarps = 4;
constexpr int kRows = 4;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile: one per lane
constexpr float kNegInf = -1e30f;      // the reference's _NEG_INF

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Mask {
  int Skv, causal, has_window, window, has_cap;
  float scale, cap;
};

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                  int Sq, int q_offset, Mask mk) {
  constexpr int KS = D + 4;            // padded K row (16-byte aligned)
  constexpr int NC = (D + 31) / 32;    // output columns per lane
  __shared__ __align__(16) float qs[kBQ][D];
  __shared__ __align__(16) float ks[kBK][KS];
  __shared__ float vs[kBK][D];
  __shared__ float ps[kWarps][kRows][kBK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bh = blockIdx.y;
  const size_t b = bh / Hq;
  const int hq = static_cast<int>(bh % Hq);
  const size_t kv_row = b * Hkv + hq / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + kv_row * mk.Skv * D;
  const T* vb = v + kv_row * mk.Skv * D;

  for (int idx = tid; idx < kBQ * D; idx += kWarps * 32) {
    const int row = idx / D, c = idx % D;
    qs[row][c] = q0 + row < Sq
                     ? to_f32(qb[static_cast<size_t>(q0 + row) * D + c])
                     : 0.f;
  }

  // keys that some row of this tile may see
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + kBQ, Sq) - 1;
  int khi = mk.Skv;
  if (mk.causal) khi = min(khi, qhi + 1);
  int klo = 0;
  if (mk.has_window) {
    const long long lo = static_cast<long long>(qlo) - mk.window + 1;
    klo = static_cast<int>(max(0LL, min(lo, static_cast<long long>(khi))));
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }

  for (int kt = (klo / kBK) * kBK; kt < khi; kt += kBK) {
    __syncthreads();  // the q tile is staged; the previous K/V tile is read
    for (int idx = tid; idx < kBK * D; idx += kWarps * 32) {
      const int key = idx / D, c = idx % D;
      const bool in = kt + key < mk.Skv;
      const size_t at = static_cast<size_t>(kt + key) * D + c;
      ks[key][c] = in ? to_f32(kb[at]) : 0.f;
      vs[key][c] = in ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane][c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[warp * kRows + r][c]);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_offset + q0 + warp * kRows + r;
      float sv = s[r] * mk.scale;
      if (mk.has_cap) sv = mk.cap * tanhf(sv / mk.cap);
      bool ok = kpos < mk.Skv;
      if (mk.causal) ok = ok && kpos <= qpos;
      if (mk.has_window)
        ok = ok && static_cast<long long>(qpos) - kpos < mk.window;
      sv = ok ? sv : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      ps[warp][r][lane] = p;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] *= corr;
    }
    __syncwarp();
    for (int key = 0; key < kBK; ++key) {
      float pk[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pk[r] = ps[warp][r][key];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          const float vv = vs[key][c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(pk[r], vv, acc[r][j]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= Sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < D)
        o[(bh * Sq + row) * D + c] = from_f32<T>(acc[r][j] * inv);
    }
  }
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int Hq,
             int Hkv, int Sq, int Skv, int d, float scale, int causal,
             int has_window, int window, int has_cap, float cap,
             int q_offset, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + kBQ - 1) / kBQ,
                  static_cast<unsigned>(B) * static_cast<unsigned>(Hq));
  const Mask mk{Skv, causal, has_window, window, has_cap, scale, cap};
  switch (d) {
    case 16:
      flash_attn_kernel<16, T><<<grid, kWarps * 32, 0, s>>>(
          q, k, v, o, Hq, Hkv, Sq, q_offset, mk);
      break;
    case 128:
      flash_attn_kernel<128, T><<<grid, kWarps * 32, 0, s>>>(
          q, k, v, o, Hq, Hkv, Sq, q_offset, mk);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lm

// q, o: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d); all in the library's dtype,
// contiguous, on `stream`.  window and cap are read only where has_window
// and has_cap are set.  Returns cudaGetLastError() after the launch (0 on
// success).
#ifdef NEKBONE_REAL_F32
extern "C" int flash_attn_f32(const float* q, const float* k, const float* v,
                              float* o, int B, int Hq, int Hkv, int Sq,
                              int Skv, int d, float scale, int causal,
                              int has_window, int window, int has_cap,
                              float cap, int q_offset, void* stream) {
  return lm::dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, scale,
                             causal, has_window, window, has_cap, cap,
                             q_offset, stream);
}
#endif

#ifdef NEKBONE_REAL_BF16
extern "C" int flash_attn_bf16(const __nv_bfloat16* q,
                               const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               int B, int Hq, int Hkv, int Sq, int Skv, int d,
                               float scale, int causal, int has_window,
                               int window, int has_cap, float cap,
                               int q_offset, void* stream) {
  return lm::dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d,
                                     scale, causal, has_window, window,
                                     has_cap, cap, q_offset, stream);
}
#endif
