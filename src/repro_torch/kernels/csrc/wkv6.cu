// K14: the RWKV6 (Finch) WKV recurrence, one block per (batch, head).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py:_wkv6_kernel
// (pallas_call at :143).  Per head, with the state S in R^{d x d} (rows:
// key channel i, columns: value channel j):
//
//   o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// which is the reference's  o_t = r_t S + (r_t . u k_t) v_t,
// S <- diag(w_t) S + k_t^T v_t.  The TPU kernel streamed time blocks past a
// VMEM-resident state, in a sequential or a chunked (three matmuls) body;
// both compute this function, and this one kernel serves both.  On Hopper
// the state lives in registers: thread j of the d-thread block owns column
// j of S (d floats).  The block stages kChunk time steps of r, k, v and w
// (and the bonus u, once) in shared memory; each thread then walks them,
// forming o_t[j] and updating its column.  Any T is handled, T = 1 (a
// decode step) included; the TPU kernel's zero padding of T to its block
// is not needed.
//
// Bound on this card: per token and head it reads r, k, v (2 bytes each in
// bf16) and w (4 bytes) and writes o, 4d^2 flops (2 multiply-adds per state
// entry); at d = 64 that is 16384 flops against 640 bytes, so at the fp32
// peak (67 TF/s) outside the tensor cores the operations, not the bytes,
// bound it.  The design does each state entry's two multiply-adds in a
// register with shared-memory broadcasts of r, k, w, so nothing but the
// inputs and outputs touches device memory.  It is a first, simple
// version: B*H blocks of d threads (128 blocks for rwkv6-1.6b at batch 4,
// on 132 SMs: one block of two warps per SM, poor occupancy), and the time
// loop is serial within a block.
//
// D (the head size) is a template parameter, 16 or 64; T is float or
// __nv_bfloat16 for r, k, v and o; w, u and the state are float.
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

constexpr int kChunk = 32;  // time steps staged per pass

template <int D, typename T>
__global__ void __launch_bounds__(D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ o, float* __restrict__ s_out, int H, int T_len) {
  __shared__ float rs[kChunk][D];
  __shared__ float ks[kChunk][D];
  __shared__ float ws[kChunk][D];
  __shared__ float vs[kChunk][D];
  __shared__ float us[D];

  const int j = threadIdx.x;
  const size_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const size_t seq = bh * static_cast<size_t>(T_len) * D;

  us[j] = u[h * D + j];
  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    S[i] = s0 ? s0[bh * D * D + static_cast<size_t>(i) * D + j] : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int ct = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int t = 0; t < ct; ++t) {
      const size_t at = seq + static_cast<size_t>(t0 + t) * D + j;
      rs[t][j] = to_f32(r[at]);
      ks[t][j] = to_f32(k[at]);
      vs[t][j] = to_f32(v[at]);
      ws[t][j] = w[at];
    }
    __syncthreads();
    for (int t = 0; t < ct; ++t) {
      const float vj = vs[t][j];
      float out = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[t][i] * vj;
        out = fmaf(rs[t][i], fmaf(us[i], kv, S[i]), out);
        S[i] = fmaf(ws[t][i], S[i], kv);
      }
      o[seq + static_cast<size_t>(t0 + t) * D + j] = from_f32<T>(out);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
    s_out[bh * D * D + static_cast<size_t>(i) * D + j] = S[i];
}

template <typename T>
int dispatch(const T* r, const T* k, const T* v, const float* w,
             const float* u, const float* s0, T* o, float* s_out, int B,
             int H, int T_len, int d, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(H);
  switch (d) {
    case 16:
      wkv6_kernel<16, T><<<blocks, 16, 0, s>>>(r, k, v, w, u, s0, o, s_out,
                                               H, T_len);
      break;
    case 64:
      wkv6_kernel<64, T><<<blocks, 64, 0, s>>>(r, k, v, w, u, s0, o, s_out,
                                               H, T_len);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lm

// r, k, v, o: (B, H, T, d) in the library's dtype; w: (B, H, T, d) float;
// u: (H, d) float; s0 (or null for a zero state), s_out: (B, H, d, d)
// float.  All contiguous, on `stream`.  Returns cudaGetLastError() after
// the launch (0 on success).
#ifdef NEKBONE_REAL_F32
extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0,
                        float* o, float* s_out, int B, int H, int T, int d,
                        void* stream) {
  return lm::dispatch<float>(r, k, v, w, u, s0, o, s_out, B, H, T, d, stream);
}
#endif

#ifdef NEKBONE_REAL_BF16
extern "C" int wkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const float* w,
                         const float* u, const float* s0, __nv_bfloat16* o,
                         float* s_out, int B, int H, int T, int d,
                         void* stream) {
  return lm::dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B, H, T, d,
                                     stream);
}
#endif
