// K14: the RWKV6 (Finch) WKV recurrence, split over column tiles and row
// groups of each head's state.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py:_wkv6_kernel
// (pallas_call at :143).  Per head, with the state S in R^{d x d} (rows:
// key channel i, columns: value channel j):
//
//   o_t[j] = sum_i r_t[i] S[i][j] + b_t v_t[j],  b_t = sum_i r_t[i] u[i] k_t[i]
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// which is the reference's  o_t = r_t S + (r_t . u k_t) v_t,
// S <- diag(w_t) S + k_t^T v_t.  The TPU kernel streamed time blocks past a
// VMEM-resident state, in a sequential or a chunked (three matmuls) body;
// both compute this function, and this one kernel serves both.
//
// Column j of S and o_t[j] need v[:, j] alone, so the value columns split
// across blocks with no reduction: block (b, h, tile) owns the C columns
// [tile C, tile C + C) of head (b, h), D / C blocks per head.  Inside a
// block the key rows split over G row groups: thread (x, g) holds S[i][j]
// in registers for the D / G rows i of group g and its CPT columns j.  The
// block stages KC time steps (a pass) of r, k, w (all D rows) and v (its C
// columns) in shared memory, upcast to f32; the next pass's inputs are
// loaded into registers, four values a load, while this pass computes.
// For each step thread (x, g) forms its group's partial
// sum_{i in g} r_t[i] S[i][j] (FMAs in ascending i) and updates its
// entries; the partials go to shared memory as [group][step][column], and
// so do the groups' partials of b_t.  At the end of the pass both are
// summed over the groups in the fixed order g = 0, 1, .., then b_t v_t[j]
// is added and o is written.  Per state entry and step a thread does one
// multiply and two FMAs (k v, r S, w S + k v).  The TPU kernel's zero
// padding of T is not needed: any T works, a partial last pass and T = 1 (a
// decode step) included.  ref.wkv6_split_emulated is this arithmetic in
// torch.
//
// Tilings (C, G, CPT, KC) were picked by measurement on the card
// (scripts/k11_k14_compare.py, rwkv6-1.6b's serve shape, batch 4, 32 heads
// of 64): (32, 8, 2, 32) for a prompt, 256 blocks of 128 threads, and
// (32, 16, 2, 1) for a decode step; kernels/wkv6.py names them.
//
// Bound on this card: per token and head it reads r, k, v (2 bytes each in
// bf16) and w (4 bytes) and writes o; 4d^2 flops (2 multiply-adds per state
// entry); at d = 64 that is 16384 flops against 640 bytes, so at the fp32
// peak (67 TF/s) outside the tensor cores the operations, not the bytes,
// bound it.  Three instructions per entry and step are 1.5 x that bound
// before any load; by ablation (scripts/k11_k14_ablation.py) the state
// update, the sums over groups and the staging each take a share of the
// rest.  The chunked tensor-core form is not used.
//
// D (the head size) is a template parameter, 16 or 64, with the tiling;
// T is float or __nv_bfloat16 for r, k, v and o; w, u and the state are
// float.
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

// Shared memory of one block (dynamic), KC time steps staged per pass.
template <int D, int C, int G, int KC>
struct WkvShared {
  __align__(16) float r[KC][D];
  __align__(16) float k[KC][D];
  __align__(16) float w[KC][D];
  __align__(16) float v[KC][C];
  float part[G][KC][C];  // sum_{i in g} r_t[i] S[i][j]
  float bpart[G][KC];    // sum_{i in g} r_t[i] (u[i] k_t[i])
  float u[D];
};

// Four consecutive values of r, k or v in their storage type (one 16- or
// 8-byte load).
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x[4];
};

// One pass's inputs, loaded from device memory into registers while the
// previous pass computes: thread tid takes the groups of four values
// 4 (it NT + tid) of the pass's (steps, D) slab of r, k, w and of its
// (steps, C) slab of v.
template <int D, int C, int NT, int KC, typename T>
struct WkvStage {
  static constexpr int NR = (KC * D / 4 + NT - 1) / NT;
  static constexpr int NV = (KC * C / 4 + NT - 1) / NT;
  Vec4<T> r[NR], k[NR];
  float4 w[NR];
  Vec4<T> v[NV];

  __device__ __forceinline__ void load(const T* __restrict__ rp,
                                       const T* __restrict__ kp,
                                       const T* __restrict__ vp,
                                       const float* __restrict__ wp,
                                       size_t at, int ct, int j0, int tid) {
#pragma unroll
    for (int it = 0; it < NR; ++it) {
      const int x = 4 * (it * NT + tid);
      if (x < ct * D) {
        r[it] = *reinterpret_cast<const Vec4<T>*>(rp + at + x);
        k[it] = *reinterpret_cast<const Vec4<T>*>(kp + at + x);
        w[it] = *reinterpret_cast<const float4*>(wp + at + x);
      }
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int y = 4 * (it * NT + tid);
      if (y < ct * C)
        v[it] = *reinterpret_cast<const Vec4<T>*>(
            vp + at + static_cast<size_t>(y / C) * D + j0 + y % C);
    }
  }

  template <int G>
  __device__ __forceinline__ void store(WkvShared<D, C, G, KC>& sh, int ct,
                                        int tid) const {
#pragma unroll
    for (int it = 0; it < NR; ++it) {
      const int x = 4 * (it * NT + tid);
      if (x < ct * D) {
        const int t = x / D;
        const int i = x % D;
        *reinterpret_cast<float4*>(&sh.r[t][i]) = to_f32x4(r[it]);
        *reinterpret_cast<float4*>(&sh.k[t][i]) = to_f32x4(k[it]);
        *reinterpret_cast<float4*>(&sh.w[t][i]) = w[it];
      }
    }
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int y = 4 * (it * NT + tid);
      if (y < ct * C)
        *reinterpret_cast<float4*>(&sh.v[y / C][y % C]) = to_f32x4(v[it]);
    }
  }

  static __device__ __forceinline__ float4 to_f32x4(const Vec4<T>& a) {
    return make_float4(to_f32(a.x[0]), to_f32(a.x[1]), to_f32(a.x[2]),
                       to_f32(a.x[3]));
  }
};

// The RG staged values of one step's row group, from 16-byte-aligned shared
// memory four at a time where RG allows.
template <int RG>
__device__ __forceinline__ void load_rows(const float* row, float (&out)[RG]) {
  if constexpr (RG % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RG / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(row)[q];
      out[4 * q] = x.x;
      out[4 * q + 1] = x.y;
      out[4 * q + 2] = x.z;
      out[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < RG; ++a) out[a] = row[a];
  }
}

template <int D, int C, int G, int CPT, int KC, typename T>
__global__ void __launch_bounds__(C / CPT * G)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ o, float* __restrict__ s_out, int H, int T_len) {
  constexpr int RG = D / G;
  constexpr int NT = C / CPT * G;
  constexpr int kTiles = D / C;
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  WkvShared<D, C, G, KC>& sh =
      *reinterpret_cast<WkvShared<D, C, G, KC>*>(wkv_smem);

  const int cx = threadIdx.x;
  const int g = threadIdx.y;
  const int tid = g * (C / CPT) + cx;
  const size_t bh = blockIdx.x / kTiles;
  const int j0 = (blockIdx.x % kTiles) * C;
  const int c0 = cx * CPT;  // the thread's first column in the tile
  const int i0 = g * RG;
  const int h = static_cast<int>(bh % H);
  const size_t seq = bh * static_cast<size_t>(T_len) * D;

  for (int i = tid; i < D; i += NT) sh.u[i] = u[h * D + i];
  float S[RG][CPT];
#pragma unroll
  for (int a = 0; a < RG; ++a)
#pragma unroll
    for (int b = 0; b < CPT; ++b)
      S[a][b] = s0 ? s0[bh * D * D + static_cast<size_t>(i0 + a) * D + j0 +
                        c0 + b]
                   : 0.f;

  WkvStage<D, C, NT, KC, T> stage;
  stage.load(r, k, v, w, seq, min(KC, T_len), j0, tid);
  for (int t0 = 0; t0 < T_len; t0 += KC) {
    const int ct = min(KC, T_len - t0);
    __syncthreads();  // the previous pass's staging and partials are read
    stage.template store<G>(sh, ct, tid);
    __syncthreads();
    if (t0 + KC < T_len)  // the next pass's loads fly while this one runs
      stage.load(r, k, v, w, seq + static_cast<size_t>(t0 + KC) * D,
                 min(KC, T_len - t0 - KC), j0, tid);
#pragma unroll 4
    for (int t = 0; t < ct; ++t) {
      float rr[RG], kk[RG], ww[RG], vj[CPT], out[CPT];
      load_rows<RG>(&sh.r[t][i0], rr);
      load_rows<RG>(&sh.k[t][i0], kk);
      load_rows<RG>(&sh.w[t][i0], ww);
      load_rows<CPT>(&sh.v[t][c0], vj);
#pragma unroll
      for (int b = 0; b < CPT; ++b) out[b] = 0.f;
#pragma unroll
      for (int a = 0; a < RG; ++a)
#pragma unroll
        for (int b = 0; b < CPT; ++b) {
          out[b] = fmaf(rr[a], S[a][b], out[b]);
          S[a][b] = fmaf(ww[a], S[a][b], kk[a] * vj[b]);
        }
#pragma unroll
      for (int b = 0; b < CPT; ++b) sh.part[g][t][c0 + b] = out[b];
    }
    // the bonus's group partials, one (step, group) pair per thread
    for (int x = tid; x < ct * G; x += NT) {
      const int t = x / G;
      const int gg = x % G;
      float b = 0.f;
#pragma unroll
      for (int a = 0; a < RG; ++a) {
        const int i = gg * RG + a;
        b = fmaf(sh.r[t][i], sh.u[i] * sh.k[t][i], b);
      }
      sh.bpart[gg][t] = b;
    }
    __syncthreads();
    for (int x = tid; x < ct * C; x += NT) {
      const int t = x / C;
      const int cc = x % C;
      float acc = sh.part[0][t][cc];
      float b = sh.bpart[0][t];
#pragma unroll
      for (int gg = 1; gg < G; ++gg) {
        acc += sh.part[gg][t][cc];
        b += sh.bpart[gg][t];
      }
      acc = fmaf(b, sh.v[t][cc], acc);
      o[seq + static_cast<size_t>(t0 + t) * D + j0 + cc] = from_f32<T>(acc);
    }
  }
#pragma unroll
  for (int a = 0; a < RG; ++a)
#pragma unroll
    for (int b = 0; b < CPT; ++b)
      s_out[bh * D * D + static_cast<size_t>(i0 + a) * D + j0 + c0 + b] =
          S[a][b];
}

template <int D, int C, int G, int CPT, int KC, typename T>
cudaError_t launch(const T* r, const T* k, const T* v, const float* w,
                   const float* u, const float* s0, T* o, float* s_out,
                   int B, int H, int T_len, cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>(B) * static_cast<unsigned>(H) * (D / C);
  constexpr int bytes = sizeof(WkvShared<D, C, G, KC>);
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<D, C, G, CPT, KC, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv6_kernel<D, C, G, CPT, KC, T><<<blocks, dim3(C / CPT, G), bytes, s>>>(
      r, k, v, w, u, s0, o, s_out, H, T_len);
  return cudaGetLastError();
}

// The (d, column tile, row groups, columns per thread, steps per pass)
// instantiations: kernels/wkv6.py's TILES (a prompt) and DECODE_TILES (one
// step).  scripts/k11_k14_compare.py measures others in an edited copy.
#define WKV6_FOR_EACH_TILING(X) \
  X(64, 32, 8, 2, 32) X(64, 32, 16, 2, 1) X(16, 16, 4, 1, 32) X(16, 16, 8, 1, 1)

template <typename T>
int dispatch(const T* r, const T* k, const T* v, const float* w,
             const float* u, const float* s0, T* o, float* s_out, int B,
             int H, int T_len, int d, int col_tile, int row_groups,
             int cols_per_thread, int steps, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WKV6_CASE(D_, C_, G_, CPT_, KC_)                                  \
  if (d == D_ && col_tile == C_ && row_groups == G_ &&                    \
      cols_per_thread == CPT_ && steps == KC_)                            \
    return static_cast<int>(launch<D_, C_, G_, CPT_, KC_, T>(             \
        r, k, v, w, u, s0, o, s_out, B, H, T_len, s));
  WKV6_FOR_EACH_TILING(WKV6_CASE)
#undef WKV6_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lm

// r, k, v, o: (B, H, T, d) in the library's dtype; w: (B, H, T, d) float;
// u: (H, d) float; s0 (or null for a zero state), s_out: (B, H, d, d)
// float.  All contiguous, on `stream`.  (d, col_tile, row_groups) must be
// with cols_per_thread and steps one of WKV6_FOR_EACH_TILING.  Returns cudaGetLastError() after the
// launch (0 on success).
#ifdef NEKBONE_REAL_F32
extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0,
                        float* o, float* s_out, int B, int H, int T, int d,
                        int col_tile, int row_groups, int cols_per_thread,
                        int steps, void* stream) {
  return lm::dispatch<float>(r, k, v, w, u, s0, o, s_out, B, H, T, d,
                             col_tile, row_groups, cols_per_thread, steps,
                             stream);
}
#endif

#ifdef NEKBONE_REAL_BF16
extern "C" int wkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const float* w,
                         const float* u, const float* s0, __nv_bfloat16* o,
                         float* s_out, int B, int H, int T, int d,
                         int col_tile, int row_groups, int cols_per_thread,
                         int steps, void* stream) {
  return lm::dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B, H, T, d,
                                     col_tile, row_groups, cols_per_thread,
                                     steps, stream);
}
#endif
