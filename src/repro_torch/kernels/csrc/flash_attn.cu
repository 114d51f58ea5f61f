// K13: online-softmax (flash) attention forward, one block per
// (batch x query head, tile of query rows).
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
// Key tiles that lie wholly outside every row's causal band or window are
// skipped: such a tile leaves m, l and the accumulator unchanged in the
// reference too (p = 0, correction exp(0) = 1), so the result is the same.
//
// Bound on this card: 4 hd flops per unmasked (query, key) pair (q.k and
// p.v), against q, k, v and o read and written once; at hd = 128 and
// thousands of keys per row the flops bound it, at the dense bf16
// tensor-core rate (989 TF/s).  Beside the flops, every unmasked pair needs
// one exp (and with a softcap one tanh) on the special-function units, some
// 4 T ops/s on the whole card: about 1 ms for gemma2's global layer at
// batch 2, 6144 tokens, against 0.63 ms of tensor-core flops.
//
// f32 (flash_attn_f32, flash_attn_kernel): four warps per block, 4 rows per
// warp.  The block stages the q tile once and one 32-key tile of K and V at
// a time in dynamic shared memory (converted to f32; K rows padded so that
// the lanes' float4 reads of different rows fall in different banks; 62.5
// KB at hd = 192, past the 48 KB a static array may take).  Lane l
// scores key l of the tile against each of its warp's rows; the row max
// and sum are warp shuffles; the p row goes through shared memory, and
// lane l then accumulates the output columns l, l + 32, ... of each row in
// registers.  It computes on the CUDA cores in f32 (67 TF/s at best): TF32
// keeps 10 bits and cannot meet the f32 tolerance, and no served model
// computes attention in f32 on the card.
//
// bf16 (flash_attn_bf16, flash_attn_tc_kernel): the tensor cores.  One
// block of four warps owns 64 query rows, 16 rows per warp (the m16 of
// mma.sync.m16n8k16), and walks its key tiles of 64 in order.  The grid's
// x is (batch, query head) and its y the query tiles, last tile first, so
// that the tiles of a causal layer with the most keys start first.
// * K and V arrive by cp.async.cg 16-byte copies into a two-stage ring in
//   dynamic shared memory (Q 17 KB, K and V 17 KB each per stage at
//   hd = 128: 85 KB, hence cudaFuncSetAttribute; two blocks of 219
//   registers a thread share an SM up to hd = 128, one block at hd = 192,
//   whose 125 KB leave no room for a second); rows are padded by 8 elements (16
//   bytes), so the 8 rows of an ldmatrix fall in 8 different bank groups;
//   rows past Sq or Skv are zero-filled (src-size 0), never read.  Tile
//   t + 1 is in flight while tile t is computed.
// * S = Q K^T: Q's fragments are loaded once by ldmatrix and kept in
//   registers (at hd = 192 their 48 registers beside the O accumulator's
//   96 spill 64 bytes; loading them again for each key tile spills
//   nothing but runs no faster on an H100, scripts/k1_k2_k13_compare.py);
//   K's by ldmatrix; bf16 x bf16 products are exact in f32, so the scores
//   lose nothing against f32 arithmetic on the same bf16 inputs.
// * The softmax runs in registers on the accumulator layout: a thread holds
//   two rows (g and g + 8 of its warp's 16) and 16 keys of each, the row
//   max and sum are two quad shuffles; scores are kept in log2 units, so
//   exp is one ex2.approx.ftz; the softcap keeps the f32-accurate tanhf
//   (tanh.approx's 2^-11 would move every p by 5e-4 |s|).  The per-element
//   mask is applied only on tiles that cross Skv, the diagonal or the
//   window's edge, as a score of -inf (p = 0, m unchanged).
// * O += P V with P split in two bf16 terms, p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi), each an mma against the same V fragment
//   (ldmatrix.trans), summed in f32: p keeps about 2^-17 of its value.
//   Rounding P once to bf16, as FA2 does, puts up to 2^-8 on each p and
//   some 2e-3 of a typical |o| on the output, with random sign; the card's
//   value-by-value check (one bf16 step of each value plus 1e-5 of max |o|)
//   then fails every output well below the typical size.  The split costs
//   half as many MMAs again (6 hd instead of 4 hd per pair).
//
// D (the head size) is a template parameter of both kernels, 16, 64, 128
// or 192 (NEKBONE_FOR_EACH_HEAD_DIM): 128 is gemma2's, 64 hymba's and
// whisper's, 192 nemotron-4's, 16 the reduced configs'.  The CUDA-core
// kernel takes the storage type T of q, k, v and o as a parameter too, and
// is built for float.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// The head sizes both kernels are instantiated for (kernels/flash_attn.py
// HEAD_DIMS).
#define NEKBONE_FOR_EACH_HEAD_DIM(X) X(16) X(64) X(128) X(192)

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

// Dynamic shared memory of flash_attn_kernel, in floats: the q tile, the K
// tile (rows padded to D + 4), the V tile and the p rows of the warps.
template <int D>
struct F32Smem {
  static constexpr int kKS = D + 4;
  static constexpr int kQ = kBQ * D;
  static constexpr int kK = kBK * kKS;
  static constexpr int kV = kBK * D;
  static constexpr int kP = kWarps * kRows * kBK;
  static constexpr int kBytes = (kQ + kK + kV + kP) * 4;
};

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                  int Sq, int q_offset, Mask mk) {
  using L = F32Smem<D>;
  constexpr int KS = L::kKS;           // padded K row (16-byte aligned)
  constexpr int NC = (D + 31) / 32;    // output columns per lane
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;                // [kBQ][D]
  float* ks = qs + L::kQ;              // [kBK][KS]
  float* vs = ks + L::kK;              // [kBK][D]
  float* ps = vs + L::kV;              // [kWarps][kRows][kBK]

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
    qs[row * D + c] = q0 + row < Sq
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
      ks[key * KS + c] = in ? to_f32(kb[at]) : 0.f;
      vs[key * D + c] = in ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane * KS + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[(warp * kRows + r) * D + c]);
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
      ps[(warp * kRows + r) * kBK + lane] = p;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] *= corr;
    }
    __syncwarp();
    for (int key = 0; key < kBK; ++key) {
      float pk[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pk[r] = ps[(warp * kRows + r) * kBK + key];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          const float vv = vs[key * D + c];
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

template <int D, typename T>
int launch_f32(dim3 grid, const T* q, const T* k, const T* v, T* o, int Hq,
               int Hkv, int Sq, int q_offset, const Mask& mk,
               cudaStream_t s) {
  constexpr int bytes = F32Smem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attn_kernel<D, T><<<grid, kWarps * 32, bytes, s>>>(
      q, k, v, o, Hq, Hkv, Sq, q_offset, mk);
  return static_cast<int>(cudaGetLastError());
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
#define LM_CASE(D) \
  case D:          \
    return launch_f32<D, T>(grid, q, k, v, o, Hq, Hkv, Sq, q_offset, mk, s);
    NEKBONE_FOR_EACH_HEAD_DIM(LM_CASE)
#undef LM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
#ifdef NEKBONE_REAL_BF16
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;       // query rows per block, 16 per warp
constexpr int kBK = 64;                // keys per tile
// Two blocks per SM up to hd = 128 (85 KB of shared memory each at hd =
// 128).  Stating it lets ptxas spend up to 255 registers a thread (it takes
// 219 at hd = 128); left to its own heuristic it stops at 177 and the
// kernel runs a fifth slower on an H100.  At hd = 192 a block takes 125 KB,
// so one fits an SM.
template <int D>
constexpr int kMinBlocks = D <= 128 ? 2 : 1;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory: the q tile, then a ring of two stages, each a K
// tile and a V tile; rows of D + 8 elements (the pad puts the 8 rows of an
// ldmatrix in 8 different banks).
template <int D>
struct Smem {
  static constexpr int kStride = D + 8;
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kTile = kBK * kStride;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kBytes = (kQ + 2 * kStage) * 2;
};

// 2^x by ex2.approx.ftz (2 ulp; 2^-inf = 0, results below 2^-126 are 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) unless `in`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t at) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(at));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t at) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(at));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16x2, x0 in the low half
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) -> bf16x2 of p_hi, and of p_lo = bf16(p - p_hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x0 - f.x, x1 - f.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + rows) of a (limit, D) bf16 matrix into shared memory
// (row stride D + 8); rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int rows, int limit) {
  constexpr int KC = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * KC; idx += kThreads) {
    const int r = idx / KC, ch = idx % KC;
    const bool in = row0 + r < limit;
    const bf16* from =
        src + (in ? static_cast<size_t>(row0 + r) * D + ch * 8 : 0);
    cp_async16(smem_addr(dst + r * Smem<D>::kStride + ch * 8), from, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
flash_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int Hq, int Hkv, int Sq, int q_offset, Mask mk) {
  using L = Smem<D>;
  constexpr int S = L::kStride;
  constexpr int NT = kBK / 8;  // 8-key column tiles of the scores
  constexpr int DT = D / 8;    // 8-wide column tiles of the output
  constexpr int DK = D / 16;   // 16-deep steps of Q K^T
  constexpr int PK = kBK / 16; // 16-deep steps of P V
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + L::kQ;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const size_t bh = blockIdx.x;
  const size_t b = bh / Hq;
  const int hq = static_cast<int>(bh % Hq);
  const size_t kv_row = b * Hkv + hq / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const bf16* qb = q + bh * Sq * D;
  const bf16* kb = k + kv_row * mk.Skv * D;
  const bf16* vb = v + kv_row * mk.Skv * D;

  // keys that some valid row of this tile may see
  const long long qlo = static_cast<long long>(q_offset) + q0;
  const long long qhi =
      static_cast<long long>(q_offset) + min(q0 + kBQ, Sq) - 1;
  long long khi = mk.Skv;
  if (mk.causal) khi = min(khi, qhi + 1);
  long long klo = 0;
  if (mk.has_window) klo = max(0LL, min(qlo - mk.window + 1, khi));
  const int kt0 = static_cast<int>(klo / kBK) * kBK;
  const int ntiles =
      khi > kt0 ? static_cast<int>((khi - kt0 + kBK - 1) / kBK) : 0;

  if (ntiles > 0) {
    load_rows<D>(qs, qb, q0, kBQ, Sq);
    load_rows<D>(ring, kb, kt0, kBK, mk.Skv);
    load_rows<D>(ring + L::kTile, vb, kt0, kBK, mk.Skv);
    cp_async_commit();
  }

  // this thread's rows of its warp's 16: g and g + 8
  const long long qpos0 = qlo + warp * 16 + g;
  // scores in log2 units: x = cap log2(e) tanh(s scale / cap), or
  // s scale log2(e); the running max m is kept in the same units, from the
  // same -1e30 (below every score either way), and a masked score is -inf,
  // which leaves m as the reference's -1e30 does and gives p = 2^-inf = 0.
  const float pre = mk.has_cap ? mk.scale / mk.cap : mk.scale * kLog2e;
  const float post = mk.cap * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[DK][4];

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kt0 + it * kBK;
    if (it + 1 < ntiles) {
      bf16* nx = ring + ((it + 1) & 1) * L::kStage;
      load_rows<D>(nx, kb, kt + kBK, kBK, mk.Skv);
      load_rows<D>(nx + L::kTile, vb, kt + kBK, kBK, mk.Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // K/V tile it (and at it = 0 the q tile) has landed
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * S +
                                      kk * 16 + (lane >> 4) * 8));
    }

    // S = Q K^T: s[j] holds keys 8j + 2c, + 1 of rows g (0, 1), g + 8 (2, 3)
    const bf16* kst = ring + (it & 1) * L::kStage;
    const bf16* vst = kst + L::kTile;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(kst + (j * 8 + (lane & 7) +
                                         (lane >> 4) * 8) * S +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma(s[j], qf[kk], bk[0], bk[1]);
        mma(s[j + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // the online softmax, per element masked only where the tile needs it
    const bool masked = kt + kBK > mk.Skv ||
                        (mk.causal && kt + kBK - 1 > qlo) ||
                        (mk.has_window && qhi - kt >= mk.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * pre;
        if (mk.has_cap) x = post * tanhf(x);
        if (masked) {
          const long long qpos = qpos0 + (e >> 1) * 8;
          const int kpos = kt + j * 8 + 2 * c + (e & 1);
          bool in = kpos < mk.Skv;
          if (mk.causal) in = in && kpos <= qpos;
          if (mk.has_window) in = in && qpos - kpos < mk.window;
          if (!in) x = __uint_as_float(0xff800000u);  // -inf
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = quad_max(mx[i]);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += (P_hi + P_lo) V; the A fragment of keys 16kk.. is s[2kk], s[2kk+1]
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(vst + (kk * 16 + (lane & 7) +
                                               ((lane >> 3) & 1) * 8) * S +
                                        j * 8 + (lane >> 4) * 8));
        mma(acc[j], ph, bv[0], bv[1]);
        mma(acc[j + 1], ph, bv[2], bv[3]);
        mma(acc[j], pl, bv[0], bv[1]);
        mma(acc[j + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const float li = quad_sum(l[i]);
    if (row >= Sq) continue;
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    uint32_t* out =
        reinterpret_cast<uint32_t*>(o + (bh * Sq + row) * D + 2 * c);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      out[j * 4] = pack(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
           int Hq, int Hkv, int Sq, int q_offset, const Mask& mk,
           cudaStream_t s) {
  constexpr int bytes = Smem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(Hq),
                  (Sq + kBQ - 1) / kBQ);
  flash_attn_tc_kernel<D><<<grid, kThreads, bytes, s>>>(q, k, v, o, Hq, Hkv,
                                                       Sq, q_offset, mk);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int d, float scale, int causal,
             int has_window, int window, int has_cap, float cap,
             int q_offset, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0 ||
      (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{Skv, causal, has_window, window, has_cap, scale, cap};
  switch (d) {
#define LM_CASE(D) \
  case D:          \
    return launch<D>(q, k, v, o, B, Hq, Hkv, Sq, q_offset, mk, s);
    NEKBONE_FOR_EACH_HEAD_DIM(LM_CASE)
#undef LM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int smem_bytes(int d) {
  switch (d) {
#define LM_CASE(D) \
  case D:          \
    return Smem<D>::kBytes;
    NEKBONE_FOR_EACH_HEAD_DIM(LM_CASE)
#undef LM_CASE
    default:
      return 0;
  }
}

}  // namespace tc
#endif  // NEKBONE_REAL_BF16
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

// Dynamic shared memory of flash_attn_f32's block at head size d (0 for a
// size it is not built for).
extern "C" int flash_attn_f32_smem_bytes(int d) {
  switch (d) {
#define LM_CASE(D) \
  case D:          \
    return lm::F32Smem<D>::kBytes;
    NEKBONE_FOR_EACH_HEAD_DIM(LM_CASE)
#undef LM_CASE
    default:
      return 0;
  }
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
  return lm::tc::dispatch(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, scale, causal,
                          has_window, window, has_cap, cap, q_offset, stream);
}

// Dynamic shared memory of flash_attn_bf16's block at head size d (0 for a
// size it is not built for).
extern "C" int flash_attn_bf16_smem_bytes(int d) {
  return lm::tc::smem_bytes(d);
}
#endif
