// K8: the matrix-powers front half of one s-step CG cycle.
//
//     A' v  = (1/theta) * gs(mask * A_loc v)      (mask, assemble, scale)
//     V     = [p, A'p, .., A'^s p, r, A'r, .., A'^(s-1) r]
//     basis = V without p and r                   (E, 2s-1, n^3)
//     gram  = per element, G_ab = sum(V_a * c * V_b)   (E, 2s+1, 2s+1)
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_ax_powers_kernel (pallas_call at
// :1164).  The TPU kernel kept a block of z-slabs plus s ghost slabs on each
// side in VMEM (sstep_extend_field / sstep_extend_zfactor), so the 2s - 1
// chained assembled applications never left the chip; the windows exist
// because the TPU walks its grid in order.  Here one thread block cannot
// see its neighbours' new vector without a grid-wide barrier, so the
// function is computed over the whole box as a chain of s + 2 launches on
// the caller's stream, one thread block per element, an n x n thread layer
// marching the k layers (K11, nekbone_cheb_apply.cu, was such a chain too
// and is now one cooperative launch with grid syncs between its steps):
//
// * start:       mask * A_loc p (and of r when s >= 2), unassembled;
// * step j=1..s: assembles the previous unassembled output with common.cuh's
//                sum_xyz (core/gs.ds_sum_local's tree: x pairs, then y
//                pairs of x-sums, then z pairs, the reference's order),
//                scales by 1/theta and stores A'^j p in the basis (and
//                A'^j r while j <= s - 1); then writes mask * A_loc of the
//                new vector unless its chain ends here;
// * gram:        one 128-thread block per element reads the element's 2s+1
//                vectors layer by layer into shared memory; thread t sums
//                the upper-triangle pairs t and t + 128 over the element's
//                nodes in a fixed order, and the partial is mirrored.
//
// Each vector is stored before the next application reads it and before the
// Gram reads it (the reference's rounding through storage; T is both the
// storage and the accumulation type here, f32 or f64).  The unassembled
// outputs ping-pong between two buffers per chain, since a step reads its
// neighbours' copies of the previous one while it writes the next.  The
// local operator is common.cuh's masked_ax (K4's and K11's); its
// contractions use FMA, so the basis is not bitwise the plain version's but
// within a few ulps (held to 1e-12 relative), while the assembly, the scale
// and the Gram's order of terms are fixed.  The Gram partials are summed
// over elements by torch.sum; only the (2s+1)^2 matrix goes to the host.
//
// Bound: bytes.  The book is p, r and the 3 metric diagonals in and the
// 2s - 1 basis vectors out: 12 fields at s=4, 98.3 MB at E=1024, n=10, fp64
// (29.3 us at the data sheet's 3.35 TB/s).  The work is (2s - 1)(12n + 10)
// flops per node for the applications and 3 per pair and node for the Gram,
// 1.1 GF at s=4: below the bytes' time.  The chain moves far more than the
// book: 11s fields for s >= 2 (44 at s=4: start 7, each step with two
// applications 9, step s - 1 8, step s 2, the Gram 2s + 1) — what a
// one-residency design (thread-block clusters sharing ghost layers through
// distributed shared memory) would save.
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

constexpr int kGramThreads = 128;

template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_powers_start_kernel(const T* __restrict__ p, const T* __restrict__ r,
                            const T* __restrict__ D, const T* __restrict__ g3,
                            const T* __restrict__ mx,
                            const T* __restrict__ my,
                            const T* __restrict__ mz, T* __restrict__ adp,
                            T* __restrict__ adr, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, T> sh;

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const size_t base = e * N3 + j * N + i;

  load_D(sh, D, i, j);
  T vc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) vc[k] = p[base + k * N2];
  masked_ax(sh, g3, mx, my, mz, vc, adp, e, i, j, ix, iy, iz);
  if (adr != nullptr) {
#pragma unroll
    for (int k = 0; k < N; ++k) vc[k] = r[base + k * N2];
    masked_ax(sh, g3, mx, my, mz, vc, adr, e, i, j, ix, iy, iz);
  }
}

// One chain's part of a step: v = (1/theta) gs(ad_in) into basis slot m,
// then mask * A_loc v into ad_out unless ad_out is null.
template <int N, typename T>
__device__ __forceinline__ void powers_advance(
    AxShared<N, T>& sh, const T* __restrict__ ad_in, T* __restrict__ ad_out,
    T* __restrict__ vm, const T* __restrict__ g3, const T* __restrict__ mx,
    const T* __restrict__ my, const T* __restrict__ mz, T ith, size_t e,
    int i, int j, int ix, int iy, int iz, int ex, int ey, int ez) {
  constexpr int N2 = N * N;
  T vc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    vc[k] = mul_rn(sum_xyz<N>(ad_in, e, k, j, i, ix, iy, iz, ex, ey, ez),
                   ith);
    vm[k * N2 + j * N + i] = vc[k];
  }
  if (ad_out != nullptr)
    masked_ax(sh, g3, mx, my, mz, vc, ad_out, e, i, j, ix, iy, iz);
}

// Step j: the p-chain's vector goes to basis slot mp, the r-chain's (when
// mr >= 0) to slot mr; a null ad_out ends that chain.
template <int N, typename T>
__global__ void __launch_bounds__(N * N)
nekbone_powers_step_kernel(const T* __restrict__ adp_in,
                           T* __restrict__ adp_out,
                           const T* __restrict__ adr_in,
                           T* __restrict__ adr_out, T* __restrict__ basis,
                           const T* __restrict__ D, const T* __restrict__ g3,
                           const T* __restrict__ mx,
                           const T* __restrict__ my,
                           const T* __restrict__ mz,
                           const T* __restrict__ inv_theta, int nb, int mp,
                           int mr, int ex, int ey, int ez) {
  constexpr int N3 = N * N * N;
  __shared__ AxShared<N, T> sh;

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  T* be = basis + e * nb * N3;

  load_D(sh, D, i, j);
  const T ith = *inv_theta;
  powers_advance<N>(sh, adp_in, adp_out, be + mp * N3, g3, mx, my, mz, ith,
                    e, i, j, ix, iy, iz, ex, ey, ez);
  if (mr >= 0)
    powers_advance<N>(sh, adr_in, adr_out, be + mr * N3, g3, mx, my, mz, ith,
                      e, i, j, ix, iy, iz, ex, ey, ez);
}

// Per-element Gram partials over V = [p, basis[0..s-1], r, basis[s..2s-2]].
template <int N, typename T>
__global__ void __launch_bounds__(kGramThreads)
nekbone_powers_gram_kernel(const T* __restrict__ p, const T* __restrict__ r,
                           const T* __restrict__ basis,
                           const T* __restrict__ cx,
                           const T* __restrict__ cy,
                           const T* __restrict__ cz, T* __restrict__ gram,
                           int s, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ T sv[kSstepMaxK][N2];
  __shared__ T sc[N2];

  const int tid = threadIdx.x;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const int K = 2 * s + 1;
  const int nb = 2 * s - 1;
  const int npairs = K * (K + 1) / 2;

  // this thread's pairs (a <= b), row-major over the upper triangle
  int pa[2] = {0, 0}, pb[2] = {0, 0};
  bool own[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int idx = tid + q * kGramThreads;
    own[q] = idx < npairs;
    int a = 0;
    while (own[q] && idx >= K - a) {
      idx -= K - a;
      ++a;
    }
    pa[q] = a;
    pb[q] = a + idx;
  }
  T acc[2] = {T(0), T(0)};

  for (int k = 0; k < N; ++k) {
    for (int t = tid; t < K * N2; t += kGramThreads) {
      const int m = t / N2;
      const int node = t - m * N2;
      const T* v;
      if (m == 0)
        v = p + e * N3;
      else if (m <= s)
        v = basis + (e * nb + m - 1) * N3;
      else if (m == s + 1)
        v = r + e * N3;
      else
        v = basis + (e * nb + m - 2) * N3;
      sv[m][node] = v[k * N2 + node];
    }
    for (int t = tid; t < N2; t += kGramThreads) {
      const int jj = t / N;
      const int ii = t - jj * N;
      // c = (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
      // exact in any order.
      sc[t] = cz[iz * N + k] * (cy[iy * N + jj] * cx[ix * N + ii]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!own[q]) continue;
      const T* va = sv[pa[q]];
      const T* vb = sv[pb[q]];
      T sum = acc[q];
      for (int node = 0; node < N2; ++node)
        sum += (va[node] * sc[node]) * vb[node];
      acc[q] = sum;
    }
    __syncthreads();
  }
  T* ge = gram + e * K * K;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!own[q]) continue;
    ge[pa[q] * K + pb[q]] = acc[q];
    ge[pb[q] * K + pa[q]] = acc[q];
  }
}

template <int N, typename T>
cudaError_t launch(const T* p, const T* r, const T* D, const T* g3,
                   const T* mx, const T* my, const T* mz, const T* cx,
                   const T* cy, const T* cz, const T* inv_theta, T* basis,
                   T* gram, T* ad0p, T* ad1p, T* ad0r, T* ad1r, int ex,
                   int ey, int ez, int s, cudaStream_t stream) {
  const int E = ex * ey * ez;
  const dim3 threads(N, N);
  const int nb = 2 * s - 1;
  nekbone_powers_start_kernel<N, T><<<E, threads, 0, stream>>>(
      p, r, D, g3, mx, my, mz, ad0p, s >= 2 ? ad0r : nullptr, ex, ey);
  cudaError_t err = cudaGetLastError();
  T* adp[2] = {ad0p, ad1p};
  T* adr[2] = {ad0r, ad1r};
  for (int step = 1; step <= s && err == cudaSuccess; ++step) {
    const int mr = step <= s - 1 ? s + step - 1 : -1;
    nekbone_powers_step_kernel<N, T><<<E, threads, 0, stream>>>(
        adp[(step - 1) % 2], step < s ? adp[step % 2] : nullptr,
        adr[(step - 1) % 2], step < s - 1 ? adr[step % 2] : nullptr, basis, D,
        g3, mx, my, mz, inv_theta, nb, step - 1, mr, ex, ey, ez);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  nekbone_powers_gram_kernel<N, T><<<E, kGramThreads, 0, stream>>>(
      p, r, basis, cx, cy, cz, gram, s, ex, ey);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* p, const T* r, const T* D, const T* g3, const T* mx,
             const T* my, const T* mz, const T* cx, const T* cy, const T* cz,
             const T* inv_theta, T* basis, T* gram, T* ad0p, T* ad1p,
             T* ad0r, T* ad1r, int ex, int ey, int ez, int n, int s,
             void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || s < 1 || s > kSstepMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, T>(p, r, D, g3, mx, my, mz, cx, cy,   \
                                         cz, inv_theta, basis, gram, ad0p,  \
                                         ad1p, ad0r, ad1r, ex, ey, ez, s,   \
                                         st));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// p, r and the scratch ad0p, ad1p, ad0r, ad1r: (E, n^3); D: (n, n); g3:
// (E, 3, n^3); mx, cx: (EX, n); my, cy: (EY, n); mz, cz: (EZ, n);
// inv_theta: one value; basis: (E, 2s-1, n^3); gram: (E, 2s+1, 2s+1).
// Elements z-major over (EX, EY, EZ); 1 <= s <= 10.  Queues s + 2 launches
// and returns the first non-zero cudaGetLastError(), or 0.
#ifdef NEKBONE_REAL_F64
extern "C" int nekbone_ax_powers_f64(
    const double* p, const double* r, const double* D, const double* g3,
    const double* mx, const double* my, const double* mz, const double* cx,
    const double* cy, const double* cz, const double* inv_theta,
    double* basis, double* gram, double* ad0p, double* ad1p, double* ad0r,
    double* ad1r, int ex, int ey, int ez, int n, int s, void* stream) {
  return nekbone::dispatch<double>(p, r, D, g3, mx, my, mz, cx, cy, cz,
                                   inv_theta, basis, gram, ad0p, ad1p, ad0r,
                                   ad1r, ex, ey, ez, n, s, stream);
}
#endif

#ifdef NEKBONE_REAL_F32
extern "C" int nekbone_ax_powers_f32(
    const float* p, const float* r, const float* D, const float* g3,
    const float* mx, const float* my, const float* mz, const float* cx,
    const float* cy, const float* cz, const float* inv_theta, float* basis,
    float* gram, float* ad0p, float* ad1p, float* ad0r, float* ad1r, int ex,
    int ey, int ez, int n, int s, void* stream) {
  return nekbone::dispatch<float>(p, r, D, g3, mx, my, mz, cx, cy, cz,
                                  inv_theta, basis, gram, ad0p, ad1p, ad0r,
                                  ad1r, ex, ey, ez, n, s, stream);
}
#endif
