// K9: the multi-axpy back half of one s-step CG cycle, per element.
//
//     V   = [p, basis[0..s-1], r, basis[s..2s-2]]   (K8's column order)
//     x  += V @ coef[0]
//     r   = V @ coef[1]
//     p   = V @ coef[2]
//     rcr = sum(r * c * r)                          (per element, stored r)
//
// with coef the (3, 2s+1) rows of the float64 host recurrence
// (core/cg_sstep.cycle_coefficients) in the accumulation dtype.
//
// Replaces the TPU kernel
// src/repro/kernels/nekbone_ax.py:nekbone_sstep_update_kernel (pallas_call
// at :1274), which applied the same combinations to a VMEM block of
// elements.  It is element-local and needs no assembly, so the port keeps
// the per-element layout of K5: one thread block per element, an n x n
// thread layer marching the k layers; each node reads its 2s+1 vector values
// once and forms the three combinations.  The terms are summed in the
// reference's order (x from the old x, r and p from zero, over V's columns
// in order) with rounded, uncontracted multiply and add, so x, r and p are
// bitwise the plain version's.  The weight c = mask/multiplicity is rebuilt
// per node from the factors cx, cy, cz.  rcr leaves as one value per element
// (E values), summed outside by torch.sum.
//
// Bound: bytes.  x, p, r and the 2s - 1 basis vectors in, x, r, p out:
// 13 fields at s=4, 106.5 MB at E=1024, n=10, fp64 (31.8 us at the data
// sheet's 3.35 TB/s); 6(2s+1) + 3 flops per node, far below.
//
// Storage and accumulation (common.cuh), K5's roles: S the CG vectors (p,
// r, the basis) and the c factors, X the solution, A the coefficients, the
// arithmetic and rcr.  Four builds: f64 and f32 (one type throughout);
// bf16 (S = X = bf16, A = f32) and bf16_ir (S = bf16, X = A = f32).  Each
// combination is summed in A from the upcast values and rounded once to
// its storage type; r is rounded to S before r.c.r, since the next cycle's
// K8 reads the stored r (the round trip is the identity for f64 and f32).
// At s=4 bf16 moves 26 bytes per node, bf16_ir 30 (x in f32).
#include <cuda_runtime.h>

#include "common.cuh"

namespace nekbone {

template <int N, typename S, typename X, typename A>
__global__ void __launch_bounds__(N * N)
nekbone_sstep_update_kernel(const X* __restrict__ x, const S* __restrict__ p,
                            const S* __restrict__ r,
                            const S* __restrict__ basis,
                            const A* __restrict__ coef,
                            const S* __restrict__ cx,
                            const S* __restrict__ cy,
                            const S* __restrict__ cz, X* __restrict__ x_out,
                            S* __restrict__ r_out, S* __restrict__ p_out,
                            A* __restrict__ rcr, int s, int ex, int ey) {
  constexpr int N2 = N * N;
  constexpr int N3 = N * N * N;
  __shared__ A sco[3][kSstepMaxK];
  __shared__ A red[N2];

  const int i = threadIdx.x;
  const int j = threadIdx.y;
  const int tid = j * N + i;
  const size_t e = blockIdx.x;
  const int ix = static_cast<int>(e % ex);
  const int iy = static_cast<int>((e / ex) % ey);
  const int iz = static_cast<int>(e / (static_cast<size_t>(ex) * ey));
  const int K = 2 * s + 1;
  const int nb = 2 * s - 1;
  const size_t base = e * N3 + tid;
  const S* be = basis + e * nb * N3 + tid;

  for (int t = tid; t < 3 * K; t += N2) sco[t / K][t % K] = coef[t];
  __syncthreads();
  // c is (cz * cy) * cx; the factors are 0, 1/2 or 1, so the product is
  // exact in any order.
  const A cyx = convert<A>(cy[iy * N + j]) * convert<A>(cx[ix * N + i]);

  A part = A(0);
  for (int k = 0; k < N; ++k) {
    const size_t o = base + k * N2;
    A xa = convert<A>(x[o]);
    A ra = A(0);
    A pa = A(0);
    for (int m = 0; m < K; ++m) {
      S v;
      if (m == 0)
        v = p[o];
      else if (m <= s)
        v = be[(m - 1) * N3 + k * N2];
      else if (m == s + 1)
        v = r[o];
      else
        v = be[(m - 2) * N3 + k * N2];
      const A va = convert<A>(v);
      xa = add_rn(xa, mul_rn(sco[0][m], va));
      ra = add_rn(ra, mul_rn(sco[1][m], va));
      pa = add_rn(pa, mul_rn(sco[2][m], va));
    }
    x_out[o] = convert<X>(xa);
    const S rs = convert<S>(ra);
    r_out[o] = rs;
    p_out[o] = convert<S>(pa);
    const A rn = convert<A>(rs);
    const A c = convert<A>(cz[iz * N + k]) * cyx;
    part += (rn * c) * rn;
  }
  const A total = block_sum<N2>(part, red, tid);
  if (tid == 0) rcr[e] = total;
}

template <int N, typename S, typename X, typename A>
cudaError_t launch(const X* x, const S* p, const S* r, const S* basis,
                   const A* coef, const S* cx, const S* cy, const S* cz,
                   X* x_out, S* r_out, S* p_out, A* rcr, int ex, int ey,
                   int ez, int s, cudaStream_t stream) {
  const int E = ex * ey * ez;
  nekbone_sstep_update_kernel<N, S, X, A><<<E, dim3(N, N), 0, stream>>>(
      x, p, r, basis, coef, cx, cy, cz, x_out, r_out, p_out, rcr, s, ex, ey);
  return cudaGetLastError();
}

template <typename S, typename X, typename A>
int dispatch(const X* x, const S* p, const S* r, const S* basis,
             const A* coef, const S* cx, const S* cy, const S* cz, X* x_out,
             S* r_out, S* p_out, A* rcr, int ex, int ey, int ez, int n,
             int s, void* stream) {
  if (ex <= 0 || ey <= 0 || ez <= 0 || s < 1 || s > kSstepMaxS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
#define NEKBONE_CASE(N)                                                     \
  case N:                                                                   \
    return static_cast<int>(launch<N, S, X, A>(x, p, r, basis, coef, cx,    \
                                               cy, cz, x_out, r_out, p_out, \
                                               rcr, ex, ey, ez, s, st));
    NEKBONE_FOR_EACH_N(NEKBONE_CASE)
#undef NEKBONE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace nekbone

// x, x_out: (E, n^3) in X; p, r, r_out, p_out: (E, n^3) and basis: (E,
// 2s-1, n^3) in S; coef: (3, 2s+1) and rcr: (E,) in A; cx: (EX, n); cy:
// (EY, n); cz: (EZ, n) in S.  Elements z-major over (EX, EY, EZ);
// 1 <= s <= 10.  Returns cudaGetLastError() after the launch.
#define NEKBONE_SSTEP_UPDATE_ENTRY(NAME, S, X, A)                           \
  extern "C" int NAME(const X* x, const S* p, const S* r, const S* basis,  \
                      const A* coef, const S* cx, const S* cy, const S* cz, \
                      X* x_out, S* r_out, S* p_out, A* rcr, int ex, int ey, \
                      int ez, int n, int s, void* stream) {                 \
    return nekbone::dispatch<S, X, A>(x, p, r, basis, coef, cx, cy, cz,     \
                                      x_out, r_out, p_out, rcr, ex, ey, ez, \
                                      n, s, stream);                        \
  }

#ifdef NEKBONE_REAL_F64
NEKBONE_SSTEP_UPDATE_ENTRY(nekbone_sstep_update_f64, double, double, double)
#endif
#ifdef NEKBONE_REAL_F32
NEKBONE_SSTEP_UPDATE_ENTRY(nekbone_sstep_update_f32, float, float, float)
#endif
#ifdef NEKBONE_REAL_BF16
NEKBONE_SSTEP_UPDATE_ENTRY(nekbone_sstep_update_bf16, __nv_bfloat16,
                           __nv_bfloat16, float)
#endif
#ifdef NEKBONE_REAL_BF16_IR
NEKBONE_SSTEP_UPDATE_ENTRY(nekbone_sstep_update_bf16_ir, __nv_bfloat16, float,
                           float)
#endif
