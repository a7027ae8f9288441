// The Galerkin MG levels and the PCG step kernels shared by K3
// (mg_pcg.cu, whose MG-PCG K2 also runs) and K11 (mg_stream.cu).
//
// Level 0 of a `Solve` is either the PCG matrix in packed form
// (a_diag + 8 * fluid; K3) or, with `Lvl.pk == nullptr`, a Galerkin
// coarse level in edge form (c, e, n) whose cycle output the caller
// prolongs itself (K11's resident root).  Restriction is the 2x2 block
// sum, prolongation constant injection (masked by fluid at a packed
// level 0 only); the Chebyshev coefficient rows [inv_theta, c_prev_0,
// c_r_0, ...] come precomputed, one per level.  Every dot product and
// max is a two-stage reduction (per-block partials, then one block in a
// fixed order), so iteration counts repeat from run to run.
//
// Every kernel of a PCG iteration returns at once when flags[F_DONE] is
// set, and conv_reduce sets it at convergence or at the iteration cap:
// an iteration enqueued after the solve has stopped is a no-op, so K3 can
// replay a CUDA graph of several iterations between two host reads of
// the flag and still stop where a per-iteration check would.
//
// The coarse end of the cycle is one launch a visit (`coarse_cycle`):
// from the first level below level 0 of at most kFusedCells cells that
// the truncated W visits once a cycle (128², 64², 32² at 1024²) down,
// `cycle(l)` is a V that runs in one cluster of kFusedCtas CTAs.  The
// cluster shares each operation of that first level, whose planes stay in
// device memory, with a cluster barrier between operations; CTA 0 runs
// the levels below it alone, their planes in its shared memory (the
// others write the restriction into it and read the prolongation from it
// through distributed shared memory).  On an NVIDIA H100 80GB HBM3
// (700 W, chip_smoke.py) a visit costs ~20-26 us, about what the seven
// launches it replaces cost (PERF.md §6).
//
// Rounding.  Each cell takes the same per-cell function (`*_at`) in the
// one-launch-per-operation kernels and in coarse_cycle, and every product
// and sum in it is written out: `fmac` (one rounding in K3, two in K11,
// which builds with -fmad=false) and the __f*_rn intrinsics, which nvcc
// never contracts.  So both forms round alike, whatever nvcc would fuse
// in either.  The forms written out are those nvcc chose for the
// per-operation kernels when it contracted freely (read from their SASS
// with cuobjdump), so K3's numbers are those of that build: at the edge
// form, the stencil's first two products fuse as c x + (e x_e) or as
// e x_e + (c x) (`CX`), and the west product is fused or rounded first
// (`WEST`), per call site (the odd-column children of a restriction, the
// coarse solve's steps, the Chebyshev init).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

#if !defined(EU_FMAD)
#error "define EU_FMAD: 1 where a * b + c is one rounding (K3), 0 under -fmad=false (K11)"
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kCoarseThreads = 1024;
constexpr int kFusedPlanes = 9;  // c, e, n, x, b, z, rr, d, dn in shared memory
constexpr int kFusedCtas = 8;     // CTAs of the coarse_cycle cluster
constexpr int kFusedCells = 128 * 128;  // coarse_cycle from a level this small

// device scalars and flags of one solve
enum { S_TOL = 0, S_SIGMA, S_SIGMA_NEW, S_BETA, S_ALPHA, S_RESID, S_N };
enum { F_DONE = 0, F_ITERS, F_NONZERO, F_N };

struct Lvl {
  int Y, X;
  const float* c;   // edge form (levels >= 1)
  const float* e;
  const float* n;
  const float* pk;  // packed a_diag + 8 * fluid (level 0), else nullptr
};

// a * b + c: one rounding (an FMA) with EU_FMAD, else the product rounded
// first
__device__ __forceinline__ float fmac(float a, float b, float c) {
#if EU_FMAD
  return __fmaf_rn(a, b, c);
#else
  return __fadd_rn(__fmul_rn(a, b), c);
#endif
}

// A x at (i, j): the masked 5-point PCG matrix at level 0 (fl * (a x -
// neighbours), fl in {0, 1}), the edge-weight operator (intrinsically
// masked) above it, its first two products fused as CX ? c x + (e x_e) :
// e x_e + (c x) and its west product fused when WEST
template <bool CX, bool WEST>
__device__ __forceinline__ float apply_at(const Lvl& L, const float* x, int i,
                                          int j) {
  const int k = i * L.X + j;
  if (L.pk) {
    const float p = L.pk[k];
    const float fl = p >= 8.0f ? 1.0f : 0.0f;
    const float a = __fsub_rn(p, __fmul_rn(8.0f, fl));
    float nb = __fadd_rn(ld(x, i, j - 1, L.Y, L.X), ld(x, i, j + 1, L.Y, L.X));
    nb = __fadd_rn(nb, ld(x, i + 1, j, L.Y, L.X));
    nb = __fadd_rn(nb, ld(x, i - 1, j, L.Y, L.X));
    return __fmul_rn(fl, fmac(a, x[k], -nb));
  }
  const float c = L.c[k], xc = x[k];
  const float e = L.e[k], xe = ld(x, i, j + 1, L.Y, L.X);
  float r = CX ? fmac(c, xc, __fmul_rn(e, xe)) : fmac(e, xe, __fmul_rn(c, xc));
  const float ew = ld(L.e, i, j - 1, L.Y, L.X);
  const float xw = ld(x, i, j - 1, L.Y, L.X);
  r = WEST ? fmac(ew, xw, r) : __fadd_rn(r, __fmul_rn(ew, xw));
  r = fmac(L.n[k], ld(x, i + 1, j, L.Y, L.X), r);
  return fmac(ld(L.n, i - 1, j, L.Y, L.X), ld(x, i - 1, j, L.Y, L.X), r);
}

__device__ __forceinline__ float fluid0(const Lvl& L, int k) {
  return L.pk[k] >= 8.0f ? 1.0f : 0.0f;
}

// ---- the level operations, one cell each ----

// degree-1 pre-smooth from zero fused with the restriction: for coarse
// cell t, x = b/theta and rr = b - A b/theta on its 4 children, and
// b_c = the 2x2 sum of rr
__device__ __forceinline__ void pre1_restrict_at(const Lvl& L, const float* b,
                                                 float* x, float* bc,
                                                 float it, int t) {
  const int Xc = L.X / 2;
  const int I = t / Xc, J = t - I * Xc;
  float rr[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c, k = i * L.X + j;
      const float bv = b[k];
      x[k] = __fmul_rn(it, bv);
      const float ab = c ? apply_at<true, false>(L, b, i, j)
                         : apply_at<true, true>(L, b, i, j);
      rr[a][c] = fmac(-it, ab, bv);
    }
  bc[t] = __fadd_rn(__fadd_rn(rr[0][0], rr[1][0]),
                    __fadd_rn(rr[0][1], rr[1][1]));
}

// b_c = R(b - A x) at coarse cell t
__device__ __forceinline__ void restrict_full_at(const Lvl& L, const float* b,
                                                 const float* x, float* bc,
                                                 int t) {
  const int Xc = L.X / 2;
  const int I = t / Xc, J = t - I * Xc;
  float rr[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c;
      const float ax = c ? apply_at<false, false>(L, x, i, j)
                         : apply_at<true, true>(L, x, i, j);
      rr[a][c] = __fsub_rn(b[i * L.X + j], ax);
    }
  bc[t] = __fadd_rn(__fadd_rn(rr[0][0], rr[1][0]),
                    __fadd_rn(rr[0][1], rr[1][1]));
}

// x += P z_c (constant injection, masked by fluid at level 0)
__device__ __forceinline__ void prolong_add_at(const Lvl& L, const float* zc,
                                               float* x, int t) {
  const int i = t / L.X, j = t - i * L.X;
  float add = zc[(i / 2) * (L.X / 2) + j / 2];
  if (L.pk) add = __fmul_rn(fluid0(L, t), add);
  x[t] = __fadd_rn(x[t], add);
}

// degree-1 post-smooth z = x + (b - A x)/theta; returns z * b
__device__ __forceinline__ float post1_at(const Lvl& L, const float* b,
                                          const float* x, float* z, float it,
                                          int t) {
  const int i = t / L.X, j = t - i * L.X;
  const float bb = b[t];
  const float zz =
      fmac(__fsub_rn(bb, apply_at<true, true>(L, x, i, j)), it, x[t]);
  z[t] = zz;
  return __fmul_rn(zz, bb);
}

// general-degree Chebyshev smoothing (cheby_smooth of ops/multigrid.py):
// init, degree-1 steps, then x += d
__device__ __forceinline__ void cheby_init_at(const Lvl& L, const float* b,
                                              float* x, float* rr, float* d,
                                              float it, int from_zero,
                                              int t) {
  const int i = t / L.X, j = t - i * L.X;
  float r;
  if (from_zero) {
    r = b[t];
  } else {
    r = __fsub_rn(b[t], apply_at<false, true>(L, x, i, j));
  }
  rr[t] = r;
  d[t] = __fmul_rn(r, it);
  if (from_zero) x[t] = 0.0f;
}

__device__ __forceinline__ void cheby_step_at(const Lvl& L, float* x,
                                              float* rr, const float* d,
                                              float* dn, float cp, float cr,
                                              int t) {
  const int i = t / L.X, j = t - i * L.X;
  const float dd = d[t];
  x[t] = __fadd_rn(x[t], dd);
  const float r = __fsub_rn(rr[t], apply_at<true, true>(L, d, i, j));
  rr[t] = r;
  dn[t] = fmac(cp, dd, __fmul_rn(cr, r));
}

// coarsest level: `degree` Chebyshev steps from zero in one block
// (x = b/theta; rr = b - A b/theta; d = c_prev_0 x + c_r_0 rr; then
// x += d, rr -= A d, d = c_prev_k d + c_r_k rr; the last step x += d)
__device__ __forceinline__ void coarse_solve_block(const Lvl& L,
                                                   const float* b, float* x,
                                   float* rr, float* d, float* dn,
                                   const float* row, int degree) {
  const int n = L.Y * L.X;
  const float it = row[0];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int i = t / L.X, j = t - i * L.X;
    const float bv = b[t];
    const float xv = __fmul_rn(it, bv);
    x[t] = xv;
    if (degree > 1) {
      const float r = fmac(-it, apply_at<true, true>(L, b, i, j), bv);
      rr[t] = r;
      d[t] = fmac(row[1], xv, __fmul_rn(row[2], r));
    }
  }
  __syncthreads();
  for (int k = 1; k < degree; ++k) {
    const bool last = k == degree - 1;
    const float cp = row[1 + 2 * k], cr = row[2 + 2 * k];
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float dd = d[t];
      x[t] = __fadd_rn(x[t], dd);
      if (!last) {
        const int i = t / L.X, j = t - i * L.X;
        const float r = __fsub_rn(rr[t], apply_at<false, true>(L, d, i, j));
        rr[t] = r;
        dn[t] = fmac(cp, dd, __fmul_rn(cr, r));
      }
    }
    __syncthreads();
    float* tmp = d;
    d = dn;
    dn = tmp;
  }
}

// ---- one launch per level operation ----
//
// Every kernel reads the stop flag first; all threads of the grid read
// the same value before any kernel of the iteration can change it, so
// the early return is uniform.

__global__ void pre1_restrict(Lvl L, const float* __restrict__ b,
                              float* __restrict__ x, float* __restrict__ bc,
                              const float* __restrict__ row,
                              const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (L.Y / 2) * (L.X / 2)) return;
  pre1_restrict_at(L, b, x, bc, row[0], t);
}

__global__ void restrict_full(Lvl L, const float* __restrict__ b,
                              const float* __restrict__ x,
                              float* __restrict__ bc,
                              const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (L.Y / 2) * (L.X / 2)) return;
  restrict_full_at(L, b, x, bc, t);
}

__global__ void prolong_add(Lvl L, const float* __restrict__ zc,
                            float* __restrict__ x,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  prolong_add_at(L, zc, x, t);
}

// with DOT, also the per-block partial sums of z * b (the PCG <z, r> at
// level 0)
template <bool DOT>
__global__ void post1(Lvl L, const float* __restrict__ b,
                      const float* __restrict__ x, float* __restrict__ z,
                      const float* __restrict__ row,
                      float* __restrict__ part,
                      const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < L.Y * L.X) acc = post1_at(L, b, x, z, row[0], t);
  if (DOT) {
    acc = block_reduce<EU_SUM>(acc);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}

__global__ void cheby_init(Lvl L, const float* __restrict__ b,
                           float* __restrict__ x, float* __restrict__ rr,
                           float* __restrict__ d,
                           const float* __restrict__ row, int from_zero,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  cheby_init_at(L, b, x, rr, d, row[0], from_zero, t);
}

__global__ void cheby_step(Lvl L, float* __restrict__ x,
                           float* __restrict__ rr,
                           const float* __restrict__ d,
                           float* __restrict__ dn,
                           const float* __restrict__ row, int k,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  cheby_step_at(L, x, rr, d, dn, row[1 + 2 * k], row[2 + 2 * k], t);
}

__global__ void axpy1(int n, float* __restrict__ x,
                      const float* __restrict__ d,
                      const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] = __fadd_rn(x[t], d[t]);
}

__global__ void dot_partial(int n, const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ part,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = t < n ? __fmul_rn(a[t], b[t]) : 0.0f;
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void coarse_solve(Lvl L, const float* __restrict__ b, float* x,
                             float* rr, float* d, float* dn,
                             const float* __restrict__ row, int degree,
                             const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  coarse_solve_block(L, b, x, rr, d, dn, row, degree);
}

// ---- PCG (stopping rule of main.c:738-767, tol_rel form) ----

__global__ void pcg_init(int n, const float* __restrict__ r,
                         float* __restrict__ p, float* __restrict__ s,
                         float* __restrict__ As, int zero_p,
                         float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (t < n) {
    s[t] = 0.0f;
    As[t] = 0.0f;
    if (zero_p) p[t] = 0.0f;
    m = fabsf(r[t]);
  }
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

__global__ void pcg_init_reduce(const float* __restrict__ part, int nparts,
                                float tol, float tol_rel, float* scal,
                                int* flags) {
  const float rmax0 = reduce_partials<EU_MAX>(part, nparts);
  if (threadIdx.x == 0) {
    const bool nonzero = rmax0 != 0.0f;
    scal[S_TOL] = nanmax(tol, tol_rel * rmax0);
    scal[S_SIGMA] = 0.0f;
    scal[S_RESID] = rmax0;
    flags[F_DONE] = !nonzero;
    flags[F_ITERS] = 0;
    flags[F_NONZERO] = nonzero;
  }
}

// warm start: the guess re-masked to the current fluid, zeroed on an
// all-zero RHS; then r = b - A p0 in a separate sweep
__global__ void warm_mask(Lvl L0, float* __restrict__ p,
                          const int* __restrict__ flags) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L0.Y * L0.X) return;
  const float on = flags[F_NONZERO] ? 1.0f : 0.0f;
  p[t] = __fmul_rn(__fmul_rn(p[t], fluid0(L0, t)), on);
}

__global__ void warm_resid(Lvl L0, float* __restrict__ r,
                           const float* __restrict__ p,
                           float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    const float rv = __fsub_rn(r[t], apply_at<true, true>(L0, p, i, j));
    r[t] = rv;
    m = fabsf(rv);
  }
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

__global__ void warm_reduce(const float* __restrict__ part, int nparts,
                            float* scal, int* flags) {
  const float rwarm = reduce_partials<EU_MAX>(part, nparts);
  if (threadIdx.x == 0) {
    // NaN-robust: not (rwarm > tol)
    flags[F_DONE] = !flags[F_NONZERO] || !(rwarm > scal[S_TOL]);
    scal[S_RESID] = rwarm;
  }
}

__global__ void sigma_reduce(const float* __restrict__ part, int nparts,
                             float* scal, const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const float sigma_new = reduce_partials<EU_SUM>(part, nparts);
  if (threadIdx.x == 0) {
    const float sigma = scal[S_SIGMA];
    scal[S_SIGMA_NEW] = sigma_new;
    scal[S_BETA] = sigma_new / (sigma != 0.0f ? sigma : 1.0f);
  }
}

// s' = z + beta s; As' = A z + beta As; partials of <As', s'>
__global__ void update_s(Lvl L0, const float* __restrict__ z,
                         float* __restrict__ s, float* __restrict__ As,
                         const float* __restrict__ scal,
                         float* __restrict__ part,
                         const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    const float beta = scal[S_BETA];
    const float sn = fmac(beta, s[t], z[t]);
    const float an = fmac(beta, As[t], apply_at<true, true>(L0, z, i, j));
    s[t] = sn;
    As[t] = an;
    acc = __fmul_rn(an, sn);
  }
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void alpha_reduce(const float* __restrict__ part, int nparts,
                             float* scal, const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const float zs = reduce_partials<EU_SUM>(part, nparts);
  if (threadIdx.x == 0) {
    const float sigma_new = scal[S_SIGMA_NEW];
    scal[S_ALPHA] = sigma_new / (zs != 0.0f ? zs : 1.0f);
    scal[S_SIGMA] = sigma_new;
  }
}

// p += alpha s; r -= alpha As; partials of max |r|
__global__ void update_p(int n, float* __restrict__ p, float* __restrict__ r,
                         const float* __restrict__ s,
                         const float* __restrict__ As,
                         const float* __restrict__ scal,
                         float* __restrict__ part,
                         const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (t < n) {
    const float alpha = scal[S_ALPHA];
    p[t] = fmac(alpha, s[t], p[t]);
    const float rv = fmac(-alpha, As[t], r[t]);
    r[t] = rv;
    m = fabsf(rv);
  }
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// counts the iteration; stops at convergence or at the cap
__global__ void conv_reduce(const float* __restrict__ part, int nparts,
                            int max_iters, float* scal, int* flags) {
  if (flags[F_DONE]) return;
  const float rmax = reduce_partials<EU_MAX>(part, nparts);
  if (threadIdx.x == 0) {
    const int iters = flags[F_ITERS] + 1;
    flags[F_DONE] = !(rmax > scal[S_TOL]) || iters >= max_iters;
    scal[S_RESID] = rmax;
    flags[F_ITERS] = iters;
  }
}

// ---- the cycle schedule ----

enum { P_C = 0, P_E, P_N, P_X, P_B, P_Z, P_RR, P_D, P_DN, P_COUNT };

struct Solve {
  int L;
  Lvl lv[16];
  float* x[16];
  float* b[16];
  float* z[16];
  float* rr[16];
  float* d[16];
  float* dn[16];
  const float* rows;
  int ncoef;
  int deg, coarse_deg, w, w_depth;
  int fused;        // the level where coarse_cycle takes over (L: none)
  int fused_smem;   // its dynamic shared memory, bytes
  float* part;
  const int* flags;
  cudaStream_t s;

  __host__ __device__ const float* row(int l) const {
    return rows + l * ncoef;
  }
  __host__ __device__ int visits(int l) const {
    return (l < w_depth && l + 1 < L - 1) ? w : 1;
  }
  // where level l leaves its cycle output
  __host__ __device__ float* zout(int l) const {
    return (l == L - 1 || deg != 1) ? x[l] : z[l];
  }
  unsigned blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l].Y) * lv[l].X, kThreads);
  }
  unsigned coarse_blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l].Y / 2) * (lv[l].X / 2),
                     kThreads);
  }

  // general-degree smoothing of level l; result in x[l]
  int cheby(int l, bool from_zero) {
    cheby_init<<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], rr[l],
                                              d[l], row(l), from_zero, flags);
    int rc = eu_launch_status();
    if (rc) return rc;
    float *dc = d[l], *dnc = dn[l];
    for (int k = 0; k + 1 < deg; ++k) {
      cheby_step<<<blocks(l), kThreads, 0, s>>>(lv[l], x[l], rr[l], dc, dnc,
                                                row(l), k, flags);
      if ((rc = eu_launch_status())) return rc;
      float* tmp = dc;
      dc = dnc;
      dnc = tmp;
    }
    axpy1<<<blocks(l), kThreads, 0, s>>>(lv[l].Y * lv[l].X, x[l], dc, flags);
    return eu_launch_status();
  }

  int launch_fused(int l) const;

  // z_l ~= A_l^{-1} b_l; with dot (level 0), the partials of <z, b>
  int cycle(int l, bool dot) {
    int rc;
    const int n = lv[l].Y * lv[l].X;
    if (l == fused) return launch_fused(l);
    if (l == L - 1) {
      coarse_solve<<<1, kCoarseThreads, 0, s>>>(lv[l], b[l], x[l], rr[l],
                                                d[l], dn[l], row(l),
                                                coarse_deg, flags);
      if ((rc = eu_launch_status())) return rc;
      if (dot) {
        dot_partial<<<blocks(l), kThreads, 0, s>>>(n, x[l], b[l], part,
                                                   flags);
        return eu_launch_status();
      }
      return 0;
    }
    if (deg == 1) {
      pre1_restrict<<<coarse_blocks(l), kThreads, 0, s>>>(
          lv[l], b[l], x[l], b[l + 1], row(l), flags);
      if ((rc = eu_launch_status())) return rc;
    } else {
      if ((rc = cheby(l, true))) return rc;
      restrict_full<<<coarse_blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l],
                                                          b[l + 1], flags);
      if ((rc = eu_launch_status())) return rc;
    }
    for (int v = 0; v < visits(l); ++v) {
      if (v > 0) {
        restrict_full<<<coarse_blocks(l), kThreads, 0, s>>>(
            lv[l], b[l], x[l], b[l + 1], flags);
        if ((rc = eu_launch_status())) return rc;
      }
      if ((rc = cycle(l + 1, false))) return rc;
      prolong_add<<<blocks(l), kThreads, 0, s>>>(lv[l], zout(l + 1), x[l],
                                                 flags);
      if ((rc = eu_launch_status())) return rc;
    }
    if (deg == 1) {
      if (dot)
        post1<true><<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], z[l],
                                                   row(l), part, flags);
      else
        post1<false><<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], z[l],
                                                    row(l), part, flags);
      return eu_launch_status();
    }
    if ((rc = cheby(l, false))) return rc;
    if (dot) {
      dot_partial<<<blocks(l), kThreads, 0, s>>>(n, x[l], b[l], part, flags);
      return eu_launch_status();
    }
    return 0;
  }
};

// ---- the coarse end of the cycle in one launch ----

// a barrier over the cluster (CL) or over the CTA
template <bool CL>
__device__ __forceinline__ void level_sync() {
  if (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

template <bool CL>
__device__ void cheby_dev(const Solve& S, int l, bool from_zero, int first,
                          int stride) {
  const Lvl L = S.lv[l];
  const int n = L.Y * L.X;
  const float* const row = S.row(l);
  const float* const b = S.b[l];
  float* const x = S.x[l];
  float* const rr = S.rr[l];
  const int deg = S.deg;
  const float it = row[0];
  for (int t = first; t < n; t += stride)
    cheby_init_at(L, b, x, rr, S.d[l], it, from_zero, t);
  level_sync<CL>();
  float *dc = S.d[l], *dnc = S.dn[l];
  for (int k = 0; k + 1 < deg; ++k) {
    const float cp = row[1 + 2 * k], cr = row[2 + 2 * k];
    for (int t = first; t < n; t += stride)
      cheby_step_at(L, x, rr, dc, dnc, cp, cr, t);
    level_sync<CL>();
    float* tmp = dc;
    dc = dnc;
    dnc = tmp;
  }
  for (int t = first; t < n; t += stride) x[t] = __fadd_rn(x[t], dc[t]);
  level_sync<CL>();
}

// The two halves of Solve::cycle(l, false) at a level visited once, on
// the device: CL, the cluster shares level l's operations (element
// first, first + stride, ...); else the calling CTA runs them.  Every
// operation ends with a barrier.  The level's view is held in registers
// (the schedule itself lives in shared memory).
template <bool CL>
__device__ __forceinline__ void descend(const Solve& S, int l, int first,
                                        int stride) {
  const Lvl L = S.lv[l];
  const int nc = (L.Y / 2) * (L.X / 2);
  const float* const b = S.b[l];
  float* const x = S.x[l];
  float* const bc = S.b[l + 1];
  if (S.deg == 1) {
    const float it = S.row(l)[0];
    for (int t = first; t < nc; t += stride)
      pre1_restrict_at(L, b, x, bc, it, t);
  } else {
    cheby_dev<CL>(S, l, true, first, stride);
    for (int t = first; t < nc; t += stride) restrict_full_at(L, b, x, bc, t);
  }
  level_sync<CL>();
}

template <bool CL>
__device__ __forceinline__ void ascend(const Solve& S, int l, int first,
                                       int stride) {
  const Lvl L = S.lv[l];
  const int n = L.Y * L.X;
  float* const x = S.x[l];
  const float* const zc = S.zout(l + 1);
  for (int t = first; t < n; t += stride) prolong_add_at(L, zc, x, t);
  level_sync<CL>();
  if (S.deg == 1) {
    const float it = S.row(l)[0];
    const float* const b = S.b[l];
    float* const z = S.z[l];
    for (int t = first; t < n; t += stride) post1_at(L, b, x, z, it, t);
    level_sync<CL>();
  } else {
    cheby_dev<CL>(S, l, false, first, stride);
  }
}

// cycle(from) in one launch of a cluster of kCoarseThreads-thread CTAs,
// every level from `from` down visited once (a V below the truncated W):
// the cluster descends and ascends level `from`, CTA 0 the levels below
// it, whose planes move into its shared memory (their c, e, n copied in,
// the rest scratch).  Each CTA keeps its view of the schedule, with those
// planes remapped, in its shared memory.
__global__ void __launch_bounds__(kCoarseThreads, 1)
    coarse_cycle(const __grid_constant__ Solve S0, int from,
                 const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  extern __shared__ float smem[];
  __shared__ Solve S;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  float* base = rank == 0 ? smem : cluster.map_shared_rank(smem, 0);
  const int* src = reinterpret_cast<const int*>(&S0);
  int* dst = reinterpret_cast<int*>(&S);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(Solve) / sizeof(int));
       i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  int off = 0;
  for (int l = from + 1; l < S0.L; ++l) {
    const int n = S0.lv[l].Y * S0.lv[l].X;
    float* pl[kFusedPlanes];
    for (int q = 0; q < kFusedPlanes; ++q) pl[q] = base + off + q * n;
    if (rank == 0) {
      const float* __restrict__ c = S0.lv[l].c;
      const float* __restrict__ e = S0.lv[l].e;
      const float* __restrict__ nn = S0.lv[l].n;
      float* own = smem + off;
#pragma unroll 4
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const float cv = c[t], ev = e[t], nv = nn[t];
        own[P_C * n + t] = cv;
        own[P_E * n + t] = ev;
        own[P_N * n + t] = nv;
      }
    }
    off += kFusedPlanes * n;
    if (threadIdx.x == 0) {
      S.lv[l].c = pl[P_C];
      S.lv[l].e = pl[P_E];
      S.lv[l].n = pl[P_N];
      S.x[l] = pl[P_X];
      S.b[l] = pl[P_B];
      S.z[l] = pl[P_Z];
      S.rr[l] = pl[P_RR];
      S.d[l] = pl[P_D];
      S.dn[l] = pl[P_DN];
    }
  }
  cluster.sync();
  // cycle(from): every level from `from` down is visited once
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = cluster.num_blocks() * blockDim.x;
  const int last = S0.L - 1;
  if (from < last) descend<true>(S, from, first, stride);
  if (rank == 0) {
    for (int l = from + 1; l < last; ++l)
      descend<false>(S, l, threadIdx.x, blockDim.x);
    const Lvl Lc = S.lv[last];
    coarse_solve_block(Lc, S.b[last], S.x[last], S.rr[last], S.d[last],
                       S.dn[last], S.row(last), S.coarse_deg);
    __syncthreads();
    for (int l = last - 1; l > from; --l)
      ascend<false>(S, l, threadIdx.x, blockDim.x);
  }
  if (from == last) return;
  cluster.sync();
  ascend<true>(S, from, first, stride);
}

inline int Solve::launch_fused(int l) const {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kFusedCtas);
  cfg.blockDim = dim3(kCoarseThreads);
  cfg.dynamicSmemBytes = fused_smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFusedCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = static_cast<int>(
      cudaLaunchKernelEx(&cfg, coarse_cycle, *this, l, flags));
  return rc ? rc : eu_launch_status();
}

// A Solve over L levels.  planes: P_COUNT pointers per level (c, e, n, x,
// b, z, rr, d, dn); shapes: (Y, X) per level; rows: [L, ncoef] Chebyshev
// rows.  With packed0, level 0 is the packed PCG matrix (its c/e/n are
// unused) and its b is b0; without, level 0 is in edge form like the rest.
// coarse_cycle takes over at the first level below 0 of at most
// kFusedCells cells from which every level is visited once (at 1024² with
// the truncated W of depth 2: 128²); every kernel reads the stop flag in
// flags.
inline int make_solve(Solve* S, int L, const int* shapes,
                      void* const* planes, const void* packed0, float* b0,
                      const void* rows, int ncoef, int deg, int coarse_deg,
                      int w, int w_depth, void* part, const void* flags,
                      void* stream) {
  if (L < 1 || L > 16) return static_cast<int>(cudaErrorInvalidValue);
  S->L = L;
  S->rows = static_cast<const float*>(rows);
  S->ncoef = ncoef;
  S->deg = deg;
  S->coarse_deg = coarse_deg;
  S->w = w;
  S->w_depth = w_depth;
  S->part = static_cast<float*>(part);
  S->flags = static_cast<const int*>(flags);
  S->s = static_cast<cudaStream_t>(stream);
  S->fused = L;
  for (int l = 0; l < L; ++l) {
    void* const* pl = planes + l * P_COUNT;
    const bool packed = l == 0 && packed0;
    const int Y = shapes[2 * l], X = shapes[2 * l + 1];
    S->lv[l] = Lvl{Y, X, static_cast<const float*>(pl[P_C]),
                   static_cast<const float*>(pl[P_E]),
                   static_cast<const float*>(pl[P_N]),
                   packed ? static_cast<const float*>(packed0) : nullptr};
    S->x[l] = static_cast<float*>(pl[P_X]);
    S->b[l] = packed ? b0 : static_cast<float*>(pl[P_B]);
    S->z[l] = static_cast<float*>(pl[P_Z]);
    S->rr[l] = static_cast<float*>(pl[P_RR]);
    S->d[l] = static_cast<float*>(pl[P_D]);
    S->dn[l] = static_cast<float*>(pl[P_DN]);
    if (l >= 1 && S->fused == L && static_cast<long long>(Y) * X <= kFusedCells)
      S->fused = l;
  }
  // coarse_cycle runs a V: no level from the fused one down is revisited
  while (S->fused < L && S->visits(S->fused) != 1) ++S->fused;
  S->fused_smem = 0;
  for (int l = S->fused + 1; l < L; ++l)
    S->fused_smem += static_cast<int>(sizeof(float)) * kFusedPlanes *
                     S->lv[l].Y * S->lv[l].X;
  if (S->fused_smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S->fused_smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        coarse_cycle, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S->fused_smem));
  return 0;
}

// The PCG recurrence of one solve on the packed fine level L0 (the loop
// shape of mg_kernel.py `_mg_pcg_solve`): s and As start at zero and
// As' = A z + beta As replaces a second operator apply.  sigma starts at
// 0, so the first iteration's beta multiplies the zero s and As (the
// streamed kernel's beta = 0 at i = 0).
struct PcgLoop {
  Lvl L0;
  float *p, *r, *s, *As, *part, *scal;
  int* flags;
  int max_iters;
  cudaStream_t st;

  int n() const { return L0.Y * L0.X; }
  unsigned blocks() const {
    return eu_blocks(static_cast<long long>(L0.Y) * L0.X, kThreads);
  }

  // s = As = 0 (and p = 0 when zero_p), max|r|, the tolerance and the
  // all-zero early-out
  int init(bool zero_p, float tol, float tol_rel) const {
    pcg_init<<<blocks(), kThreads, 0, st>>>(n(), r, p, s, As, zero_p, part);
    int rc = eu_launch_status();
    if (rc) return rc;
    pcg_init_reduce<<<1, 1024, 0, st>>>(part, blocks(), tol, tol_rel, scal,
                                        flags);
    return eu_launch_status();
  }

  // the host read of the stop flag (a stream synchronisation)
  int done(int* out) const {
    int rc = static_cast<int>(cudaMemcpyAsync(
        out, flags + F_DONE, sizeof(int), cudaMemcpyDeviceToHost, st));
    if (rc) return rc;
    return static_cast<int>(cudaStreamSynchronize(st));
  }

  // the rest of an iteration once part holds the partials of <z, r>
  int step(const float* z) const {
    const unsigned nb = blocks();
    sigma_reduce<<<1, 1024, 0, st>>>(part, nb, scal, flags);
    int rc = eu_launch_status();
    if (rc) return rc;
    update_s<<<nb, kThreads, 0, st>>>(L0, z, s, As, scal, part, flags);
    if ((rc = eu_launch_status())) return rc;
    alpha_reduce<<<1, 1024, 0, st>>>(part, nb, scal, flags);
    if ((rc = eu_launch_status())) return rc;
    update_p<<<nb, kThreads, 0, st>>>(n(), p, r, s, As, scal, part, flags);
    if ((rc = eu_launch_status())) return rc;
    conv_reduce<<<1, 1024, 0, st>>>(part, nb, max_iters, scal, flags);
    return eu_launch_status();
  }
};

}  // namespace
