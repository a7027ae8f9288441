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
//
// Precision.  The levels, the level operations, `SolveT` and coarse_cycle
// are templated on the plane type T: float for K2, K3, K11 and the f32
// solves of P3, P4 and P5 (`Lvl`, `Solve`), double for their f64 solves
// (pcg_mg.cu, pcg_shard.cu, pcg_mg_blocks.cu).  The roundings
// are the overloads below (`mul_rn`, `add_rn`, `sub_rn`, `fmac`: the
// __f*_rn intrinsics for float, __d*_rn and __fma_rn for double), so the
// float instantiation is the float code it always was, and the double one
// rounds each operation where the float one does.  The PCG step kernels
// at the end (`PcgLoop`: K3, K11) are float only.
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

template <typename T>
struct LvlT {
  int Y, X;
  const T* c;   // edge form (levels >= 1)
  const T* e;
  const T* n;
  const T* pk;  // packed a_diag + 8 * fluid (level 0), else nullptr
};
using Lvl = LvlT<float>;

// the correctly rounded operations of each precision, which nvcc never
// contracts
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

// a * b + c: one rounding (an FMA) with EU_FMAD, else the product rounded
// first
__device__ __forceinline__ float fmac(float a, float b, float c) {
#if EU_FMAD
  return __fmaf_rn(a, b, c);
#else
  return __fadd_rn(__fmul_rn(a, b), c);
#endif
}
__device__ __forceinline__ double fmac(double a, double b, double c) {
#if EU_FMAD
  return __fma_rn(a, b, c);
#else
  return __dadd_rn(__dmul_rn(a, b), c);
#endif
}

// What the level operations read one cell beyond a plane's edges: the
// neighbour x[i, j +- 1], x[i +- 1, j] of the iterate, and the couplings
// toward the west cell, e[i, j - 1], and the south cell, n[i - 1, j].
// `Zeros`: a whole grid (K3, K11, P3), 0 beyond its edges.  P5
// (pcg_mg_blocks.cu) reads a block's from its neighbours' edges.
struct Zeros {
  template <typename T>
  __device__ __forceinline__ T x(const T* p, int i, int j, int Y,
                                 int X) const {
    return ld(p, i, j, Y, X);
  }
  template <typename T>
  __device__ __forceinline__ T e_west(const T* e, int i, int j, int Y,
                                      int X) const {
    return ld(e, i, j - 1, Y, X);
  }
  template <typename T>
  __device__ __forceinline__ T n_south(const T* n, int i, int j, int Y,
                                       int X) const {
    return ld(n, i - 1, j, Y, X);
  }
};

// A x at (i, j): the masked 5-point PCG matrix at level 0 (fl * (a x -
// neighbours), fl in {0, 1}), the edge-weight operator (intrinsically
// masked) above it, its first two products fused as CX ? c x + (e x_e) :
// e x_e + (c x) and its west product fused when WEST; what lies beyond
// the plane from H
template <bool CX, bool WEST, class H = Zeros, typename T>
__device__ __forceinline__ T apply_at(const LvlT<T>& L, const T* x, int i,
                                      int j, const H& h = H()) {
  const int k = i * L.X + j;
  if (L.pk) {
    const T p = L.pk[k];
    const T fl = p >= T(8) ? T(1) : T(0);
    const T a = sub_rn(p, mul_rn(T(8), fl));
    T nb = add_rn(h.x(x, i, j - 1, L.Y, L.X), h.x(x, i, j + 1, L.Y, L.X));
    nb = add_rn(nb, h.x(x, i + 1, j, L.Y, L.X));
    nb = add_rn(nb, h.x(x, i - 1, j, L.Y, L.X));
    return mul_rn(fl, fmac(a, x[k], -nb));
  }
  const T c = L.c[k], xc = x[k];
  const T e = L.e[k], xe = h.x(x, i, j + 1, L.Y, L.X);
  T r = CX ? fmac(c, xc, mul_rn(e, xe)) : fmac(e, xe, mul_rn(c, xc));
  const T ew = h.e_west(L.e, i, j, L.Y, L.X);
  const T xw = h.x(x, i, j - 1, L.Y, L.X);
  r = WEST ? fmac(ew, xw, r) : add_rn(r, mul_rn(ew, xw));
  r = fmac(L.n[k], h.x(x, i + 1, j, L.Y, L.X), r);
  return fmac(h.n_south(L.n, i, j, L.Y, L.X), h.x(x, i - 1, j, L.Y, L.X), r);
}

template <typename T>
__device__ __forceinline__ T fluid0(const LvlT<T>& L, int k) {
  return L.pk[k] >= T(8) ? T(1) : T(0);
}

// ---- the level operations, one cell each ----
//
// Padded levels (P3, csrc/pcg_mg.cu): a level is stored at its padded
// shape, even wherever it is coarsened (multigrid.build_galerkin_hierarchy
// pads an odd level with inactive cells), so a child level of L holds
// L.Y / 2 x L.X / 2 cells of its own and, where that is odd and the child
// is coarsened in turn, a row or column of pad after them.  The
// restrictions take the child's stored width Xc and write 0 to the pad's
// b_c; the prolongation reads the child at that width.  K3's and K11's
// levels halve evenly, so Xc = L.X / 2 there, no cell is pad, and every
// cell takes the operations it took before.

// degree-1 pre-smooth from zero fused with the restriction: for coarse
// cell t of a child Xc cells wide, x = b/theta and rr = b - A b/theta on
// its 4 children, and b_c = the 2x2 sum of rr (0 in the child's pad)
template <class H = Zeros, typename T>
__device__ __forceinline__ void pre1_restrict_at(const LvlT<T>& L,
                                                 const T* b, T* x, T* bc,
                                                 T it, int Xc, int t,
                                                 const H& h = H()) {
  const int I = t / Xc, J = t - I * Xc;
  if (2 * I >= L.Y || 2 * J >= L.X) {
    bc[t] = T(0);
    return;
  }
  T rr[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c, k = i * L.X + j;
      const T bv = b[k];
      x[k] = mul_rn(it, bv);
      const T ab = c ? apply_at<true, false>(L, b, i, j, h)
                     : apply_at<true, true>(L, b, i, j, h);
      rr[a][c] = fmac(-it, ab, bv);
    }
  bc[t] = add_rn(add_rn(rr[0][0], rr[1][0]), add_rn(rr[0][1], rr[1][1]));
}

// b_c = R(b - A x) at coarse cell t of a child Xc cells wide (0 in its
// pad)
template <class H = Zeros, typename T>
__device__ __forceinline__ void restrict_full_at(const LvlT<T>& L,
                                                 const T* b, const T* x,
                                                 T* bc, int Xc, int t,
                                                 const H& h = H()) {
  const int I = t / Xc, J = t - I * Xc;
  if (2 * I >= L.Y || 2 * J >= L.X) {
    bc[t] = T(0);
    return;
  }
  T rr[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c;
      const T ax = c ? apply_at<false, false>(L, x, i, j, h)
                     : apply_at<true, true>(L, x, i, j, h);
      rr[a][c] = sub_rn(b[i * L.X + j], ax);
    }
  bc[t] = add_rn(add_rn(rr[0][0], rr[1][0]), add_rn(rr[0][1], rr[1][1]));
}

// x += P z_c (constant injection from a child Xc cells wide, masked by
// fluid at level 0); every cell of L has its parent inside the child's
// own cells, never in its pad
template <typename T>
__device__ __forceinline__ void prolong_add_at(const LvlT<T>& L,
                                               const T* zc, T* x, int Xc,
                                               int t) {
  const int i = t / L.X, j = t - i * L.X;
  T add = zc[(i / 2) * Xc + j / 2];
  if (L.pk) add = mul_rn(fluid0(L, t), add);
  x[t] = add_rn(x[t], add);
}

// degree-1 post-smooth z = x + (b - A x)/theta; returns z * b
template <class H = Zeros, typename T>
__device__ __forceinline__ T post1_at(const LvlT<T>& L, const T* b,
                                      const T* x, T* z, T it, int t,
                                      const H& h = H()) {
  const int i = t / L.X, j = t - i * L.X;
  const T bb = b[t];
  const T zz = fmac(sub_rn(bb, apply_at<true, true>(L, x, i, j, h)), it, x[t]);
  z[t] = zz;
  return mul_rn(zz, bb);
}

// general-degree Chebyshev smoothing (cheby_smooth of ops/multigrid.py):
// init, degree-1 steps, then x += d
template <class H = Zeros, typename T>
__device__ __forceinline__ void cheby_init_at(const LvlT<T>& L, const T* b,
                                              T* x, T* rr, T* d, T it,
                                              int from_zero, int t,
                                              const H& h = H()) {
  const int i = t / L.X, j = t - i * L.X;
  T r;
  if (from_zero) {
    r = b[t];
  } else {
    r = sub_rn(b[t], apply_at<false, true>(L, x, i, j, h));
  }
  rr[t] = r;
  d[t] = mul_rn(r, it);
  if (from_zero) x[t] = T(0);
}

template <class H = Zeros, typename T>
__device__ __forceinline__ void cheby_step_at(const LvlT<T>& L, T* x, T* rr,
                                              const T* d, T* dn, T cp, T cr,
                                              int t, const H& h = H()) {
  const int i = t / L.X, j = t - i * L.X;
  const T dd = d[t];
  x[t] = add_rn(x[t], dd);
  const T r = sub_rn(rr[t], apply_at<true, true>(L, d, i, j, h));
  rr[t] = r;
  dn[t] = fmac(cp, dd, mul_rn(cr, r));
}

// coarsest level: `degree` Chebyshev steps from zero in one block
// (x = b/theta; rr = b - A b/theta; d = c_prev_0 x + c_r_0 rr; then
// x += d, rr -= A d, d = c_prev_k d + c_r_k rr; the last step x += d)
template <typename T>
__device__ __forceinline__ void coarse_solve_block(const LvlT<T>& L,
                                                   const T* b, T* x, T* rr,
                                                   T* d, T* dn, const T* row,
                                                   int degree) {
  const int n = L.Y * L.X;
  const T it = row[0];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int i = t / L.X, j = t - i * L.X;
    const T bv = b[t];
    const T xv = mul_rn(it, bv);
    x[t] = xv;
    if (degree > 1) {
      const T r = fmac(-it, apply_at<true, true>(L, b, i, j), bv);
      rr[t] = r;
      d[t] = fmac(row[1], xv, mul_rn(row[2], r));
    }
  }
  __syncthreads();
  for (int k = 1; k < degree; ++k) {
    const bool last = k == degree - 1;
    const T cp = row[1 + 2 * k], cr = row[2 + 2 * k];
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const T dd = d[t];
      x[t] = add_rn(x[t], dd);
      if (!last) {
        const int i = t / L.X, j = t - i * L.X;
        const T r = sub_rn(rr[t], apply_at<false, true>(L, d, i, j));
        rr[t] = r;
        dn[t] = fmac(cp, dd, mul_rn(cr, r));
      }
    }
    __syncthreads();
    T* tmp = d;
    d = dn;
    dn = tmp;
  }
}

// ---- red-black Gauss-Seidel on the edge levels (P3, mg_smoother="rbgs") ----
//
// multigrid.smooth_edge: a half-sweep of one colour (red: i + j even) sets
// x += (b - A x) * inv_c on that colour's cells.  A cell's stencil reads
// only itself and cells of the other colour, so a half-sweep updates x in
// place.  inv_c is the JAX level's: one correctly rounded reciprocal of c
// where c > 1e-12 (at a packed level 0, of a_diag on fluid cells), else 0,
// which then multiplies; r * inv_c is rounded before it is added to x (the
// JAX package's order), whatever EU_FMAD says.

template <typename T>
__device__ __forceinline__ T inv_c_at(const LvlT<T>& L, int k) {
  if (L.pk) {
    const T p = L.pk[k];
    const T a = sub_rn(p, T(8));
    return p >= T(8) && a > T(0) ? rcp_rn(a) : T(0);
  }
  const T c = L.c[k];
  return c > T(1e-12) ? rcp_rn(c) : T(0);
}

// the half-sweep of `color` at cell t (other cells keep x); `from_zero`:
// the first half-sweep from x = 0, which writes every cell (b * inv_c on
// the colour, 0 elsewhere)
template <typename T>
__device__ __forceinline__ void rbgs_at(const LvlT<T>& L, const T* b, T* x,
                                        int color, bool from_zero, int t) {
  const int i = t / L.X, j = t - i * L.X;
  const bool on = ((i + j) & 1) == color;
  if (from_zero) {
    x[t] = on ? mul_rn(b[t], inv_c_at(L, t)) : T(0);
  } else if (on) {
    const T r = sub_rn(b[t], apply_at<true, false>(L, x, i, j));
    x[t] = add_rn(x[t], mul_rn(r, inv_c_at(L, t)));
  }
}

// ---- one launch per level operation ----
//
// Every kernel reads the stop flag first; all threads of the grid read
// the same value before any kernel of the iteration can change it, so
// the early return is uniform.

// the restrictions run over the child's stored Yc x Xc cells
template <typename T>
__global__ void pre1_restrict(LvlT<T> L, int Yc, int Xc,
                              const T* __restrict__ b, T* __restrict__ x,
                              T* __restrict__ bc, const T* __restrict__ row,
                              const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  pre1_restrict_at(L, b, x, bc, row[0], Xc, t);
}

template <typename T>
__global__ void restrict_full(LvlT<T> L, int Yc, int Xc,
                              const T* __restrict__ b,
                              const T* __restrict__ x, T* __restrict__ bc,
                              const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  restrict_full_at(L, b, x, bc, Xc, t);
}

template <typename T>
__global__ void prolong_add(LvlT<T> L, int Xc, const T* __restrict__ zc,
                            T* __restrict__ x,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  prolong_add_at(L, zc, x, Xc, t);
}

// with DOT, also the per-block partial sums of z * b (the PCG <z, r> at
// level 0)
template <bool DOT, typename T>
__global__ void post1(LvlT<T> L, const T* __restrict__ b,
                      const T* __restrict__ x, T* __restrict__ z,
                      const T* __restrict__ row, T* __restrict__ part,
                      const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T acc = T(0);
  if (t < L.Y * L.X) acc = post1_at(L, b, x, z, row[0], t);
  if (DOT) {
    acc = block_reduce<EU_SUM>(acc);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}

template <typename T>
__global__ void cheby_init(LvlT<T> L, const T* __restrict__ b,
                           T* __restrict__ x, T* __restrict__ rr,
                           T* __restrict__ d, const T* __restrict__ row,
                           int from_zero, const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  cheby_init_at(L, b, x, rr, d, row[0], from_zero, t);
}

template <typename T>
__global__ void cheby_step(LvlT<T> L, T* __restrict__ x, T* __restrict__ rr,
                           const T* __restrict__ d, T* __restrict__ dn,
                           const T* __restrict__ row, int k,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  cheby_step_at(L, x, rr, d, dn, row[1 + 2 * k], row[2 + 2 * k], t);
}

template <typename T>
__global__ void axpy1(int n, T* __restrict__ x, const T* __restrict__ d,
                      const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] = add_rn(x[t], d[t]);
}

template <typename T>
__global__ void dot_partial(int n, const T* __restrict__ a,
                            const T* __restrict__ b, T* __restrict__ part,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T acc = t < n ? mul_rn(a[t], b[t]) : T(0);
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

template <typename T>
__global__ void coarse_solve(LvlT<T> L, const T* __restrict__ b, T* x, T* rr,
                             T* d, T* dn, const T* __restrict__ row,
                             int degree, const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  coarse_solve_block(L, b, x, rr, d, dn, row, degree);
}

// one RB-GS half-sweep of `color` over level L (`rbgs_at` of its level
// type: an edge level here, a rediscretized one in pcg_mg_redisc.cu)
template <class Lv, typename T>
__global__ void rbgs_half(Lv L, const T* __restrict__ b, T* x,
                          int color, int from_zero,
                          const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  rbgs_at(L, b, x, color, from_zero != 0, t);
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

template <typename T>
struct SolveT {
  int L;
  LvlT<T> lv[16];
  T* x[16];
  T* b[16];
  T* z[16];
  T* rr[16];
  T* d[16];
  T* dn[16];
  const T* rows;
  int ncoef;
  int deg, coarse_deg, w, w_depth;
  int fused;        // the level where coarse_cycle takes over (L: none)
  int fused_smem;   // its dynamic shared memory, bytes
  T* part;
  const int* flags;
  cudaStream_t s;

  __host__ __device__ const T* row(int l) const { return rows + l * ncoef; }
  __host__ __device__ int visits(int l) const {
    return (l < w_depth && l + 1 < L - 1) ? w : 1;
  }
  // where level l leaves its cycle output
  __host__ __device__ T* zout(int l) const {
    return (l == L - 1 || deg != 1) ? x[l] : z[l];
  }
  unsigned blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l].Y) * lv[l].X, kThreads);
  }
  // the restriction of level l: a thread per stored cell of level l + 1
  unsigned coarse_blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l + 1].Y) * lv[l + 1].X,
                     kThreads);
  }
  // the shared memory of coarse_cycle from level f: the levels below it
  long long smem_below(int f) const {
    long long bytes = 0;
    for (int l = f + 1; l < L; ++l)
      bytes += static_cast<long long>(sizeof(T)) * kFusedPlanes * lv[l].Y *
               lv[l].X;
    return bytes;
  }

  // general-degree smoothing of level l; result in x[l]
  int cheby(int l, bool from_zero) {
    cheby_init<T><<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], rr[l],
                                                 d[l], row(l), from_zero,
                                                 flags);
    int rc = eu_launch_status();
    if (rc) return rc;
    T *dc = d[l], *dnc = dn[l];
    for (int k = 0; k + 1 < deg; ++k) {
      cheby_step<T><<<blocks(l), kThreads, 0, s>>>(lv[l], x[l], rr[l], dc,
                                                   dnc, row(l), k, flags);
      if ((rc = eu_launch_status())) return rc;
      T* tmp = dc;
      dc = dnc;
      dnc = tmp;
    }
    axpy1<T><<<blocks(l), kThreads, 0, s>>>(lv[l].Y * lv[l].X, x[l], dc,
                                            flags);
    return eu_launch_status();
  }

  int launch_fused(int l) const;

  // z_l ~= A_l^{-1} b_l; with dot (level 0), the partials of <z, b>
  int cycle(int l, bool dot) {
    int rc;
    const int n = lv[l].Y * lv[l].X;
    if (l == fused) return launch_fused(l);
    if (l == L - 1) {
      coarse_solve<T><<<1, kCoarseThreads, 0, s>>>(lv[l], b[l], x[l], rr[l],
                                                   d[l], dn[l], row(l),
                                                   coarse_deg, flags);
      if ((rc = eu_launch_status())) return rc;
      if (dot) {
        dot_partial<T><<<blocks(l), kThreads, 0, s>>>(n, x[l], b[l], part,
                                                      flags);
        return eu_launch_status();
      }
      return 0;
    }
    const int Yc = lv[l + 1].Y, Xc = lv[l + 1].X;
    if (deg == 1) {
      pre1_restrict<T><<<coarse_blocks(l), kThreads, 0, s>>>(
          lv[l], Yc, Xc, b[l], x[l], b[l + 1], row(l), flags);
      if ((rc = eu_launch_status())) return rc;
    } else {
      if ((rc = cheby(l, true))) return rc;
      restrict_full<T><<<coarse_blocks(l), kThreads, 0, s>>>(
          lv[l], Yc, Xc, b[l], x[l], b[l + 1], flags);
      if ((rc = eu_launch_status())) return rc;
    }
    for (int v = 0; v < visits(l); ++v) {
      if (v > 0) {
        restrict_full<T><<<coarse_blocks(l), kThreads, 0, s>>>(
            lv[l], Yc, Xc, b[l], x[l], b[l + 1], flags);
        if ((rc = eu_launch_status())) return rc;
      }
      if ((rc = cycle(l + 1, false))) return rc;
      prolong_add<T><<<blocks(l), kThreads, 0, s>>>(lv[l], Xc, zout(l + 1),
                                                    x[l], flags);
      if ((rc = eu_launch_status())) return rc;
    }
    if (deg == 1) {
      if (dot)
        post1<true, T><<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], z[l],
                                                      row(l), part, flags);
      else
        post1<false, T><<<blocks(l), kThreads, 0, s>>>(
            lv[l], b[l], x[l], z[l], row(l), part, flags);
      return eu_launch_status();
    }
    if ((rc = cheby(l, false))) return rc;
    if (dot) {
      dot_partial<T><<<blocks(l), kThreads, 0, s>>>(n, x[l], b[l], part,
                                                    flags);
      return eu_launch_status();
    }
    return 0;
  }
};
using Solve = SolveT<float>;

// ---- the coarse end of the cycle in one launch ----

// a barrier over the cluster (CL) or over the CTA
template <bool CL>
__device__ __forceinline__ void level_sync() {
  if (CL)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

template <bool CL, typename T>
__device__ void cheby_dev(const SolveT<T>& S, int l, bool from_zero,
                          int first, int stride) {
  const LvlT<T> L = S.lv[l];
  const int n = L.Y * L.X;
  const T* const row = S.row(l);
  const T* const b = S.b[l];
  T* const x = S.x[l];
  T* const rr = S.rr[l];
  const int deg = S.deg;
  const T it = row[0];
  for (int t = first; t < n; t += stride)
    cheby_init_at(L, b, x, rr, S.d[l], it, from_zero, t);
  level_sync<CL>();
  T *dc = S.d[l], *dnc = S.dn[l];
  for (int k = 0; k + 1 < deg; ++k) {
    const T cp = row[1 + 2 * k], cr = row[2 + 2 * k];
    for (int t = first; t < n; t += stride)
      cheby_step_at(L, x, rr, dc, dnc, cp, cr, t);
    level_sync<CL>();
    T* tmp = dc;
    dc = dnc;
    dnc = tmp;
  }
  for (int t = first; t < n; t += stride) x[t] = add_rn(x[t], dc[t]);
  level_sync<CL>();
}

// The two halves of Solve::cycle(l, false) at a level visited once, on
// the device: CL, the cluster shares level l's operations (element
// first, first + stride, ...); else the calling CTA runs them.  Every
// operation ends with a barrier.  The level's view is held in registers
// (the schedule itself lives in shared memory).
template <bool CL, typename T>
__device__ __forceinline__ void descend(const SolveT<T>& S, int l, int first,
                                        int stride) {
  const LvlT<T> L = S.lv[l];
  const int Xc = S.lv[l + 1].X;
  const int nc = S.lv[l + 1].Y * Xc;
  const T* const b = S.b[l];
  T* const x = S.x[l];
  T* const bc = S.b[l + 1];
  if (S.deg == 1) {
    const T it = S.row(l)[0];
    for (int t = first; t < nc; t += stride)
      pre1_restrict_at(L, b, x, bc, it, Xc, t);
  } else {
    cheby_dev<CL>(S, l, true, first, stride);
    for (int t = first; t < nc; t += stride)
      restrict_full_at(L, b, x, bc, Xc, t);
  }
  level_sync<CL>();
}

template <bool CL, typename T>
__device__ __forceinline__ void ascend(const SolveT<T>& S, int l, int first,
                                       int stride) {
  const LvlT<T> L = S.lv[l];
  const int n = L.Y * L.X;
  const int Xc = S.lv[l + 1].X;
  T* const x = S.x[l];
  const T* const zc = S.zout(l + 1);
  for (int t = first; t < n; t += stride) prolong_add_at(L, zc, x, Xc, t);
  level_sync<CL>();
  if (S.deg == 1) {
    const T it = S.row(l)[0];
    const T* const b = S.b[l];
    T* const z = S.z[l];
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
template <typename T>
__global__ void __launch_bounds__(kCoarseThreads, 1)
    coarse_cycle(const __grid_constant__ SolveT<T> S0, int from,
                 const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  extern __shared__ __align__(16) unsigned char coarse_smem[];
  T* const smem = reinterpret_cast<T*>(coarse_smem);
  __shared__ SolveT<T> S;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  T* base = rank == 0 ? smem : cluster.map_shared_rank(smem, 0);
  const int* src = reinterpret_cast<const int*>(&S0);
  int* dst = reinterpret_cast<int*>(&S);
  for (int i = threadIdx.x;
       i < static_cast<int>(sizeof(SolveT<T>) / sizeof(int));
       i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  int off = 0;
  for (int l = from + 1; l < S0.L; ++l) {
    const int n = S0.lv[l].Y * S0.lv[l].X;
    T* pl[kFusedPlanes];
    for (int q = 0; q < kFusedPlanes; ++q) pl[q] = base + off + q * n;
    if (rank == 0) {
      const T* __restrict__ c = S0.lv[l].c;
      const T* __restrict__ e = S0.lv[l].e;
      const T* __restrict__ nn = S0.lv[l].n;
      T* own = smem + off;
#pragma unroll 4
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const T cv = c[t], ev = e[t], nv = nn[t];
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
    const LvlT<T> Lc = S.lv[last];
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

// The start of coarse_cycle_rbgs, as coarse_cycle starts: the schedule S0
// copied into S (the calling CTA's shared memory), with the planes of
// every level below `from` remapped into CTA 0's shared memory `smem`
// (their c, e, n copied in, the rest scratch), where the other CTAs of the
// cluster reach them through distributed shared memory; ends with a
// cluster barrier.  (coarse_cycle keeps its own copy of these lines: a
// call there changed its register allocation, which stays as it was.)
template <typename T>
__device__ __forceinline__ void stage_below(const SolveT<T>& S0, int from,
                                            SolveT<T>& S, T* smem,
                                            cg::cluster_group& cluster) {
  const unsigned rank = cluster.block_rank();
  T* base = rank == 0 ? smem : cluster.map_shared_rank(smem, 0);
  const int* src = reinterpret_cast<const int*>(&S0);
  int* dst = reinterpret_cast<int*>(&S);
  for (int i = threadIdx.x;
       i < static_cast<int>(sizeof(SolveT<T>) / sizeof(int));
       i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
  int off = 0;
  for (int l = from + 1; l < S0.L; ++l) {
    const int n = S0.lv[l].Y * S0.lv[l].X;
    T* pl[kFusedPlanes];
    for (int q = 0; q < kFusedPlanes; ++q) pl[q] = base + off + q * n;
    if (rank == 0) {
      const T* __restrict__ c = S0.lv[l].c;
      const T* __restrict__ e = S0.lv[l].e;
      const T* __restrict__ nn = S0.lv[l].n;
      T* own = smem + off;
#pragma unroll 4
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const T cv = c[t], ev = e[t], nv = nn[t];
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
}

// ---- the RB-GS cycle's coarse end (P3, mg_smoother="rbgs") ----

// `sweeps` symmetric RB-GS sweeps over level L by the threads first,
// first + stride, ... of one CTA (CL false) or of the cluster (CL true),
// a barrier after each half-sweep: red then black, or with `reverse`
// black then red; from x = 0 with `from_zero` (x = 0 when sweeps is 0)
template <bool CL, class Lv, typename T>
__device__ void rbgs_dev(const Lv& L, const T* b, T* x, int sweeps,
                         bool from_zero, bool reverse, int first,
                         int stride) {
  const int n = L.Y * L.X;
  if (from_zero && sweeps == 0) {
    for (int t = first; t < n; t += stride) x[t] = T(0);
    level_sync<CL>();
    return;
  }
  for (int k = 0; k < sweeps; ++k)
    for (int h = 0; h < 2; ++h) {
      const int color = reverse ? 1 - h : h;
      const bool zero = from_zero && k == 0 && h == 0;
      for (int t = first; t < n; t += stride)
        rbgs_at(L, b, x, color, zero, t);
      level_sync<CL>();
    }
}

// the coarsest level: `sweeps` forward sweeps from zero, then as many
// reversed, in one CTA
template <class Lv, typename T>
__device__ __forceinline__ void rbgs_coarse_block(const Lv& L, const T* b,
                                                  T* x, int sweeps) {
  rbgs_dev<false>(L, b, x, sweeps, true, false, threadIdx.x, blockDim.x);
  rbgs_dev<false>(L, b, x, sweeps, false, true, threadIdx.x, blockDim.x);
}

template <class Lv, typename T>
__global__ void rbgs_coarse(Lv L, const T* __restrict__ b, T* x, int sweeps,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  rbgs_coarse_block(L, b, x, sweeps);
}

// `n` symmetric sweeps of one level of `cells` cells as one launch a
// half-sweep, `half(color, from_zero)`: red first (black first with
// `reverse`); from x = 0 with `from_zero` (a zero fill of x for n = 0)
template <typename T, class Half>
inline int rbgs_sweeps(T* x, long long cells, int n, bool from_zero,
                       bool reverse, cudaStream_t st, const Half& half) {
  if (from_zero && n == 0)
    return static_cast<int>(cudaMemsetAsync(x, 0, sizeof(T) * cells, st));
  for (int k = 0; k < n; ++k)
    for (int h = 0; h < 2; ++h) {
      half(reverse ? 1 - h : h, from_zero && k == 0 && h == 0);
      const int rc = eu_launch_status();
      if (rc) return rc;
    }
  return 0;
}

// the RB-GS halves of a level visited once (`descend` / `ascend` with
// pre and post sweeps): the pre-smooth from zero and the restriction of b
// - A x; the prolongation of the child's x and the reversed post-smooth
template <bool CL, typename T>
__device__ __forceinline__ void descend_rbgs(const SolveT<T>& S, int l,
                                             int pre, int first,
                                             int stride) {
  const LvlT<T> L = S.lv[l];
  const int Xc = S.lv[l + 1].X;
  const int nc = S.lv[l + 1].Y * Xc;
  rbgs_dev<CL>(L, S.b[l], S.x[l], pre, true, false, first, stride);
  for (int t = first; t < nc; t += stride)
    restrict_full_at(L, S.b[l], S.x[l], S.b[l + 1], Xc, t);
  level_sync<CL>();
}

template <bool CL, typename T>
__device__ __forceinline__ void ascend_rbgs(const SolveT<T>& S, int l,
                                            int post, int first,
                                            int stride) {
  const LvlT<T> L = S.lv[l];
  const int n = L.Y * L.X;
  const int Xc = S.lv[l + 1].X;
  for (int t = first; t < n; t += stride)
    prolong_add_at(L, S.x[l + 1], S.x[l], Xc, t);
  level_sync<CL>();
  rbgs_dev<CL>(L, S.b[l], S.x[l], post, false, true, first, stride);
}

// `coarse_cycle` with RB-GS smoothing (pre, post sweeps; `coarse` forward
// and reversed sweeps at the coarsest level), every level leaving its
// output in x: the same cluster, the same staging, the same per-cell
// functions as one launch per level operation (`RbgsT`)
template <typename T>
__global__ void __launch_bounds__(kCoarseThreads, 1)
    coarse_cycle_rbgs(const __grid_constant__ SolveT<T> S0, int from,
                      int pre, int post, int coarse,
                      const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  extern __shared__ __align__(16) unsigned char coarse_smem[];
  __shared__ SolveT<T> S;
  cg::cluster_group cluster = cg::this_cluster();
  stage_below(S0, from, S, reinterpret_cast<T*>(coarse_smem), cluster);
  const unsigned rank = cluster.block_rank();
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = cluster.num_blocks() * blockDim.x;
  const int last = S0.L - 1;
  if (from < last) descend_rbgs<true>(S, from, pre, first, stride);
  if (rank == 0) {
    for (int l = from + 1; l < last; ++l)
      descend_rbgs<false>(S, l, pre, threadIdx.x, blockDim.x);
    rbgs_coarse_block(S.lv[last], S.b[last], S.x[last], coarse);
    for (int l = last - 1; l > from; --l)
      ascend_rbgs<false>(S, l, post, threadIdx.x, blockDim.x);
  }
  if (from == last) return;
  cluster.sync();
  ascend_rbgs<true>(S, from, post, first, stride);
}

// one launch of `kernel` (coarse_cycle or coarse_cycle_rbgs) on a cluster
// of kFusedCtas CTAs of kCoarseThreads threads, `smem` bytes of dynamic
// shared memory each
template <typename Kernel, typename... Args>
inline int launch_cluster(Kernel kernel, int smem, cudaStream_t s,
                          Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kFusedCtas);
  cfg.blockDim = dim3(kCoarseThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFusedCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  return rc ? rc : eu_launch_status();
}

template <typename T>
inline int SolveT<T>::launch_fused(int l) const {
  return launch_cluster(coarse_cycle<T>, fused_smem, s, *this, l, flags);
}

// Where the coarse end of S's cycle starts so that the levels below it fit
// the shared memory `kernel` (coarse_cycle or coarse_cycle_rbgs) may have,
// from S->fused down, and that memory raised to it.
template <typename T, class Kernel>
inline int fit_fused(SolveT<T>* S, Kernel kernel) {
  const int L = S->L;
  S->fused_smem = static_cast<int>(S->smem_below(S->fused));
  if (S->fused_smem <= 48 * 1024) return 0;
  // the limit is the kernel's, not this solver's: raise it to all the
  // card allows, so that a solver made later with a smaller coarse end
  // cannot lower it under this one's launches
  cudaFuncAttributes fa;
  int rc = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
  int dev = 0, optin = 0;
  if (!rc) rc = static_cast<int>(cudaGetDevice(&dev));
  if (!rc)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (rc) return rc;
  const int most = optin - static_cast<int>(fa.sharedSizeBytes);
  // start lower where the levels below do not fit (a V from any level
  // below the first is a V too)
  while (S->fused < L && S->smem_below(S->fused) > most) ++S->fused;
  S->fused_smem = static_cast<int>(S->smem_below(S->fused));
  if (S->fused_smem > most) return static_cast<int>(cudaErrorInvalidValue);
  if (fa.maxDynamicSharedSizeBytes >= most) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most));
}

// A Solve over L levels.  planes: P_COUNT pointers per level (c, e, n, x,
// b, z, rr, d, dn) of T planes; shapes: (Y, X) per level; rows: [L,
// ncoef] Chebyshev rows.  With packed0, level 0 is the packed PCG matrix
// (its c/e/n are unused) and its b is b0; without, level 0 is in edge form
// like the rest.  coarse_cycle takes over at the first level below 0 of
// at most kFusedCells cells from which every level is visited once (at
// 1024² with the truncated W of depth 2: 128²), or, where the levels below
// that one do not fit the card's shared memory in T (f64 at 1024²: 64² +
// 32² cells of 9 planes is 368,640 bytes), at the first level below it
// whose lower levels fit (f64 at 1024²: 64²); every f32 plan fits at the
// first.  Every kernel reads the stop flag in flags.
template <typename T>
inline int make_solve(SolveT<T>* S, int L, const int* shapes,
                      void* const* planes, const void* packed0, void* b0,
                      const void* rows, int ncoef, int deg, int coarse_deg,
                      int w, int w_depth, void* part, const void* flags,
                      void* stream) {
  if (L < 1 || L > 16) return static_cast<int>(cudaErrorInvalidValue);
  S->L = L;
  S->rows = static_cast<const T*>(rows);
  S->ncoef = ncoef;
  S->deg = deg;
  S->coarse_deg = coarse_deg;
  S->w = w;
  S->w_depth = w_depth;
  S->part = static_cast<T*>(part);
  S->flags = static_cast<const int*>(flags);
  S->s = static_cast<cudaStream_t>(stream);
  S->fused = L;
  for (int l = 0; l < L; ++l) {
    void* const* pl = planes + l * P_COUNT;
    const bool packed = l == 0 && packed0;
    const int Y = shapes[2 * l], X = shapes[2 * l + 1];
    S->lv[l] = LvlT<T>{Y, X, static_cast<const T*>(pl[P_C]),
                       static_cast<const T*>(pl[P_E]),
                       static_cast<const T*>(pl[P_N]),
                       packed ? static_cast<const T*>(packed0) : nullptr};
    S->x[l] = static_cast<T*>(pl[P_X]);
    S->b[l] = packed ? static_cast<T*>(b0) : static_cast<T*>(pl[P_B]);
    S->z[l] = static_cast<T*>(pl[P_Z]);
    S->rr[l] = static_cast<T*>(pl[P_RR]);
    S->d[l] = static_cast<T*>(pl[P_D]);
    S->dn[l] = static_cast<T*>(pl[P_DN]);
    if (l >= 1 && S->fused == L && static_cast<long long>(Y) * X <= kFusedCells)
      S->fused = l;
  }
  // coarse_cycle runs a V: no level from the fused one down is revisited
  while (S->fused < L && S->visits(S->fused) != 1) ++S->fused;
  return fit_fused(S, coarse_cycle<T>);
}

// The cycle of P3 with RB-GS smoothing (multigrid.cycle_galerkin with
// smoother="rbgs") over a Solve made with deg 0, so that every level
// leaves its output in x (`zout`): at level l, `pre` sweeps from zero
// (2 pre launches: the first half-sweep writes every cell), the
// restriction of b - A x, per visit the cycle below, its prolongation
// (and before each visit after the first the restriction again), then
// `post` reversed sweeps (2 post launches); the coarsest level is one
// CTA's `coarse` forward and as many reversed sweeps.  From S.fused down
// the whole V is one cluster launch of coarse_cycle_rbgs.  An iteration
// of the loop at 1024² (six levels, the W on levels 0 and 1, the cluster
// from 128²) enqueues 8 + 2 (8 + 2 (6 + 1)) = 52 launches of the cycle:
// 8 a visit of levels 0 and 1, 6 a visit of level 2, 1 cluster launch.
template <typename T>
struct RbgsT {
  SolveT<T> S;
  int pre, post, coarse;

  // n symmetric sweeps of level l, red first (black first with reverse);
  // from x = 0 with from_zero (a zero fill for n = 0)
  int sweeps(int l, int n, bool from_zero, bool reverse) const {
    const LvlT<T>& L = S.lv[l];
    return rbgs_sweeps(S.x[l], static_cast<long long>(L.Y) * L.X, n,
                       from_zero, reverse, S.s, [&](int color, bool zero) {
                         rbgs_half<<<S.blocks(l), kThreads, 0, S.s>>>(
                             L, S.b[l], S.x[l], color, zero, S.flags);
                       });
  }

  int restrict_to(int l) const {
    restrict_full<T><<<S.coarse_blocks(l), kThreads, 0, S.s>>>(
        S.lv[l], S.lv[l + 1].Y, S.lv[l + 1].X, S.b[l], S.x[l], S.b[l + 1],
        S.flags);
    return eu_launch_status();
  }

  int launch_fused(int l) const {
    return launch_cluster(coarse_cycle_rbgs<T>, S.fused_smem, S.s, S, l, pre,
                          post, coarse, S.flags);
  }

  // x_l ~= A_l^{-1} b_l
  int cycle(int l) const {
    if (l == S.fused) return launch_fused(l);
    int rc;
    if (l == S.L - 1) {
      rbgs_coarse<<<1, kCoarseThreads, 0, S.s>>>(S.lv[l], S.b[l], S.x[l],
                                                 coarse, S.flags);
      return eu_launch_status();
    }
    if ((rc = sweeps(l, pre, true, false)) || (rc = restrict_to(l))) return rc;
    for (int v = 0; v < S.visits(l); ++v) {
      if (v > 0 && (rc = restrict_to(l))) return rc;
      if ((rc = cycle(l + 1))) return rc;
      prolong_add<T><<<S.blocks(l), kThreads, 0, S.s>>>(
          S.lv[l], S.lv[l + 1].X, S.x[l + 1], S.x[l], S.flags);
      if ((rc = eu_launch_status())) return rc;
    }
    return sweeps(l, post, false, true);
  }
};

// The RB-GS cycle over a Solve `S` made by make_solve with deg 0: its
// coarse end re-fitted to coarse_cycle_rbgs's shared memory.
template <typename T>
inline int make_rbgs(RbgsT<T>* R, const SolveT<T>& S, int pre, int post,
                     int coarse) {
  R->S = S;
  R->pre = pre;
  R->post = post;
  R->coarse = coarse;
  return fit_fused(&R->S, coarse_cycle_rbgs<T>);
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
