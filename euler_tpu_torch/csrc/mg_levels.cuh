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
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoarseThreads = 1024;

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

// A x at (i, j): the masked 5-point PCG matrix at level 0, the
// edge-weight operator (intrinsically masked) above it
__device__ __forceinline__ float apply_at(const Lvl& L, const float* x, int i,
                                          int j) {
  const int k = i * L.X + j;
  if (L.pk) {
    const float p = L.pk[k];
    const float fl = p >= 8.0f ? 1.0f : 0.0f;
    const float a = p - 8.0f * fl;
    float nb = ld(x, i, j - 1, L.Y, L.X) + ld(x, i, j + 1, L.Y, L.X);
    nb = nb + ld(x, i + 1, j, L.Y, L.X);
    nb = nb + ld(x, i - 1, j, L.Y, L.X);
    return fl * (a * x[k] - nb);
  }
  float r = L.c[k] * x[k];
  r = r + L.e[k] * ld(x, i, j + 1, L.Y, L.X);
  r = r + ld(L.e, i, j - 1, L.Y, L.X) * ld(x, i, j - 1, L.Y, L.X);
  r = r + L.n[k] * ld(x, i + 1, j, L.Y, L.X);
  r = r + ld(L.n, i - 1, j, L.Y, L.X) * ld(x, i - 1, j, L.Y, L.X);
  return r;
}

__device__ __forceinline__ float fluid0(const Lvl& L, int k) {
  return L.pk[k] >= 8.0f ? 1.0f : 0.0f;
}

// degree-1 pre-smooth from zero fused with the restriction: per coarse
// cell, x = b/theta and rr = b - A b/theta on its 4 children, and
// b_c = the 2x2 sum of rr
__global__ void pre1_restrict(Lvl L, const float* __restrict__ b,
                              float* __restrict__ x, float* __restrict__ bc,
                              const float* __restrict__ row) {
  const int Xc = L.X / 2, Yc = L.Y / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  const int I = t / Xc, J = t - I * Xc;
  const float it = row[0];
  float rr[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c, k = i * L.X + j;
      const float bv = b[k];
      x[k] = it * bv;
      rr[a][c] = bv - it * apply_at(L, b, i, j);
    }
  bc[t] = (rr[0][0] + rr[1][0]) + (rr[0][1] + rr[1][1]);
}

// b_c = R(b - A x)
__global__ void restrict_full(Lvl L, const float* __restrict__ b,
                              const float* __restrict__ x,
                              float* __restrict__ bc) {
  const int Xc = L.X / 2, Yc = L.Y / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  const int I = t / Xc, J = t - I * Xc;
  float rr[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c;
      rr[a][c] = b[i * L.X + j] - apply_at(L, x, i, j);
    }
  bc[t] = (rr[0][0] + rr[1][0]) + (rr[0][1] + rr[1][1]);
}

// x += P z_c (constant injection, masked by fluid at level 0)
__global__ void prolong_add(Lvl L, const float* __restrict__ zc,
                            float* __restrict__ x) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  const int i = t / L.X, j = t - i * L.X;
  float add = zc[(i / 2) * (L.X / 2) + j / 2];
  if (L.pk) add = fluid0(L, t) * add;
  x[t] = x[t] + add;
}

// degree-1 post-smooth: z = x + (b - A x)/theta; with DOT, also the
// per-block partial sums of z * b (the PCG <z, r> at level 0)
template <bool DOT>
__global__ void post1(Lvl L, const float* __restrict__ b,
                      const float* __restrict__ x, float* __restrict__ z,
                      const float* __restrict__ row,
                      float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < L.Y * L.X) {
    const int i = t / L.X, j = t - i * L.X;
    const float bb = b[t];
    const float zz = x[t] + (bb - apply_at(L, x, i, j)) * row[0];
    z[t] = zz;
    acc = zz * bb;
  }
  if (DOT) {
    acc = block_reduce<EU_SUM>(acc);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}

// general-degree Chebyshev smoothing (cheby_smooth of ops/multigrid.py):
// init, degree-1 steps, then x += d
__global__ void cheby_init(Lvl L, const float* __restrict__ b,
                           float* __restrict__ x, float* __restrict__ rr,
                           float* __restrict__ d,
                           const float* __restrict__ row, int from_zero) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  const int i = t / L.X, j = t - i * L.X;
  float r;
  if (from_zero) {
    r = b[t];
  } else {
    r = b[t] - apply_at(L, x, i, j);
  }
  rr[t] = r;
  d[t] = r * row[0];
  if (from_zero) x[t] = 0.0f;
}

__global__ void cheby_step(Lvl L, float* __restrict__ x,
                           float* __restrict__ rr,
                           const float* __restrict__ d,
                           float* __restrict__ dn,
                           const float* __restrict__ row, int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  const int i = t / L.X, j = t - i * L.X;
  const float dd = d[t];
  x[t] = x[t] + dd;
  const float r = rr[t] - apply_at(L, d, i, j);
  rr[t] = r;
  dn[t] = row[1 + 2 * k] * dd + row[2 + 2 * k] * r;
}

__global__ void axpy1(int n, float* __restrict__ x,
                      const float* __restrict__ d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) x[t] = x[t] + d[t];
}

__global__ void dot_partial(int n, const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = t < n ? a[t] * b[t] : 0.0f;
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// coarsest level: `degree` Chebyshev steps from zero in one block
// (x = b/theta; rr = b - A b/theta; d = c_prev_0 x + c_r_0 rr; then
// x += d, rr -= A d, d = c_prev_k d + c_r_k rr; the last step x += d)
__global__ void coarse_solve(Lvl L, const float* __restrict__ b, float* x,
                             float* rr, float* d, float* dn,
                             const float* __restrict__ row, int degree) {
  const int n = L.Y * L.X;
  const float it = row[0];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int i = t / L.X, j = t - i * L.X;
    const float bv = b[t];
    const float xv = it * bv;
    x[t] = xv;
    if (degree > 1) {
      const float r = bv - it * apply_at(L, b, i, j);
      rr[t] = r;
      d[t] = row[1] * xv + row[2] * r;
    }
  }
  __syncthreads();
  for (int k = 1; k < degree; ++k) {
    const bool last = k == degree - 1;
    const float cp = row[1 + 2 * k], cr = row[2 + 2 * k];
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float dd = d[t];
      x[t] = x[t] + dd;
      if (!last) {
        const int i = t / L.X, j = t - i * L.X;
        const float r = rr[t] - apply_at(L, d, i, j);
        rr[t] = r;
        dn[t] = cp * dd + cr * r;
      }
    }
    __syncthreads();
    float* tmp = d;
    d = dn;
    dn = tmp;
  }
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
  p[t] = p[t] * fluid0(L0, t) * on;
}

__global__ void warm_resid(Lvl L0, float* __restrict__ r,
                           const float* __restrict__ p,
                           float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    const float rv = r[t] - apply_at(L0, p, i, j);
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
                             float* scal) {
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
                         float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    const float beta = scal[S_BETA];
    const float sn = z[t] + beta * s[t];
    const float an = apply_at(L0, z, i, j) + beta * As[t];
    s[t] = sn;
    As[t] = an;
    acc = an * sn;
  }
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void alpha_reduce(const float* __restrict__ part, int nparts,
                             float* scal) {
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
                         float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  if (t < n) {
    const float alpha = scal[S_ALPHA];
    p[t] = p[t] + alpha * s[t];
    const float rv = r[t] - alpha * As[t];
    r[t] = rv;
    m = fabsf(rv);
  }
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

__global__ void conv_reduce(const float* __restrict__ part, int nparts,
                            float* scal, int* flags) {
  const float rmax = reduce_partials<EU_MAX>(part, nparts);
  if (threadIdx.x == 0) {
    flags[F_DONE] = !(rmax > scal[S_TOL]);
    scal[S_RESID] = rmax;
    flags[F_ITERS] += 1;
  }
}

// ---- host side: the cycle schedule and the PCG loop ----

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
  float* part;
  cudaStream_t s;

  const float* row(int l) const { return rows + l * ncoef; }
  unsigned blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l].Y) * lv[l].X, kThreads);
  }
  unsigned coarse_blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l].Y / 2) * (lv[l].X / 2),
                     kThreads);
  }
  // where level l leaves its cycle output
  float* zout(int l) const {
    return (l == L - 1 || deg != 1) ? x[l] : z[l];
  }

  // general-degree smoothing of level l; result in x[l]
  int cheby(int l, bool from_zero) {
    cheby_init<<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], rr[l],
                                              d[l], row(l), from_zero);
    int rc = eu_launch_status();
    if (rc) return rc;
    float *dc = d[l], *dnc = dn[l];
    for (int k = 0; k + 1 < deg; ++k) {
      cheby_step<<<blocks(l), kThreads, 0, s>>>(lv[l], x[l], rr[l], dc, dnc,
                                                row(l), k);
      if ((rc = eu_launch_status())) return rc;
      float* tmp = dc;
      dc = dnc;
      dnc = tmp;
    }
    axpy1<<<blocks(l), kThreads, 0, s>>>(lv[l].Y * lv[l].X, x[l], dc);
    return eu_launch_status();
  }

  // z_l ~= A_l^{-1} b_l; with dot (level 0), the partials of <z, b>
  int cycle(int l, bool dot) {
    int rc;
    const int n = lv[l].Y * lv[l].X;
    if (l == L - 1) {
      coarse_solve<<<1, kCoarseThreads, 0, s>>>(lv[l], b[l], x[l], rr[l],
                                                d[l], dn[l], row(l),
                                                coarse_deg);
      if ((rc = eu_launch_status())) return rc;
      if (dot) {
        dot_partial<<<blocks(l), kThreads, 0, s>>>(n, x[l], b[l], part);
        return eu_launch_status();
      }
      return 0;
    }
    if (deg == 1) {
      pre1_restrict<<<coarse_blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l],
                                                          b[l + 1], row(l));
      if ((rc = eu_launch_status())) return rc;
    } else {
      if ((rc = cheby(l, true))) return rc;
      restrict_full<<<coarse_blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l],
                                                          b[l + 1]);
      if ((rc = eu_launch_status())) return rc;
    }
    const int visits = (l < w_depth && l + 1 < L - 1) ? w : 1;
    for (int v = 0; v < visits; ++v) {
      if (v > 0) {
        restrict_full<<<coarse_blocks(l), kThreads, 0, s>>>(lv[l], b[l],
                                                            x[l], b[l + 1]);
        if ((rc = eu_launch_status())) return rc;
      }
      if ((rc = cycle(l + 1, false))) return rc;
      prolong_add<<<blocks(l), kThreads, 0, s>>>(lv[l], zout(l + 1), x[l]);
      if ((rc = eu_launch_status())) return rc;
    }
    if (deg == 1) {
      if (dot)
        post1<true><<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], z[l],
                                                   row(l), part);
      else
        post1<false><<<blocks(l), kThreads, 0, s>>>(lv[l], b[l], x[l], z[l],
                                                    row(l), part);
      return eu_launch_status();
    }
    if ((rc = cheby(l, false))) return rc;
    if (dot) {
      dot_partial<<<blocks(l), kThreads, 0, s>>>(n, x[l], b[l], part);
      return eu_launch_status();
    }
    return 0;
  }
};

// A Solve over L levels.  planes: P_COUNT pointers per level (c, e, n, x,
// b, z, rr, d, dn); shapes: (Y, X) per level; rows: [L, ncoef] Chebyshev
// rows.  With packed0, level 0 is the packed PCG matrix (its c/e/n are
// unused) and its b is b0; without, level 0 is in edge form like the rest.
inline int make_solve(Solve* S, int L, const int* shapes,
                      void* const* planes, const void* packed0, float* b0,
                      const void* rows, int ncoef, int deg, int coarse_deg,
                      int w, int w_depth, void* part, void* stream) {
  if (L < 1 || L > 16) return static_cast<int>(cudaErrorInvalidValue);
  S->L = L;
  S->rows = static_cast<const float*>(rows);
  S->ncoef = ncoef;
  S->deg = deg;
  S->coarse_deg = coarse_deg;
  S->w = w;
  S->w_depth = w_depth;
  S->part = static_cast<float*>(part);
  S->s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < L; ++l) {
    void* const* pl = planes + l * P_COUNT;
    const bool packed = l == 0 && packed0;
    S->lv[l] = Lvl{shapes[2 * l], shapes[2 * l + 1],
                   static_cast<const float*>(pl[P_C]),
                   static_cast<const float*>(pl[P_E]),
                   static_cast<const float*>(pl[P_N]),
                   packed ? static_cast<const float*>(packed0) : nullptr};
    S->x[l] = static_cast<float*>(pl[P_X]);
    S->b[l] = packed ? b0 : static_cast<float*>(pl[P_B]);
    S->z[l] = static_cast<float*>(pl[P_Z]);
    S->rr[l] = static_cast<float*>(pl[P_RR]);
    S->d[l] = static_cast<float*>(pl[P_D]);
    S->dn[l] = static_cast<float*>(pl[P_DN]);
  }
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
    sigma_reduce<<<1, 1024, 0, st>>>(part, nb, scal);
    int rc = eu_launch_status();
    if (rc) return rc;
    update_s<<<nb, kThreads, 0, st>>>(L0, z, s, As, scal, part);
    if ((rc = eu_launch_status())) return rc;
    alpha_reduce<<<1, 1024, 0, st>>>(part, nb, scal);
    if ((rc = eu_launch_status())) return rc;
    update_p<<<nb, kThreads, 0, st>>>(n(), p, r, s, As, scal, part);
    if ((rc = eu_launch_status())) return rc;
    conv_reduce<<<1, 1024, 0, st>>>(part, nb, scal, flags);
    return eu_launch_status();
  }
};

}  // namespace
