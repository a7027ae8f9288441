// K8, K9, K10, K12: Jacobi-preconditioned CG for Hopper — the
// reference-budget "speed mode" solve alone (K8), between the divergence
// RHS and the clamp + face update (K9), behind K2's grid stage as well
// (K10), and in its two-sweep form with the As recurrence (K12).
//
// Replaces the Pallas kernels euler_tpu/ops/pallas/pcg_kernel.py
// `_pcg_kernel` (launched by `solve_pressure_pallas`) and
// `_project_kernel` (launched by `project_pallas`),
// euler_tpu/ops/pallas/substep_kernel.py `_substep_jacobi_kernel`
// (launched by `project_substep_jacobi`), and
// euler_tpu/ops/pallas/pcg_stream_kernel.py `_stream_kernel` (launched by
// `solve_pressure_stream`).  Ported is what they compute; their TPU
// devices (row chunks, the VMEM plan, HBM row windows, b aliased as r)
// are not.
//
// What bounds it on an H100: bytes, iteration by iteration.  One
// iteration is three sweeps over [Y, X] f32 planes: As = A s (reads
// packed and s, writes As), p += alpha s and r -= alpha As (reads packed,
// s, p, r and As, writes p and r), s = invd r + beta s (reads packed, r
// and s, writes s): 14 plane passes, 59 MB at 1024², 17.5 us at
// 3.35 TB/s.  The five live planes (20 MB) fit the 50 MB L2, so that HBM
// figure bounds the floor from above.  Each iteration also needs two
// grid-wide reductions (<As, s>; max|r| with <invd r, r>), and on a GPU
// each costs a launch boundary.
//
// Design: one thread per cell and five launches per iteration — the
// three sweeps, and after sweeps 1 and 2 one block that folds the
// per-block partials in a fixed order (no float atomics, NaN-propagating
// max), so the iteration count repeats from run to run.  The loop runs
// on the host side of the library, but the iteration counter, the
// scalars and the stop flag live on the device and every kernel returns
// at once when the flag is set: the host reads the flag only every
// kCheckEvery iterations, and the results are those of a per-iteration
// check.  The grid stage (K10) and the clamp / face update / maxsq tail
// (K9, K10) are grid_stage.cuh's, shared with K2.  Built with -fmad=false
// and with the plain version's operand order (ops/project.py apply_a),
// so every sweep rounds as the plain PyTorch version does; only the order
// of the reductions differs.
//
// K12 computes the same solve another way, as its Pallas kernel does:
// s' = z + beta s and As' = A z + beta As with z = invd r recomputed on
// the cell and its neighbours, so an iteration is two sweeps (13 plane
// passes: the s/As update, then K8's p/r update) and the same two
// reductions, four launches in all; one max|r| pass ends the solve.
#include "grid_stage.cuh"

namespace {

constexpr int kReduceThreads = 1024;
constexpr int kCheckEvery = 8;

// device scalars and flags of one solve
enum { S_TOL = 0, S_SIGMA, S_ALPHA, S_BETA, S_RESID, S_N };
enum { F_DONE = 0, F_ITERS, F_N };

// the packed plane a_diag * fl + 8 * fl decoded: the fluid flag, the
// diagonal, and the Jacobi inverse diagonal (a fluid cell with a = 0
// falls back to the identity, pcg_kernel.py:72-75)
struct Cell {
  float fl, a, invd;
};

__device__ __forceinline__ Cell decode(float packed) {
  Cell c;
  c.fl = packed >= 8.0f ? 1.0f : 0.0f;
  c.a = packed - 8.0f * c.fl;
  c.invd = c.fl / fmaxf(c.a, 1.0f);
  return c;
}

// r = b, s = invd b, p = 0; the block partials of <invd b, b> and max |b|
__device__ __forceinline__ void init_cell(int t, float b, float invd,
                                          float* r, float* s, float* p,
                                          float* zr, float* bmax) {
  const float z = invd * b;
  r[t] = b;
  s[t] = z;
  p[t] = 0.0f;
  *zr = z * b;
  *bmax = fabsf(b);
}

__device__ __forceinline__ void write_partials(float zr, float bmax,
                                               float* part_sum,
                                               float* part_max) {
  zr = block_reduce<EU_SUM>(zr);
  bmax = block_reduce<EU_MAX>(bmax);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = zr;
    part_max[blockIdx.x] = bmax;
  }
}

// K8's head: the packed plane from a_diag and the fluid mask
__global__ void solve_head(int n, const int32_t* __restrict__ a_diag,
                           const uint8_t* __restrict__ fl,
                           const float* __restrict__ b,
                           float* __restrict__ packed, float* __restrict__ r,
                           float* __restrict__ s, float* __restrict__ p,
                           float* __restrict__ part_sum,
                           float* __restrict__ part_max) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float zr = 0.0f, bmax = 0.0f;
  if (t < n) {
    const float f = fl[t] ? 1.0f : 0.0f;
    const float pk = static_cast<float>(a_diag[t]) * f + 8.0f * f;
    packed[t] = pk;
    init_cell(t, b[t], decode(pk).invd, r, s, p, &zr, &bmax);
  }
  write_partials(zr, bmax, part_sum, part_max);
}

// K9's head: the packed plane from the solid mask (pcg_kernel.py:283-284)
// and b = -div(u) * h^2 rho / dt_proj on fluid cells (main.c:713-724)
__global__ void project_head(Masks m, const float* __restrict__ ut,
                             const float* __restrict__ vt,
                             const float* __restrict__ dtp_ptr, float inv_h,
                             float scale, float* __restrict__ packed,
                             float* __restrict__ r, float* __restrict__ s,
                             float* __restrict__ p,
                             float* __restrict__ part_sum,
                             float* __restrict__ part_max) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float zr = 0.0f, bmax = 0.0f;
  if (t < m.Y * m.X) {
    const int y = t / m.X, x = t - y * m.X;
    const float pk = packed_at(m, t, y, x);
    const Cell cell = decode(pk);
    packed[t] = pk;
    const float k_inv_scale = scale / *dtp_ptr;
    const float div = (ut[t] - ld(ut, y, x - 1, m.Y, m.X) + vt[t] -
                       ld(vt, y - 1, x, m.Y, m.X)) * inv_h;
    const float b = cell.fl != 0.0f ? -div * k_inv_scale : 0.0f;
    init_cell(t, b, cell.invd, r, s, p, &zr, &bmax);
  }
  write_partials(zr, bmax, part_sum, part_max);
}

// sigma0, max|b|, the effective tolerance and the all-zero early-out
// (main.c:742)
__global__ void init_reduce(const float* __restrict__ part_sum,
                            const float* __restrict__ part_max, int nparts,
                            float tol, float tol_rel, float* scal,
                            int* flags) {
  const float sigma0 = reduce_partials<EU_SUM>(part_sum, nparts);
  const float rmax0 = reduce_partials<EU_MAX>(part_max, nparts);
  if (threadIdx.x == 0) {
    scal[S_TOL] = nanmax(tol, tol_rel * rmax0);
    scal[S_SIGMA] = sigma0;
    scal[S_BETA] = 0.0f;
    scal[S_RESID] = rmax0;
    flags[F_DONE] = !(rmax0 != 0.0f);
    flags[F_ITERS] = 0;
  }
}

// Every iteration kernel reads the stop flag first; all threads of the
// grid read the same value before any of them can change it, so the
// early return is uniform.

// sweep 1: As = fl (a s - (left + right + down + up)); partials of <As, s>
__global__ void apply_s(int Y, int X, const float* __restrict__ packed,
                        const float* __restrict__ s, float* __restrict__ As,
                        float* __restrict__ part,
                        const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < Y * X) {
    const int y = t / X, x = t - y * X;
    const Cell c = decode(packed[t]);
    const float sc = s[t];
    float nb = ld(s, y, x - 1, Y, X) + ld(s, y, x + 1, Y, X);
    nb = nb + ld(s, y - 1, x, Y, X);
    nb = nb + ld(s, y + 1, x, Y, X);
    const float as = c.fl * (c.a * sc - nb);
    As[t] = as;
    acc = as * sc;
  }
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

__global__ void alpha_reduce(const float* __restrict__ part, int nparts,
                             float* scal, const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const float zs = reduce_partials<EU_SUM>(part, nparts);
  if (threadIdx.x == 0)
    scal[S_ALPHA] = scal[S_SIGMA] / (zs != 0.0f ? zs : 1.0f);
}

// sweep 2: p += alpha s; r -= alpha As; partials of max|r| and
// <invd r, r>
__global__ void update_pr(int n, const float* __restrict__ packed,
                          const float* __restrict__ s,
                          const float* __restrict__ As, float* __restrict__ p,
                          float* __restrict__ r,
                          const float* __restrict__ scal,
                          float* __restrict__ part_sum,
                          float* __restrict__ part_max,
                          const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float zr = 0.0f, rmax = 0.0f;
  if (t < n) {
    const float alpha = scal[S_ALPHA];
    p[t] = p[t] + alpha * s[t];
    const float rv = r[t] - alpha * As[t];
    r[t] = rv;
    rmax = fabsf(rv);
    zr = (decode(packed[t]).invd * rv) * rv;
  }
  write_partials(zr, rmax, part_sum, part_max);
}

// the NaN-robust stop test not (max|r| > tol) after the p/r update, and
// beta = sigma_new / sigma
__global__ void conv_reduce(const float* __restrict__ part_sum,
                            const float* __restrict__ part_max, int nparts,
                            float* scal, int* flags) {
  if (flags[F_DONE]) return;
  const float sigma_new = reduce_partials<EU_SUM>(part_sum, nparts);
  const float rmax = reduce_partials<EU_MAX>(part_max, nparts);
  if (threadIdx.x == 0) {
    const float sigma = scal[S_SIGMA];
    scal[S_BETA] = sigma_new / (sigma != 0.0f ? sigma : 1.0f);
    scal[S_SIGMA] = sigma_new;
    scal[S_RESID] = rmax;
    flags[F_ITERS] += 1;
    flags[F_DONE] = !(rmax > scal[S_TOL]);
  }
}

// sweep 3: s = invd r + beta s (skipped once converged: s is not read
// again)
__global__ void update_s(int n, const float* __restrict__ packed,
                         const float* __restrict__ r, float* __restrict__ s,
                         const float* __restrict__ scal,
                         const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  s[t] = decode(packed[t]).invd * r[t] + scal[S_BETA] * s[t];
}

// K12's sweep 1: z = invd r on the cell and its neighbours; s = z + beta s;
// As = A z + beta As; partials of <As, s>
__global__ void update_s_as(int Y, int X, const float* __restrict__ packed,
                            const float* __restrict__ r,
                            float* __restrict__ s, float* __restrict__ As,
                            const float* __restrict__ scal,
                            float* __restrict__ part,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < Y * X) {
    const int y = t / X, x = t - y * X;
    auto z_at = [&](int i, int j) {
      if (i < 0 || i >= Y || j < 0 || j >= X) return 0.0f;
      const int k = i * X + j;
      return decode(packed[k]).invd * r[k];
    };
    const Cell c = decode(packed[t]);
    const float z = c.invd * r[t];
    float nb = z_at(y, x - 1) + z_at(y, x + 1);
    nb = nb + z_at(y - 1, x);
    nb = nb + z_at(y + 1, x);
    const float az = c.fl * (c.a * z - nb);
    const float beta = scal[S_BETA];
    const float sn = z + beta * s[t];
    const float an = az + beta * As[t];
    s[t] = sn;
    As[t] = an;
    acc = an * sn;
  }
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// partials of max|r|, then the solve's final residual
__global__ void rmax_partial(int n, const float* __restrict__ r,
                             float* __restrict__ part) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float m = t < n ? fabsf(r[t]) : 0.0f;
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

__global__ void resid_reduce(const float* __restrict__ part, int nparts,
                             float* scal) {
  const float rmax = reduce_partials<EU_MAX>(part, nparts);
  if (threadIdx.x == 0) scal[S_RESID] = rmax;
}

// the planes and scalars of one solve
struct Pcg {
  int Y, X;
  float *packed, *r, *p, *s, *As, *part, *scal;
  int* flags;
  cudaStream_t st;

  int n() const { return Y * X; }
  unsigned blocks() const {
    return eu_blocks(static_cast<long long>(Y) * X, kThreads);
  }
  float* part_sum() const { return part; }
  float* part_max() const { return part + blocks(); }

  // after a head kernel has written packed, r, s, p and the partials;
  // `as_recurrence` takes K12's two-sweep iteration (As must be zero)
  int solve(int max_iters, float tol, float tol_rel,
            bool as_recurrence = false) const {
    const unsigned nb = blocks();
    init_reduce<<<1, kReduceThreads, 0, st>>>(part_sum(), part_max(), nb, tol,
                                              tol_rel, scal, flags);
    int rc = eu_launch_status();
    if (rc) return rc;
    for (int it = 0; it < max_iters; ++it) {
      if (it % kCheckEvery == 0) {
        int done = 0;
        if ((rc = static_cast<int>(cudaMemcpyAsync(
                 &done, flags + F_DONE, sizeof(int), cudaMemcpyDeviceToHost,
                 st))))
          return rc;
        if ((rc = static_cast<int>(cudaStreamSynchronize(st)))) return rc;
        if (done) break;
      }
      if (as_recurrence)
        update_s_as<<<nb, kThreads, 0, st>>>(Y, X, packed, r, s, As, scal,
                                             part_sum(), flags);
      else
        apply_s<<<nb, kThreads, 0, st>>>(Y, X, packed, s, As, part_sum(),
                                         flags);
      if ((rc = eu_launch_status())) return rc;
      alpha_reduce<<<1, kReduceThreads, 0, st>>>(part_sum(), nb, scal, flags);
      if ((rc = eu_launch_status())) return rc;
      update_pr<<<nb, kThreads, 0, st>>>(n(), packed, s, As, p, r, scal,
                                         part_sum(), part_max(), flags);
      if ((rc = eu_launch_status())) return rc;
      conv_reduce<<<1, kReduceThreads, 0, st>>>(part_sum(), part_max(), nb,
                                                scal, flags);
      if ((rc = eu_launch_status())) return rc;
      if (as_recurrence) continue;
      update_s<<<nb, kThreads, 0, st>>>(n(), packed, r, s, scal, flags);
      if ((rc = eu_launch_status())) return rc;
    }
    if (!as_recurrence) return 0;
    rmax_partial<<<nb, kThreads, 0, st>>>(n(), r, part_max());
    if ((rc = eu_launch_status())) return rc;
    resid_reduce<<<1, kReduceThreads, 0, st>>>(part_max(), nb, scal);
    return eu_launch_status();
  }
};

Pcg make_pcg(int Y, int X, void* packed, void* r, void* p, void* s,
             void* As, void* part, void* scal, void* flags, void* stream) {
  return Pcg{Y, X,
             static_cast<float*>(packed), static_cast<float*>(r),
             static_cast<float*>(p), static_cast<float*>(s),
             static_cast<float*>(As), static_cast<float*>(part),
             static_cast<float*>(scal), static_cast<int*>(flags),
             static_cast<cudaStream_t>(stream)};
}

// K9's body: head, solve, clamp, face update of (ut, vt) into (u2, v2)
// with the face-update dt, and msq
int project_body(const Masks& m, const Pcg& P, int max_iters, float tol,
                 float tol_rel, float inv_h, float scale, float c,
                 const float* dt, const float* dt_proj, const float* ut,
                 const float* vt, float* u2, float* v2, float* msq) {
  project_head<<<P.blocks(), kThreads, 0, P.st>>>(
      m, ut, vt, dt_proj, inv_h, scale, P.packed, P.r, P.s, P.p, P.part_sum(),
      P.part_max());
  int rc = eu_launch_status();
  if (rc) return rc;
  if ((rc = P.solve(max_iters, tol, tol_rel))) return rc;
  return project_tail(m, c, dt, P.p, P.p, ut, vt, u2, v2, P.part, msq,
                      P.st);
}

}  // namespace

// Buffers of every entry point: packed, r, p, s, As: [Y, X] f32 (p ends
// as the solution: the clamped pressure for K9/K10); part:
// 2 * ceil(Y*X/256) f32; scal: S_N f32; flags: F_N i32.  The iteration
// count and the final max|r| stay on the device (flags[F_ITERS],
// scal[S_RESID]).

// K8: A p = b from a_diag ([Y, X] i32) and fl ([Y, X] u8).
EU_API int eu_jacobi_solve(int Y, int X, int max_iters, float tol,
                           float tol_rel, const void* a_diag, const void* fl,
                           const void* b, void* packed, void* r, void* p,
                           void* s, void* As, void* part, void* scal,
                           void* flags, void* stream) {
  const Pcg P = make_pcg(Y, X, packed, r, p, s, As, part, scal, flags, stream);
  solve_head<<<P.blocks(), kThreads, 0, P.st>>>(
      P.n(), static_cast<const int32_t*>(a_diag),
      static_cast<const uint8_t*>(fl), static_cast<const float*>(b), P.packed,
      P.r, P.s, P.p, P.part_sum(), P.part_max());
  const int rc = eu_launch_status();
  if (rc) return rc;
  return P.solve(max_iters, tol, tol_rel);
}

// K12: K8's solve in its two-sweep form (same buffers and arguments).
EU_API int eu_jacobi_stream_solve(int Y, int X, int max_iters, float tol,
                                  float tol_rel, const void* a_diag,
                                  const void* fl, const void* b,
                                  void* packed, void* r, void* p, void* s,
                                  void* As, void* part, void* scal,
                                  void* flags, void* stream) {
  const Pcg P = make_pcg(Y, X, packed, r, p, s, As, part, scal, flags, stream);
  solve_head<<<P.blocks(), kThreads, 0, P.st>>>(
      P.n(), static_cast<const int32_t*>(a_diag),
      static_cast<const uint8_t*>(fl), static_cast<const float*>(b), P.packed,
      P.r, P.s, P.p, P.part_sum(), P.part_max());
  int rc = eu_launch_status();
  if (rc) return rc;
  if ((rc = static_cast<int>(cudaMemsetAsync(
           P.As, 0, sizeof(float) * P.n(), P.st))))
    return rc;
  return P.solve(max_iters, tol, tol_rel, true);
}

// K9: the projection of (ut, vt) into (u2, v2).  fl, so: [Y, X] u8;
// dt (face update) and dt_proj (RHS scale): one f32 each on the device;
// msq: one f32 out.
EU_API int eu_jacobi_project(int Y, int X, int max_iters, float tol,
                             float tol_rel, float inv_h, float scale,
                             float c, const void* fl, const void* so,
                             const void* dt, const void* dt_proj,
                             const void* ut, const void* vt, void* u2,
                             void* v2, void* packed, void* r, void* p,
                             void* s, void* As, void* part, void* scal,
                             void* flags, void* msq, void* stream) {
  const Pcg P = make_pcg(Y, X, packed, r, p, s, As, part, scal, flags, stream);
  const Masks m{Y, X, static_cast<const uint8_t*>(fl), nullptr,
                static_cast<const uint8_t*>(so)};
  return project_body(m, P, max_iters, tol, tol_rel, inv_h, scale, c,
                      static_cast<const float*>(dt),
                      static_cast<const float*>(dt_proj),
                      static_cast<const float*>(ut),
                      static_cast<const float*>(vt), static_cast<float*>(u2),
                      static_cast<float*>(v2), static_cast<float*>(msq));
}

// K10: the grid stage of (u, v) (passes A and B, with dt) into (u2, v2),
// then K9's body in place on them.  pfl: [Y, X] u8; zu, zv: [Y, X]
// scratch.
EU_API int eu_jacobi_substep(int Y, int X, int max_iters, float tol,
                             float tol_rel, float inv_h, float g,
                             float scale, float c, const void* fl,
                             const void* pfl, const void* so, const void* dt,
                             const void* dt_proj, const void* u,
                             const void* v, void* zu, void* zv, void* u2,
                             void* v2, void* packed, void* r, void* p,
                             void* s, void* As, void* part, void* scal,
                             void* flags, void* msq, void* stream) {
  const Pcg P = make_pcg(Y, X, packed, r, p, s, As, part, scal, flags, stream);
  const Masks m = make_masks(Y, X, fl, pfl, so);
  float* uo = static_cast<float*>(u2);
  float* vo = static_cast<float*>(v2);
  const float* dtf = static_cast<const float*>(dt);
  const int rc = grid_passes(m, inv_h, g, static_cast<const float*>(u),
                             static_cast<const float*>(v), dtf,
                             static_cast<float*>(zu), static_cast<float*>(zv),
                             uo, vo, P.st);
  if (rc) return rc;
  return project_body(m, P, max_iters, tol, tol_rel, inv_h, scale, c, dtf,
                      static_cast<const float*>(dt_proj), uo, vo, uo, vo,
                      static_cast<float*>(msq));
}
