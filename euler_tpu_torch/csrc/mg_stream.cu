// K11: MG-PCG with the F-to-1 level skip for Hopper — the converged solve
// of grids whose MG hierarchy the resident Pallas kernel (K3) cannot hold.
//
// Replaces the Pallas kernel euler_tpu/ops/pallas/mg_stream_kernel.py
// `_stream_mg_kernel` (launched by `solve_pressure_mg_stream`).  Ported is
// what it computes: the preconditioner restricts the fine residual of a
// degree-1 Chebyshev pre-smooth straight to the first resident level
// (F = 2 at 2048², F = 4 at 4096²), runs the truncated-W cycle of the
// levels below it with that root in edge form, and post-smooths the fine
// level once with degree-1 Chebyshev.  Its TPU device (fine planes in HBM
// streamed through VMEM row windows) is not ported: every plane lives in
// device memory.  It starts cold and takes no guess, as the Pallas kernel.
//
// What bounds it on an H100: launches, then bytes.  Per PCG iteration the
// fine level costs four sweeps (the F-to-1 restriction, the fused
// prolongation + post-smooth, the s/As update, the p/r update) that move
// 17 fine planes, ~0.09 ms of HBM time each at 2048²; the resident cycle
// below is K3's (its coarse end one cluster launch a visit), and the host
// reads the stop flag once per iteration.
//
// Design: one thread per root cell for the restriction (the F x F sum of
// r - it0 A r over its children), one thread per fine cell for the post-
// smooth (x = it0 r + fl ec on the cell and its 4 neighbours, then
// z = x + it0 (r - A x) and the partials of <z, r>), and K3's level
// kernels, cycle schedule and PCG step kernels from mg_levels.cuh.  it0 is
// the fine level's degree-1 1/theta, the last row of `rows`.  Built with
// -fmad=false, so the shared level functions round every product on its
// own (EU_FMAD 0).
#define EU_FMAD 0
#include "mg_levels.cuh"

namespace {

// b_root = the F x F child sums of r - it0 A r: columns of children
// first, then across them (the Pallas kernel's row-then-lane order)
__global__ void restrict_f(Lvl L0, int F, const float* __restrict__ r,
                           float* __restrict__ bc,
                           const float* __restrict__ fine_row,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int Xc = L0.X / F, Yc = L0.Y / F;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  const int I = t / Xc, J = t - I * Xc;
  const float it0 = fine_row[0];
  float acc = 0.0f;
  for (int c = 0; c < F; ++c) {
    const int j = F * J + c;
    float col = 0.0f;
    for (int a = 0; a < F; ++a) {
      const int i = F * I + a;
      col = col + (r[i * L0.X + j] - it0 * apply_at<true, true>(L0, r, i, j));
    }
    acc = acc + col;
  }
  bc[t] = acc;
}

// the prolonged pre-smooth x = it0 r + fl ec[i/F, j/F], zero outside the
// grid
__device__ __forceinline__ float x_at(const Lvl& L0, int F,
                                      const float* __restrict__ r,
                                      const float* __restrict__ ec, float it0,
                                      int i, int j) {
  if (i < 0 || i >= L0.Y || j < 0 || j >= L0.X) return 0.0f;
  const int k = i * L0.X + j;
  return it0 * r[k] + fluid0(L0, k) * ec[(i / F) * (L0.X / F) + j / F];
}

// z = x + it0 (r - A x) with x from x_at; partials of <z, r>
__global__ void post_f(Lvl L0, int F, const float* __restrict__ r,
                       const float* __restrict__ ec, float* __restrict__ z,
                       const float* __restrict__ fine_row,
                       float* __restrict__ part,
                       const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    const float it0 = fine_row[0];
    const float pk = L0.pk[t];
    const float fl = pk >= 8.0f ? 1.0f : 0.0f;
    const float a = pk - 8.0f * fl;
    const float xc = x_at(L0, F, r, ec, it0, i, j);
    float nb = x_at(L0, F, r, ec, it0, i, j - 1) +
               x_at(L0, F, r, ec, it0, i, j + 1);
    nb = nb + x_at(L0, F, r, ec, it0, i + 1, j);
    nb = nb + x_at(L0, F, r, ec, it0, i - 1, j);
    const float ax = fl * (a * xc - nb);
    const float rv = r[t];
    const float zz = xc + it0 * (rv - ax);
    z[t] = zz;
    acc = zz * rv;
  }
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

}  // namespace

// One MG-PCG solve of A p = b from p = 0.  On entry r holds b (it becomes
// the residual).  packed: the [Y, X] plane a_diag + 8 * fluid.  L resident
// levels, the first (the root) of shape (Y/F, X/F): shapes, planes
// (P_COUNT pointers per level, c/e/n the Galerkin planes; the root's b is
// the restriction's target) and rows ([L + 1, ncoef]: the levels'
// Chebyshev rows, then the fine level's, whose first entry is it0) as
// eu_mg_create takes them.  s, As, z: [Y, X] scratch; part:
// ceil(Y*X/256) floats; scal: S_N floats; flags: F_N ints.  The iteration
// count and the final max|r| stay on the device (flags[F_ITERS],
// scal[S_RESID]).
EU_API int eu_mg_stream(int Y, int X, int F, int L, const int* shapes,
                        void* const* planes, const void* packed,
                        const void* rows, int ncoef, int deg, int coarse_deg,
                        int w, int w_depth, int max_iters, float tol,
                        float tol_rel, void* p, void* r, void* s_, void* As,
                        void* z, void* part, void* scal, void* flags,
                        void* stream) {
  if (F < 1 || shapes[0] * F != Y || shapes[1] * F != X)
    return static_cast<int>(cudaErrorInvalidValue);
  Solve S;
  int rc = make_solve(&S, L, shapes, planes, nullptr, nullptr, rows, ncoef,
                      deg, coarse_deg, w, w_depth, part, flags, stream);
  if (rc) return rc;
  const Lvl L0{Y, X, nullptr, nullptr, nullptr,
               static_cast<const float*>(packed)};
  const PcgLoop P{L0, static_cast<float*>(p), static_cast<float*>(r),
                  static_cast<float*>(s_), static_cast<float*>(As), S.part,
                  static_cast<float*>(scal), static_cast<int*>(flags),
                  max_iters, S.s};
  float* zp = static_cast<float*>(z);
  const float* fine_row = S.row(L);
  const unsigned nb_root = S.blocks(0);
  if ((rc = P.init(true, tol, tol_rel))) return rc;
  for (int it = 0; it < max_iters; ++it) {
    int done = 0;
    if ((rc = P.done(&done))) return rc;
    if (done) break;
    restrict_f<<<nb_root, kThreads, 0, P.st>>>(L0, F, P.r, S.b[0], fine_row,
                                               P.flags);
    if ((rc = eu_launch_status())) return rc;
    if ((rc = S.cycle(0, false))) return rc;
    post_f<<<P.blocks(), kThreads, 0, P.st>>>(L0, F, P.r, S.zout(0), zp,
                                              fine_row, P.part, P.flags);
    if ((rc = eu_launch_status())) return rc;
    if ((rc = P.step(zp))) return rc;
  }
  return 0;
}
