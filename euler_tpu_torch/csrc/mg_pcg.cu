// K3: Galerkin multigrid-preconditioned CG for Hopper — the solver body
// that K2 (the substep) also runs.
//
// Replaces the Pallas kernel euler_tpu/ops/pallas/mg_kernel.py
// `_mg_kernel` (launched by `solve_pressure_mg_pallas`), i.e.
// `_mg_pcg_solve` + `make_mg_cycle`, which also run inside
// substep_kernel.py `_substep_kernel`.
//
// What bounds it on an H100: launches, then bytes.  A PCG iteration is
// one truncated-W cycle over 6 levels at 1024² (1024² .. 32²) plus three
// level-0 sweeps; the fine sweeps stream a few 4 MB planes each (~10 us
// at 3.35 TB/s), while the 5 coarse levels are visited 2-4 times a cycle
// with tiny grids, so per-launch latency dominates them.  The host reads
// one device flag per iteration (the NaN-robust stop test), which costs a
// stream synchronisation each time.
//
// Design: one kernel per level operation (restriction fused into the
// degree-1 pre-smooth, the <z, r> dot fused into the level-0
// post-smooth), the coarsest level's degree-12 Chebyshev solve in a
// single 1024-thread block with __syncthreads between steps, and every
// dot product / max by a two-stage reduction (per-block partials, then
// one block in a fixed order), so the iteration count repeats from run
// to run.  The loop runs here, on the host side of the library; moving
// it onto the device or into a CUDA graph removes the per-iteration sync.
//
// Arithmetic follows the Pallas body: level 0 uses the packed plane
// a_diag + 8 * fluid; levels >= 1 the edge-weight planes (c, e, n).  The
// level kernels, the cycle schedule (`Solve`) and the PCG step kernels
// live in mg_levels.cuh, which K11 (mg_stream.cu) shares.
#include "mg_levels.cuh"

// One MG-PCG solve of A p = b.  On entry r holds b (it becomes the
// residual) and, with warm, p holds the initial guess.  planes: P_COUNT
// pointers per level (c, e, n, x, b, z, rr, d, dn; level 0's c/e/n are
// unused and its b is r).  shapes: (Y, X) per level.  rows: [L, ncoef]
// Chebyshev rows.  part: ceil(Y0*X0/256) floats; scal: S_N floats; flags:
// F_N ints.  The iteration count and final residual max stay on the
// device (flags[F_ITERS], scal[S_RESID]).
EU_API int eu_mg_pcg(int L, const int* shapes, void* const* planes,
                     const void* packed0, const void* rows, int ncoef,
                     int deg, int coarse_deg, int w, int w_depth,
                     int max_iters, float tol, float tol_rel, int warm,
                     void* p, void* r, void* s_, void* As, void* part,
                     void* scal, void* flags, void* stream) {
  Solve S;
  float* rp = static_cast<float*>(r);
  int rc = make_solve(&S, L, shapes, planes, packed0, rp, rows, ncoef, deg,
                      coarse_deg, w, w_depth, part, stream);
  if (rc) return rc;
  const PcgLoop P{S.lv[0], static_cast<float*>(p), rp,
                  static_cast<float*>(s_), static_cast<float*>(As), S.part,
                  static_cast<float*>(scal), static_cast<int*>(flags), S.s};
  const unsigned nb0 = P.blocks();
  if ((rc = P.init(!warm, tol, tol_rel))) return rc;
  if (warm) {
    warm_mask<<<nb0, kThreads, 0, P.st>>>(P.L0, P.p, P.flags);
    if ((rc = eu_launch_status())) return rc;
    warm_resid<<<nb0, kThreads, 0, P.st>>>(P.L0, P.r, P.p, P.part);
    if ((rc = eu_launch_status())) return rc;
    warm_reduce<<<1, 1024, 0, P.st>>>(P.part, nb0, P.scal, P.flags);
    if ((rc = eu_launch_status())) return rc;
  }
  for (int it = 0; it < max_iters; ++it) {
    int done = 0;
    if ((rc = P.done(&done))) return rc;
    if (done) break;
    if ((rc = S.cycle(0, true))) return rc;
    if ((rc = P.step(S.zout(0)))) return rc;
  }
  return 0;
}
