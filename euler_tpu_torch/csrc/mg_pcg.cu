// K3: Galerkin multigrid-preconditioned CG for Hopper — the solver body
// that K2 (the substep) also runs.
//
// Replaces the Pallas kernel euler_tpu/ops/pallas/mg_kernel.py
// `_mg_kernel` (launched by `solve_pressure_mg_pallas`), i.e.
// `_mg_pcg_solve` + `make_mg_cycle`, which also run inside
// substep_kernel.py `_substep_kernel`.  That kernel runs the whole PCG
// loop on the chip (a `while_loop` inside one kernel); so does this one,
// as far as a GPU lets it.
//
// What bounds it on an H100: launches and barriers, then bytes.  A PCG
// iteration at 1024² is one truncated-W cycle over 6 levels (1024² ..
// 32²) plus three level-0 sweeps, ~166 MB of plane traffic (~50 us at
// 3.35 TB/s; the ~32 MB fine working set fits the 50 MB L2), spread over
// some thirty launches, most of them on grids too small to fill the card.
//
// Design:
//   * a persistent workspace (ops/cuda/mg_kernel.py) owns every plane,
//     the hierarchy, the Chebyshev rows, the scalars and the flags, so the
//     launch sequence of an iteration is fixed;
//   * `eu_mg_create` captures a chunk of kChunk = 8 iterations (the cycle,
//     then the PCG step) into one CUDA graph, once per workspace; every
//     kernel of an iteration returns at once when the stop flag is set
//     (mg_levels.cuh), so a chunk replayed past convergence or the cap
//     changes nothing, and the host reads the flag once per chunk instead
//     of once per iteration;
//   * the coarse end of each cycle visit (128², 64², 32² at 1024²) is one
//     cluster launch, `coarse_cycle` (mg_levels.cuh), which rounds every
//     cell as the one-launch-per-operation kernels do (`eu_mg_cycle` runs
//     one preconditioner application either way, for the check);
//   * the Galerkin hierarchy and the Chebyshev rows are built on the
//     device, equal to `mg_host_operands`' bit for bit, and skipped on an
//     all-zero RHS (the solve then takes 0 iterations).  The solver, the
//     hierarchy and the chunk's capture are mg_solver.cuh's, shared with
//     K11.
// Every dot product and max is a two-stage reduction in a fixed order,
// so the iteration count repeats from run to run.  The level functions
// write their rounding out, one FMA wherever nvcc contracted the
// per-iteration host loop this design replaced, so the solve repeats
// that loop's results bit for bit.
//
// What bounds it now: graph nodes.  An iteration is ~36 of them (the
// cycle's operations on levels 0-2, four coarse_cycle launches, the five
// PCG step kernels), each a few us even where its grid is tiny, and
// coarse_cycle costs ~20-26 us a visit.  Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 (700 W): ~3.4-3.6 ms a call on the developed
// 1024² state (16 iterations, ~0.22 ms each; the per-iteration host loop
// it replaces took 11-13 ms for the same solve), 3.8-3.9x the 0.91 ms
// sweep bound.  PERF.md §6 has the numbers of record.

// fmac in the level functions is one FMA (mg_levels.cuh)
#define EU_FMAD 1
#include "mg_solver.cuh"

// A solver over one workspace.  L levels of shapes (Y, X); planes:
// P_COUNT pointers per level (c, e, n, x, b, z, rr, d, dn; level 0's
// c/e/n are unused and its b is r; the coarse c/e/n are the hierarchy's
// outputs); act: one u8 plane per level (level 0's unused); packed0: the
// [Y, X] plane a_diag + 8 * fluid; rows: [L, ncoef]; p, r, s, As: [Y, X];
// part: ceil(Y*X/256) floats; hpart: the sum over levels of
// ceil(Yl*Xl/256) floats; scal: S_N floats; flags: F_N ints.  Captures
// one chunk of kChunk iterations into a graph; returns the solver in
// *out.
EU_API int eu_mg_create(int L, const int* shapes, void* const* planes,
                        void* const* act, void* packed0, void* rows,
                        int ncoef, int deg, int coarse_deg, int w,
                        int w_depth, float ratio, float coarse_ratio,
                        int max_iters, float tol, float tol_rel, void* p,
                        void* r, void* s_, void* As, void* part, void* hpart,
                        void* scal, void* flags, void** out) {
  *out = nullptr;
  MgSolver* M = new MgSolver{};
  float* rp = static_cast<float*>(r);
  int rc = make_solve(&M->S, L, shapes, planes, packed0, rp, rows, ncoef,
                      deg, coarse_deg, w, w_depth, part, flags, nullptr);
  if (!rc)
    rc = set_hierarchy(M, L, shapes, planes, act, packed0, rows, ncoef, deg,
                       coarse_deg, ratio, coarse_ratio, -1, hpart);
  if (!rc) {
    M->P = PcgLoop{M->S.lv[0], static_cast<float*>(p), rp,
                   static_cast<float*>(s_), static_cast<float*>(As),
                   M->S.part, static_cast<float*>(scal),
                   static_cast<int*>(flags), max_iters, nullptr};
    M->tol = tol;
    M->tol_rel = tol_rel;
    // an iteration: the cycle from level 0 with <z, r>, then the PCG step
    rc = capture_chunk(M, [](Solve& S, const PcgLoop& P) {
      const int rc_cycle = S.cycle(0, true);
      return rc_cycle ? rc_cycle : P.step(S.zout(0));
    });
  }
  if (rc) {
    delete M;
    return rc;
  }
  *out = M;
  return 0;
}

// K3's head: packed0 from a_diag ([Y, X] i32) and fl ([Y, X] u8), r = b,
// and p = x0 when x0 is given (the warm start).
EU_API int eu_mg_load(void* solver, const void* a_diag, const void* fl,
                      const void* b, const void* x0, void* stream) {
  const MgSolver* M = static_cast<const MgSolver*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = M->P.n();
  pack_kernel<<<M->P.blocks(), kThreads, 0, st>>>(
      n, static_cast<const int32_t*>(a_diag), static_cast<const uint8_t*>(fl),
      M->packed0);
  int rc = eu_launch_status();
  if (rc) return rc;
  const size_t bytes = sizeof(float) * n;
  if ((rc = static_cast<int>(cudaMemcpyAsync(
           M->P.r, b, bytes, cudaMemcpyDeviceToDevice, st))))
    return rc;
  if (!x0) return 0;
  return static_cast<int>(
      cudaMemcpyAsync(M->P.p, x0, bytes, cudaMemcpyDeviceToDevice, st));
}

// One MG-PCG solve of A p = b on the workspace: packed0 and r (= b) are
// loaded and, with warm, p holds the initial guess.  Builds the
// hierarchy, applies the warm start, then replays the chunk graph until
// the stop flag is set.  The iteration count and final residual max stay
// on the device (flags[F_ITERS], scal[S_RESID]); p ends as the solution.
EU_API int eu_mg_solve(void* solver, int warm, void* stream) {
  const MgSolver* M = static_cast<const MgSolver*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PcgLoop P = M->P;
  P.st = st;
  int rc = P.init(!warm, M->tol, M->tol_rel);
  if (rc) return rc;
  if ((rc = M->hierarchy(st))) return rc;
  if (warm) {
    const unsigned nb0 = P.blocks();
    warm_mask<<<nb0, kThreads, 0, st>>>(P.L0, P.p, P.flags);
    if ((rc = eu_launch_status())) return rc;
    warm_resid<<<nb0, kThreads, 0, st>>>(P.L0, P.r, P.p, P.part);
    if ((rc = eu_launch_status())) return rc;
    warm_reduce<<<1, 1024, 0, st>>>(P.part, nb0, P.scal, P.flags);
    if ((rc = eu_launch_status())) return rc;
  }
  return M->iterate(st);
}

// One application of the preconditioner z = M r to the workspace's r, on
// the hierarchy its last solve built, through coarse_cycle or, with
// per_op, through one launch per level operation down to the coarsest
// (the check that both round alike); z is copied to out ([Y, X] f32).
// Clears the stop flag first.
EU_API int eu_mg_cycle(void* solver, int per_op, void* out, void* stream) {
  const MgSolver* M = static_cast<const MgSolver*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(
      cudaMemsetAsync(M->P.flags + F_DONE, 0, sizeof(int), st));
  if (rc) return rc;
  Solve S = M->S;
  S.s = st;
  if (per_op) S.fused = S.L;
  if ((rc = S.cycle(0, true))) return rc;
  return static_cast<int>(cudaMemcpyAsync(out, S.zout(0),
                                          sizeof(float) * M->P.n(),
                                          cudaMemcpyDeviceToDevice, st));
}
