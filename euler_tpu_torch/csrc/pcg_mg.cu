// P3: the PCG loop with the Galerkin MG cycle as its preconditioner, where
// the JAX package's `solve_pressure` falls through to its jnp `pcg_loop`
// with MG: every level size that does not halve evenly to mg_min_size
// (1080 x 1920, 1200², 1448², 2160 x 3840, 999², ...), beyond the gates of
// its Pallas MG kernels (K3, K11).  No pallas_call: the JAX package runs
// euler_tpu/ops/project.py:115 `pcg_loop` with multigrid.py:492
// `make_mg_preconditioner`, whose hierarchy pads odd levels with inactive
// cells (:332-352) and whose cycle zero-pads b and crops x (:430-489).
//
// What it computes is that loop, not K3's: As = A s every iteration (P1's
// recurrence, pcg_loop.cuh), the all-zero early-out, the warm start, the
// NaN-robust stop.  The preconditioner step between the p / r update and
// <z, r> is one truncated-W cycle of mg_levels.cuh from the packed level
// 0 (the cycle's output plane is the loop's z, its right-hand side the
// loop's r), on a hierarchy built on the device each solve by
// mg_solver.cuh's hierarchy kernels (the Chebyshev rows from each level's
// Gershgorin bound).  Skipped, with the hierarchy, once the stop flag is
// set (an all-zero RHS, a warm start already converged).
//
// Padding.  Every level is stored at the shape the JAX hierarchy gives it:
// an odd level that is coarsened is one row or column of inactive pad
// larger (c = e = n = 0, not active), written so by `coarsen`; the
// restrictions write 0 to a child's pad and the prolongation reads only a
// child's own cells (mg_levels.cuh).  The pad's iterates may take the
// prolonged values of their block, but a pad cell has no coupling, so
// none reaches a real cell, as under the JAX cycle's exit mask.  An odd
// grid (999²) is solved on its padded level-0 shape: the head copies the
// inputs into the top left of the planes and makes the pad non-fluid, so
// every iterate is 0 there and A, the dots and the maxima are the
// unpadded loop's; the wrapper crops p.  The reductions fold per-CTA
// partials in a fixed order, which is not the plain loop's, so the last
// bits of p may differ from it.
//
// What bounds it on an H100: the launches of the cycle, then bytes.  An
// iteration is P1's four level-0 sweeps and the cycle's (at 1080 x 1920:
// seven levels, the W on levels 0 and 1, its coarse end from 68 x 120 one
// cluster launch a visit), some thirty launches replayed from one CUDA
// graph of kChunk iterations; the host reads the stop flag after each
// chunk (K3's policy: an MG solve converges in a few chunks, and P1's
// batches of 13 would replay the rest of its cap as no-ops).  Built with
// -fmad=false: the level functions round every product on its own
// (EU_FMAD 0), as K11's.
//
// RB-GS (`rbgs` at create, the JAX package's mg_smoother="rbgs"): the same
// hierarchy and loop with multigrid.py:430-489's RB-GS cycle (RbgsT,
// mg_levels.cuh): mg_pre_smooth red-black sweeps, the post-smooth in
// reversed colour order, mg_coarse_iters forward and reversed sweeps on
// the coarsest level, each half-sweep one launch in place, the coarse end
// one cluster launch of coarse_cycle_rbgs.  Its head builds the Galerkin
// levels without the Chebyshev bounds and rows (two launches fewer: no
// fine_lmax, no cheby_rows).  An iteration at 1024² enqueues P1's 4 loop
// launches and 52 of the cycle (RbgsT's note); at 1080 x 1920 (seven
// levels, the cluster from 68 x 120) 4 + 8 + 2 (8 + 2 (6 + 6 + 1)) = 80.
//
// Precision.  A solver is float or double (`f64` at create): the loop is
// pcg_loop.cuh's at T, and the hierarchy, the rows and the cycle are the
// T instantiations of mg_solver.cuh and mg_levels.cuh, so an f64 solve
// (the JAX package's `solver.dtype="float64"` with MG) runs every level in
// double and takes its Chebyshev rows from double bounds.  Its coarse
// cycle starts where the levels below fit the card's shared memory in
// double (`make_solve`: at 1024², from 64², one level lower than f32's
// 128²); `eu_pcg_mg_plan` reports that level.
#define EU_FMAD 0
#include "mg_solver.cuh"
#include "pcg_loop.cuh"

namespace {

// what every solver starts with: its precision
struct PcgMgHead {
  int f64;
};

template <typename T>
struct PcgMg : PcgMgHead {
  pcg::Ws w;
  MgSolverT<T> M;  // the hierarchy and the cycle (its loop and graph unused)
  RbgsT<T> R;      // the cycle with RB-GS smoothing (rbgs)
  bool rbgs;
  cudaGraphExec_t exec;
  cudaEvent_t replayed;

  // z = M r, through coarse_cycle (coarse_cycle_rbgs) or, with per_op,
  // one launch per level operation
  int cycle(cudaStream_t st, bool per_op = false) const {
    if (rbgs) {
      RbgsT<T> Q = R;
      Q.S.s = st;
      if (per_op) Q.S.fused = Q.S.L;
      return Q.cycle(0);
    }
    SolveT<T> S = M.S;
    S.s = st;
    if (per_op) S.fused = S.L;
    return S.cycle(0, false);
  }

  // the head's step: the packed level 0, the hierarchy and (Chebyshev)
  // its rows, z
  int head_step(cudaStream_t st) const {
    pack_code<T><<<eu_blocks(w.Y * w.X, kThreads), kThreads, 0, st>>>(
        w.Y, w.X, w.code, M.packed0, w.X, w.flags);
    int rc = eu_launch_status();
    if (!rc) rc = M.hierarchy(st, !rbgs);
    return rc ? rc : cycle(st);
  }
};

template <typename T>
int create(int Y, int X, int Yi, int Xi, int L, const int* shapes,
           void* const* planes, void* const* act, void* packed0, void* rows,
           int ncoef, int deg, int coarse_deg, int w, int w_depth, int rbgs,
           int pre_sweeps, int post_sweeps, double ratio, double coarse_ratio,
           void* code, void* p, void* r, void* d, void* z, void* ad,
           void* pre, void* q, void* part, void* hpart, void* scal,
           void* flags, void** out) {
  void* pl[16 * P_COUNT];
  for (int k = 0; k < L * P_COUNT; ++k) pl[k] = planes[k];
  // level 0: the cycle reads b = r and leaves its output in the loop's z
  // (Solve::zout: its z after the degree-1 post-smooth, else its x, as
  // with RB-GS, whose Solve has deg 0); pre, q and ad are free between the
  // p / r update and the next Ad
  const bool post1 = !rbgs && deg == 1 && L > 1;
  pl[P_X] = post1 ? pre : z;
  pl[P_Z] = post1 ? z : nullptr;
  pl[P_RR] = post1 ? q : pre;
  pl[P_D] = post1 ? ad : q;
  pl[P_DN] = post1 ? nullptr : ad;
  PcgMg<T>* S = new PcgMg<T>{};
  S->f64 = sizeof(T) == sizeof(double);
  S->rbgs = rbgs != 0;
  S->w = pcg::Ws{Y, X, Yi, Xi, static_cast<uint8_t*>(code), p, r, d, z, ad,
                 pre, q, part, scal, static_cast<int*>(flags)};
  int rc = make_solve(&S->M.S, L, shapes, pl, packed0, r, rows, ncoef,
                      rbgs ? 0 : deg, coarse_deg, w, w_depth, part, flags,
                      nullptr);
  if (!rc && rbgs)
    rc = make_rbgs(&S->R, S->M.S, pre_sweeps, post_sweeps, coarse_deg);
  if (!rc)
    rc = set_hierarchy(&S->M, L, shapes, pl, act, packed0, rows, ncoef, deg,
                       coarse_deg, ratio, coarse_ratio, -1, hpart);
  if (!rc)
    rc = static_cast<int>(cudaMemset(flags, 0, sizeof(int) * pcg::F_N));
  if (!rc) rc = static_cast<int>(cudaDeviceSynchronize());
  if (!rc)
    rc = static_cast<int>(
        cudaEventCreateWithFlags(&S->replayed, cudaEventDisableTiming));
  if (rc) {
    delete S;
    return rc;
  }
  rc = capture_graph(&S->exec, [&](cudaStream_t cs) {
    const auto step = [S](cudaStream_t s) { return S->cycle(s); };
    int rc_it = 0;
    for (int j = 0; !rc_it && j < pcg::kChunk; ++j)
      rc_it = pcg::enqueue_iteration<T, pcg::kMg>(S->w, step, cs);
    return rc_it;
  });
  if (rc) {
    cudaEventDestroy(S->replayed);
    delete S;
    return rc;
  }
  *out = static_cast<PcgMgHead*>(S);
  return 0;
}

template <typename T>
int destroy(PcgMg<T>* S) {
  int rc = static_cast<int>(cudaEventSynchronize(S->replayed));
  const int rc_graph = static_cast<int>(cudaGraphExecDestroy(S->exec));
  const int rc_event = static_cast<int>(cudaEventDestroy(S->replayed));
  delete S;
  if (!rc) rc = rc_graph;
  return rc ? rc : rc_event;
}

template <typename T>
int solve(const PcgMg<T>* S, int cap, double tol, double tol_rel,
          const void* a_diag, const void* fluid, const void* b,
          const void* x0, cudaStream_t st) {
  const auto step = [S](cudaStream_t s) { return S->head_step(s); };
  const int rc = pcg::enqueue_head<T, pcg::kMg>(
      S->w, static_cast<const int32_t*>(a_diag),
      static_cast<const uint8_t*>(fluid), static_cast<const T*>(b),
      static_cast<const T*>(x0), cap, tol, tol_rel, step, st);
  if (rc) return rc;
  return pcg::replay(S->exec, S->replayed, S->w.flags, cap, 1, st);
}

template <typename T>
int cycle(const PcgMg<T>* S, int per_op, const void* r_in, void* z_out,
          cudaStream_t st) {
  const size_t bytes = sizeof(T) * S->w.Y * S->w.X;
  int rc = static_cast<int>(
      cudaMemsetAsync(S->w.flags + pcg::F_DONE, 0, sizeof(int), st));
  if (!rc)
    rc = static_cast<int>(
        cudaMemcpyAsync(S->w.r, r_in, bytes, cudaMemcpyDeviceToDevice, st));
  if (!rc) rc = S->cycle(st, per_op != 0);
  if (rc) return rc;
  return static_cast<int>(
      cudaMemcpyAsync(z_out, S->w.z, bytes, cudaMemcpyDeviceToDevice, st));
}

const PcgMgHead* head(const void* solver) {
  return static_cast<const PcgMgHead*>(solver);
}

template <typename T>
const PcgMg<T>* as(const void* solver) {
  return static_cast<const PcgMg<T>*>(head(solver));
}

template <typename T>
void plan(const PcgMg<T>* S, int* out) {
  const SolveT<T>& Q = S->rbgs ? S->R.S : S->M.S;
  out[0] = Q.fused;
  out[1] = Q.fused_smem;
  out[2] = Q.L;
}

}  // namespace

// A solver over a workspace's buffers: the loop's [Y, X] planes p, r, d,
// z, ad, pre, q (f32, or f64 with f64 = 1) and u8 code at the padded
// level-0 shape (Y, X), for inputs of Yi x Xi; part: 1024 of the planes'
// type; scal, flags: P1's.  The cycle's L levels: shapes (Y, X) per level
// as stored, level 0 the planes' shape; planes: P_COUNT pointers per
// level (c, e, n, x, b, z, rr, d, dn) of which level 0's are taken from
// the loop's planes here (z is the cycle's output; pre, q, ad its
// scratch) and the coarse c, e, n are the hierarchy's outputs; act: one
// u8 plane per level (level 0's unused); packed0: [Y, X]; rows: [L,
// ncoef]; hpart: the sum over levels of ceil(Yl * Xl / 256); every
// plane, row and partial in the planes' type, the ratios rounded to it.
// Captures the graph of one chunk; *out is the handle.
EU_API int eu_pcg_mg_create(int Y, int X, int Yi, int Xi, int f64, int L,
                            const int* shapes, void* const* planes,
                            void* const* act, void* packed0, void* rows,
                            int ncoef, int deg, int coarse_deg, int w,
                            int w_depth, int rbgs, int pre_sweeps,
                            int post_sweeps, double ratio,
                            double coarse_ratio, void* code, void* p,
                            void* r, void* d, void* z, void* ad, void* pre,
                            void* q, void* part, void* hpart, void* scal,
                            void* flags, void** out) {
  *out = nullptr;
  if (L < 1 || L > 16 || shapes[0] != Y || shapes[1] != X || Yi > Y ||
      Xi > X)
    return static_cast<int>(cudaErrorInvalidValue);
  return (f64 ? create<double> : create<float>)(
      Y, X, Yi, Xi, L, shapes, planes, act, packed0, rows, ncoef, deg,
      coarse_deg, w, w_depth, rbgs, pre_sweeps, post_sweeps, ratio,
      coarse_ratio, code, p, r, d, z, ad, pre, q, part, hpart, scal, flags,
      out);
}

// Frees a solver once its last solve's replays have run.
EU_API int eu_pcg_mg_destroy(void* solver) {
  PcgMgHead* H = static_cast<PcgMgHead*>(solver);
  if (H->f64) return destroy(static_cast<PcgMg<double>*>(H));
  return destroy(static_cast<PcgMg<float>*>(H));
}

// P3: A p = b with a_diag ([Yi, Xi] i32), fluid ([Yi, Xi] u8), b and x0
// ([Yi, Xi] in the solver's type; x0 null: a cold start); the solution
// stays in the workspace's p ([Y, X], the input at its top left), the
// iterations in flags[1], max|r| in scal[4].
EU_API int eu_pcg_mg_solve(void* solver, int cap, double tol, double tol_rel,
                           const void* a_diag, const void* fluid,
                           const void* b, const void* x0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64)
    return solve(as<double>(solver), cap, tol, tol_rel, a_diag, fluid, b, x0,
                 st);
  return solve(as<float>(solver), cap, tol, tol_rel, a_diag, fluid, b, x0,
               st);
}

// One application of the preconditioner to r_in ([Y, X] in the solver's
// type, the planes' shape) on the hierarchy of the last solve, through
// coarse_cycle or, with per_op, one launch per level operation down to the
// coarsest (the check that both round alike); z is copied to z_out ([Y,
// X]).  Clears the stop flag first; the workspace's r and z are
// overwritten.
EU_API int eu_pcg_mg_cycle(void* solver, int per_op, const void* r_in,
                           void* z_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64)
    return cycle(as<double>(solver), per_op, r_in, z_out, st);
  return cycle(as<float>(solver), per_op, r_in, z_out, st);
}

// The cycle's plan: out[0] the level where coarse_cycle (coarse_cycle_rbgs)
// takes over (L: none), out[1] its dynamic shared memory in bytes, out[2]
// L.
EU_API int eu_pcg_mg_plan(const void* solver, int* out) {
  if (head(solver)->f64)
    plan(as<double>(solver), out);
  else
    plan(as<float>(solver), out);
  return 0;
}
