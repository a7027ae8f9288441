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
//   * the Galerkin hierarchy is built here, on the device: one kernel for
//     level 0's Gershgorin partials, one per coarse level (the 2x2 block
//     sums into c, e, n, active and that level's partials), and one block
//     that folds the partials into each level's lmax and writes the
//     Chebyshev rows.  The weights are integers and lmax a max, so the
//     planes are exact; the rows follow `cheby_coefficients`' f32
//     recurrence operation by operation with the correctly rounded
//     intrinsics (__fdiv_rn, __frcp_rn, ...), which nvcc never contracts,
//     so they equal `mg_host_operands`' rows bit for bit.  They are skipped
//     on an all-zero RHS (the solve then takes 0 iterations).
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
#include "mg_levels.cuh"

namespace {

constexpr int kChunk = 8;  // PCG iterations per replay of the captured graph

// a cell of a level in edge form: diagonal, east and north couplings
struct Edge {
  float c, e, n;
  bool act;
};

// packed level 0 in edge form (multigrid.fine_edge_level): c = a_diag on
// fluid cells, -1 couplings between two fluid cells
__device__ __forceinline__ Edge edge0(const Lvl& L, int i, int j) {
  const int k = i * L.X + j;
  const float fl = fluid0(L, k);
  const bool f = fl != 0.0f;
  return Edge{L.pk[k] - 8.0f * fl,
              f && j + 1 < L.X && fluid0(L, k + 1) != 0.0f ? -1.0f : 0.0f,
              f && i + 1 < L.Y && fluid0(L, k + L.X) != 0.0f ? -1.0f : 0.0f,
              f};
}

template <bool PACKED>
__device__ __forceinline__ Edge fine_at(const Lvl& L,
                                        const uint8_t* __restrict__ act,
                                        int i, int j) {
  if (PACKED) return edge0(L, i, j);
  const int k = i * L.X + j;
  return Edge{L.c[k], L.e[k], L.n[k], act[k] != 0};
}

// coarse cell (I, J) of A_c = P^T A P (multigrid.coarsen_galerkin): the
// block's diagonals plus twice its inner couplings, the couplings that
// cross to the east and north blocks, active when a child is
template <bool PACKED>
__device__ Edge coarse_at(const Lvl& L, const uint8_t* __restrict__ act,
                          int I, int J) {
  const Edge q00 = fine_at<PACKED>(L, act, 2 * I, 2 * J);
  const Edge q01 = fine_at<PACKED>(L, act, 2 * I, 2 * J + 1);
  const Edge q10 = fine_at<PACKED>(L, act, 2 * I + 1, 2 * J);
  const Edge q11 = fine_at<PACKED>(L, act, 2 * I + 1, 2 * J + 1);
  const bool a = q00.act || q01.act || q10.act || q11.act;
  const float c = ((q00.c + q01.c) + (q10.c + q11.c)) +
                  2.0f * (q00.e + q10.e) + 2.0f * (q00.n + q01.n);
  return Edge{a ? c : 0.0f, q01.e + q11.e, q10.n + q11.n, a};
}

// the Gershgorin row value c + |off-diagonals| of an active cell, from
// the cell and its west and south neighbours' couplings
__device__ __forceinline__ float gershgorin(const Edge& q, float e_west,
                                            float n_south) {
  return q.act ? q.c + -(((q.e + e_west) + q.n) + n_south) : 0.0f;
}

__device__ __forceinline__ void write_max(float m, float* part) {
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// level 0's per-block maxima of the Gershgorin row value
__global__ void fine_lmax(Lvl L0, float* __restrict__ part,
                          const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float g = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    g = gershgorin(edge0(L0, i, j), j > 0 ? edge0(L0, i, j - 1).e : 0.0f,
                   i > 0 ? edge0(L0, i - 1, j).n : 0.0f);
  }
  write_max(g, part);
}

// the level below L: its c, e, n planes, active flags and per-block
// maxima of its Gershgorin row value (the west and south couplings
// recomputed from L)
template <bool PACKED>
__global__ void coarsen(Lvl L, const uint8_t* __restrict__ act,
                        float* __restrict__ c, float* __restrict__ e,
                        float* __restrict__ n, uint8_t* __restrict__ act_c,
                        float* __restrict__ part,
                        const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int Yc = L.Y / 2, Xc = L.X / 2;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float g = 0.0f;
  if (t < Yc * Xc) {
    const int I = t / Xc, J = t - I * Xc;
    const Edge q = coarse_at<PACKED>(L, act, I, J);
    c[t] = q.c;
    e[t] = q.e;
    n[t] = q.n;
    act_c[t] = q.act;
    g = gershgorin(q, J > 0 ? coarse_at<PACKED>(L, act, I, J - 1).e : 0.0f,
                   I > 0 ? coarse_at<PACKED>(L, act, I - 1, J).n : 0.0f);
  }
  write_max(g, part);
}

struct Rows {
  int L, ncoef, deg, coarse_deg;
  float ratio, coarse_ratio;
  int off[17];  // level l's partials: part[off[l] .. off[l + 1])
};

// lmax = max(1, max of level l's partials), then the Golub-Varga row
// [1/theta, c_prev_0, c_r_0, ...] on [lmax/ratio, lmax] in the operation
// order of multigrid.cheby_coefficients (x / 2.0 is x * 0.5 there),
// zero past the level's degree
__global__ void cheby_rows(Rows R, const float* __restrict__ part,
                           float* __restrict__ rows,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  for (int l = 0; l < R.L; ++l) {
    const float m =
        reduce_partials<EU_MAX>(part + R.off[l], R.off[l + 1] - R.off[l]);
    if (threadIdx.x != 0) continue;
    const bool last = l == R.L - 1;
    const int degree = last ? R.coarse_deg : R.deg;
    const float lmax = nanmax(m, 1.0f);
    const float lmin = __fdiv_rn(lmax, last ? R.coarse_ratio : R.ratio);
    const float theta = __fmul_rn(__fadd_rn(lmax, lmin), 0.5f);
    const float delta = __fmul_rn(__fsub_rn(lmax, lmin), 0.5f);
    const float sigma = __fdiv_rn(theta, delta);
    float rho = __frcp_rn(sigma);
    float* row = rows + l * R.ncoef;
    row[0] = __frcp_rn(theta);
    for (int k = 0; 2 * k + 2 < R.ncoef; ++k) {
      float cp = 0.0f, cr = 0.0f;
      if (k < degree) {
        const float rho_new =
            __frcp_rn(__fsub_rn(__fmul_rn(2.0f, sigma), rho));
        cp = __fmul_rn(rho_new, rho);
        cr = __fdiv_rn(__fmul_rn(2.0f, rho_new), delta);
        rho = rho_new;
      }
      row[1 + 2 * k] = cp;
      row[2 + 2 * k] = cr;
    }
  }
}

// K3's head: the packed plane a_diag * fl + 8 * fl
__global__ void pack_kernel(int n, const int32_t* __restrict__ a_diag,
                            const uint8_t* __restrict__ fl,
                            float* __restrict__ packed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float f = fl[t] ? 1.0f : 0.0f;
  packed[t] = static_cast<float>(a_diag[t]) * f + 8.0f * f;
}

// one workspace's solver: the cycle, the PCG loop, the hierarchy's
// planes and partials, and the graph of one chunk of iterations
struct MgSolver {
  Solve S;
  PcgLoop P;
  float* packed0;
  float* rows;
  float* hpart;
  float* c[16];
  float* e[16];
  float* n[16];
  uint8_t* act[16];
  Rows R;
  float tol, tol_rel;
  cudaGraphExec_t exec;
  cudaEvent_t replayed;  // recorded after each solve's last replay

  // the Galerkin hierarchy and the Chebyshev rows of packed0
  int hierarchy(cudaStream_t st) const {
    const int* fl = S.flags;
    fine_lmax<<<S.blocks(0), kThreads, 0, st>>>(S.lv[0], hpart, fl);
    int rc = eu_launch_status();
    for (int l = 0; !rc && l + 1 < S.L; ++l) {
      float* part = hpart + R.off[l + 1];
      if (l == 0)
        coarsen<true><<<S.blocks(1), kThreads, 0, st>>>(
            S.lv[0], nullptr, c[1], e[1], n[1], act[1], part, fl);
      else
        coarsen<false><<<S.blocks(l + 1), kThreads, 0, st>>>(
            S.lv[l], act[l], c[l + 1], e[l + 1], n[l + 1], act[l + 1], part,
            fl);
      rc = eu_launch_status();
    }
    if (rc) return rc;
    cheby_rows<<<1, 1024, 0, st>>>(R, hpart, rows, fl);
    return eu_launch_status();
  }

  // iterations in chunks of kChunk, reading the stop flag after each
  int iterate(cudaStream_t st) const {
    const int chunks = (P.max_iters + kChunk - 1) / kChunk;
    PcgLoop Q = P;
    Q.st = st;
    for (int k = 0; k < chunks; ++k) {
      int rc = static_cast<int>(cudaGraphLaunch(exec, st));
      if (rc) return rc;
      int done = 0;
      if ((rc = Q.done(&done))) return rc;
      if (done) break;
    }
    return static_cast<int>(cudaEventRecord(replayed, st));
  }
};

}  // namespace

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
    rc = static_cast<int>(
        cudaEventCreateWithFlags(&M->replayed, cudaEventDisableTiming));
  if (rc) {
    delete M;
    return rc;
  }
  M->P = PcgLoop{M->S.lv[0], static_cast<float*>(p), rp,
                 static_cast<float*>(s_), static_cast<float*>(As),
                 M->S.part, static_cast<float*>(scal),
                 static_cast<int*>(flags), max_iters, nullptr};
  M->packed0 = static_cast<float*>(packed0);
  M->rows = static_cast<float*>(rows);
  M->hpart = static_cast<float*>(hpart);
  M->R = Rows{L, ncoef, deg, coarse_deg, ratio, coarse_ratio, {0}};
  for (int l = 0; l < L; ++l) {
    void* const* pl = planes + l * P_COUNT;
    M->c[l] = static_cast<float*>(pl[P_C]);
    M->e[l] = static_cast<float*>(pl[P_E]);
    M->n[l] = static_cast<float*>(pl[P_N]);
    M->act[l] = static_cast<uint8_t*>(act[l]);
    M->R.off[l + 1] = M->R.off[l] + static_cast<int>(M->S.blocks(l));
  }
  M->tol = tol;
  M->tol_rel = tol_rel;

  // capture the chunk on a stream of our own
  cudaStream_t cs;
  if ((rc = static_cast<int>(
           cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking)))) {
    delete M;
    return rc;
  }
  Solve S = M->S;
  PcgLoop P = M->P;
  S.s = P.st = cs;
  rc = static_cast<int>(
      cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal));
  if (!rc) {
    for (int it = 0; !rc && it < kChunk; ++it) {
      rc = S.cycle(0, true);
      if (!rc) rc = P.step(S.zout(0));
    }
    cudaGraph_t g = nullptr;
    const int rc_end = static_cast<int>(cudaStreamEndCapture(cs, &g));
    if (!rc) rc = rc_end;
    if (!rc) rc = static_cast<int>(cudaGraphInstantiate(&M->exec, g, 0));
    if (g) cudaGraphDestroy(g);
  }
  const int rc_destroy = static_cast<int>(cudaStreamDestroy(cs));
  if (!rc) rc = rc_destroy;
  if (rc) {
    if (M->exec) cudaGraphExecDestroy(M->exec);
    cudaEventDestroy(M->replayed);
    delete M;
    return rc;
  }
  *out = M;
  return 0;
}

// Frees the solver once its last solve's replays have run (the buffers
// are the caller's).
EU_API int eu_mg_destroy(void* solver) {
  MgSolver* M = static_cast<MgSolver*>(solver);
  int rc = static_cast<int>(cudaEventSynchronize(M->replayed));
  const int rc_graph = static_cast<int>(cudaGraphExecDestroy(M->exec));
  const int rc_event = static_cast<int>(cudaEventDestroy(M->replayed));
  delete M;
  if (!rc) rc = rc_graph;
  return rc ? rc : rc_event;
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
