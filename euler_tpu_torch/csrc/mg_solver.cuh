// The MG-PCG solver over a workspace, shared by K3 (mg_pcg.cu) and K11
// (mg_stream.cu): the Galerkin hierarchy and the Chebyshev rows built on
// the device, and a captured CUDA graph of kChunk PCG iterations that a
// solve replays, reading the stop flag once a chunk.
//
// The hierarchy starts at the packed fine level (a_diag + 8 * fluid):
// one kernel for its Gershgorin partials, one per coarse level (the 2x2
// block sums into c, e, n, active and that level's partials), and one
// block that folds the partials into each level's lmax and writes the
// Chebyshev rows.  The weights are integers and lmax a max, so the planes
// are exact whatever the build contracts; the rows follow
// `cheby_coefficients`' recurrence operation by operation in the
// correctly rounded intrinsics (__fdiv_rn, __frcp_rn, ...; mg_levels.cuh's
// `div_rn`, `rcp_rn`, ...), which nvcc never contracts, so K3's library
// (EU_FMAD 1) and K11's (-fmad=false) build the same bits, equal to
// `mg_host_operands`'.  The build is templated on the plane type as the
// levels are: float for K3, K11 and the f32 solves of P3, P4 and P5,
// double for their f64 solves, whose packed level 0, partial maxima,
// bounds and rows are double (the JAX package takes an f64 hierarchy's Chebyshev rows from
// its f64 lmax).  Every kernel of it returns at once when the stop flag
// is set (an all-zero RHS).
//
// K3's cycle runs on every level of the hierarchy, from the packed one;
// K11's from its root, the first resident level (F = 2 or 4 below the
// fine one), and the levels between only feed the hierarchy.  K11 also
// takes the fine level's degree-1 1/theta as one row more after the
// levels' (`Rows.fine`).
#pragma once

#include "mg_levels.cuh"

namespace {

constexpr int kChunk = 8;  // PCG iterations per replay of the captured graph

// a cell of a level in edge form: diagonal, east and north couplings
template <typename T>
struct EdgeT {
  T c, e, n;
  bool act;
};
using Edge = EdgeT<float>;

// packed level 0 in edge form (multigrid.fine_edge_level): c = a_diag on
// fluid cells, -1 couplings between two fluid cells
template <typename T>
__device__ __forceinline__ EdgeT<T> edge0(const LvlT<T>& L, int i, int j) {
  const int k = i * L.X + j;
  const T fl = fluid0(L, k);
  const bool f = fl != T(0);
  return EdgeT<T>{L.pk[k] - T(8) * fl,
                  f && j + 1 < L.X && fluid0(L, k + 1) != T(0) ? T(-1) : T(0),
                  f && i + 1 < L.Y && fluid0(L, k + L.X) != T(0) ? T(-1)
                                                                 : T(0),
                  f};
}

template <bool PACKED, typename T>
__device__ __forceinline__ EdgeT<T> fine_at(const LvlT<T>& L,
                                            const uint8_t* __restrict__ act,
                                            int i, int j) {
  if (PACKED) return edge0(L, i, j);
  const int k = i * L.X + j;
  return EdgeT<T>{L.c[k], L.e[k], L.n[k], act[k] != 0};
}

// a level's cells in edge form, `fine_at`
template <bool PACKED, typename T = float>
struct FineAt {
  LvlT<T> L;
  const uint8_t* act;
  __device__ __forceinline__ EdgeT<T> at(int i, int j) const {
    return fine_at<PACKED>(L, act, i, j);
  }
};

// coarse cell (I, J) of A_c = P^T A P (multigrid.coarsen_galerkin) from
// the cells F.at(i, j) of the level above: the block's diagonals plus
// twice its inner couplings, the couplings that cross to the east and
// north blocks, active when a child is (integers: exact in any order)
template <class Fine>
__device__ auto coarse_of(const Fine& F, int I, int J) {
  const auto q00 = F.at(2 * I, 2 * J);
  const auto q01 = F.at(2 * I, 2 * J + 1);
  const auto q10 = F.at(2 * I + 1, 2 * J);
  const auto q11 = F.at(2 * I + 1, 2 * J + 1);
  using T = decltype(q00.c);
  const bool a = q00.act || q01.act || q10.act || q11.act;
  const T c = ((q00.c + q01.c) + (q10.c + q11.c)) + T(2) * (q00.e + q10.e) +
              T(2) * (q00.n + q01.n);
  return EdgeT<T>{a ? c : T(0), q01.e + q11.e, q10.n + q11.n, a};
}

template <bool PACKED, typename T>
__device__ EdgeT<T> coarse_at(const LvlT<T>& L,
                              const uint8_t* __restrict__ act, int I, int J) {
  return coarse_of(FineAt<PACKED, T>{L, act}, I, J);
}

// the Gershgorin row value c + |off-diagonals| of an active cell, from
// the cell and its west and south neighbours' couplings
template <typename T>
__device__ __forceinline__ T gershgorin(const EdgeT<T>& q, T e_west,
                                        T n_south) {
  return q.act ? q.c + -(((q.e + e_west) + q.n) + n_south) : T(0);
}

template <typename T>
__device__ __forceinline__ void write_max(T m, T* part) {
  m = block_reduce<EU_MAX>(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// level 0's per-block maxima of the Gershgorin row value
template <typename T>
__global__ void fine_lmax(LvlT<T> L0, T* __restrict__ part,
                          const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T g = T(0);
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    g = gershgorin(edge0(L0, i, j), j > 0 ? edge0(L0, i, j - 1).e : T(0),
                   i > 0 ? edge0(L0, i - 1, j).n : T(0));
  }
  write_max(g, part);
}

// the level below L, stored Yc x Xc (L / 2, and where P3 pads it, a row
// or column of inactive pad more: zero weights, not active): its c, e, n
// planes, active flags and per-block maxima of its Gershgorin row value
// (the west and south couplings recomputed from L)
template <bool PACKED, typename T>
__global__ void coarsen(LvlT<T> L, int Yc, int Xc,
                        const uint8_t* __restrict__ act, T* __restrict__ c,
                        T* __restrict__ e, T* __restrict__ n,
                        uint8_t* __restrict__ act_c, T* __restrict__ part,
                        const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T g = T(0);
  if (t < Yc * Xc) {
    const int I = t / Xc, J = t - I * Xc;
    const bool pad = 2 * I >= L.Y || 2 * J >= L.X;
    const EdgeT<T> q = pad ? EdgeT<T>{T(0), T(0), T(0), false}
                           : coarse_at<PACKED>(L, act, I, J);
    c[t] = q.c;
    e[t] = q.e;
    n[t] = q.n;
    act_c[t] = q.act;
    if (!pad)
      g = gershgorin(q, J > 0 ? coarse_at<PACKED>(L, act, I, J - 1).e : T(0),
                     I > 0 ? coarse_at<PACKED>(L, act, I - 1, J).n : T(0));
  }
  write_max(g, part);
}

template <typename T>
struct RowsT {
  int L, ncoef, deg, coarse_deg;
  T ratio, coarse_ratio;
  int fine;     // the row that gets level 0's [1/theta, 0, ...] (-1: none)
  int off[17];  // level l's partials: part[off[l] .. off[l + 1])
};
using Rows = RowsT<float>;

// lmax = max(1, max of level l's partials), then the Golub-Varga row
// [1/theta, c_prev_0, c_r_0, ...] on [lmax/ratio, lmax] in the operation
// order of multigrid.cheby_coefficients (x / 2.0 is x * 0.5 there),
// zero past the level's degree; in T, as the JAX package computes an f64
// hierarchy's rows in f64
template <typename T>
__global__ void cheby_rows(RowsT<T> R, const T* __restrict__ part,
                           T* __restrict__ rows,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  for (int l = 0; l < R.L; ++l) {
    const T m =
        reduce_partials<EU_MAX>(part + R.off[l], R.off[l + 1] - R.off[l]);
    if (threadIdx.x != 0) continue;
    const bool last = l == R.L - 1;
    const int degree = last ? R.coarse_deg : R.deg;
    const T lmax = nanmax(m, T(1));
    const T lmin = div_rn(lmax, last ? R.coarse_ratio : R.ratio);
    const T theta = mul_rn(add_rn(lmax, lmin), T(0.5));
    const T delta = mul_rn(sub_rn(lmax, lmin), T(0.5));
    const T sigma = div_rn(theta, delta);
    T rho = rcp_rn(sigma);
    T* row = rows + l * R.ncoef;
    row[0] = rcp_rn(theta);
    for (int k = 0; 2 * k + 2 < R.ncoef; ++k) {
      T cp = T(0), cr = T(0);
      if (k < degree) {
        const T rho_new = rcp_rn(sub_rn(mul_rn(T(2), sigma), rho));
        cp = mul_rn(rho_new, rho);
        cr = div_rn(mul_rn(T(2), rho_new), delta);
        rho = rho_new;
      }
      row[1 + 2 * k] = cp;
      row[2 + 2 * k] = cr;
    }
  }
  if (R.fine >= 0 && threadIdx.x == 0) {
    T* row = rows + R.fine * R.ncoef;
    row[0] = rows[0];
    for (int k = 1; k < R.ncoef; ++k) row[k] = T(0);
  }
}

// level 0 of the cycle in packed form, a_diag + 8 on fluid cells and 0
// elsewhere, from the PCG loop's [Y, X] operator code 8 | a_diag (P3, P4,
// P5), into a plane of row stride Xd: X, or a level 0 stored padded (P4's
// odd-sided block), whose pad keeps the zeros it was made with
template <typename T>
__global__ void pack_code(int Y, int X, const uint8_t* __restrict__ code,
                          T* __restrict__ packed, int Xd,
                          const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Y * X) return;
  const int i = t / X, j = t - i * X;
  packed[static_cast<long long>(i) * Xd + j] = static_cast<T>(code[t]);
}

// a [Y, X] window between two planes of row strides Xs and Xd: a block's
// plane into the top left of its padded level 0 (P4), or the block's
// cells out of the whole grid's (P5; src at the block's first cell)
template <typename T>
__global__ void copy_window(int Y, int X, const T* __restrict__ src, int Xs,
                            T* __restrict__ dst, int Xd,
                            const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Y * X) return;
  const int i = t / X, j = t - i * X;
  dst[static_cast<long long>(i) * Xd + j] =
      src[static_cast<long long>(i) * Xs + j];
}

// the head: the packed plane a_diag * fl + 8 * fl
__global__ void pack_kernel(int n, const int32_t* __restrict__ a_diag,
                            const uint8_t* __restrict__ fl,
                            float* __restrict__ packed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float f = fl[t] ? 1.0f : 0.0f;
  packed[t] = static_cast<float>(a_diag[t]) * f + 8.0f * f;
}

// one workspace's solver: the cycle, the PCG loop, the hierarchy's
// planes and partials, and the graph of one chunk of iterations.  In T:
// float for K3, K11 and the f32 solves of P3 and P4; double for their
// f64 solves.  P3 and P4 use the hierarchy and the cycle only (the loop P
// and its graph are K3's and K11's, float)
template <typename T>
struct MgSolverT {
  SolveT<T> S;      // the cycle's levels (K3: all; K11: from its root)
  PcgLoop P;        // the PCG loop on the packed fine level
  int HL;           // the hierarchy's levels, the packed fine one first
  LvlT<T> hl[16];
  T* c[16];         // the coarse levels' planes and active flags, the
  T* e[16];         // hierarchy's outputs (level 0's unused)
  T* n[16];
  uint8_t* act[16];
  T* packed0;
  T* rows;
  T* hpart;
  RowsT<T> R;
  float tol, tol_rel;
  cudaGraphExec_t exec;
  cudaEvent_t replayed;  // recorded after each solve's last replay

  unsigned blocks(int l) const {
    return eu_blocks(static_cast<long long>(hl[l].Y) * hl[l].X, kThreads);
  }

  // the Galerkin hierarchy and, with_rows, the Chebyshev rows of packed0
  // (their bounds: fine_lmax, coarsen's partial maxima, cheby_rows)
  int hierarchy(cudaStream_t st, bool with_rows = true) const {
    const int* fl = S.flags;
    int rc = 0;
    if (with_rows) {
      fine_lmax<T><<<blocks(0), kThreads, 0, st>>>(hl[0], hpart, fl);
      rc = eu_launch_status();
    }
    for (int l = 0; !rc && l + 1 < HL; ++l) {
      T* part = hpart + R.off[l + 1];
      const int Yc = hl[l + 1].Y, Xc = hl[l + 1].X;
      if (l == 0)
        coarsen<true, T><<<blocks(1), kThreads, 0, st>>>(
            hl[0], Yc, Xc, nullptr, c[1], e[1], n[1], act[1], part, fl);
      else
        coarsen<false, T><<<blocks(l + 1), kThreads, 0, st>>>(
            hl[l], Yc, Xc, act[l], c[l + 1], e[l + 1], n[l + 1], act[l + 1],
            part, fl);
      rc = eu_launch_status();
    }
    if (rc || !with_rows) return rc;
    cheby_rows<T><<<1, 1024, 0, st>>>(R, hpart, rows, fl);
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
using MgSolver = MgSolverT<float>;

// The hierarchy of HL levels over packed0: shapes (Y, X) per level;
// planes: P_COUNT pointers per level, of which the coarse levels' c, e, n
// are the build's outputs; act: one u8 plane per level (level 0's
// unused); rows: [HL, ncoef], then row `fine` (K11; -1: none); hpart:
// the sum over levels of ceil(Yl*Xl/256) T; the ratios rounded to T.
template <typename T>
inline int set_hierarchy(MgSolverT<T>* M, int HL, const int* shapes,
                         void* const* planes, void* const* act,
                         void* packed0, void* rows, int ncoef, int deg,
                         int coarse_deg, double ratio, double coarse_ratio,
                         int fine, void* hpart) {
  if (HL < 1 || HL > 16) return static_cast<int>(cudaErrorInvalidValue);
  M->HL = HL;
  M->packed0 = static_cast<T*>(packed0);
  M->rows = static_cast<T*>(rows);
  M->hpart = static_cast<T*>(hpart);
  M->R = RowsT<T>{HL, ncoef, deg, coarse_deg, static_cast<T>(ratio),
                  static_cast<T>(coarse_ratio), fine, {0}};
  for (int l = 0; l < HL; ++l) {
    void* const* pl = planes + l * P_COUNT;
    M->c[l] = static_cast<T*>(pl[P_C]);
    M->e[l] = static_cast<T*>(pl[P_E]);
    M->n[l] = static_cast<T*>(pl[P_N]);
    M->act[l] = static_cast<uint8_t*>(act[l]);
    M->hl[l] = LvlT<T>{shapes[2 * l], shapes[2 * l + 1], M->c[l], M->e[l],
                       M->n[l], l == 0 ? M->packed0 : nullptr};
    M->R.off[l + 1] = M->R.off[l] + static_cast<int>(M->blocks(l));
  }
  return 0;
}

// Captures kChunk iterations, each enqueued by `iteration(S, P)`, into
// M->exec on a stream of its own, and creates M->replayed.  On failure
// frees what it made.
template <class Iteration>
int capture_chunk(MgSolver* M, Iteration iteration) {
  int rc = static_cast<int>(
      cudaEventCreateWithFlags(&M->replayed, cudaEventDisableTiming));
  if (rc) return rc;
  rc = capture_graph(&M->exec, [&](cudaStream_t cs) {
    Solve S = M->S;
    PcgLoop P = M->P;
    S.s = P.st = cs;
    int rc_it = 0;
    for (int it = 0; !rc_it && it < kChunk; ++it) rc_it = iteration(S, P);
    return rc_it;
  });
  if (rc) cudaEventDestroy(M->replayed);
  return rc;
}

}  // namespace

// Frees a solver once its last solve's replays have run (the buffers are
// the caller's).
EU_API int eu_mg_destroy(void* solver) {
  MgSolver* M = static_cast<MgSolver*>(solver);
  int rc = static_cast<int>(cudaEventSynchronize(M->replayed));
  const int rc_graph = static_cast<int>(cudaGraphExecDestroy(M->exec));
  const int rc_event = static_cast<int>(cudaEventDestroy(M->replayed));
  delete M;
  if (!rc) rc = rc_graph;
  return rc ? rc : rc_event;
}
