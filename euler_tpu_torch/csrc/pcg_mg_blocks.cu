// P5: the MG-PCG solve of the whole grid, computed on blocks of it: the
// port of what GSPMD makes of euler_tpu/ops/project.py:115 `pcg_loop`
// with ops/multigrid.py:492 `make_mg_preconditioner` (Galerkin,
// Chebyshev) in the frame on ("y", "x") blocks,
// euler_tpu/parallel/spatial.py:113 `make_spatial_step` (no pallas_call):
// one truncated-W cycle over the WHOLE grid's hierarchy, partitioned.
//
// P5 computes P3's function (pcg_mg.cu), each block holding its cells:
//   * the loop is P1's (pcg_loop.cuh) with SHARD = kGridOrder, driven
//     from the host one stage at a time as P4's (pcg_shard.cu): the
//     operator in apply_a's order, a s - (((l + r) + d) + u), with the
//     neighbours' edges of d (of p, warm) exchanged before each apply, and
//     every reduction's block fold all-reduced over the blocks before the
//     `shard_finish` that uses it.  One block's fold is P1's, so 1 x 1
//     blocks repeat P3 bit for bit; on n blocks only the fold of the dots
//     and maxima over the blocks differs.
//   * levels 0 .. G - 1 of the cycle are distributed.  Every level
//     operation is P3's per-cell function (mg_levels.cuh `*_at`) with a
//     `BlockEdges` loader: what lies one cell beyond the block comes from
//     the neighbours' edges of the plane the operation applies the
//     operator to (b for the pre-smooth and restriction, x for the
//     restriction and post-smooth, d for a Chebyshev step), which the host
//     exchanges before the launch, and from the level's west e and south n
//     edges, exchanged once a build; the operand order is P3's.  The
//     restriction and the prolongation stay in the block: its extent is
//     even at every level it coarsens.
//   * the gather level G is the first where P3's coarse cluster launch
//     takes over (kFusedCells), or an earlier one where a block's extent
//     turns odd or under 8 cells.  Its c, e, n, active are all-gathered
//     once a build, and the restricted residual on every visit, into
//     whole planes stored as P3 stores its levels >= 1 (a row or column
//     of inactive pad where a coarsened level is odd); every block then
//     runs P3's cycle from G down on the whole coarse grid (`Solve`, the
//     same launches) and prolongs its own part of the correction.
//   * G = 0 where a block has an odd side (1080 x 1920 on 8 row blocks of
//     135 rows; 999² on 3 x 3): level 1 cannot be made in the blocks, so
//     every block holds the whole grid's hierarchy, stored as P3 stores
//     it (level 0 padded by a row or column of inactive cells where the
//     grid is odd).  Once a build the blocks' packed level 0 is
//     all-gathered into its top left, and on every visit of the cycle
//     the blocks' r, with a zero pad; every block runs P3's cycle on it
//     (`Solve` from level 0, the same launches) and copies its own cells
//     of the correction into the loop's z.  The whole cycle is computed
//     on every block; a split of level 1 into ragged blocks would keep
//     the fine levels distributed (ROADMAP queue 2 item 9).
//   * the hierarchy's weights are integer sums, exact in any order, and
//     lmax is a max: a distributed level's is the max over the blocks of
//     the block's partials (the host all-reduces the G maxima), so the
//     planes and the Chebyshev rows are P3's bit for bit.
// The host drives the stages, the level operations and the exchanges
// (ops/cuda/pcg_mg_blocks_kernel.py): no graph.  On an H100 the device
// work of an iteration is P3's cut into blocks, launch-bound below the
// fine levels; what bounds it at the sizes here is the host: some forty
// exchanges and all-reduces an iteration, each a meeting of the blocks.
// Built with -fmad=false (EU_FMAD 0), as P3.
//
// Precision.  A solver is float or double (`f64` at create), as P3's: the
// loop, the block's levels, its partials and maxima, the gathered levels,
// the Chebyshev rows and every edge the host exchanges in a cycle are T,
// so an f64 solve (the JAX package's `solver.dtype="float64"` with MG in
// its frame on blocks) takes its rows from double bounds; the gathered
// `Solve` starts its coarse cycle where P3's of the same precision does.
#define EU_FMAD 0
#include "mg_solver.cuh"
#include "pcg_loop.cuh"

namespace {

// A distributed level's neighbours' edges: of the plane an operation
// applies the operator to, the row before row 0 and after row Y - 1 ([X])
// and the column before column 0 and after column X - 1 ([Y]); of the
// level's couplings, e of the column before column 0 ([Y]) and n of the
// row before row 0 ([X]).  Zeros beyond the grid's edges, as `Zeros`.
template <typename T>
struct BlockEdges {
  const T* below;
  const T* above;
  const T* left;
  const T* right;
  const T* ew;
  const T* ns;
  __device__ __forceinline__ T x(const T* p, int i, int j, int Y,
                                 int X) const {
    if (i < 0) return below[j];
    if (i >= Y) return above[j];
    if (j < 0) return left[i];
    if (j >= X) return right[i];
    return p[i * X + j];
  }
  __device__ __forceinline__ T e_west(const T* e, int i, int j, int,
                                      int X) const {
    return j > 0 ? e[i * X + j - 1] : ew[i];
  }
  __device__ __forceinline__ T n_south(const T* n, int i, int j, int,
                                       int X) const {
    return i > 0 ? n[(i - 1) * X + j] : ns[j];
  }
};

// The packed level 0 of a block in edge form (fine_at<true>'s cells), its
// neighbours' fluid one cell beyond each edge from the fluid ring (u8: [X]
// below and above, [Y] left and right; zeros beyond the grid's edges), so
// that the couplings across the block's edges are the grid's
template <typename T>
struct Ring0 {
  LvlT<T> L;
  const uint8_t* below;
  const uint8_t* above;
  const uint8_t* left;
  const uint8_t* right;
  __device__ __forceinline__ bool fl(int i, int j) const {
    if (i < 0) return below[j] != 0;
    if (i >= L.Y) return above[j] != 0;
    if (j < 0) return left[i] != 0;
    if (j >= L.X) return right[i] != 0;
    return fluid0(L, i * L.X + j) != T(0);
  }
  // the couplings of (i, j) to (i, j + 1) and to (i + 1, j): a cell of the
  // block, or of the ring before its first row or column
  __device__ __forceinline__ T e(int i, int j) const {
    return fl(i, j) && fl(i, j + 1) ? T(-1) : T(0);
  }
  __device__ __forceinline__ T n(int i, int j) const {
    return fl(i, j) && fl(i + 1, j) ? T(-1) : T(0);
  }
  __device__ __forceinline__ EdgeT<T> at(int i, int j) const {
    const int k = i * L.X + j;
    const T f = fluid0(L, k);
    return EdgeT<T>{L.pk[k] - T(8) * f, e(i, j), n(i, j), f != T(0)};
  }
};

// ---- the hierarchy on a block ----

// level 0's block partials of the Gershgorin row value (P3's fine_lmax)
template <typename T>
__global__ void ring_lmax0(Ring0<T> R, T* __restrict__ part,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T g = T(0);
  if (t < R.L.Y * R.L.X) {
    const int i = t / R.L.X, j = t - i * R.L.X;
    g = gershgorin(R.at(i, j), R.e(i, j - 1), R.n(i - 1, j));
  }
  write_max(g, part);
}

// the block's cells of the level below F (Ring0 at level 0, a level's
// planes above it): c, e, n, active; the level's Gershgorin partials wait
// for the neighbours' edges (edge_lmax)
template <class Fine, typename T>
__global__ void block_coarsen(Fine F, int Yc, int Xc, T* __restrict__ c,
                              T* __restrict__ e, T* __restrict__ n,
                              uint8_t* __restrict__ act,
                              const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  const int I = t / Xc, J = t - I * Xc;
  const EdgeT<T> q = coarse_of(F, I, J);
  c[t] = q.c;
  e[t] = q.e;
  n[t] = q.n;
  act[t] = q.act;
}

// a level's partials of the Gershgorin row value in edge form, the west
// and south couplings across its edges from ew, ns (null: 0, a whole
// level; a pad cell is inactive: 0)
template <typename T>
__global__ void edge_lmax(LvlT<T> L, const uint8_t* __restrict__ act,
                          const T* __restrict__ ew, const T* __restrict__ ns,
                          T* __restrict__ part,
                          const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  T g = T(0);
  if (t < L.Y * L.X) {
    const int i = t / L.X, j = t - i * L.X;
    const EdgeT<T> q{L.c[t], L.e[t], L.n[t], act[t] != 0};
    const T w = j > 0 ? L.e[t - 1] : (ew ? ew[i] : T(0));
    const T s = i > 0 ? L.n[t - L.X] : (ns ? ns[j] : T(0));
    g = gershgorin(q, w, s);
  }
  write_max(g, part);
}

struct Folds {
  int G;
  int off[17];  // level l's block partials: bpart[off[l] .. off[l + 1])
};

// the block's max of each distributed level's partials, into hp[l]
template <typename T>
__global__ void fold_max(Folds F, const T* __restrict__ bpart,
                         T* __restrict__ hp, const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  for (int l = 0; l < F.G; ++l) {
    const T m =
        reduce_partials<EU_MAX>(bpart + F.off[l], F.off[l + 1] - F.off[l]);
    if (threadIdx.x == 0) hp[l] = m;
  }
}

// ---- the level operations on a block (P3's, with its edges) ----

template <typename T>
__global__ void b_pre1_restrict(LvlT<T> L, int Yc, int Xc,
                                const T* __restrict__ b, T* __restrict__ x,
                                T* __restrict__ bc,
                                const T* __restrict__ row, BlockEdges<T> h,
                                const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  pre1_restrict_at(L, b, x, bc, row[0], Xc, t, h);
}

template <typename T>
__global__ void b_restrict_full(LvlT<T> L, int Yc, int Xc,
                                const T* __restrict__ b,
                                const T* __restrict__ x, T* __restrict__ bc,
                                BlockEdges<T> h,
                                const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  restrict_full_at(L, b, x, bc, Xc, t, h);
}

template <typename T>
__global__ void b_post1(LvlT<T> L, const T* __restrict__ b,
                        const T* __restrict__ x, T* __restrict__ z,
                        const T* __restrict__ row, BlockEdges<T> h,
                        const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < L.Y * L.X) post1_at(L, b, x, z, row[0], t, h);
}

template <typename T>
__global__ void b_cheby_init(LvlT<T> L, const T* __restrict__ b,
                             T* __restrict__ x, T* __restrict__ rr,
                             T* __restrict__ d, const T* __restrict__ row,
                             int from_zero, BlockEdges<T> h,
                             const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < L.Y * L.X) cheby_init_at(L, b, x, rr, d, row[0], from_zero, t, h);
}

template <typename T>
__global__ void b_cheby_step(LvlT<T> L, T* __restrict__ x,
                             T* __restrict__ rr, const T* __restrict__ d,
                             T* __restrict__ dn, const T* __restrict__ row,
                             int k, BlockEdges<T> h,
                             const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < L.Y * L.X)
    cheby_step_at(L, x, rr, d, dn, row[1 + 2 * k], row[2 + 2 * k], t, h);
}

// the host's level operations (pcg_mg_blocks_kernel.py `OPS`)
enum Op { kPre1, kRestrict, kProlong, kPost1, kChebyInit, kChebyStep,
          kAxpy, kCoarse };
// the hierarchy's build steps (`BUILD`)
enum Build { kBuild0, kBuildLevel, kBuildGathered, kBuildRows };

// a distributed level of the block: its operator (level 0: the packed
// plane; above: c, e, n), the cycle's planes, its active flags and its
// west e / south n edges (level 0: none)
template <typename T>
struct BlockLvl {
  LvlT<T> L;
  T *c, *e, *n, *x, *b, *z, *rr, *d, *dn;
  const T *ew, *ns;
  uint8_t* act;

  unsigned cells_blocks() const {
    return eu_blocks(static_cast<long long>(L.Y) * L.X, kThreads);
  }
};

// what every solver starts with: its precision
struct BlocksHead {
  int f64;
};

template <typename T>
struct Blocks : BlocksHead {
  pcg::Ws w;
  int G, deg;
  BlockLvl<T> bl[17];  // levels 0 .. G of the block (G: c, e, n, act, b)
  T* packed0;
  T* bpart;            // the distributed levels' block partials
  Folds folds;
  SolveT<T> S;         // the gathered levels G .. L - 1 (whole planes)
  T* gc[16];           // their c, e, n planes and active flags
  T* ge[16];
  T* gn[16];
  uint8_t* gact[16];
  T* hpart;            // [the G maxima | the gathered levels' partials]
  RowsT<T> R;
  int r0, c0;          // the block's first row and column at level G

  static unsigned blocks(const LvlT<T>& L) {
    return eu_blocks(static_cast<long long>(L.Y) * L.X, kThreads);
  }

  int build(int step, int l, const uint8_t* below, const uint8_t* above,
            const uint8_t* left, const uint8_t* right,
            cudaStream_t st) const {
    const int* fl = w.flags;
    if (step == kBuild0 || step == kBuildLevel) {
      // level l's partials, and the block's cells of level l + 1
      const BlockLvl<T>& B = bl[l];
      const BlockLvl<T>& C = bl[l + 1];
      T* part = bpart + folds.off[l];
      const unsigned nc = C.cells_blocks();
      if (step == kBuild0) {
        const Ring0<T> R0{B.L, below, above, left, right};
        ring_lmax0<T><<<B.cells_blocks(), kThreads, 0, st>>>(R0, part, fl);
        block_coarsen<<<nc, kThreads, 0, st>>>(R0, C.L.Y, C.L.X, C.c, C.e,
                                               C.n, C.act, fl);
      } else {
        edge_lmax<T><<<B.cells_blocks(), kThreads, 0, st>>>(B.L, B.act, B.ew,
                                                            B.ns, part, fl);
        block_coarsen<<<nc, kThreads, 0, st>>>(FineAt<false, T>{B.L, B.act},
                                               C.L.Y, C.L.X, C.c, C.e, C.n,
                                               C.act, fl);
      }
      return eu_launch_status();
    }
    if (step == kBuildGathered) {
      // the gathered level G's partials, the levels below it (P3's
      // coarsen; at G = 0 P3's hierarchy from the packed level 0), and the
      // block's maxima of the distributed levels
      if (G == 0)
        fine_lmax<T><<<blocks(S.lv[0]), kThreads, 0, st>>>(S.lv[0], hpart,
                                                           fl);
      else
        edge_lmax<T><<<blocks(S.lv[G]), kThreads, 0, st>>>(
            S.lv[G], gact[G], nullptr, nullptr, hpart + R.off[G], fl);
      int rc = eu_launch_status();
      for (int k = G; !rc && k + 1 < S.L; ++k) {
        const LvlT<T>& Lc = S.lv[k + 1];
        if (k == 0)
          coarsen<true, T><<<blocks(Lc), kThreads, 0, st>>>(
              S.lv[0], Lc.Y, Lc.X, nullptr, gc[1], ge[1], gn[1], gact[1],
              hpart + R.off[1], fl);
        else
          coarsen<false, T><<<blocks(Lc), kThreads, 0, st>>>(
              S.lv[k], Lc.Y, Lc.X, gact[k], gc[k + 1], ge[k + 1], gn[k + 1],
              gact[k + 1], hpart + R.off[k + 1], fl);
        rc = eu_launch_status();
      }
      if (rc || G == 0) return rc;
      fold_max<T><<<1, 1024, 0, st>>>(folds, bpart, hpart, fl);
      return eu_launch_status();
    }
    if (step == kBuildRows) {
      cheby_rows<T><<<1, 1024, 0, st>>>(R, hpart, const_cast<T*>(S.rows),
                                        fl);
      return eu_launch_status();
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }

  // where a distributed level leaves its cycle output
  T* zout(int l) const { return deg != 1 ? bl[l].x : bl[l].z; }

  int level(int op, int l, int k, BlockEdges<T> h, cudaStream_t st) const {
    const int* fl = w.flags;
    if (op == kCoarse) {
      SolveT<T> C = S;
      C.s = st;
      int rc = C.cycle(G, false);
      if (rc || G > 0) return rc;
      // G = 0: the block's cells of the whole grid's correction into z
      const int X0 = S.lv[0].X;
      copy_window<T><<<eu_blocks(w.Y * w.X, kThreads), kThreads, 0, st>>>(
          w.Y, w.X, S.zout(0) + static_cast<long long>(r0) * X0 + c0, X0,
          static_cast<T*>(w.z), w.X, fl);
      return eu_launch_status();
    }
    const BlockLvl<T>& B = bl[l];
    const BlockLvl<T>& C = bl[l + 1];
    const LvlT<T>& L = B.L;
    const T* row = S.rows + l * S.ncoef;
    const unsigned nb = B.cells_blocks();
    h.ew = B.ew;
    h.ns = B.ns;
    switch (op) {
      case kPre1:
        b_pre1_restrict<T><<<C.cells_blocks(), kThreads, 0, st>>>(
            L, C.L.Y, C.L.X, B.b, B.x, C.b, row, h, fl);
        break;
      case kRestrict:
        b_restrict_full<T><<<C.cells_blocks(), kThreads, 0, st>>>(
            L, C.L.Y, C.L.X, B.b, B.x, C.b, h, fl);
        break;
      case kProlong:
        if (l + 1 < G) {
          prolong_add<T><<<nb, kThreads, 0, st>>>(L, C.L.X, zout(l + 1),
                                                  B.x, fl);
        } else {
          // the block's part of the gathered level's correction
          const int Xg = S.lv[G].X;
          prolong_add<T><<<nb, kThreads, 0, st>>>(
              L, Xg, S.zout(G) + static_cast<long long>(r0) * Xg + c0, B.x,
              fl);
        }
        break;
      case kPost1:
        b_post1<T><<<nb, kThreads, 0, st>>>(L, B.b, B.x, B.z, row, h, fl);
        break;
      case kChebyInit:
        b_cheby_init<T><<<nb, kThreads, 0, st>>>(L, B.b, B.x, B.rr, B.d, row,
                                                 k, h, fl);
        break;
      case kChebyStep:
        // step k reads d (k even) or dn and writes the other
        b_cheby_step<T><<<nb, kThreads, 0, st>>>(
            L, B.x, B.rr, k & 1 ? B.dn : B.d, k & 1 ? B.d : B.dn, row, k, h,
            fl);
        break;
      case kAxpy:
        axpy1<T><<<nb, kThreads, 0, st>>>(L.Y * L.X, B.x,
                                          (deg - 1) & 1 ? B.dn : B.d, fl);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return eu_launch_status();
  }

  // P1's loop (pcg_shard.cu's stages, apply_a's order); the MG steps
  // between them are the host's
  int stage(int k, int cap, double tol, double tol_rel, const void* a_diag,
            const void* fluid, const void* b, const void* x0,
            pcg::Halo<T> h, cudaStream_t st) const {
    constexpr int O = pcg::kGridOrder;
    const unsigned nb = pcg::grid_blocks(w.Y * w.X);
    const bool warm = x0 != nullptr;
    auto fin = [&](auto kernel) {
      kernel<<<1, 1, 0, st>>>(w, cap, tol, tol_rel, warm);
    };
    switch (k) {
      case 0:
        pcg::head_init<T, O><<<nb, pcg::kThreads, 0, st>>>(
            w, static_cast<const int32_t*>(a_diag),
            static_cast<const uint8_t*>(fluid), static_cast<const T*>(b),
            cap, tol, tol_rel, warm);
        break;
      case 1:
        fin(pcg::shard_finish<T, pcg::kFinInit>);
        if (warm)
          pcg::head_x0<T><<<nb, pcg::kThreads, 0, st>>>(
              w, static_cast<const T*>(x0));
        break;
      case 2:
        pcg::head_residual<T, O><<<nb, pcg::kThreads, 0, st>>>(w, h);
        break;
      case 3: {
        if (warm) fin(pcg::shard_finish<T, pcg::kFinResidual>);
        pack_code<T><<<eu_blocks(w.Y * w.X, kThreads), kThreads, 0, st>>>(
            w.Y, w.X, w.code, packed0, w.X, w.flags);
        break;
      }
      case 4:
        pcg::precon_dot<T, pcg::kMg, true, O>
            <<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      case 5:
        fin(pcg::shard_finish<T, pcg::kFinSigma0>);
        break;
      case 6:
        pcg::iter_ad<T, O><<<nb, pcg::kThreads, 0, st>>>(w, h);
        break;
      case 7:
        fin(pcg::shard_finish<T, pcg::kFinAlpha>);
        pcg::iter_update<T, O><<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      case 8:
        fin(pcg::shard_finish<T, pcg::kFinConv>);
        break;
      case 9:
        pcg::precon_dot<T, pcg::kMg, false, O>
            <<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      case 10:
        fin(pcg::shard_finish<T, pcg::kFinBeta>);
        pcg::iter_dir<T><<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return eu_launch_status();
  }
};

template <typename T>
int create(int Y, int X, int G, int L, const int* shapes,
           void* const* planes, void* const* act, void* const* edges, int r0,
           int c0, void* packed0, void* whole0, void* rows, int ncoef,
           int deg, int coarse_deg, int w, int w_depth, double ratio,
           double coarse_ratio, void* bpart, void* hpart, void* code, void* p,
           void* r, void* d, void* z, void* ad, void* pre, void* q,
           void* part, void* scal, void* flags, void* red, void** out) {
  Blocks<T>* B = new Blocks<T>{};
  B->f64 = sizeof(T) == sizeof(double);
  B->w = pcg::Ws{Y, X, Y, X, static_cast<uint8_t*>(code), p, r, d, z, ad,
                 pre, q, part, scal, static_cast<int*>(flags), red};
  B->G = G;
  B->deg = deg;
  B->r0 = r0;
  B->c0 = c0;
  B->packed0 = static_cast<T*>(packed0);
  B->bpart = static_cast<T*>(bpart);
  B->hpart = static_cast<T*>(hpart);
  B->folds.G = G;
  for (int l = 0; l <= G; ++l) {
    void* const* pl = planes + l * P_COUNT;
    BlockLvl<T>& V = B->bl[l];
    auto f = [&](int k) { return static_cast<T*>(pl[k]); };
    V.c = f(P_C);
    V.e = f(P_E);
    V.n = f(P_N);
    V.x = f(P_X);
    V.b = f(P_B);
    V.z = f(P_Z);
    V.rr = f(P_RR);
    V.d = f(P_D);
    V.dn = f(P_DN);
    V.L = LvlT<T>{shapes[2 * l], shapes[2 * l + 1], V.c, V.e, V.n,
                  l == 0 ? B->packed0 : nullptr};
    V.ew = static_cast<const T*>(edges[2 * l]);
    V.ns = static_cast<const T*>(edges[2 * l + 1]);
    V.act = static_cast<uint8_t*>(act[l]);
    if (l < G)
      B->folds.off[l + 1] =
          B->folds.off[l] + static_cast<int>(V.cells_blocks());
  }
  // the gathered levels: a Solve over the grid's levels, P3's from G down
  const int* gshapes = shapes + 2 * (G + 1);
  void* const* gplanes = planes + (G + 1) * P_COUNT;
  int rc = make_solve(&B->S, L, gshapes, gplanes, whole0,
                      G == 0 ? gplanes[P_B] : nullptr, rows, ncoef, deg,
                      coarse_deg, w, w_depth, part, flags, nullptr);
  if (!rc && B->S.fused < G) rc = static_cast<int>(cudaErrorInvalidValue);
  B->R = RowsT<T>{L, ncoef, deg, coarse_deg, static_cast<T>(ratio),
                  static_cast<T>(coarse_ratio), -1, {0}};
  for (int l = 0; l < L; ++l) {
    void* const* pl = gplanes + l * P_COUNT;
    B->gc[l] = static_cast<T*>(pl[P_C]);
    B->ge[l] = static_cast<T*>(pl[P_E]);
    B->gn[l] = static_cast<T*>(pl[P_N]);
    B->gact[l] = static_cast<uint8_t*>(act[G + 1 + l]);
    B->R.off[l + 1] = l < G ? l + 1
                            : B->R.off[l] + static_cast<int>(
                                                Blocks<T>::blocks(B->S.lv[l]));
  }
  if (!rc)
    rc = static_cast<int>(cudaMemset(flags, 0, sizeof(int) * pcg::F_N));
  if (!rc) rc = static_cast<int>(cudaDeviceSynchronize());
  if (rc) {
    delete B;
    return rc;
  }
  *out = static_cast<BlocksHead*>(B);
  return 0;
}

const BlocksHead* head(const void* solver) {
  return static_cast<const BlocksHead*>(solver);
}

template <typename T>
const Blocks<T>* as(const void* solver) {
  return static_cast<const Blocks<T>*>(head(solver));
}

template <typename T>
int stage(const Blocks<T>* B, int k, int cap, double tol, double tol_rel,
          const void* a_diag, const void* fluid, const void* b,
          const void* x0, const void* below, const void* above,
          const void* left, const void* right, cudaStream_t st) {
  const pcg::Halo<T> h{static_cast<const T*>(below),
                       static_cast<const T*>(above),
                       static_cast<const T*>(left),
                       static_cast<const T*>(right)};
  return B->stage(k, cap, tol, tol_rel, a_diag, fluid, b, x0, h, st);
}

template <typename T>
int build(const Blocks<T>* B, int step, int l, const void* below,
          const void* above, const void* left, const void* right,
          cudaStream_t st) {
  if ((step == kBuild0 || step == kBuildLevel) && (l < 0 || l >= B->G))
    return static_cast<int>(cudaErrorInvalidValue);
  return B->build(step, l, static_cast<const uint8_t*>(below),
                  static_cast<const uint8_t*>(above),
                  static_cast<const uint8_t*>(left),
                  static_cast<const uint8_t*>(right), st);
}

template <typename T>
int level(const Blocks<T>* B, int op, int l, int k, const void* below,
          const void* above, const void* left, const void* right,
          cudaStream_t st) {
  if (l < 0 || l > B->G || (op != kCoarse && l == B->G))
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockEdges<T> h{static_cast<const T*>(below),
                        static_cast<const T*>(above),
                        static_cast<const T*>(left),
                        static_cast<const T*>(right), nullptr, nullptr};
  return B->level(op, l, k, h, st);
}

}  // namespace

// A solver over a workspace's buffers, every plane, row, partial and edge
// of them f32, or f64 with f64 = 1.  The block's loop planes ([Y, X] p,
// r, d, z, ad, pre, q and u8 code; part: 1024; scal, flags: P1's; red: 1);
// G the gather level, L the grid's levels.  shapes: (Y, X) of the block's
// levels 0 .. G, then of the grid's L levels as stored
// (mg_kernel.padded_level_shapes).  planes: P_COUNT pointers (c, e, n, x,
// b, z, rr, d, dn) per block level 0 .. G (level 0: its x, b, z, rr, d,
// dn are loop planes; level G: c, e, n, b only), then per grid level
// (those below G null).  act: one u8 plane per block level, then per grid
// level (level 0's and those below G null).  edges: e_west [Yl], n_south
// [Xl] per block level 0 .. G (levels 0 and G null).  r0, c0: the block's
// first row and column at level G.  packed0: [Y, X]; whole0: at G = 0 the
// grid's packed level 0 at its stored shape, zero in its pad (null at G >
// 0; the grid level 0's x, b, z, rr, d, dn are planes of that shape, b
// zero in its pad); rows: [L, ncoef]; bpart: the block levels'
// ceil(Yl * Xl / 256) each, levels 0 .. G - 1; hpart: G, then the grid
// levels' ceil(Yl * Xl / 256) each from G; the ratios rounded to the
// planes' type.  *out is the handle.
EU_API int eu_pcg_mg_blocks_create(int Y, int X, int f64, int G, int L,
                                   const int* shapes, void* const* planes,
                                   void* const* act, void* const* edges,
                                   int r0, int c0, void* packed0,
                                   void* whole0, void* rows, int ncoef,
                                   int deg, int coarse_deg, int w,
                                   int w_depth, double ratio,
                                   double coarse_ratio, void* bpart,
                                   void* hpart, void* code, void* p, void* r,
                                   void* d, void* z, void* ad, void* pre,
                                   void* q, void* part, void* scal,
                                   void* flags, void* red, void** out) {
  *out = nullptr;
  if (G < 0 || G >= L || L > 16 || shapes[0] != Y || shapes[1] != X ||
      (G == 0) != (whole0 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return (f64 ? create<double> : create<float>)(
      Y, X, G, L, shapes, planes, act, edges, r0, c0, packed0, whole0, rows,
      ncoef, deg, coarse_deg, w, w_depth, ratio, coarse_ratio, bpart, hpart,
      code, p, r, d, z, ad, pre, q, part, scal, flags, red, out);
}

EU_API int eu_pcg_mg_blocks_destroy(void* solver) {
  BlocksHead* H = static_cast<BlocksHead*>(solver);
  if (H->f64)
    delete static_cast<Blocks<double>*>(H);
  else
    delete static_cast<Blocks<float>*>(H);
  return 0;
}

// Stage k of the loop (0 head_init, 1 finish + x0, 2 warm residual, 3
// [finish] + the packed level 0, 4 <z, r> head, 5 finish, 6 Ad, 7 finish
// + p, r, 8 finish, 9 <z, r>, 10 finish + d; the host all-reduces red[0]
// after 0, 2, 4, 6, 7, 9) with a_diag ([Y, X] i32), fluid ([Y, X] u8), b
// and x0 (null: a cold start) of the solver's type, and the exchanged
// edges of the plane the stage applies the operator to (2: p, 6: d; below
// / above [X], left / right [Y]).  The solution stays in the workspace's
// p, the iterations in flags[1], max|r| in scal[4].
EU_API int eu_pcg_mg_blocks_stage(void* solver, int k, int cap, double tol,
                                  double tol_rel, const void* a_diag,
                                  const void* fluid, const void* b,
                                  const void* x0, const void* below,
                                  const void* above, const void* left,
                                  const void* right, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64)
    return stage(as<double>(solver), k, cap, tol, tol_rel, a_diag, fluid, b,
                 x0, below, above, left, right, st);
  return stage(as<float>(solver), k, cap, tol, tol_rel, a_diag, fluid, b,
               x0, below, above, left, right, st);
}

// Build step `step` of the hierarchy (0: level 0's partials and the
// block's level 1, from the fluid ring below, above [X], left, right [Y]
// (u8); 1: level l's partials, its edges exchanged, and the block's level
// l + 1; 2: after the gather of level G, the gathered levels and the
// block's maxima of the distributed levels into hpart[0 .. G) (at G = 0,
// after the gather of the packed level 0, P3's hierarchy); 3: after
// their all-reduce, the Chebyshev rows).
EU_API int eu_pcg_mg_blocks_build(void* solver, int step, int l,
                                  const void* below, const void* above,
                                  const void* left, const void* right,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64)
    return build(as<double>(solver), step, l, below, above, left, right,
                 st);
  return build(as<float>(solver), step, l, below, above, left, right, st);
}

// Level operation `op` of the cycle on distributed level l (k: the
// Chebyshev init's from_zero, or the step's index), with the exchanged
// edges of the plane it applies the operator to (below / above [X_l],
// left / right [Y_l], of the solver's type; null where it applies none);
// kCoarse: P3's cycle from the gathered level G on its whole planes (at
// G = 0, then the block's cells of its output into the loop's z).
EU_API int eu_pcg_mg_blocks_level(void* solver, int op, int l, int k,
                                  const void* below, const void* above,
                                  const void* left, const void* right,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64)
    return level(as<double>(solver), op, l, k, below, above, left, right,
                 st);
  return level(as<float>(solver), op, l, k, below, above, left, right, st);
}

// The gathered cycle's plan: out[0] the level where coarse_cycle takes
// over (L: none), out[1] its dynamic shared memory in bytes, out[2] L,
// out[3] G.
EU_API int eu_pcg_mg_blocks_plan(const void* solver, int* out) {
  const BlocksHead* H = head(solver);
  const auto plan = [out](const auto* B) {
    out[0] = B->S.fused;
    out[1] = B->S.fused_smem;
    out[2] = B->S.L;
    out[3] = B->G;
  };
  if (H->f64)
    plan(as<double>(solver));
  else
    plan(as<float>(solver));
  return 0;
}
