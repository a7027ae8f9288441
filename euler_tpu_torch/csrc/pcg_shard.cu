// P4: the PCG loop on one block of a grid split over ranks, the port of
// euler_tpu/parallel/halo.py `_pcg_sharded` (ops/project.py `pcg_loop`
// under shard_map with psum / pmax reductions and a halo-exchanging
// operator; no pallas_call).
//
// It is P1's loop (pcg_loop.cuh, its kernels with SHARD = true), driven
// from the host one stage at a time, because a collective sits between
// each reduction and its use:
//   * the operator reads the edge rows (and columns, on 2D blocks) of the
//     neighbour blocks from buffers the host exchanges before each apply,
//     and adds them in halo.py:84's order: a s - (((l + r) + u) + d);
//   * each reduction's block fold goes to red[0]; the host all-reduces it
//     over the blocks (sum for sigma and <Ad, d>, NaN-propagating max for
//     max|b| and max|r|), and the stage after it starts with a one-thread
//     `shard_finish` that does what P1's last CTA does with its fold (the
//     fin_* functions of pcg_loop.cuh).  The tolerance, the all-zero
//     early-out, the count and the stop flag are thus the same on every
//     block, so all blocks stop on the same iteration and enqueue the same
//     collectives; every kernel returns at once after the stop.
//   * the MG preconditioner ("mg", f32 or f64) is P3's cycle
//     (mg_levels.cuh) on the block's own hierarchy, built on the card from
//     the block's operator (block-Jacobi additive Schwarz, halo.py:113-134):
//     no communication.  Where the block has an odd side (135 rows of 1080
//     x 1920 on 8 blocks), its level 0 is stored padded, as the JAX
//     hierarchy pads it, on planes of its own: the packed operator and
//     r go into their top left (the pad stays 0, inactive), the cycle
//     runs there and its output is cropped into the loop's z, as JAX
//     `cycle_galerkin` zero-pads b and crops x (multigrid.py:430-489);
//     the loop and the halo operator stay on the block's own planes.
// Stages, and the all-reduce the host runs after each (ops/cuda/
// pcg_shard_kernel.py `HEAD` .. `ITERATION`):
//   0 head_init (max|b|: max)             1 finish; x0
//   2 warm: r = b - A x0 (max|r|: max)     3 [finish] [MG head] <z, r> (sum)
//   4 finish: sigma
//   5 Ad = A d, <Ad, d> (sum)             6 alpha; p, r (max|r|: max)
//   7 conv; [MG cycle]; <z, r> (sum)      8 beta, count, stop; d
// Built with -fmad=false, in the plain version's operand order.
//
// Precision.  A solver is float or double (`f64` at create): the loop is
// pcg_loop.cuh's at T and the block MG the T instantiations of
// mg_solver.cuh and mg_levels.cuh, as P3's (pcg_mg.cu), so an f64 block
// MG builds its hierarchy and Chebyshev rows in double and its coarse
// cycle starts where the levels below fit a CTA's shared memory in double.
#define EU_FMAD 0
#include "mg_solver.cuh"
#include "pcg_loop.cuh"

namespace {

// what every solver starts with: its precision and preconditioner
struct ShardHead {
  int f64, precon;
};

template <typename T>
struct Shard : ShardHead {
  pcg::Ws w;
  MgSolverT<T> M;  // "mg": the block's hierarchy and cycle
  bool pad;        // its level 0 stored padded, on planes of its own

  unsigned cells() const { return eu_blocks(w.Y * w.X, kThreads); }

  int cycle(cudaStream_t st) const {
    SolveT<T> S = M.S;
    S.s = st;
    const int X0 = S.lv[0].X;
    if (pad) {
      copy_window<T><<<cells(), kThreads, 0, st>>>(
          w.Y, w.X, static_cast<const T*>(w.r), w.X, S.b[0], X0, w.flags);
      const int rc = eu_launch_status();
      if (rc) return rc;
    }
    int rc = S.cycle(0, false);
    if (rc || !pad) return rc;
    copy_window<T><<<cells(), kThreads, 0, st>>>(
        w.Y, w.X, S.zout(0), X0, static_cast<T*>(w.z), w.X, w.flags);
    return eu_launch_status();
  }

  int mg_head(cudaStream_t st) const {
    pack_code<T><<<cells(), kThreads, 0, st>>>(w.Y, w.X, w.code, M.packed0,
                                               M.S.lv[0].X, w.flags);
    int rc = eu_launch_status();
    if (!rc) rc = M.hierarchy(st);
    return rc ? rc : cycle(st);
  }

  template <int PK>
  int stage(int k, int cap, double tol, double tol_rel, const void* a_diag,
            const void* fluid, const void* b, const void* x0, pcg::Halo<T> h,
            cudaStream_t st) const {
    const unsigned nb = pcg::grid_blocks(w.Y * w.X);
    const bool warm = x0 != nullptr;
    auto fin = [&](auto kernel) {
      kernel<<<1, 1, 0, st>>>(w, cap, tol, tol_rel, warm);
    };
    int rc = 0;
    switch (k) {
      case 0:
        pcg::head_init<T, pcg::kHaloOrder><<<nb, pcg::kThreads, 0, st>>>(
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
        pcg::head_residual<T, pcg::kHaloOrder>
            <<<nb, pcg::kThreads, 0, st>>>(w, h);
        break;
      case 3:
        if (warm) fin(pcg::shard_finish<T, pcg::kFinResidual>);
        if (PK == pcg::kMg &&
            ((rc = eu_launch_status()) || (rc = mg_head(st))))
          return rc;
        pcg::precon_dot<T, PK, true, pcg::kHaloOrder>
            <<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      case 4:
        fin(pcg::shard_finish<T, pcg::kFinSigma0>);
        break;
      case 5:
        pcg::iter_ad<T, pcg::kHaloOrder><<<nb, pcg::kThreads, 0, st>>>(w, h);
        break;
      case 6:
        fin(pcg::shard_finish<T, pcg::kFinAlpha>);
        pcg::iter_update<T, pcg::kHaloOrder><<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      case 7:
        fin(pcg::shard_finish<T, pcg::kFinConv>);
        if (PK == pcg::kMg &&
            ((rc = eu_launch_status()) || (rc = cycle(st))))
          return rc;
        pcg::precon_dot<T, PK, false, pcg::kHaloOrder>
            <<<nb, pcg::kThreads, 0, st>>>(w);
        break;
      case 8:
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
int create(int Y, int X, int precon, int L, const int* shapes,
           void* const* planes, void* const* act, void* packed0, void* rows,
           int ncoef, int deg, int coarse_deg, int w, int w_depth,
           double ratio, double coarse_ratio, void* code, void* p, void* r,
           void* d, void* z, void* ad, void* pre, void* q, void* part,
           void* hpart, void* scal, void* flags, void* red, void** out) {
  Shard<T>* S = new Shard<T>{};
  S->w = pcg::Ws{Y, X, Y, X, static_cast<uint8_t*>(code), p, r, d, z, ad,
                 pre, q, part, scal, static_cast<int*>(flags), red};
  S->f64 = sizeof(T) == sizeof(double);
  S->precon = precon;
  int rc = 0;
  if (precon == pcg::kMg) {
    void* pl[16 * P_COUNT];
    for (int k = 0; k < L * P_COUNT; ++k) pl[k] = planes[k];
    S->pad = shapes[0] != Y || shapes[1] != X;
    if (!S->pad) {
      // level 0 of the cycle is the loop's: b = r, its output in z (as P3)
      const bool post1 = deg == 1 && L > 1;
      pl[P_X] = post1 ? pre : z;
      pl[P_Z] = post1 ? z : nullptr;
      pl[P_RR] = post1 ? q : pre;
      pl[P_D] = post1 ? ad : q;
      pl[P_DN] = post1 ? nullptr : ad;
    }
    rc = make_solve(&S->M.S, L, shapes, pl, packed0,
                    S->pad ? pl[P_B] : r, rows, ncoef, deg, coarse_deg, w,
                    w_depth, part, flags, nullptr);
    if (!rc)
      rc = set_hierarchy(&S->M, L, shapes, pl, act, packed0, rows, ncoef,
                         deg, coarse_deg, ratio, coarse_ratio, -1, hpart);
  }
  if (!rc)
    rc = static_cast<int>(cudaMemset(flags, 0, sizeof(int) * pcg::F_N));
  if (!rc) rc = static_cast<int>(cudaDeviceSynchronize());
  if (rc) {
    delete S;
    return rc;
  }
  *out = static_cast<ShardHead*>(S);
  return 0;
}

template <typename T>
int stage(const Shard<T>* S, int k, int cap, double tol, double tol_rel,
          const void* a_diag, const void* fluid, const void* b,
          const void* x0, const void* below, const void* above,
          const void* left, const void* right, cudaStream_t st) {
  const pcg::Halo<T> h{static_cast<const T*>(below),
                       static_cast<const T*>(above),
                       static_cast<const T*>(left),
                       static_cast<const T*>(right)};
  switch (S->precon) {
    case pcg::kJacobi:
      return S->template stage<pcg::kJacobi>(k, cap, tol, tol_rel, a_diag,
                                             fluid, b, x0, h, st);
    case pcg::kMg:
      return S->template stage<pcg::kMg>(k, cap, tol, tol_rel, a_diag,
                                         fluid, b, x0, h, st);
    default:
      return S->template stage<pcg::kNone>(k, cap, tol, tol_rel, a_diag,
                                           fluid, b, x0, h, st);
  }
}

const ShardHead* head(const void* solver) {
  return static_cast<const ShardHead*>(solver);
}

template <typename T>
const Shard<T>* as(const void* solver) {
  return static_cast<const Shard<T>*>(head(solver));
}

}  // namespace

// A solver over a workspace's buffers ([Y, X] planes of the solve's
// precision: code u8, p, r, d, z, ad, pre, q; part: 1024; scal: S_N;
// flags: F_N i32; red: 1), f64 0/1, precon 0 none / 1 Jacobi / 3 MG.
// MG (L > 0): the cycle's levels as eu_pcg_mg_create takes them, every
// plane, row and partial in the solve's precision, the ratios rounded to
// it; level 0 the planes' shape, its planes the loop's, or, stored padded
// (larger than the planes: an odd side), its own x, b, z, rr, d, dn
// planes, b and packed0 zero in the pad; L = 0 otherwise, and the MG
// arguments unused.  *out is the handle.
EU_API int eu_pcg_shard_create(int Y, int X, int f64, int precon, int L,
                               const int* shapes, void* const* planes,
                               void* const* act, void* packed0, void* rows,
                               int ncoef, int deg, int coarse_deg, int w,
                               int w_depth, double ratio,
                               double coarse_ratio, void* code, void* p,
                               void* r, void* d, void* z, void* ad,
                               void* pre, void* q, void* part, void* hpart,
                               void* scal, void* flags, void* red,
                               void** out) {
  *out = nullptr;
  const bool mg = precon == pcg::kMg;
  if ((mg && (L < 1 || L > 16 || shapes[0] < Y || shapes[1] < X)) ||
      (!mg && precon != pcg::kNone && precon != pcg::kJacobi))
    return static_cast<int>(cudaErrorInvalidValue);
  return (f64 ? create<double> : create<float>)(
      Y, X, precon, L, shapes, planes, act, packed0, rows, ncoef, deg,
      coarse_deg, w, w_depth, ratio, coarse_ratio, code, p, r, d, z, ad, pre,
      q, part, hpart, scal, flags, red, out);
}

EU_API int eu_pcg_shard_destroy(void* solver) {
  ShardHead* H = static_cast<ShardHead*>(solver);
  if (H->f64)
    delete static_cast<Shard<double>*>(H);
  else
    delete static_cast<Shard<float>*>(H);
  return 0;
}

// Stage k of a solve (see the top of this file) with a_diag ([Y, X] i32),
// fluid ([Y, X] u8), b and x0 (null: a cold start) of the solver's
// precision, and the exchanged edges of the plane the stage applies the
// operator to (stages 2: p, 5: d; below / above [X], left / right [Y] or
// null).  The solution stays in the workspace's p, the iterations in
// flags[1], max|r| in scal[4].
EU_API int eu_pcg_shard_stage(void* solver, int k, int cap, double tol,
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

// The block MG cycle's plan: out[0] the level where coarse_cycle takes
// over (L: none), out[1] its dynamic shared memory in bytes, out[2] L (0
// without MG).
EU_API int eu_pcg_shard_plan(const void* solver, int* out) {
  const ShardHead* H = head(solver);
  const auto plan = [out](const auto* S) {
    out[0] = S->M.S.fused;
    out[1] = S->M.S.fused_smem;
    out[2] = S->M.S.L;
  };
  out[0] = out[1] = out[2] = 0;
  if (H->precon != pcg::kMg) return 0;
  if (H->f64)
    plan(as<double>(solver));
  else
    plan(as<float>(solver));
  return 0;
}
