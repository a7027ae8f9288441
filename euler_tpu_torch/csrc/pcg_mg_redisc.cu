// P7: the PCG loop with the rediscretized MG V-cycle as its preconditioner,
// where the JAX package's `solve_pressure` runs its jnp `pcg_loop` with
// mg_scheme="rediscretize" (every Pallas MG gate refuses it: mg_kernel.py:
// 748-756, mg_stream_kernel.py:503-504).  No pallas_call: the JAX package
// runs euler_tpu/ops/project.py:115 `pcg_loop` with multigrid.py:492
// `make_mg_preconditioner`, whose hierarchy is `build_hierarchy` (:64-80)
// and whose cycle is `v_cycle` (:166-184).
//
// The loop is P1's (pcg_loop.cuh, as P3 runs it: As = A s, the all-zero
// early-out, the warm start, the NaN-robust stop, the stop flag read after
// every chunk of kChunk iterations replayed from one CUDA graph).  Its
// preconditioner step is one V-cycle on a hierarchy built on the device
// each solve, one launch a level (`redisc_level0`, `redisc_coarsen`):
//   * level 0 takes the solve's fluid and solid masks; the level below
//     is fluid where any of its 2x2 children is, solid where all are
//     (beyond an odd side: solid) and it is not fluid; each level is
//     ceil(Y/2) x ceil(X/2) of the one above, stored unpadded, down to a
//     side of at most mg_min_size;
//   * each level's a_diag = 4 - #solid neighbours (beyond the plane: not
//     solid) on fluid, and inv_diag = 1 / a_diag (one correctly rounded
//     reciprocal) where a_diag > 0, else 0 (`_rediscretize`, :54-61).
// The cycle at level l: mg_pre_smooth red-black Gauss-Seidel sweeps from
// zero (`_smooth`, :96-123: a half-sweep of one colour updates x in place,
// a cell's stencil reading only the other colour), the residual fused with
// the cell-centred bilinear restriction (each coarse cell recomputes the
// 16 fine residuals of its window, weights 9/16, 3/16, 3/16, 1/16 in
// `_restrict`'s order, :150-163), the cycle below, the bilinear
// prolongation added under the fluid mask (`_prolong`, :126-147), then
// mg_post_smooth sweeps in reversed colour order; the coarsest level is
// one CTA's mg_coarse_iters forward and as many reversed sweeps.  The
// sweeps are mg_levels.cuh's RB-GS kernels and host loop (`rbgs_half`,
// `rbgs_coarse`, `rbgs_sweeps`) over this level type's `rbgs_at`.  Every
// product and sum is written out in the JAX package's operand order with
// the correctly rounded intrinsics (mg_levels.cuh's `mul_rn`, `add_rn`,
// ...), so the cycle is the plain `v_cycle`'s arithmetic cell for cell;
// the loop's reductions fold per-CTA partials in a fixed order, which is
// not the plain loop's.
//
// What bounds it on an H100: launches, then bytes.  An iteration is P1's 4
// loop launches and the V-cycle's 6 a level above the coarsest (2 pre, the
// restriction, the prolongation, 2 post) and 1 for the coarsest: at 1024²
// (six levels, 1024² to 32²) 4 + 31 = 35 launches, at 1080 x 1920 (seven,
// to 17 x 30) 4 + 37 = 41; the head adds one build launch a level.  A
// simple kernel a level operation; no cluster launch for the coarse end.
//
// Precision: float or double (`f64` at create), every plane in the
// solver's type, as the JAX package runs an f64 v_cycle.
#define EU_FMAD 0
#include "mg_levels.cuh"
#include "pcg_loop.cuh"

namespace {

// cell-centred bilinear weights (_W0 * _W0, _W0 * _W1, _W1 * _W0, _W1 *
// _W1 of multigrid.py), exact in either type
constexpr double kW00 = 0.5625, kW01 = 0.1875, kW10 = 0.1875, kW11 = 0.0625;

// one level of the rediscretized hierarchy, [Y, X]
template <typename T>
struct RLvl {
  int Y, X;
  uint8_t* fl;  // fluid
  uint8_t* so;  // solid
  int32_t* a;   // a_diag
  T* inv;       // inv_diag
};

// a_diag and inv_diag of cell t: fluid, with `ns` solid neighbours
template <typename T>
__device__ __forceinline__ void write_diag(const RLvl<T>& L, int t, bool f,
                                           int ns) {
  const int a = f ? 4 - ns : 0;
  L.a[t] = a;
  L.inv[t] = f && a > 0 ? rcp_rn(static_cast<T>(a)) : T(0);
}

__device__ __forceinline__ int solid_at(const uint8_t* so, int i, int j,
                                        int Y, int X) {
  return i >= 0 && i < Y && j >= 0 && j < X && so[i * X + j] ? 1 : 0;
}

// level 0: the solve's masks and their operator
template <typename T>
__global__ void redisc_level0(RLvl<T> L, const uint8_t* __restrict__ solid,
                              const uint8_t* __restrict__ fluid,
                              const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X) return;
  const int i = t / L.X, j = t - i * L.X;
  const bool f = fluid[t] != 0;
  L.fl[t] = f;
  L.so[t] = solid[t] != 0;
  const int ns = solid_at(solid, i, j - 1, L.Y, L.X) +
                 solid_at(solid, i, j + 1, L.Y, L.X) +
                 solid_at(solid, i - 1, j, L.Y, L.X) +
                 solid_at(solid, i + 1, j, L.Y, L.X);
  write_diag(L, t, f, ns);
}

// the masks of coarse cell (I, J) from the level F above: fluid if any
// child is fluid; solid if every child is solid (a child beyond F's
// plane counting as solid) and the cell is not fluid
template <typename T>
__device__ __forceinline__ void coarse_masks(const RLvl<T>& F, int I, int J,
                                             bool* fl, bool* so) {
  bool any_f = false, all_s = true;
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c;
      if (i < F.Y && j < F.X) {
        any_f = any_f || F.fl[i * F.X + j];
        all_s = all_s && F.so[i * F.X + j];
      }
    }
  *fl = any_f;
  *so = all_s && !any_f;
}

// the level C below F: its masks, and its operator from the masks of its
// own cells and of their neighbours (recomputed from F)
template <typename T>
__global__ void redisc_coarsen(RLvl<T> F, RLvl<T> C,
                               const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C.Y * C.X) return;
  const int I = t / C.X, J = t - I * C.X;
  bool f, s;
  coarse_masks(F, I, J, &f, &s);
  C.fl[t] = f;
  C.so[t] = s;
  const int di[4] = {0, 0, -1, 1}, dj[4] = {-1, 1, 0, 0};
  int ns = 0;
  for (int q = 0; q < 4; ++q) {
    const int In = I + di[q], Jn = J + dj[q];
    if (In < 0 || In >= C.Y || Jn < 0 || Jn >= C.X) continue;
    bool nf, nsd;
    coarse_masks(F, In, Jn, &nf, &nsd);
    ns += nsd;
  }
  write_diag(C, t, f, ns);
}

// A x at (i, j): a x - (((x_w + x_e) + x_s) + x_n) on fluid
// (multigrid._apply_a), 0 beyond the plane
template <typename T>
__device__ __forceinline__ T redisc_apply(const RLvl<T>& L, const T* x, int i,
                                          int j) {
  const int k = i * L.X + j;
  if (!L.fl[k]) return T(0);
  T nb = add_rn(ld(x, i, j - 1, L.Y, L.X), ld(x, i, j + 1, L.Y, L.X));
  nb = add_rn(nb, ld(x, i - 1, j, L.Y, L.X));
  nb = add_rn(nb, ld(x, i + 1, j, L.Y, L.X));
  return sub_rn(mul_rn(static_cast<T>(L.a[k]), x[k]), nb);
}

// the half-sweep of `color` (0: red, i + j even) at cell t: x += (b - A x)
// * inv_diag on that colour; `from_zero`: the first half-sweep from x = 0,
// which writes every cell (b * inv_diag on the colour, 0 elsewhere).  The
// rediscretized level's `rbgs_at`, which mg_levels.cuh's RB-GS kernels
// (`rbgs_half`, `rbgs_coarse`) call for an RLvl
template <typename T>
__device__ __forceinline__ void rbgs_at(const RLvl<T>& L, const T* b, T* x,
                                        int color, bool from_zero, int t) {
  const int i = t / L.X, j = t - i * L.X;
  const bool on = ((i + j) & 1) == color;
  if (from_zero) {
    x[t] = on ? mul_rn(b[t], L.inv[t]) : T(0);
  } else if (on) {
    const T r = sub_rn(b[t], redisc_apply(L, x, i, j));
    x[t] = add_rn(x[t], mul_rn(r, L.inv[t]));
  }
}

// the residual b - A x at (i, j) on fluid, 0 elsewhere and beyond the plane
template <typename T>
__device__ __forceinline__ T redisc_resid(const RLvl<T>& L, const T* b,
                                          const T* x, int i, int j) {
  if (i < 0 || i >= L.Y || j < 0 || j >= L.X) return T(0);
  const int k = i * L.X + j;
  return L.fl[k] ? sub_rn(b[k], redisc_apply(L, x, i, j)) : T(0);
}

// b_C = R (b - A x) at coarse cell t, on C's fluid (0 elsewhere): for each
// child parity (a, c) in order, its own residual and the three across the
// block edges on its side, weighted 9/16, 3/16 (x), 3/16 (y), 1/16
template <typename T>
__global__ void redisc_restrict(RLvl<T> L, RLvl<T> C,
                                const T* __restrict__ b,
                                const T* __restrict__ x, T* __restrict__ bc,
                                const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C.Y * C.X) return;
  const int I = t / C.X, J = t - I * C.X;
  T out = T(0);
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * I + a, j = 2 * J + c;
      const int oi = a == 0 ? i + 2 : i - 2, oj = c == 0 ? j + 2 : j - 2;
      out = add_rn(out, mul_rn(T(kW00), redisc_resid(L, b, x, i, j)));
      out = add_rn(out, mul_rn(T(kW01), redisc_resid(L, b, x, i, oj)));
      out = add_rn(out, mul_rn(T(kW10), redisc_resid(L, b, x, oi, j)));
      out = add_rn(out, mul_rn(T(kW11), redisc_resid(L, b, x, oi, oj)));
    }
  bc[t] = C.fl[t] ? out : T(0);
}

// x += P x_C on L's fluid: fine cell (2I + a, 2J + c) takes 9/16 of its
// parent and 3/16, 3/16, 1/16 of the parent's neighbours toward its side
template <typename T>
__global__ void redisc_prolong(RLvl<T> L, RLvl<T> C,
                               const T* __restrict__ xc, T* __restrict__ x,
                               const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L.Y * L.X || !L.fl[t]) return;
  const int i = t / L.X, j = t - i * L.X;
  const int I = i >> 1, J = j >> 1;
  const int di = (i & 1) ? 1 : -1, dj = (j & 1) ? 1 : -1;
  T up = mul_rn(T(kW00), xc[I * C.X + J]);
  up = add_rn(up, mul_rn(T(kW01), ld(xc, I, J + dj, C.Y, C.X)));
  up = add_rn(up, mul_rn(T(kW10), ld(xc, I + di, J, C.Y, C.X)));
  up = add_rn(up, mul_rn(T(kW11), ld(xc, I + di, J + dj, C.Y, C.X)));
  x[t] = add_rn(x[t], up);
}

// the hierarchy and the V-cycle over it
template <typename T>
struct Redisc {
  int L;
  RLvl<T> lv[16];
  T* x[16];  // level 0: the loop's z (the cycle's output)
  T* b[16];  // level 0: the loop's r
  int pre, post, coarse;
  const int* flags;

  unsigned blocks(int l) const {
    return eu_blocks(static_cast<long long>(lv[l].Y) * lv[l].X, kThreads);
  }

  // the hierarchy of (solid, fluid), one launch a level
  int build(const uint8_t* solid, const uint8_t* fluid,
            cudaStream_t st) const {
    redisc_level0<T><<<blocks(0), kThreads, 0, st>>>(lv[0], solid, fluid,
                                                     flags);
    int rc = eu_launch_status();
    for (int l = 1; !rc && l < L; ++l) {
      redisc_coarsen<T><<<blocks(l), kThreads, 0, st>>>(lv[l - 1], lv[l],
                                                        flags);
      rc = eu_launch_status();
    }
    return rc;
  }

  // n symmetric sweeps of level l, red first (black first with reverse),
  // from x = 0 with from_zero (a zero fill for n = 0)
  int sweeps(int l, int n, bool from_zero, bool reverse,
             cudaStream_t st) const {
    return rbgs_sweeps(x[l], static_cast<long long>(lv[l].Y) * lv[l].X, n,
                       from_zero, reverse, st, [&](int color, bool zero) {
                         rbgs_half<<<blocks(l), kThreads, 0, st>>>(
                             lv[l], b[l], x[l], color, zero, flags);
                       });
  }

  // x_l ~= A_l^{-1} b_l (v_cycle)
  int cycle(int l, cudaStream_t st) const {
    int rc;
    if (l == L - 1) {
      rbgs_coarse<<<1, kCoarseThreads, 0, st>>>(lv[l], b[l], x[l], coarse,
                                                flags);
      return eu_launch_status();
    }
    if ((rc = sweeps(l, pre, true, false, st))) return rc;
    redisc_restrict<T><<<blocks(l + 1), kThreads, 0, st>>>(
        lv[l], lv[l + 1], b[l], x[l], b[l + 1], flags);
    if ((rc = eu_launch_status())) return rc;
    if ((rc = cycle(l + 1, st))) return rc;
    redisc_prolong<T><<<blocks(l), kThreads, 0, st>>>(lv[l], lv[l + 1],
                                                      x[l + 1], x[l], flags);
    if ((rc = eu_launch_status())) return rc;
    return sweeps(l, post, false, true, st);
  }
};

// what every solver starts with: its precision
struct PcgRediscHead {
  int f64;
};

template <typename T>
struct PcgRedisc : PcgRediscHead {
  pcg::Ws w;
  Redisc<T> M;
  cudaGraphExec_t exec;
  cudaEvent_t replayed;
};

template <typename T>
int create(int Y, int X, int L, const int* shapes, void* const* fl,
           void* const* so, void* const* a, void* const* inv,
           void* const* x, void* const* b, int pre, int post, int coarse,
           void* code, void* p, void* r, void* d, void* z, void* ad,
           void* pre_plane, void* q, void* part, void* scal, void* flags,
           void** out) {
  PcgRedisc<T>* S = new PcgRedisc<T>{};
  S->f64 = sizeof(T) == sizeof(double);
  S->w = pcg::Ws{Y, X, Y, X, static_cast<uint8_t*>(code), p, r, d, z, ad,
                 pre_plane, q, part, scal, static_cast<int*>(flags)};
  Redisc<T>& M = S->M;
  M.L = L;
  M.pre = pre;
  M.post = post;
  M.coarse = coarse;
  M.flags = static_cast<const int*>(flags);
  for (int l = 0; l < L; ++l) {
    M.lv[l] = RLvl<T>{shapes[2 * l], shapes[2 * l + 1],
                      static_cast<uint8_t*>(fl[l]),
                      static_cast<uint8_t*>(so[l]),
                      static_cast<int32_t*>(a[l]), static_cast<T*>(inv[l])};
    M.x[l] = static_cast<T*>(l == 0 ? z : x[l]);
    M.b[l] = static_cast<T*>(l == 0 ? r : b[l]);
  }
  int rc = static_cast<int>(cudaMemset(flags, 0, sizeof(int) * pcg::F_N));
  if (!rc)
    rc = static_cast<int>(
        cudaEventCreateWithFlags(&S->replayed, cudaEventDisableTiming));
  if (rc) {
    delete S;
    return rc;
  }
  rc = capture_graph(&S->exec, [&](cudaStream_t cs) {
    const auto step = [S](cudaStream_t s) { return S->M.cycle(0, s); };
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
  *out = static_cast<PcgRediscHead*>(S);
  return 0;
}

template <typename T>
int destroy(PcgRedisc<T>* S) {
  int rc = static_cast<int>(cudaEventSynchronize(S->replayed));
  const int rc_graph = static_cast<int>(cudaGraphExecDestroy(S->exec));
  const int rc_event = static_cast<int>(cudaEventDestroy(S->replayed));
  delete S;
  if (!rc) rc = rc_graph;
  return rc ? rc : rc_event;
}

template <typename T>
int solve(const PcgRedisc<T>* S, int cap, double tol, double tol_rel,
          const void* a_diag, const void* fluid, const void* solid,
          const void* b, const void* x0, cudaStream_t st) {
  const auto* so = static_cast<const uint8_t*>(solid);
  const auto* fl = static_cast<const uint8_t*>(fluid);
  const auto step = [S, so, fl](cudaStream_t s) {
    const int rc = S->M.build(so, fl, s);
    return rc ? rc : S->M.cycle(0, s);
  };
  const int rc = pcg::enqueue_head<T, pcg::kMg>(
      S->w, static_cast<const int32_t*>(a_diag), fl,
      static_cast<const T*>(b), static_cast<const T*>(x0), cap, tol,
      tol_rel, step, st);
  if (rc) return rc;
  return pcg::replay(S->exec, S->replayed, S->w.flags, cap, 1, st);
}

template <typename T>
int cycle(const PcgRedisc<T>* S, const void* r_in, void* z_out,
          cudaStream_t st) {
  const size_t bytes = sizeof(T) * S->w.Y * S->w.X;
  int rc = static_cast<int>(
      cudaMemsetAsync(S->w.flags + pcg::F_DONE, 0, sizeof(int), st));
  if (!rc)
    rc = static_cast<int>(
        cudaMemcpyAsync(S->w.r, r_in, bytes, cudaMemcpyDeviceToDevice, st));
  if (!rc) rc = S->M.cycle(0, st);
  if (rc) return rc;
  return static_cast<int>(
      cudaMemcpyAsync(z_out, S->w.z, bytes, cudaMemcpyDeviceToDevice, st));
}

const PcgRediscHead* head(const void* solver) {
  return static_cast<const PcgRediscHead*>(solver);
}

template <typename T>
const PcgRedisc<T>* as(const void* solver) {
  return static_cast<const PcgRedisc<T>*>(head(solver));
}

}  // namespace

// A solver over a workspace's buffers: the loop's [Y, X] planes p, r, d,
// z, ad, pre, q (f32, or f64 with f64 = 1) and u8 code, part (1024 of the
// planes' type), scal and flags (P1's); the hierarchy's L levels: shapes
// (Y, X) per level, level 0 the planes' shape; per level the u8 fluid and
// solid planes, the i32 a_diag and the inv_diag plane (the build's
// outputs), and for levels >= 1 the cycle's x and b (level 0's: the loop's
// z and r; entries 0 of x and b unused).  pre, post, coarse: the sweeps.
// Captures the graph of one chunk; *out is the handle.
EU_API int eu_pcg_redisc_create(int Y, int X, int f64, int L,
                                const int* shapes, void* const* fl,
                                void* const* so, void* const* a,
                                void* const* inv, void* const* x,
                                void* const* b, int pre, int post,
                                int coarse, void* code, void* p, void* r,
                                void* d, void* z, void* ad, void* pre_plane,
                                void* q, void* part, void* scal, void* flags,
                                void** out) {
  *out = nullptr;
  if (L < 1 || L > 16 || shapes[0] != Y || shapes[1] != X || pre < 0 ||
      post < 0 || coarse < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return (f64 ? create<double> : create<float>)(
      Y, X, L, shapes, fl, so, a, inv, x, b, pre, post, coarse, code, p, r,
      d, z, ad, pre_plane, q, part, scal, flags, out);
}

// Frees a solver once its last solve's replays have run.
EU_API int eu_pcg_redisc_destroy(void* solver) {
  PcgRediscHead* H = static_cast<PcgRediscHead*>(solver);
  if (H->f64) return destroy(static_cast<PcgRedisc<double>*>(H));
  return destroy(static_cast<PcgRedisc<float>*>(H));
}

// P7: A p = b with a_diag ([Y, X] i32), fluid and solid ([Y, X] u8), b and
// x0 ([Y, X] in the solver's type; x0 null: a cold start); the solution
// stays in the workspace's p, the iterations in flags[1], max|r| in
// scal[4].
EU_API int eu_pcg_redisc_solve(void* solver, int cap, double tol,
                               double tol_rel, const void* a_diag,
                               const void* fluid, const void* solid,
                               const void* b, const void* x0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64)
    return solve(as<double>(solver), cap, tol, tol_rel, a_diag, fluid, solid,
                 b, x0, st);
  return solve(as<float>(solver), cap, tol, tol_rel, a_diag, fluid, solid, b,
               x0, st);
}

// One V-cycle on r_in ([Y, X] in the solver's type) over the hierarchy of
// the last solve; z is copied to z_out.  Clears the stop flag first; the
// workspace's r and z are overwritten.
EU_API int eu_pcg_redisc_cycle(void* solver, const void* r_in, void* z_out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head(solver)->f64) return cycle(as<double>(solver), r_in, z_out, st);
  return cycle(as<float>(solver), r_in, z_out, st);
}
