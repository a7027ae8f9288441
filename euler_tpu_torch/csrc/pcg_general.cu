// P1 and P2: the general PCG loop, where no Pallas kernel's gate lets the
// JAX package solve (f64 solves, no preconditioner, IC(0), Jacobi beyond
// K8's and K12's gates), and the IC(0) preconditioner.
//
// P1 computes ops/project.py `pcg_loop` with `make_preconditioner` (the
// port of the JAX package's jnp `pcg_loop`, euler_tpu/ops/project.py:
// 110-178, which XLA compiles; no pallas_call): the all-zero early-out,
// the warm start x0, the tolerance max(tol, tol_rel ||b||_inf), the
// NaN-robust stop test not (max|r| > tol) after the p / r update, the cap.
// Templated on the precision (float, double) and the preconditioner:
// none (z = r on the fluid), the jnp-form Jacobi (z = r / a on fluid
// cells with a > 0, r on the other fluid cells; not K8's invd * r), or
// IC(0) through P2.
//
// P2 computes ops/ic0.py (euler_tpu/ops/ic0.py:35-76, main.c:580-627):
// the E_inv recurrence, then per application the forward and back
// solves.  Each couples a cell to its left and lower (back: right and
// upper) neighbour, so it walks the anti-diagonals x + y = d, Y + X - 1
// dependent steps, in ONE CTA with a __syncthreads() between steps; its
// planes live in shared memory when they fit (40 x 100 in f64 does), in
// global memory otherwise.  The guard e < 0.25 a -> (a != 0 ? a : 1) and
// the rebuild from zeros each solve are the JAX package's.
//
// The machinery is K8's (jacobi_pcg.cu): a workspace cached per grid,
// precision and preconditioner (ops/cuda/pcg_general_kernel.py) owns every
// buffer and a CUDA graph of kChunk iterations; the cap, the tolerance and
// the stop flag live on the device and every iteration kernel returns at
// once after the stop; a solve replays ceil(cap / kChunk) chunks in
// batches of kBatch, reading the stop flag only between batches.  An
// iteration is four launches (five with IC(0)): Ad = A d with <Ad, d> and
// alpha; the p and r updates with max|r| and the stop test; [P2's apply];
// z = M^-1 r with <z, r>, beta, the count and the stop; d = z + beta d.
// Each reduction is per-CTA partials whose last CTA (atomic ticket after
// a fence) folds them in a fixed order, so a solve is deterministic; the
// order is not the plain loop's, so the last bits of p may differ from
// it.  Built with -fmad=false, in the plain version's operand order.  The
// loop's kernels and their order are pcg_loop.cuh's, shared with P3
// (pcg_mg.cu, the loop with the MG cycle as its preconditioner).
#include "ic0.cuh"
#include "pcg_loop.cuh"

namespace {

using namespace pcg;

// ---- P2: IC(0) on anti-diagonals, one CTA (ic0.cuh) --------------------

using ic0::kIcSmem;
using ic0::kIcThreads;

template <typename T>
__global__ void __launch_bounds__(kIcThreads)
    ic0_build(int Y, int X, const uint8_t* code, T* pre_out, bool smem) {
  ic0::build_body(Y, X, code, pre_out, smem, ic0::Zeros<T>{});
}

template <typename T>
__global__ void __launch_bounds__(kIcThreads)
    ic0_apply(int Y, int X, const uint8_t* code, const T* pre, const T* r,
              T* z, T* q, bool smem, const int* done) {
  if (done != nullptr && *done) return;
  ic0::apply_body(Y, X, code, pre, r, z, q, smem, ic0::Zeros<T>{});
}

__global__ void __launch_bounds__(kThreads)
    make_code(int n, const int32_t* a_diag, const uint8_t* fluid,
              uint8_t* code) {
  GRID_STRIDE(i, n)
  code[i] = fluid[i] ? static_cast<uint8_t>(8 | a_diag[i]) : 0;
}

template <typename T>
int ic0_prepare() {  // let P2's kernels take up to kIcSmem
  int rc = static_cast<int>(cudaFuncSetAttribute(
      ic0_build<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kIcSmem)));
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        ic0_apply<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kIcSmem)));
  return rc;
}

template <typename T>
int launch_ic0_build(int Y, int X, const uint8_t* code, T* pre,
                     cudaStream_t st) {
  const size_t sm = ic0::smem_bytes<T>(Y, X, 1);
  ic0_build<T><<<1, kIcThreads, sm, st>>>(Y, X, code, pre, sm > 0);
  return eu_launch_status();
}

template <typename T>
int launch_ic0_apply(int Y, int X, const uint8_t* code, const T* pre,
                     const T* r, T* z, T* q, const int* done,
                     cudaStream_t st) {
  const size_t sm = ic0::smem_bytes<T>(Y, X, 3);
  ic0_apply<T><<<1, kIcThreads, sm, st>>>(Y, X, code, pre, r, z, q, sm > 0,
                                          done);
  return eu_launch_status();
}

// ---- the solver --------------------------------------------------------

struct Solver {
  Ws w;
  int f64, precon;
  cudaGraphExec_t exec;
  cudaEvent_t replayed;

  // P2 in an iteration: guarded by the stop flag
  template <typename T>
  int ic0_step(cudaStream_t st) const {
    return launch_ic0_apply<T>(w.Y, w.X, w.code, static_cast<const T*>(w.pre),
                               static_cast<const T*>(w.r),
                               static_cast<T*>(w.z), static_cast<T*>(w.q),
                               w.flags + F_DONE, st);
  }

  // P2 in the head: E_inv built anew, then applied
  template <typename T>
  int ic0_head(cudaStream_t st) const {
    const int rc = launch_ic0_build<T>(w.Y, w.X, w.code,
                                       static_cast<T*>(w.pre), st);
    if (rc) return rc;
    return launch_ic0_apply<T>(w.Y, w.X, w.code, static_cast<const T*>(w.pre),
                               static_cast<const T*>(w.r),
                               static_cast<T*>(w.z), static_cast<T*>(w.q),
                               nullptr, st);
  }

  template <typename T>
  int dispatch_iteration(cudaStream_t st) const {
    const auto ic0 = [this](cudaStream_t s) { return ic0_step<T>(s); };
    switch (precon) {
      case kNone: return enqueue_iteration<T, kNone>(w, ic0, st);
      case kJacobi: return enqueue_iteration<T, kJacobi>(w, ic0, st);
      default: return enqueue_iteration<T, kIc0>(w, ic0, st);
    }
  }

  int iteration(cudaStream_t st) const {
    return f64 ? dispatch_iteration<double>(st)
               : dispatch_iteration<float>(st);
  }

  template <typename T>
  int head(const void* a_diag, const void* fluid, const void* b,
           const void* x0, int cap, double tol, double tol_rel,
           cudaStream_t st) const {
    const int32_t* a = static_cast<const int32_t*>(a_diag);
    const uint8_t* f = static_cast<const uint8_t*>(fluid);
    const T* bb = static_cast<const T*>(b);
    const T* xx = static_cast<const T*>(x0);
    const auto ic0 = [this](cudaStream_t s) { return ic0_head<T>(s); };
    switch (precon) {
      case kNone:
        return enqueue_head<T, kNone>(w, a, f, bb, xx, cap, tol, tol_rel,
                                      ic0, st);
      case kJacobi:
        return enqueue_head<T, kJacobi>(w, a, f, bb, xx, cap, tol, tol_rel,
                                        ic0, st);
      default:
        return enqueue_head<T, kIc0>(w, a, f, bb, xx, cap, tol, tol_rel, ic0,
                                     st);
    }
  }
};

}  // namespace

// A solver over a workspace's buffers ([Y, X] planes of the solve's
// precision unless said: code u8, p, r, d, z, ad, pre, q; part: 1024;
// scal: S_N; flags: F_N i32), f64 0/1, precon 0 none / 1 Jacobi / 2
// IC(0).  Captures the graph of one chunk; *out is the handle.
EU_API int eu_pcg_create(int Y, int X, int f64, int precon, void* code,
                         void* p, void* r, void* d, void* z, void* ad,
                         void* pre, void* q, void* part, void* scal,
                         void* flags, void** out) {
  *out = nullptr;
  Solver* S = new Solver{};
  S->w = Ws{Y, X, Y, X, static_cast<uint8_t*>(code), p, r, d, z, ad, pre, q,
            part, scal, static_cast<int*>(flags)};
  S->f64 = f64;
  S->precon = precon;
  int rc = static_cast<int>(cudaMemset(flags, 0, sizeof(int) * F_N));
  if (!rc) rc = f64 ? ic0_prepare<double>() : ic0_prepare<float>();
  if (!rc) rc = static_cast<int>(cudaDeviceSynchronize());
  if (!rc)
    rc = static_cast<int>(
        cudaEventCreateWithFlags(&S->replayed, cudaEventDisableTiming));
  if (rc) {
    delete S;
    return rc;
  }
  rc = capture_graph(&S->exec, [&](cudaStream_t cs) {
    int rc_it = 0;
    for (int j = 0; !rc_it && j < kChunk; ++j) rc_it = S->iteration(cs);
    return rc_it;
  });
  if (rc) {
    cudaEventDestroy(S->replayed);
    delete S;
    return rc;
  }
  *out = S;
  return 0;
}

// Frees a solver once its last solve's replays have run.
EU_API int eu_pcg_destroy(void* solver) {
  Solver* S = static_cast<Solver*>(solver);
  int rc = static_cast<int>(cudaEventSynchronize(S->replayed));
  const int rc_graph = static_cast<int>(cudaGraphExecDestroy(S->exec));
  const int rc_event = static_cast<int>(cudaEventDestroy(S->replayed));
  delete S;
  if (!rc) rc = rc_graph;
  return rc ? rc : rc_event;
}

// P1: A p = b with a_diag ([Y, X] i32), fluid ([Y, X] u8), b and x0
// (null: a cold start) of the solver's precision; the solution stays in
// the workspace's p, the iterations in flags[1], max|r| in scal[4].
EU_API int eu_pcg_solve(void* solver, int cap, double tol, double tol_rel,
                        const void* a_diag, const void* fluid, const void* b,
                        const void* x0, void* stream) {
  const Solver* S = static_cast<const Solver*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = S->f64 ? S->head<double>(a_diag, fluid, b, x0, cap, tol,
                                          tol_rel, st)
                        : S->head<float>(a_diag, fluid, b, x0, cap, tol,
                                         tol_rel, st);
  if (rc) return rc;
  return replay(S->exec, S->replayed, S->w.flags, cap, kBatch, st);
}

// P2 alone: z = M^-1 r of IC(0) for a_diag ([Y, X] i32) and fluid ([Y, X]
// u8), E_inv built anew; code ([Y, X] u8), pre and q ([Y, X]) scratch.
EU_API int eu_ic0_apply(int Y, int X, int f64, const void* a_diag,
                        const void* fluid, const void* r, void* z,
                        void* code, void* pre, void* q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = f64 ? ic0_prepare<double>() : ic0_prepare<float>();
  if (rc) return rc;
  uint8_t* c = static_cast<uint8_t*>(code);
  make_code<<<grid_blocks(Y * X), kThreads, 0, st>>>(
      Y * X, static_cast<const int32_t*>(a_diag),
      static_cast<const uint8_t*>(fluid), c);
  if ((rc = eu_launch_status())) return rc;
  if (f64) {
    if ((rc = launch_ic0_build<double>(Y, X, c, static_cast<double*>(pre),
                                       st)))
      return rc;
    return launch_ic0_apply<double>(Y, X, c, static_cast<double*>(pre),
                                    static_cast<const double*>(r),
                                    static_cast<double*>(z),
                                    static_cast<double*>(q), nullptr, st);
  }
  if ((rc = launch_ic0_build<float>(Y, X, c, static_cast<float*>(pre), st)))
    return rc;
  return launch_ic0_apply<float>(Y, X, c, static_cast<float*>(pre),
                                 static_cast<const float*>(r),
                                 static_cast<float*>(z),
                                 static_cast<float*>(q), nullptr, st);
}
