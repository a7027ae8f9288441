// P6: the IC(0)-PCG solve of the whole grid, computed on blocks of it: the
// port of what GSPMD makes of euler_tpu/ops/project.py:115 `pcg_loop` with
// ops/ic0.py:35 `make_ic0_preconditioner` in the frame on ("y", "x")
// blocks, euler_tpu/parallel/spatial.py:113 `make_spatial_step` (no
// pallas_call): the whole grid's IC(0), rebuilt from zeros each solve.
//
// P6 computes P1 + P2's function (pcg_general.cu), each block holding its
// cells:
//   * the loop is P1's (pcg_loop.cuh) with SHARD = kGridOrder, driven from
//     the host one stage at a time as P5's (pcg_mg_blocks.cu): the
//     operator in apply_a's order with the neighbours' edges of d (of p,
//     warm) exchanged before each apply, every reduction's block fold
//     all-reduced over the blocks before the `shard_finish` that uses it.
//     One block's fold is P1's, so 1 x 1 blocks repeat P1 + P2 bit for bit.
//   * the preconditioner is P2's three sweeps (ic0.cuh) on the block, one
//     CTA each, with a `BlockEdges` loader: the build and the forward solve
//     at stage by + bx, the back solve at (ny - 1 - by) + (nx - 1 - bx),
//     of ny + nx - 1 stages.  Before each stage the host exchanges the
//     edges of the plane being swept, and the blocks of that stage read
//     their west and south neighbours' E_inv (kept from the build) and q,
//     or their east and north neighbours' z.  A cell's arithmetic is P2's
//     operand for operand, so the blocks' E_inv and z are P2's bit for bit.
// The host drives the stages, the sweeps and the exchanges
// (ops/cuda/pcg_ic0_blocks_kernel.py): no graph.  A sweep's planes live in
// shared memory when they fit (ic0::kIcSmem), as P2's.  Built with
// -fmad=false, in the plain version's operand order.
#include "ic0.cuh"
#include "pcg_loop.cuh"

namespace {

using ic0::kIcSmem;
using ic0::kIcThreads;

// the sweeps (the host's `BUILD`, `FORWARD`, `BACK`)
enum Sweep { kBuild, kForward, kBack };

template <typename T>
__global__ void __launch_bounds__(kIcThreads)
    b_build(int Y, int X, const uint8_t* code, T* pre, bool smem,
            ic0::BlockEdges<T> e, const int* done) {
  if (*done) return;
  ic0::build_body(Y, X, code, pre, smem, e);
}

// q of L q = r on the block (pre, q in shared memory with `smem`)
template <typename T>
__global__ void __launch_bounds__(kIcThreads)
    b_forward(int Y, int X, const uint8_t* code, const T* pre_g, const T* r,
              T* q_g, bool smem, ic0::BlockEdges<T> e, const int* done) {
  if (*done) return;
  extern __shared__ __align__(16) unsigned char eu_smem[];
  const int n = Y * X;
  T* pre = smem ? reinterpret_cast<T*>(eu_smem) : const_cast<T*>(pre_g);
  T* q = smem ? pre + n : q_g;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (smem) pre[i] = pre_g[i];
    q[i] = T(0);
  }
  __syncthreads();
  ic0::forward_sweep(Y, X, code, pre, r, q, e);
  if (smem)
    for (int i = threadIdx.x; i < n; i += blockDim.x) q_g[i] = q[i];
}

// z of L^T z = q on the block (pre, q, z in shared memory with `smem`)
template <typename T>
__global__ void __launch_bounds__(kIcThreads)
    b_back(int Y, int X, const uint8_t* code, const T* pre_g, const T* q_g,
           T* z_g, bool smem, ic0::BlockEdges<T> e, const int* done) {
  if (*done) return;
  extern __shared__ __align__(16) unsigned char eu_smem[];
  const int n = Y * X;
  T* pre = smem ? reinterpret_cast<T*>(eu_smem) : const_cast<T*>(pre_g);
  T* q = smem ? pre + n : const_cast<T*>(q_g);
  T* z = smem ? q + n : z_g;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (smem) {
      pre[i] = pre_g[i];
      q[i] = q_g[i];
    }
    z[i] = T(0);
  }
  __syncthreads();
  ic0::back_sweep(Y, X, code, pre, q, z, e);
  if (smem)
    for (int i = threadIdx.x; i < n; i += blockDim.x) z_g[i] = z[i];
}

template <typename T>
int prepare() {  // let the sweeps take up to kIcSmem
  int rc = static_cast<int>(cudaFuncSetAttribute(
      b_build<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kIcSmem)));
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        b_forward<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kIcSmem)));
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        b_back<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kIcSmem)));
  return rc;
}

struct Ic0Blocks {
  pcg::Ws w;
  int f64;

  template <typename T>
  int sweep(int kind, const ic0::BlockEdges<T>& e, cudaStream_t st) const {
    const int Y = w.Y, X = w.X;
    const int* done = w.flags + pcg::F_DONE;
    const T* pre = static_cast<const T*>(w.pre);
    switch (kind) {
      case kBuild: {
        const size_t sm = ic0::smem_bytes<T>(Y, X, 1);
        b_build<T><<<1, kIcThreads, sm, st>>>(
            Y, X, w.code, static_cast<T*>(w.pre), sm > 0, e, done);
        break;
      }
      case kForward: {
        const size_t sm = ic0::smem_bytes<T>(Y, X, 2);
        b_forward<T><<<1, kIcThreads, sm, st>>>(
            Y, X, w.code, pre, static_cast<const T*>(w.r),
            static_cast<T*>(w.q), sm > 0, e, done);
        break;
      }
      case kBack: {
        const size_t sm = ic0::smem_bytes<T>(Y, X, 3);
        b_back<T><<<1, kIcThreads, sm, st>>>(
            Y, X, w.code, pre, static_cast<const T*>(w.q),
            static_cast<T*>(w.z), sm > 0, e, done);
        break;
      }
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return eu_launch_status();
  }

  // P1's loop (pcg_mg_blocks.cu's stages, apply_a's order); the sweeps
  // between them are the host's
  template <typename T>
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
      case 3:
        if (warm) fin(pcg::shard_finish<T, pcg::kFinResidual>);
        break;
      case 4:
        pcg::precon_dot<T, pcg::kIc0, true, O>
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
        pcg::precon_dot<T, pcg::kIc0, false, O>
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

}  // namespace

// A solver over a workspace's buffers: the block's [Y, X] planes of the
// solve's precision (code u8, p, r, d, z, ad, pre, q; part: 1024; scal,
// flags: P1's; red: 1), f64 0/1.  *out is the handle.
EU_API int eu_pcg_ic0_blocks_create(int Y, int X, int f64, void* code,
                                    void* p, void* r, void* d, void* z,
                                    void* ad, void* pre, void* q, void* part,
                                    void* scal, void* flags, void* red,
                                    void** out) {
  *out = nullptr;
  Ic0Blocks* B = new Ic0Blocks{};
  B->w = pcg::Ws{Y, X, Y, X, static_cast<uint8_t*>(code), p, r, d, z, ad,
                 pre, q, part, scal, static_cast<int*>(flags), red};
  B->f64 = f64;
  int rc = f64 ? prepare<double>() : prepare<float>();
  if (!rc)
    rc = static_cast<int>(cudaMemset(flags, 0, sizeof(int) * pcg::F_N));
  if (!rc) rc = static_cast<int>(cudaDeviceSynchronize());
  if (rc) {
    delete B;
    return rc;
  }
  *out = B;
  return 0;
}

EU_API int eu_pcg_ic0_blocks_destroy(void* solver) {
  delete static_cast<Ic0Blocks*>(solver);
  return 0;
}

// Stage k of the loop (0 head_init, 1 finish + x0, 2 warm residual, 3
// [finish], 4 <z, r> head, 5 finish, 6 Ad, 7 finish + p, r, 8 finish, 9
// <z, r>, 10 finish + d; the host all-reduces red[0] after 0, 2, 4, 6, 7,
// 9, and sweeps IC(0) after 3 and after 8) with a_diag ([Y, X] i32), fluid
// ([Y, X] u8), b and x0 (null: a cold start) of the solver's precision,
// and the exchanged edges of the plane the stage applies the operator to
// (2: p, 6: d; below / above [X], left / right [Y] or null).  The
// solution stays in the workspace's p, the iterations in flags[1], max|r|
// in scal[4].
EU_API int eu_pcg_ic0_blocks_stage(void* solver, int k, int cap, double tol,
                                   double tol_rel, const void* a_diag,
                                   const void* fluid, const void* b,
                                   const void* x0, const void* below,
                                   const void* above, const void* left,
                                   const void* right, void* stream) {
  const Ic0Blocks* B = static_cast<const Ic0Blocks*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B->f64)
    return B->stage<double>(
        k, cap, tol, tol_rel, a_diag, fluid, b, x0,
        pcg::Halo<double>{static_cast<const double*>(below),
                          static_cast<const double*>(above),
                          static_cast<const double*>(left),
                          static_cast<const double*>(right)},
        st);
  return B->stage<float>(
      k, cap, tol, tol_rel, a_diag, fluid, b, x0,
      pcg::Halo<float>{static_cast<const float*>(below),
                       static_cast<const float*>(above),
                       static_cast<const float*>(left),
                       static_cast<const float*>(right)},
      st);
}

// Sweep `kind` of IC(0) on the block (0: E_inv into pre; 1: q from r; 2: z
// from q), with the neighbours' edges it reads: E_inv of the west column
// [Y] and the south row [X] (0, 1), q of them (1), z of the east column [Y]
// and the north row [X] (2); zeros at the grid's edges, null where the
// sweep reads none.  Each returns at once after the stop.
EU_API int eu_pcg_ic0_blocks_sweep(void* solver, int kind, const void* pw,
                                   const void* ps, const void* qw,
                                   const void* qs, const void* ze,
                                   const void* zn, void* stream) {
  const Ic0Blocks* B = static_cast<const Ic0Blocks*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B->f64)
    return B->sweep<double>(
        kind,
        ic0::BlockEdges<double>{
            static_cast<const double*>(pw), static_cast<const double*>(ps),
            static_cast<const double*>(qw), static_cast<const double*>(qs),
            static_cast<const double*>(ze), static_cast<const double*>(zn)},
        st);
  return B->sweep<float>(
      kind,
      ic0::BlockEdges<float>{
          static_cast<const float*>(pw), static_cast<const float*>(ps),
          static_cast<const float*>(qw), static_cast<const float*>(qs),
          static_cast<const float*>(ze), static_cast<const float*>(zn)},
      st);
}
