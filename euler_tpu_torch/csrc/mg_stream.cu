// K11: MG-PCG with the F-to-1 level skip for Hopper — the converged solve
// of grids whose MG hierarchy the resident Pallas kernel (K3) cannot hold.
//
// Replaces the Pallas kernel euler_tpu/ops/pallas/mg_stream_kernel.py
// `_stream_mg_kernel` (launched by `solve_pressure_mg_stream`).  Ported is
// what it computes: the preconditioner restricts the fine residual of a
// degree-1 Chebyshev pre-smooth straight to the first resident level
// (F = 2 at 2048², F = 4 at 4096²), runs the truncated-W cycle of the
// levels below it with that root in edge form, and post-smooths the fine
// level once with degree-1 Chebyshev.  Its TPU device (fine planes in HBM
// streamed through VMEM row windows) is not ported: every plane lives in
// device memory.  It starts cold and takes no guess, as the Pallas kernel.
//
// What bounds it on an H100: launches, then bytes.  Per PCG iteration the
// fine level costs four sweeps (the F-to-1 restriction, the fused
// prolongation + post-smooth, the s/As update, the p/r update) that move
// 17 fine planes, ~0.09 ms of HBM time each at 2048²; the resident cycle
// below is K3's (its coarse end one cluster launch a visit), ~8 fine
// plane equivalents more.
//
// Design: K3's (mg_solver.cuh) from the root down.  A workspace cached
// per configuration (ops/cuda/mg_kernel.py) owns every buffer, the
// Galerkin hierarchy from the fine level down and its Chebyshev rows are
// built on the device per solve (the levels between the fine one and
// the root only feed it), and a CUDA graph of kChunk = 8 iterations,
// captured once per workspace, is replayed with one read of the stop flag
// a chunk.  One thread per root cell for the restriction (the F x F sum
// of r - it0 A r over its children), one thread per fine cell for the
// post-smooth (x = it0 r + fl ec on the cell and its 4 neighbours, then
// z = x + it0 (r - A x) and the partials of <z, r>), and K3's level
// kernels, cycle schedule and PCG step kernels from mg_levels.cuh.  it0
// is the fine level's degree-1 1/theta, the row after the levels'.  Built
// with -fmad=false, so the shared level functions round every product on
// its own (EU_FMAD 0).
#define EU_FMAD 0
#include "mg_solver.cuh"

namespace {

// b_root = the F x F child sums of r - it0 A r: columns of children
// first, then across them (the Pallas kernel's row-then-lane order)
__global__ void restrict_f(Lvl L0, int F, const float* __restrict__ r,
                           float* __restrict__ bc,
                           const float* __restrict__ fine_row,
                           const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int Xc = L0.X / F, Yc = L0.Y / F;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Yc * Xc) return;
  const int I = t / Xc, J = t - I * Xc;
  const float it0 = fine_row[0];
  float acc = 0.0f;
  for (int c = 0; c < F; ++c) {
    const int j = F * J + c;
    float col = 0.0f;
    for (int a = 0; a < F; ++a) {
      const int i = F * I + a;
      col = col + (r[i * L0.X + j] - it0 * apply_at<true, true>(L0, r, i, j));
    }
    acc = acc + col;
  }
  bc[t] = acc;
}

// the prolonged pre-smooth x = it0 r + fl ec[i/F, j/F], zero outside the
// grid (F = 2^fs)
__device__ __forceinline__ float x_at(const Lvl& L0, int fs,
                                      const float* __restrict__ r,
                                      const float* __restrict__ ec, float it0,
                                      int i, int j) {
  if (i < 0 || i >= L0.Y || j < 0 || j >= L0.X) return 0.0f;
  const int k = i * L0.X + j;
  return it0 * r[k] +
         fluid0(L0, k) * ec[(i >> fs) * (L0.X >> fs) + (j >> fs)];
}

// z = x + it0 (r - A x) with x from x_at; partials of <z, r>
__global__ void post_f(Lvl L0, int fs, const float* __restrict__ r,
                       const float* __restrict__ ec, float* __restrict__ z,
                       const float* __restrict__ fine_row,
                       float* __restrict__ part,
                       const int* __restrict__ flags) {
  if (flags[F_DONE]) return;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (t < L0.Y * L0.X) {
    const int i = t / L0.X, j = t - i * L0.X;
    const float it0 = fine_row[0];
    const float pk = L0.pk[t];
    const float fl = pk >= 8.0f ? 1.0f : 0.0f;
    const float a = pk - 8.0f * fl;
    const float xc = x_at(L0, fs, r, ec, it0, i, j);
    float nb = x_at(L0, fs, r, ec, it0, i, j - 1) +
               x_at(L0, fs, r, ec, it0, i, j + 1);
    nb = nb + x_at(L0, fs, r, ec, it0, i + 1, j);
    nb = nb + x_at(L0, fs, r, ec, it0, i - 1, j);
    const float ax = fl * (a * xc - nb);
    const float rv = r[t];
    const float zz = xc + it0 * (rv - ax);
    z[t] = zz;
    acc = zz * rv;
  }
  acc = block_reduce<EU_SUM>(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

}  // namespace

// A K11 solver over one workspace.  HL levels of the hierarchy, of shapes
// (Y, X), the fine level first; the cycle's root is level ls, of shape
// (Y/F, X/F) with F = 2^ls.  planes: P_COUNT pointers per level (c, e, n, x, b, z, rr,
// d, dn): the coarse levels' c, e, n are the hierarchy's outputs, the
// other planes are those of the levels from the root down (the root's b
// is the restriction's target) and unused above it; act: one u8 plane
// per level (level 0's unused); packed0: the [Y, X] plane a_diag + 8 *
// fluid; rows: [HL + 1, ncoef], the levels' Chebyshev rows and then the
// fine level's [it0, 0, ...]; p, r, s, As, z: [Y, X]; part: ceil(Y*X/256)
// floats; hpart: the sum over levels of ceil(Yl*Xl/256) floats; scal:
// S_N floats; flags: F_N ints.  Captures one chunk of kChunk iterations
// into a graph; returns the solver in *out.
EU_API int eu_mg_stream_create(int HL, const int* shapes, int ls,
                               void* const* planes, void* const* act,
                               void* packed0, void* rows, int ncoef, int deg,
                               int coarse_deg, int w, int w_depth,
                               float ratio, float coarse_ratio,
                               int max_iters, float tol, float tol_rel,
                               void* p, void* r, void* s_, void* As, void* z,
                               void* part, void* hpart, void* scal,
                               void* flags, void** out) {
  *out = nullptr;
  const int F = 1 << ls;
  if (ls < 1 || ls >= HL || shapes[2 * ls] * F != shapes[0] ||
      shapes[2 * ls + 1] * F != shapes[1])
    return static_cast<int>(cudaErrorInvalidValue);
  MgSolver* M = new MgSolver{};
  const float* fine_row = static_cast<const float*>(rows) + HL * ncoef;
  int rc = make_solve(&M->S, HL - ls, shapes + 2 * ls, planes + ls * P_COUNT,
                      nullptr, nullptr, static_cast<float*>(rows) + ls * ncoef,
                      ncoef, deg, coarse_deg, w, w_depth, part, flags,
                      nullptr);
  if (!rc)
    rc = set_hierarchy(M, HL, shapes, planes, act, packed0, rows, ncoef, deg,
                       coarse_deg, ratio, coarse_ratio, HL, hpart);
  if (!rc) {
    M->P = PcgLoop{M->hl[0], static_cast<float*>(p), static_cast<float*>(r),
                   static_cast<float*>(s_), static_cast<float*>(As),
                   M->S.part, static_cast<float*>(scal),
                   static_cast<int*>(flags), max_iters, nullptr};
    M->tol = tol;
    M->tol_rel = tol_rel;
    float* zp = static_cast<float*>(z);
    // an iteration: restrict to the root, the cycle from it, the
    // prolongation and post-smooth with <z, r>, then the PCG step
    rc = capture_chunk(M, [=](Solve& S, const PcgLoop& P) {
      restrict_f<<<S.blocks(0), kThreads, 0, P.st>>>(P.L0, F, P.r, S.b[0],
                                                      fine_row, P.flags);
      int rc_it = eu_launch_status();
      if (!rc_it) rc_it = S.cycle(0, false);
      if (rc_it) return rc_it;
      post_f<<<P.blocks(), kThreads, 0, P.st>>>(P.L0, ls, P.r, S.zout(0), zp,
                                                fine_row, P.part, P.flags);
      if ((rc_it = eu_launch_status())) return rc_it;
      return P.step(zp);
    });
  }
  if (rc) {
    delete M;
    return rc;
  }
  *out = M;
  return 0;
}

// One MG-PCG solve of A p = b from p = 0 on the workspace, with a_diag
// ([Y, X] i32), fl ([Y, X] u8) and b ([Y, X] f32): packed0 and r = b
// loaded, the hierarchy and the rows built, then the chunk graph replayed
// until the stop flag is set.  The iteration count and the final max|r|
// stay on the device (flags[F_ITERS], scal[S_RESID]); p ends as the
// solution.
EU_API int eu_mg_stream_solve(void* solver, const void* a_diag,
                              const void* fl, const void* b, void* stream) {
  const MgSolver* M = static_cast<const MgSolver*>(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PcgLoop P = M->P;
  P.st = st;
  pack_kernel<<<P.blocks(), kThreads, 0, st>>>(
      P.n(), static_cast<const int32_t*>(a_diag),
      static_cast<const uint8_t*>(fl), M->packed0);
  int rc = eu_launch_status();
  if (rc) return rc;
  if ((rc = static_cast<int>(cudaMemcpyAsync(P.r, b, sizeof(float) * P.n(),
                                             cudaMemcpyDeviceToDevice, st))))
    return rc;
  if ((rc = P.init(true, M->tol, M->tol_rel))) return rc;
  if ((rc = M->hierarchy(st))) return rc;
  return M->iterate(st);
}
