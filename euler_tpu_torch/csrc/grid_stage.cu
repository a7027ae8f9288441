// K2: the grid half of a substep for Hopper, around the K3 solve; and K7,
// the grid stage alone.
//
// K7 (`eu_grid_passes`) replaces the Pallas kernel
// euler_tpu/ops/pallas/grid_kernel.py `_grid_kernel` (launched by
// `grid_stage_pallas`, the unfused routes' grid stage): passes A and B
// below, nothing else.
//
// K2 replaces the Pallas kernel euler_tpu/ops/pallas/substep_kernel.py
// `_substep_kernel` (launched by `project_substep_mg`): its grid stage
// `_grid_stage_sweeps` (extrapolate -> zero_bounds -> advect -> gravity ->
// zero_bounds, main.c:865-889), the divergence RHS (main.c:713-724) and
// the packed PCG matrix, written straight into K3's workspace, and after
// the MG-PCG solve (mg_pcg.cu, on that workspace) the pressure clamp
// (main.c:773-779), the face velocity update (main.c:782-806) and the
// CFL maxsq (main.c:808-820).
//
// What bounds it on an H100: bytes.  Each pass is a stencil over a few
// [Y, X] planes (4 MB each at 1024²): the grid stage reads u, v, three
// u8 masks and writes two planes twice; the tail reads p, the masks and
// the velocities once.  Together a few tens of MB a substep.
//
// Design: one thread per cell — pass A (extrapolate + zero_bounds into
// zu/zv, materialised because pass B reads their 3x3 neighbourhood), pass
// B (advection + gravity + zero_bounds), the RHS (which also writes the
// packed matrix and copies the warm-start guess), and the tail (the clamp
// of the workspace's pressure into a fresh plane, then the face update
// reading the clamped neighbours, so it is split into two launches) with
// the maxsq by a two-stage reduction.
// The passes and the tail live in grid_stage.cuh, which jacobi_pcg.cu
// (K9, K10) shares.  Built with -fmad=false so the grid stage rounds as
// the plain PyTorch version does.
#include "grid_stage.cuh"

namespace {

// b = -div(u) * h^2 rho / dt_proj on fluid cells; the packed matrix;
// p = p0 when warm
__global__ void rhs_kernel(Masks m, const float* __restrict__ ut,
                           const float* __restrict__ vt,
                           const float* __restrict__ dtp_ptr, float inv_h,
                           float scale, const float* __restrict__ p0,
                           float* __restrict__ r, float* __restrict__ p,
                           float* __restrict__ packed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m.Y * m.X) return;
  const int y = t / m.X, x = t - y * m.X;
  const float k_inv_scale = scale / *dtp_ptr;
  const float div = (ut[t] - ld(ut, y, x - 1, m.Y, m.X) + vt[t] -
                     ld(vt, y - 1, x, m.Y, m.X)) * inv_h;
  r[t] = m.fl[t] ? -div * k_inv_scale : 0.0f;
  packed[t] = packed_at(m, t, y, x);
  if (p0) p[t] = p0[t];
}

}  // namespace

// K7: the grid stage of (u, v) into (ut, vt).  u, v: [Y, X] f32 in; fl,
// pfl, so: [Y, X] u8; zu, zv: [Y, X] scratch; dt: one f32 on the device.
EU_API int eu_grid_passes(int Y, int X, float inv_h, float g, const void* fl,
                          const void* pfl, const void* so, const void* u,
                          const void* v, const void* dt, void* zu, void* zv,
                          void* ut, void* vt, void* stream) {
  return grid_passes(make_masks(Y, X, fl, pfl, so), inv_h, g,
                     static_cast<const float*>(u),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dt), static_cast<float*>(zu),
                     static_cast<float*>(zv), static_cast<float*>(ut),
                     static_cast<float*>(vt), static_cast<cudaStream_t>(stream));
}

// Grid stage + RHS.  u, v: [Y, X] f32 in; fl, pfl, so: [Y, X] u8;
// zu, zv: [Y, X] scratch; ut, vt: [Y, X] out; r: [Y, X] RHS out; p0
// (nullable): warm-start guess copied into p; packed: [Y, X] out.  dt,
// dt_proj: one f32 each on the device.
EU_API int eu_grid_stage(int Y, int X, float inv_h, float g, float scale,
                         const void* fl, const void* pfl, const void* so,
                         const void* u, const void* v, const void* dt,
                         const void* dt_proj, const void* p0, void* zu,
                         void* zv, void* ut, void* vt, void* r, void* p,
                         void* packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Masks m = make_masks(Y, X, fl, pfl, so);
  const unsigned nb = eu_blocks(static_cast<long long>(Y) * X, kThreads);
  int rc = grid_passes(m, inv_h, g, static_cast<const float*>(u),
                       static_cast<const float*>(v),
                       static_cast<const float*>(dt), static_cast<float*>(zu),
                       static_cast<float*>(zv), static_cast<float*>(ut),
                       static_cast<float*>(vt), s);
  if (rc) return rc;
  rhs_kernel<<<nb, kThreads, 0, s>>>(m, static_cast<const float*>(ut),
                                     static_cast<const float*>(vt),
                                     static_cast<const float*>(dt_proj),
                                     inv_h, scale,
                                     static_cast<const float*>(p0),
                                     static_cast<float*>(r),
                                     static_cast<float*>(p),
                                     static_cast<float*>(packed));
  return eu_launch_status();
}

// Clamp p_in into p, then the face update over u/v (in place) and msq
// (one f32 on the device).  part: 2 * ceil(Y*X/256) floats.
EU_API int eu_project_tail(int Y, int X, float c, const void* fl,
                           const void* so, const void* dt, const void* p_in,
                           void* p, void* u, void* v, void* part, void* msq,
                           void* stream) {
  Masks m{Y, X, static_cast<const uint8_t*>(fl), nullptr,
          static_cast<const uint8_t*>(so)};
  float* uf = static_cast<float*>(u);
  float* vf = static_cast<float*>(v);
  return project_tail(m, c, static_cast<const float*>(dt),
                      static_cast<const float*>(p_in),
                      static_cast<float*>(p), uf, vf, uf, vf,
                      static_cast<float*>(part), static_cast<float*>(msq),
                      static_cast<cudaStream_t>(stream));
}
