// K2: the grid half of a substep for Hopper, around the K3 solve; and K7,
// the grid stage alone.
//
// K7 (`eu_grid_passes`) replaces the Pallas kernel
// euler_tpu/ops/pallas/grid_kernel.py `_grid_kernel` (launched by
// `grid_stage_pallas`, the unfused routes' grid stage): `grid_passes`
// of grid_stage.cuh, one tiled launch, nothing else.
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
// [Y, X] planes (4 MB each at 1024²): the grid stage reads u, v and three
// u8 masks and writes ut and vt; the RHS reads them back; the tail reads
// p, the masks and the velocities once.  Together a few tens of MB a
// substep.
//
// Design: the grid stage is K7's tiled launch (`grid_passes`, the
// extrapolated velocities kept in shared memory); then one thread per
// cell: the RHS (which also writes the packed matrix and copies the
// warm-start guess), and the tail (the clamp of the workspace's pressure
// into a fresh plane, then the face update reading the clamped
// neighbours, so it is split into two launches) with the maxsq by a
// two-stage reduction.  The grid stage and the tail live in
// grid_stage.cuh, which jacobi_pcg.cu (K9, K10) shares.  Built with
// -fmad=false so the grid stage rounds as the plain PyTorch version does.
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

// K7: the grid stage of (u, v) into (ut, vt), on tiles of ty x tx cells
// and `threads` threads a CTA.  u, v: [Y, X] f32 in; fl, pfl, so: [Y, X]
// u8; dt: one f32 on the device; uu, vv: null, or [Y, X] f32 out, the
// extrapolated, zeroed velocities (the rainbow form).  clamp_ny, row_offset,
// clamp_nx, col_offset: Y, 0, X, 0 on a whole plane; on a block padded
// with its neighbours' rows and columns, the grid's row and column counts
// and the grid row and column of the block's cell (0, 0).
EU_API int eu_grid_passes(int Y, int X, int clamp_ny, int row_offset,
                          int clamp_nx, int col_offset, float inv_h,
                          float g, const void* fl,
                          const void* pfl, const void* so, const void* u,
                          const void* v, const void* dt, void* ut, void* vt,
                          void* uu, void* vv, int ty, int tx, int threads,
                          void* stream) {
  Masks m = make_masks(Y, X, fl, pfl, so);
  m.gY = clamp_ny;
  m.off = row_offset;
  m.gX = clamp_nx;
  m.offx = col_offset;
  return grid_passes(m, GridTile{ty, tx, threads},
                     inv_h, g, static_cast<const float*>(u),
                     static_cast<const float*>(v),
                     static_cast<const float*>(dt), static_cast<float*>(ut),
                     static_cast<float*>(vt), static_cast<float*>(uu),
                     static_cast<float*>(vv),
                     static_cast<cudaStream_t>(stream));
}

// Grid stage (K7's, on tiles of ty x tx cells and `threads` threads) +
// RHS.  u, v: [Y, X] f32 in; fl, pfl, so: [Y, X] u8; ut, vt: [Y, X] out;
// r: [Y, X] RHS out; p0 (nullable): warm-start guess copied into p;
// packed: [Y, X] out.  dt, dt_proj: one f32 each on the device.
EU_API int eu_grid_stage(int Y, int X, float inv_h, float g, float scale,
                         const void* fl, const void* pfl, const void* so,
                         const void* u, const void* v, const void* dt,
                         const void* dt_proj, const void* p0, void* ut,
                         void* vt, void* r, void* p, void* packed, int ty,
                         int tx, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Masks m = make_masks(Y, X, fl, pfl, so);
  const unsigned nb = eu_blocks(static_cast<long long>(Y) * X, kThreads);
  int rc = grid_passes(m, GridTile{ty, tx, threads}, inv_h, g,
                       static_cast<const float*>(u),
                       static_cast<const float*>(v),
                       static_cast<const float*>(dt), static_cast<float*>(ut),
                       static_cast<float*>(vt), nullptr, nullptr, s);
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
