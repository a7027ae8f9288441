// The grid stage and the projection tail of a substep, shared by K2
// (grid_stage.cu, around the MG-PCG solve) and K9/K10 (jacobi_pcg.cu,
// around the Jacobi-PCG solve).
//
// Pass A (extrapolate -> zero_bounds, main.c:865-870) and pass B
// (advection + gravity + zero_bounds, main.c:871-889; both launched by
// grid_passes, which is all of K7) are the grid stage
// `_grid_stage_sweeps` of euler_tpu/ops/pallas/substep_kernel.py; the
// clamp (main.c:773-779), the face update (main.c:782-806) and the CFL
// maxsq (main.c:808-820) are the tail both Pallas projection kernels end
// with.  One thread per cell; include from a file built with -fmad=false
// so the passes round as the plain PyTorch versions do.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Masks {
  int Y, X;
  const uint8_t* __restrict__ fl;   // fluid
  const uint8_t* __restrict__ pfl;  // fluid at the previous substep
  const uint8_t* __restrict__ so;   // solid

  __device__ bool at(const uint8_t* m, int i, int j) const {
    return ld(m, i, j, Y, X) != 0;
  }
  // u/v properties inside the logical sample regions (u: x < X-1,
  // v: y < Y-1), false outside the grid
  __device__ bool uprop(const uint8_t* m, int i, int j) const {
    return i >= 0 && i < Y && j >= 0 && j < X - 1 &&
           (at(m, i, j) || at(m, i, j + 1));
  }
  __device__ bool vprop(const uint8_t* m, int i, int j) const {
    return i >= 0 && i < Y - 1 && j >= 0 && j < X &&
           (at(m, i, j) || at(m, i + 1, j));
  }
};

// extrapolate (main.c:173-185) then zero_bounds (main.c:822-832) of one
// face sample; V selects the v planes
template <bool V>
__device__ float extrap_zero(const Masks& m, const float* __restrict__ q,
                             int y, int x) {
  auto prop = [&](const uint8_t* mk, int i, int j) {
    return V ? m.vprop(mk, i, j) : m.uprop(mk, i, j);
  };
  const bool cur = prop(m.fl, y, x);
  if (!cur) return 0.0f;  // zero_bounds clears every non-fluid face
  float qv = q[y * m.X + x];
  if (!prop(m.pfl, y, x)) {
    // newly fluid: average of the 3x3 neighbours that were fluid,
    // rows first then columns (the plain version's order)
    float total[3], count[3];
    for (int c = 0; c < 3; ++c) {
      const int j = x + c - 1;
      float ts = 0.0f, cs = 0.0f;
      for (int r = 0; r < 3; ++r) {
        const int i = y + r - 1;
        const float mk = prop(m.pfl, i, j) ? 1.0f : 0.0f;
        const float qm = ld(q, i, j, m.Y, m.X) * mk;
        ts = r == 0 ? qm : ts + qm;
        cs = r == 0 ? mk : cs + mk;
      }
      total[c] = ts;
      count[c] = cs;
    }
    const float tot = (total[0] + total[1]) + total[2];
    const float cnt = (count[0] + count[1]) + count[2];
    const float avg = tot / (cnt > 0.0f ? cnt : 1.0f);
    qv = cnt > 0.0f ? avg : 0.0f;
  }
  return prop(m.so, y, x) ? 0.0f : qv;
}

__global__ void pass_a(Masks m, const float* __restrict__ u,
                       const float* __restrict__ v, float* __restrict__ zu,
                       float* __restrict__ zv) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m.Y * m.X) return;
  const int y = t / m.X, x = t - y * m.X;
  zu[t] = extrap_zero<false>(m, u, y, x);
  zv[t] = extrap_zero<true>(m, v, y, x);
}

// interpolate_stencil of q (u- or v-type by V) at idx around site (sy, sx)
template <bool V>
__device__ float interp(const Masks& m, const float* __restrict__ q,
                        float idx_x, float idx_y, int sx, int sy) {
  int bx, by;
  float fx, fy;
  clamped_base(idx_x, sx, V ? m.X : m.X - 1, &bx, &fx);
  clamped_base(idx_y, sy, V ? m.Y - 1 : m.Y, &by, &fy);
  auto prop = [&](int i, int j) {
    return V ? m.vprop(m.fl, i, j) : m.uprop(m.fl, i, j);
  };
  const bool v00 = prop(by, bx), v01 = prop(by, bx + 1);
  const bool v10 = prop(by + 1, bx), v11 = prop(by + 1, bx + 1);
  const float q00 = v00 ? ld(q, by, bx, m.Y, m.X) : 0.0f;
  const float q01 = v01 ? ld(q, by, bx + 1, m.Y, m.X) : 0.0f;
  const float q10 = v10 ? ld(q, by + 1, bx, m.Y, m.X) : 0.0f;
  const float q11 = v11 ? ld(q, by + 1, bx + 1, m.Y, m.X) : 0.0f;
  return bilinear(q00, q01, q10, q11, fx, fy, v00, v01, v10, v11);
}

// advect_u / advect_v (main.c:382-422), gravity (main.c:539-545),
// zero_bounds (main.c:888-889)
__global__ void pass_b(Masks m, const float* __restrict__ zu,
                       const float* __restrict__ zv,
                       const float* __restrict__ dt_ptr, float inv_h,
                       float g, float* __restrict__ ut,
                       float* __restrict__ vt) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m.Y * m.X) return;
  const int y = t / m.X, x = t - y * m.X;
  const float dt = *dt_ptr;
  const float xs = static_cast<float>(x), ys = static_cast<float>(y);

  float uo = 0.0f;
  if (m.uprop(m.fl, y, x)) {
    const float dxu = zu[t];
    const float dyu = interp<true>(m, zv, xs + 0.5f, ys - 0.5f, x, y);
    const float px = xs - dxu * dt * inv_h;
    const float py = ys - dyu * dt * inv_h;
    uo = interp<false>(m, zu, px, py, x, y);
    if (m.uprop(m.so, y, x)) uo = 0.0f;
  }
  float vo = 0.0f;
  const bool vmask = m.vprop(m.fl, y, x);
  if (vmask) {
    const float dyv = zv[t];
    const float dxv = interp<false>(m, zu, xs - 0.5f, ys + 0.5f, x, y);
    const float px = xs - dxv * dt * inv_h;
    const float py = ys - dyv * dt * inv_h;
    vo = interp<true>(m, zv, px, py, x, y);
  }
  if (y < m.Y - 1) vo = vo + g * dt;  // every V sample, fluid or not
  if (!vmask || m.vprop(m.so, y, x)) vo = 0.0f;
  ut[t] = uo;
  vt[t] = vo;
}

// passes A and B: (u, v) -> (ut, vt) through the scratch planes zu, zv
inline int grid_passes(const Masks& m, float inv_h, float g, const float* u,
                const float* v, const float* dt, float* zu, float* zv,
                float* ut, float* vt, cudaStream_t s) {
  const unsigned nb = eu_blocks(static_cast<long long>(m.Y) * m.X, kThreads);
  pass_a<<<nb, kThreads, 0, s>>>(m, u, v, zu, zv);
  const int rc = eu_launch_status();
  if (rc) return rc;
  pass_b<<<nb, kThreads, 0, s>>>(m, zu, zv, dt, inv_h, g, ut, vt);
  return eu_launch_status();
}

inline Masks make_masks(int Y, int X, const void* fl, const void* pfl,
                 const void* so) {
  return Masks{Y, X, static_cast<const uint8_t*>(fl),
               static_cast<const uint8_t*>(pfl),
               static_cast<const uint8_t*>(so)};
}

// the packed PCG matrix a_diag * fl + 8 * fl at cell (y, x) from the
// solid mask (a_diag = 4 - #solid neighbours, pcg_kernel.py:283-284)
__device__ __forceinline__ float packed_at(const Masks& m, int t, int y,
                                           int x) {
  auto so = [&](int i, int j) { return m.at(m.so, i, j) ? 1.0f : 0.0f; };
  const float a =
      4.0f - (((so(y, x - 1) + so(y, x + 1)) + so(y + 1, x)) + so(y - 1, x));
  const float f = m.fl[t] ? 1.0f : 0.0f;
  return a * f + 8.0f * f;
}

// pressure clamp >= 0 on fluid cells, NaN-propagating like jnp.maximum,
// of p_in into p (p_in may be p)
__global__ void clamp_kernel(int n, const uint8_t* __restrict__ fl,
                             const float* p_in, float* p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float pv = p_in[t];
  p[t] = fl[t] ? nanmax(pv, 0.0f) : 0.0f;
}

// face update of (u, v) into (u2, v2) + per-block maxima of u2^2 and
// v2^2.  u2/v2 may be u/v (each thread reads and writes only its own
// sample).  dt is the face-update dt: +inf on an inactive substep of the
// unfused routes gives NaN that the frame loop's select discards.
__global__ void face_kernel(Masks m, const float* __restrict__ p,
                            const float* __restrict__ dt_ptr, float c,
                            const float* u, const float* v, float* u2,
                            float* v2, float* __restrict__ part_u,
                            float* __restrict__ part_v) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float mu = 0.0f, mv = 0.0f;
  if (t < m.Y * m.X) {
    const int y = t / m.X, x = t - y * m.X;
    const float dt = *dt_ptr;
    const float pc = p[t];
    const bool u_keep = x < m.X - 1 && (m.at(m.fl, y, x) ||
                                        m.at(m.fl, y, x + 1)) &&
                        !(m.at(m.so, y, x) || m.at(m.so, y, x + 1));
    const bool v_keep = y < m.Y - 1 && (m.at(m.fl, y, x) ||
                                        m.at(m.fl, y + 1, x)) &&
                        !(m.at(m.so, y, x) || m.at(m.so, y + 1, x));
    const float pr = ld(p, y, x + 1, m.Y, m.X);
    const float pu = ld(p, y + 1, x, m.Y, m.X);
    const float uo = u_keep ? u[t] + (c * (pr - pc)) * dt : 0.0f;
    const float vo = v_keep ? v[t] + (c * (pu - pc)) * dt : 0.0f;
    u2[t] = uo;
    v2[t] = vo;
    mu = uo * uo;
    mv = vo * vo;
  }
  mu = block_reduce<EU_MAX>(mu);
  mv = block_reduce<EU_MAX>(mv);
  if (threadIdx.x == 0) {
    part_u[blockIdx.x] = mu;
    part_v[blockIdx.x] = mv;
  }
}

__global__ void msq_reduce(const float* __restrict__ part_u,
                           const float* __restrict__ part_v, int nparts,
                           float* __restrict__ msq) {
  const float mu = reduce_partials<EU_MAX>(part_u, nparts);
  const float mv = reduce_partials<EU_MAX>(part_v, nparts);
  if (threadIdx.x == 0) *msq = mu + mv;
}

// clamp p_in into p (p_in may be p), then the face update of (u, v) into
// (u2, v2) and msq (one f32 on the device).  part: 2 * ceil(Y*X/kThreads)
// floats.
inline int project_tail(const Masks& m, float c, const float* dt,
                        const float* p_in, float* p, const float* u,
                        const float* v, float* u2, float* v2, float* part,
                        float* msq, cudaStream_t s) {
  const unsigned nb = eu_blocks(static_cast<long long>(m.Y) * m.X, kThreads);
  clamp_kernel<<<nb, kThreads, 0, s>>>(m.Y * m.X, m.fl, p_in, p);
  int rc = eu_launch_status();
  if (rc) return rc;
  face_kernel<<<nb, kThreads, 0, s>>>(m, p, dt, c, u, v, u2, v2, part,
                                      part + nb);
  if ((rc = eu_launch_status())) return rc;
  msq_reduce<<<1, 1024, 0, s>>>(part, part + nb, nb, msq);
  return eu_launch_status();
}

}  // namespace
