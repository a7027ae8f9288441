// The grid stage and the projection tail of a substep, shared by K2
// (grid_stage.cu, around the MG-PCG solve), K7 (grid_stage.cu, the grid
// stage alone) and K9/K10 (jacobi_pcg.cu, around the Jacobi-PCG solve).
//
// The grid stage (`grid_passes`, all of K7: extrapolate -> zero_bounds
// -> advect u, v -> gravity -> zero_bounds, main.c:865-889) is the grid
// stage `_grid_stage_sweeps` of euler_tpu/ops/pallas/substep_kernel.py
// and all of `_grid_kernel` in euler_tpu/ops/pallas/grid_kernel.py.  It
// is bound by bytes: u and v in, three u8 masks in, ut and vt out, 19
// bytes a cell.  So it is one launch of one CTA per tile of TY x TX
// cells, which stages the tile's window in shared memory with coalesced
// row loads (an interior tile's as 16-byte words of u and v and 4-byte
// words of each mask, every load of a thread issued before its uses) and
// computes everything from there:
//   * u and v with a halo of 2 cells on each side, and the three masks
//     with a halo of 2 before and 3 after, packed as 3 bits a cell (the
//     advection samples the extrapolated planes in the 3x3 window around
//     the site, `clamped_base`; the extrapolation reaches 1 further; the
//     u-property of a cell reads the cell after it, the v-property the
//     row after it).  Outside the grid u, v and the masks read 0.
//   * each window cell's six u/v properties (fluid, prev_fluid, solid of
//     u and v, false outside their sample regions) once, as bits;
//   * the extrapolated, zeroed velocities over the tile and a one-cell
//     ring, in shared memory only;
//   * the advection, gravity and zeroing of the tile's own cells, which
//     write ut and vt once (and, in the rainbow form, the extrapolated
//     velocities uu and vv, which the colours' advection reads).
// The arithmetic is the plain PyTorch version's, in its operand order;
// include from a file built with -fmad=false so it rounds as that does.
//
// The clamp (main.c:773-779), the face update (main.c:782-806) and the
// CFL maxsq (main.c:808-820) are the tail both Pallas projection kernels
// end with, one thread per cell.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Masks {
  int Y, X;
  const uint8_t* __restrict__ fl;   // fluid
  const uint8_t* __restrict__ pfl;  // fluid at the previous substep
  const uint8_t* __restrict__ so;   // solid
  // K7 on a block padded with its neighbours' rows and columns
  // (parallel/spatial.py): the grid's row and column counts (0: Y, X, a
  // whole plane) and the grid's row and column of plane cell (0, 0).
  // The interpolation clamps, the u and v sample regions, the sites'
  // coordinates, gravity's rows and the zero beyond the grid take grid
  // rows and columns.
  int gY = 0, off = 0, gX = 0, offx = 0;

  __device__ bool at(const uint8_t* m, int i, int j) const {
    return ld(m, i, j, Y, X) != 0;
  }
};

// K7's launch (ops/cuda/grid_kernel.py `grid_tile_plan`): tiles of ty x
// tx cells, `threads` threads a CTA
struct GridTile {
  int ty, tx, threads;
};

// a window cell's mask bits (kMask*) and u/v property bits (kProp*: the
// u bits, then the same shifted by kPropV for v)
enum : int {
  kMaskFl = 1, kMaskPfl = 2, kMaskSo = 4,
  kPropFl = 0, kPropPfl = 1, kPropSo = 2, kPropV = 3,
};

// The shared memory of a tile of ty x TX cells, from the tile's first
// cell (y0, x0): u and v over the window W of rows y0-2 .. y0+ty+1 and
// the same columns (PW = TX + 4 wide), the extrapolated velocities over
// the ring Z of rows y0-1 .. y0+ty (ZW = TX + 2 wide), the property bits
// over W and the mask bits over the mask window of rows y0-2 .. y0+ty+2
// (MW = TX + 5 wide).  Mirrored by grid_kernel.grid_tile_smem_bytes.
__host__ __device__ constexpr int grid_tile_smem(int ty, int tx) {
  return 9 * (ty + 4) * (tx + 4) + 8 * (ty + 2) * (tx + 2) +
         (ty + 5) * (tx + 5);
}

// extrapolate (main.c:173-185) then zero_bounds (main.c:822-832) of one
// face sample at window index c; V selects the v properties.  q: u or v
// over the window; pr: the property bits; pw: the window's row pitch.
template <bool V>
__device__ float extrap_zero(const uint8_t* pr, const float* q, int c,
                             int pw) {
  auto prop = [&](int k, int bit) {
    return ((pr[k] >> (bit + (V ? kPropV : 0))) & 1) != 0;
  };
  if (!prop(c, kPropFl)) return 0.0f;  // zero_bounds clears non-fluid faces
  float qv = q[c];
  if (!prop(c, kPropPfl)) {
    // newly fluid: average of the 3x3 neighbours that were fluid,
    // rows first then columns (the plain version's order)
    float total[3], count[3];
    for (int col = 0; col < 3; ++col) {
      float ts = 0.0f, cs = 0.0f;
      for (int r = 0; r < 3; ++r) {
        const int k = c + (r - 1) * pw + (col - 1);
        const float mk = prop(k, kPropPfl) ? 1.0f : 0.0f;
        const float qm = q[k] * mk;
        ts = r == 0 ? qm : ts + qm;
        cs = r == 0 ? mk : cs + mk;
      }
      total[col] = ts;
      count[col] = cs;
    }
    const float tot = (total[0] + total[1]) + total[2];
    const float cnt = (count[0] + count[1]) + count[2];
    const float avg = tot / (cnt > 0.0f ? cnt : 1.0f);
    qv = cnt > 0.0f ? avg : 0.0f;
  }
  return prop(c, kPropSo) ? 0.0f : qv;
}

// A tile's planes in shared memory, addressed by grid coordinates
template <int TX>
struct TileView {
  static constexpr int PW = TX + 4, ZW = TX + 2;
  int Y, X, y0, x0;
  int GY, off;        // the grid's rows, the grid row of plane row 0
  int GX, offx;       // the grid's columns, the grid column of plane col 0
  const uint8_t* pr;  // property bits over the window
  const float* zu;    // extrapolated velocities over the ring
  const float* zv;

  __device__ int w(int y, int x) const {
    return (y - y0 + 2) * PW + (x - x0 + 2);
  }
  __device__ int z(int y, int x) const {
    return (y - y0 + 1) * ZW + (x - x0 + 1);
  }
  // interpolate_stencil of the extrapolated u or v (by V) at idx around
  // site (sy, sx), idx and the site in grid rows and columns; the base
  // back on the plane
  template <bool V>
  __device__ float interp(float idx_x, float idx_y, int sx, int sy) const {
    int bx, by;
    float fx, fy;
    clamped_base(idx_x, sx, V ? GX : GX - 1, &bx, &fx);
    clamped_base(idx_y, sy, V ? GY - 1 : GY, &by, &fy);
    bx -= offx;
    by -= off;
    const float* q = V ? zv : zu;
    const int kw = w(by, bx), sh = kPropFl + (V ? kPropV : 0);
    const bool v00 = ((pr[kw] >> sh) & 1) != 0;
    const bool v01 = ((pr[kw + 1] >> sh) & 1) != 0;
    const bool v10 = ((pr[kw + PW] >> sh) & 1) != 0;
    const bool v11 = ((pr[kw + PW + 1] >> sh) & 1) != 0;
    const int k = z(by, bx);
    const float q00 = v00 ? q[k] : 0.0f;
    const float q01 = v01 ? q[k + 1] : 0.0f;
    const float q10 = v10 ? q[k + ZW] : 0.0f;
    const float q11 = v11 ? q[k + ZW + 1] : 0.0f;
    return bilinear(q00, q01, q10, q11, fx, fy, v00, v01, v10, v11);
  }
};

// K7: the grid stage of one tile of ty x TX cells (see the top of this
// file).  With EXTRAP the tile's extrapolated velocities go to uu, vv.
template <int TX, bool EXTRAP>
__global__ void __launch_bounds__(512)
    grid_tiles(Masks m, int ty, float inv_h, float g,
               const float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ dt_ptr, float* __restrict__ ut,
               float* __restrict__ vt, float* __restrict__ uu,
               float* __restrict__ vv) {
  constexpr int MW = TX + 5, PW = TX + 4, ZW = TX + 2;
  const int MH = ty + 5, PH = ty + 4, ZH = ty + 2;
  const int Y = m.Y, X = m.X;
  const int GY = m.gY > 0 ? m.gY : Y, off = m.off;
  const int GX = m.gX > 0 ? m.gX : X, offx = m.offx;
  const int y0 = blockIdx.y * ty, x0 = blockIdx.x * TX;
  extern __shared__ float smem[];
  float* su = smem;
  float* sv = su + PH * PW;
  float* zu = sv + PH * PW;
  float* zv = zu + ZH * ZW;
  uint8_t* pr = reinterpret_cast<uint8_t*>(zv + ZH * ZW);
  uint8_t* mk = pr + PH * PW;

  // the window: mask bits, u and v (0 outside the grid).  A tile whose
  // window (widened to x0-4 .. x0+TX+3) lies in the grid, on rows of a
  // multiple of 4 cells, loads it as 16-byte words of u and v and 4-byte
  // words of each mask, all of a thread's loads issued before their
  // uses; the others load it cell by cell.
  constexpr int WW = (TX + 8) / 4;  // words a widened row
  const bool vec =
      (X & 3) == 0 && y0 >= 2 && y0 + ty + 3 <= Y && y0 - 2 + off >= 0 &&
      y0 + ty + 3 + off <= GY && x0 >= 4 && x0 - 4 + offx >= 0 &&
      x0 + TX + 4 <= X && x0 + TX + 4 + offx <= GX &&
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v)) &
       15) == 0 &&
      ((reinterpret_cast<uintptr_t>(m.fl) | reinterpret_cast<uintptr_t>(m.pfl) |
        reinterpret_cast<uintptr_t>(m.so)) & 3) == 0;
  for (int k = threadIdx.x; vec && k < MH * WW; k += blockDim.x) {
    const int i = k / WW, c = k - i * WW;
    const int t = (y0 - 2 + i) * X + x0 - 4 + 4 * c;
    const uint32_t f = *reinterpret_cast<const uint32_t*>(m.fl + t);
    const uint32_t pf = *reinterpret_cast<const uint32_t*>(m.pfl + t);
    const uint32_t so = *reinterpret_cast<const uint32_t*>(m.so + t);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (i < PH) {
      a = *reinterpret_cast<const float4*>(u + t);
      b = *reinterpret_cast<const float4*>(v + t);
    }
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * c + e - 2;  // the window's column
      if (j < 0) continue;
      const int sh = 8 * e;
      if (j < MW)
        mk[i * MW + j] = ((f >> sh) & 0xff ? kMaskFl : 0) |
                         ((pf >> sh) & 0xff ? kMaskPfl : 0) |
                         ((so >> sh) & 0xff ? kMaskSo : 0);
      if (i < PH && j < PW) {
        su[i * PW + j] = av[e];
        sv[i * PW + j] = bv[e];
      }
    }
  }
  for (int k = threadIdx.x; !vec && k < MH * MW; k += blockDim.x) {
    const int i = k / MW, j = k - i * MW;
    const int y = y0 - 2 + i, x = x0 - 2 + j, gy = y + off, gx = x + offx;
    const bool in = y >= 0 && y < Y && gy >= 0 && gy < GY && x >= 0 &&
                    x < X && gx >= 0 && gx < GX;
    const int t = y * X + x;
    mk[k] = in ? (m.fl[t] ? kMaskFl : 0) | (m.pfl[t] ? kMaskPfl : 0) |
                     (m.so[t] ? kMaskSo : 0)
               : 0;
    if (i < PH && j < PW) {
      su[i * PW + j] = in ? u[t] : 0.0f;
      sv[i * PW + j] = in ? v[t] : 0.0f;
    }
  }
  __syncthreads();
  // the u/v properties, inside their sample regions (u: grid column <
  // GX-1, v: grid row < GY-1): a mask of the cell or of the one after it
  for (int k = threadIdx.x; k < PH * PW; k += blockDim.x) {
    const int i = k / PW, j = k - i * PW;
    const int y = y0 - 2 + i, x = x0 - 2 + j, gy = y + off, gx = x + offx;
    const int a = mk[i * MW + j];
    const bool row = y >= 0 && y < Y && gy >= 0;
    const bool col = x >= 0 && x < X && gx >= 0;
    const int pu = (row && gy < GY && col && gx < GX - 1)
                       ? (a | mk[i * MW + j + 1]) : 0;
    const int pv = (row && gy < GY - 1 && col && gx < GX)
                       ? (a | mk[(i + 1) * MW + j]) : 0;
    pr[k] = static_cast<uint8_t>(pu | (pv << kPropV));
  }
  __syncthreads();
  // extrapolate -> zero_bounds over the tile and its one-cell ring
  for (int k = threadIdx.x; k < ZH * ZW; k += blockDim.x) {
    const int i = k / ZW, j = k - i * ZW;
    const int c = (i + 1) * PW + j + 1;
    zu[k] = extrap_zero<false>(pr, su, c, PW);
    zv[k] = extrap_zero<true>(pr, sv, c, PW);
  }
  __syncthreads();

  // advect_u / advect_v (main.c:382-422), gravity (main.c:539-545),
  // zero_bounds (main.c:888-889) of the tile's cells
  const TileView<TX> tv{Y, X, y0, x0, GY, off, GX, offx, pr, zu, zv};
  const float dt = *dt_ptr;
  for (int k = threadIdx.x; k < ty * TX; k += blockDim.x) {
    const int y = y0 + k / TX, x = x0 + k % TX;
    if (y >= Y || x >= X) continue;
    const int t = y * X + x, zc = tv.z(y, x), gy = y + off, gx = x + offx;
    const int pc = pr[tv.w(y, x)];  // the site's property bits
    const float xs = static_cast<float>(gx), ys = static_cast<float>(gy);
    float uo = 0.0f;
    if (pc & (1 << kPropFl)) {
      const float dxu = zu[zc];
      const float dyu =
          tv.template interp<true>(xs + 0.5f, ys - 0.5f, gx, gy);
      const float px = xs - dxu * dt * inv_h;
      const float py = ys - dyu * dt * inv_h;
      uo = tv.template interp<false>(px, py, gx, gy);
      if (pc & (1 << kPropSo)) uo = 0.0f;
    }
    float vo = 0.0f;
    const bool vmask = (pc & (1 << (kPropV + kPropFl))) != 0;
    if (vmask) {
      const float dyv = zv[zc];
      const float dxv =
          tv.template interp<false>(xs - 0.5f, ys + 0.5f, gx, gy);
      const float px = xs - dxv * dt * inv_h;
      const float py = ys - dyv * dt * inv_h;
      vo = tv.template interp<true>(px, py, gx, gy);
    }
    if (gy < GY - 1) vo = vo + g * dt;  // every V sample, fluid or not
    if (!vmask || (pc & (1 << (kPropV + kPropSo)))) vo = 0.0f;
    ut[t] = uo;
    vt[t] = vo;
    if (EXTRAP) {
      uu[t] = zu[zc];
      vv[t] = zv[zc];
    }
  }
}

template <int TX>
inline int launch_grid_tiles(const Masks& m, int ty, int threads,
                             float inv_h, float g, const float* u,
                             const float* v, const float* dt, float* ut,
                             float* vt, float* uu, float* vv,
                             cudaStream_t s) {
  const dim3 grid((m.X + TX - 1) / TX, (m.Y + ty - 1) / ty);
  const int smem = grid_tile_smem(ty, TX);
  if (uu)
    grid_tiles<TX, true><<<grid, threads, smem, s>>>(
        m, ty, inv_h, g, u, v, dt, ut, vt, uu, vv);
  else
    grid_tiles<TX, false><<<grid, threads, smem, s>>>(
        m, ty, inv_h, g, u, v, dt, ut, vt, nullptr, nullptr);
  return eu_launch_status();
}

// The grid stage: (u, v) -> (ut, vt), one launch of `tile`'s tiles; with
// uu (and vv) non-null also the extrapolated, zeroed velocities.  A tile
// must fit the 48 KB of shared memory a launch gets without opting in.
inline int grid_passes(const Masks& m, const GridTile& tile, float inv_h,
                       float g, const float* u, const float* v,
                       const float* dt, float* ut, float* vt, float* uu,
                       float* vv, cudaStream_t s) {
  if (tile.ty < 1 || tile.threads < 32 || tile.threads > 512 ||
      grid_tile_smem(tile.ty, tile.tx) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile.tx) {
    case 32:
      return launch_grid_tiles<32>(m, tile.ty, tile.threads, inv_h, g, u, v,
                                   dt, ut, vt, uu, vv, s);
    case 64:
      return launch_grid_tiles<64>(m, tile.ty, tile.threads, inv_h, g, u, v,
                                   dt, ut, vt, uu, vv, s);
    case 128:
      return launch_grid_tiles<128>(m, tile.ty, tile.threads, inv_h, g, u,
                                    v, dt, ut, vt, uu, vv, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
