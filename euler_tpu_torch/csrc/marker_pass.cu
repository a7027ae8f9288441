// The slot-marker pass for Hopper, one tiled design behind four kernels:
// K1 (march + re-bin), K4 (K1 over the persistent padded store), and the
// unfused pair K5 (the march alone) and K6 (the re-bin alone).
//
// Replaces the Pallas kernels of euler_tpu/ops/pallas/:
//   K1  marker_fused_kernel.py `_fused_kernel` via `march_rebin_pallas`;
//   K4  the same kernel via `march_rebin_padded` (store [2K, Y+16, X+256],
//       interior at (8, 128));
//   K5  marker_kernel.py `_march_kernel` (`advect_markers_pallas`);
//   K6  rebin_kernel.py `_rebin_kernel` (`rebin_markers_pallas`, validity
//       from an alive plane).
// They compute ops/markers_slots.py advect_markers_slots and
// refresh_marker_counts_slots (main.c:464-537, 102-117).
//
// What bounds them on an H100: bytes.  Each returns a whole new [2K, Y, X]
// f32 store (64 MB at 1024², K = 8): K1, K4 and K6 zero the slots at and
// beyond a cell's new count, K5 copies its dead slots through (so it also
// reads the whole store).  The arithmetic per marker (two bilinear
// samples, a <= 4-step DDA) is small.
//
// `tile_pass`: one CTA per tile of TY x TX cells.  A marker moves at most
// one cell a substep (the re-bin clamps every offset to [-1, 1]), so a
// re-binning tile's arrivals all come from the tile and a one-cell halo
// around it; K5 needs no halo, a cell's markers stay in its own slots.
//   0. Each halo cell's live markers: the clamped count (K1, K4, K5: slots
//      k < count), or a K-bit mask read from the alive plane plane by
//      plane (K6: any slot may be live, holes included).  Where the halo
//      holds a live marker, take the block-wide exclusive prefix of the
//      cells' numbers: live marker j of the halo is the (j - start[s])-th
//      live slot, in k order, of the halo cell s with start[s] <= j <
//      start[s + 1].
//   1. One thread per live marker (no thread for a dead slot) loads its
//      position, marches it (K1, K4, K5), and keeps it in shared memory
//      with its destination offset as a code 0..8 (K1, K4, K6).  A halo
//      marker is marched by every CTA whose halo holds it; each march is a
//      pure function of its inputs, so the copies agree bit for bit.
//   2. K1, K4, K6: one thread per destination cell walks the source cells
//      in OFFSETS_OWN_FIRST order (own cell, then the 8 neighbours
//      lexicographically) and each source's live markers in k order,
//      picking those bound for it.  The running count is the destination
//      slot, so the slot assignment is the plain version's exactly, with
//      no atomics.  It then writes its K slots plane by plane (a warp's 32
//      cells of a tile row on one plane are one coalesced store), zeros
//      beyond min(run, K), K6's alive plane, the count and the drop.
//      K5: slot k of cell c is the marched pos[start[c] + k] for k <
//      count, the input slot otherwise, written plane by plane.
// A tile whose halo holds no live marker skips 1 and the walk of 2: it
// writes zeros (the Pallas kernels' skip_tile), or K5 copies its slots
// through.  No scratch lives in device memory.  The store is addressed
// through a row pitch and an interior offset (`Store`), so K4 reads and
// writes the padded store in place and leaves its pads unwritten.
// Built with -fmad=false so every product and sum rounds as the plain
// PyTorch version's do: positions and counts match it bit for bit.
//
// K1 also runs on one block of a plane (parallel/cuda_shard.py): the
// block's cells with H = 8 rows and columns of each neighbour around
// them (the corners from the diagonal neighbours), which is then the
// [Y, X] plane here.  Marker positions stay global, so the march and the
// re-bin take the site's global row and column (its plane row plus
// `row_offset`, its plane column plus `col_offset`: the global row and
// column of plane cell (0, 0)) and the interpolation clamps the global
// row and column counts `clamp_ny`, `clamp_nx`; a clamped base goes back
// to a plane cell before any load.  The cells a block keeps are those of
// the whole plane bit for bit: their arrivals come from one cell away,
// marched from cells within two, and u_property / v_property read one
// cell more, all inside the H rows and columns.  On a whole plane
// clamp_ny = Y, row_offset = 0, clamp_nx = X, col_offset = 0.
#include "common.cuh"

namespace {

__device__ __forceinline__ float time_to(float p0, float p1, float vel) {
  return fabsf(vel) > 0.0f ? (p1 - p0) / vel : FLT_MAX;
}

// The planes the march reads: u, v and the fluid and solid masks (a read
// beyond the grid gives 0), with the velocity samples and the solid probe.
struct Grid {
  int Y, X;
  int clamp_ny, row_offset;  // the global row count, the global row of 0
  int clamp_nx, col_offset;  // the global column count, column of 0
  const float* __restrict__ u;
  const float* __restrict__ v;
  const uint8_t* __restrict__ fluid_mask;
  const uint8_t* __restrict__ solid;

  __device__ bool fluid(int i, int j) const {
    return ld(fluid_mask, i, j, Y, X) != 0;
  }
  // u_property / v_property of the fluid mask (main.c:128-138)
  __device__ bool uprop(int i, int j) const {
    return (i >= 0 && i < Y && j >= 0 && j < X) &&
           (fluid(i, j) || fluid(i, j + 1));
  }
  __device__ bool vprop(int i, int j) const {
    return (i >= 0 && i < Y && j >= 0 && j < X) &&
           (fluid(i, j) || fluid(i + 1, j));
  }
  // interpolate_stencil of u (size (clamp_nx-1, clamp_ny)) / v (size
  // (clamp_nx, clamp_ny-1)) at the site of global row sy and column sx;
  // the base back on the plane
  __device__ float interp_u(float idx_x, float idx_y, int sx, int sy) const {
    int bx, by;
    float fx, fy;
    clamped_base(idx_x, sx, clamp_nx - 1, &bx, &fx);
    clamped_base(idx_y, sy, clamp_ny, &by, &fy);
    bx -= col_offset;
    by -= row_offset;
    bool v00 = uprop(by, bx), v01 = uprop(by, bx + 1);
    bool v10 = uprop(by + 1, bx), v11 = uprop(by + 1, bx + 1);
    float q00 = v00 ? ld(u, by, bx, Y, X) : 0.0f;
    float q01 = v01 ? ld(u, by, bx + 1, Y, X) : 0.0f;
    float q10 = v10 ? ld(u, by + 1, bx, Y, X) : 0.0f;
    float q11 = v11 ? ld(u, by + 1, bx + 1, Y, X) : 0.0f;
    return bilinear(q00, q01, q10, q11, fx, fy, v00, v01, v10, v11);
  }
  __device__ float interp_v(float idx_x, float idx_y, int sx, int sy) const {
    int bx, by;
    float fx, fy;
    clamped_base(idx_x, sx, clamp_nx, &bx, &fx);
    clamped_base(idx_y, sy, clamp_ny - 1, &by, &fy);
    bx -= col_offset;
    by -= row_offset;
    bool v00 = vprop(by, bx), v01 = vprop(by, bx + 1);
    bool v10 = vprop(by + 1, bx), v11 = vprop(by + 1, bx + 1);
    float q00 = v00 ? ld(v, by, bx, Y, X) : 0.0f;
    float q01 = v01 ? ld(v, by, bx + 1, Y, X) : 0.0f;
    float q10 = v10 ? ld(v, by + 1, bx, Y, X) : 0.0f;
    float q11 = v11 ? ld(v, by + 1, bx + 1, Y, X) : 0.0f;
    return bilinear(q00, q01, q10, q11, fx, fy, v00, v01, v10, v11);
  }
  // solid probe within the 3x3 window of the site of global row sy and
  // column sx
  __device__ bool solid_at(int yy, int xx, int sy, int sx) const {
    int dy = min(max(yy - sy, -1), 1), dx = min(max(xx - sx, -1), 1);
    return ld(solid, sy - row_offset + dy, sx - col_offset + dx, Y, X) != 0;
  }
};

// The px and py planes of a slot store, addressed through a row pitch
// and the offset of the interior: pitch X and offset 0 for the [2K, Y, X]
// store, pitch X + 2 kPadX and offset (kPadY, kPadX) for K4's persistent
// padded [2K, Y + 2 kPadY, X + 2 kPadX] store.
constexpr int kPadY = 8, kPadX = 128;

template <typename T>
struct Store {
  T* px;
  T* py;
  long long plane;  // elements from one slot plane to the next
  int pitch, oy, ox;
  __device__ long long at(int k, int y, int x) const {
    return k * plane + static_cast<long long>(y + oy) * pitch + (x + ox);
  }
};

// px planes 0..K-1, then py planes K..2K-1
template <typename T>
Store<T> slot_store(T* slots, int K, int Y, int X, bool padded) {
  const int Yp = padded ? Y + 2 * kPadY : Y, Xp = padded ? X + 2 * kPadX : X;
  const long long plane = static_cast<long long>(Yp) * Xp;
  return {slots, slots + K * plane, plane, Xp, padded ? kPadY : 0,
          padded ? kPadX : 0};
}

// March one live marker at (px, py), homed in cell (y, x) (its global
// row and column), through dt:
// velocity sampling, the bounded DDA collision march and the advance
// (main.c:464-537).
__device__ __forceinline__ float2 march_marker(const Grid& g, float px,
                                               float py, int y, int x,
                                               float dt, int iters, float h,
                                               float inv_h) {
  float vx = g.interp_u(px * inv_h - 1.0f, py * inv_h - 0.5f, x, y);
  float vy = g.interp_v(px * inv_h - 0.5f, py * inv_h - 1.0f, x, y);

  int x_idx = static_cast<int>(floorf(px * inv_h));
  int y_idx = static_cast<int>(floorf(py * inv_h));
  const int x_dir = vx > 0.0f ? 1 : -1;
  int nx_idx = x_idx + (vx > 0.0f ? 1 : 0);
  float npx = static_cast<float>(nx_idx) * h;
  float t_x = time_to(px, npx, vx);
  const int x_off = vx < 0.0f ? -1 : 0;
  const int y_dir = vy > 0.0f ? 1 : -1;
  int ny_idx = y_idx + (vy > 0.0f ? 1 : 0);
  float npy = static_cast<float>(ny_idx) * h;
  float t_y = time_to(py, npy, vy);
  const int y_off = vy < 0.0f ? -1 : 0;

  float t_prev = 0.0f, t_near = fminf(t_x, t_y), dt_rem = dt;
  float mx = px, my = py;
  // bounded DDA march (main.c:495-533); an inactive step changes nothing,
  // so leaving the loop early is exact
  for (int it = 0; it < iters && t_near < dt_rem; ++it) {
    const bool horiz = t_x < t_y;
    const bool hit_h = horiz && g.solid_at(y_idx, nx_idx + x_off, y, x);
    const bool adv_h = horiz && !hit_h;
    const bool hit_v = !horiz && g.solid_at(ny_idx + y_off, x_idx, y, x);
    const bool adv_v = !horiz && !hit_v;
    const bool hit = hit_h || hit_v;
    if (hit) {
      mx = mx + t_prev * vx;
      my = my + t_prev * vy;
      dt_rem = dt_rem - t_prev;
    }
    if (hit_h) vx = 0.0f;
    if (hit_v) vy = 0.0f;
    if (adv_h) {
      x_idx = nx_idx;
      nx_idx = nx_idx + x_dir;
      npx = static_cast<float>(nx_idx) * h;
    }
    if (adv_v) {
      y_idx = ny_idx;
      ny_idx = ny_idx + y_dir;
      npy = static_cast<float>(ny_idx) * h;
    }
    t_x = time_to(mx, npx, vx);
    t_y = time_to(my, npy, vy);
    t_prev = hit ? 0.0f : t_near;
    t_near = fminf(t_x, t_y);
  }
  const float tt = t_near < FLT_MAX ? dt_rem : t_prev;
  return make_float2(mx + tt * vx, my + tt * vy);
}

// The destination of a marker at (mx, my) homed in (sy, sx) (its global
// row and column): the offset
// (dy, dx) of its new cell, clamped to the 3x3 window, as the code
// (dy + 1) * 3 + dx + 1.
__device__ __forceinline__ int dest_code(float mx, float my, int sy, int sx,
                                         float inv_h) {
  const int ody = min(max(static_cast<int>(floorf(my * inv_h)) - sy, -1), 1);
  const int odx = min(max(static_cast<int>(floorf(mx * inv_h)) - sx, -1), 1);
  return (ody + 1) * 3 + odx + 1;
}

__device__ __constant__ int kOffsets[9][2] = {
    {0, 0},  {-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
    {0, 1},  {1, -1},  {1, 0},  {1, 1}};

// Which pass a tile runs.
enum class Pass {
  kMarchRebin,  // K1, K4: march, then re-bin by counts
  kRebin,       // K6: re-bin by the alive plane
  kMarch,       // K5: march by counts, dead slots copied through
};

// The shared memory of one tile of TY x TX cells and its halo of H =
// (TY + 2 halo)(TX + 2 halo) cells (halo 1, or 0 for K5), in this order:
// the positions of the halo's live markers in (cell, slot) order, H K
// float2; K6's alive mask of each halo cell, H u64; the exclusive prefix of
// the halo's numbers of live markers, H + 1 ints; the scan's 32 warp sums;
// then for the re-bins each destination's picked markers, slot-major, TY TX
// K u16 (so H K may not exceed 65536), and the destination code of each
// live marker, H K bytes.  ops/cuda/marker_fused_kernel.py
// `tile_smem_bytes` computes the same total.
struct TileLayout {
  int halo, HX, H, T, K;
  bool gather, masks;
  __host__ __device__ TileLayout(Pass p, int ty, int tx, int k)
      : halo(p == Pass::kMarch ? 0 : 1),
        HX(tx + 2 * halo),
        H((ty + 2 * halo) * HX),
        T(ty * tx),
        K(k),
        gather(p != Pass::kMarch),
        masks(p == Pass::kRebin) {}
  __host__ __device__ size_t masks_at() const { return 8ull * H * K; }
  __host__ __device__ size_t start_at() const {
    return masks_at() + (masks ? 8ull * H : 0);
  }
  __host__ __device__ size_t pick_at() const {
    return start_at() + 4ull * (H + 1) + 4ull * 32;
  }
  __host__ __device__ size_t code_at() const {
    return pick_at() + (gather ? 2ull * T * K : 0);
  }
  __host__ __device__ size_t bytes() const {
    return code_at() + (gather ? 1ull * H * K : 0);
  }
};

constexpr int kTileThreadsMax = 512;
// what a thread loads before it uses any of it: kSlotBatch slots of a
// cell (K6's alive bytes, K5's copied slots), kMarkerBatch of K6's markers
constexpr int kSlotBatch = 8, kMarkerBatch = 4;

// Exclusive prefix of a[0..n) in place, with a[n] the total, over the
// block (blockDim.x a multiple of 32): each thread sums a contiguous run,
// a warp scan and a scan of the warp sums give each run's offset.
// Returns the total to every thread.
__device__ int exclusive_scan(int* a, int n, int* warp_sum) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int per = (n + nt - 1) / nt;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < nw) warp_sum[lane] = w;
  }
  __syncthreads();
  int run = incl - own + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  const int total = warp_sum[nw - 1];
  if (t == 0) a[n] = total;
  __syncthreads();
  return total;
}

// The position of the (r + 1)-th set bit of m (r < popcount(m)).
__device__ __forceinline__ int nth_set_bit(uint64_t m, int r) {
  for (int i = 0; i < r; ++i) m &= m - 1;
  return __ffsll(static_cast<long long>(m)) - 1;
}

// What a tile pass reads and writes; each pass uses its own part.
struct TileArgs {
  Grid g;                           // the march's planes (K6: Y, X only)
  const int32_t* __restrict__ count;  // K1, K4, K5
  const uint8_t* __restrict__ alive;  // K6: [K, Y, X] 0/1
  const uint8_t* __restrict__ dead;   // K1, K4, K6
  const float* __restrict__ dt;       // K1, K4, K5: one f32 on device
  Store<const float> in;
  Store<float> out;
  int32_t* __restrict__ out_count;  // K1, K4, K6
  int32_t* __restrict__ out_drop;   // K1, K4, K6
  uint8_t* __restrict__ out_alive;  // K6: [K, Y, X] 0/1
  int K, iters, TY, TX;
  float h, inv_h;
};

// One tile of pass P (see the top of this file).
template <Pass P>
__device__ __forceinline__ void tile_pass(const TileArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout L(P, a.TY, a.TX, a.K);
  float2* pos = reinterpret_cast<float2*>(smem);
  uint64_t* mask = reinterpret_cast<uint64_t*>(smem + L.masks_at());
  int* start = reinterpret_cast<int*>(smem + L.start_at());
  int* warp_sum = start + L.H + 1;
  uint16_t* pick = reinterpret_cast<uint16_t*>(smem + L.pick_at());
  uint8_t* code = smem + L.code_at();
  const int t = threadIdx.x, nt = blockDim.x, K = a.K;
  const int Y = a.g.Y, X = a.g.X;
  const long long plane = static_cast<long long>(Y) * X;
  const int hy0 = blockIdx.y * a.TY - L.halo;
  const int hx0 = blockIdx.x * a.TX - L.halo;

  // 0. the halo's live markers a cell (none beyond the grid); where the
  // halo holds one, their prefix
  int any = 0;
  for (int s = t; s < L.H; s += nt) {
    const int y = hy0 + s / L.HX, x = hx0 + s % L.HX;
    const bool inside = y >= 0 && y < Y && x >= 0 && x < X;
    int n;
    if constexpr (P == Pass::kRebin) {
      // the alive bytes of kSlotBatch slots loaded at once, then their
      // bits
      uint64_t m = 0;
      for (int k0 = 0; inside && k0 < K; k0 += kSlotBatch) {
        uint8_t b[kSlotBatch];
#pragma unroll
        for (int i = 0; i < kSlotBatch; ++i)
          b[i] = k0 + i < K ? a.alive[(k0 + i) * plane + y * X + x] : 0;
#pragma unroll
        for (int i = 0; i < kSlotBatch; ++i)
          if (b[i]) m |= 1ull << (k0 + i);
      }
      mask[s] = m;
      n = __popcll(m);
    } else {
      n = inside ? min(max(a.count[y * X + x], 0), K) : 0;
    }
    start[s] = n;
    any |= n;
  }
  const bool live = __syncthreads_or(any);
  if (live) {
    const int total = exclusive_scan(start, L.H, warp_sum);

    // 1. each live marker's position (marched, but for K6) and
    // destination code, into shared memory.  K6 loads the positions of
    // kMarkerBatch markers a thread at once: with no march to wait on,
    // the loads' latency is its cost.
    constexpr int B = P == Pass::kRebin ? kMarkerBatch : 1;
    float dt = 0.0f;
    if constexpr (P != Pass::kRebin) dt = *a.dt;
    for (int j0 = t; j0 < total; j0 += B * nt) {
      int home[B];
      float2 m[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int j = j0 + i * nt;
        if (j >= total) continue;
        int s = 0, hi = L.H;  // start[s] <= j < start[hi]
        while (hi - s > 1) {
          const int mid = (s + hi) >> 1;
          if (start[mid] <= j) s = mid; else hi = mid;
        }
        int k = j - start[s];
        if constexpr (P == Pass::kRebin) k = nth_set_bit(mask[s], k);
        const long long src = a.in.at(k, hy0 + s / L.HX, hx0 + s % L.HX);
        home[i] = s;
        m[i] = make_float2(a.in.px[src], a.in.py[src]);
      }
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int j = j0 + i * nt;
        if (j >= total) continue;
        // the home cell's global row and column
        const int y = hy0 + home[i] / L.HX + a.g.row_offset;
        const int x = hx0 + home[i] % L.HX + a.g.col_offset;
        if constexpr (P != Pass::kRebin)
          m[i] = march_marker(a.g, m[i].x, m[i].y, y, x, dt, a.iters, a.h,
                              a.inv_h);
        pos[j] = m[i];
        if constexpr (P != Pass::kMarch)
          code[j] =
              static_cast<uint8_t>(dest_code(m[i].x, m[i].y, y, x, a.inv_h));
      }
    }
    __syncthreads();
  }

  // 2. write each cell's slots plane by plane
  for (int c = t; c < L.T; c += nt) {
    const int ty = c / a.TX, tx = c - ty * a.TX;
    const int y = hy0 + L.halo + ty, x = hx0 + L.halo + tx;
    if (y >= Y || x >= X) continue;
    if constexpr (P == Pass::kMarch) {
      // the marched live slots, the dead ones copied through (kSlotBatch
      // slots' loads issued before their stores)
      const int first = live ? start[c] : 0;
      const int n = live ? start[c + 1] - first : 0;
      for (int k0 = 0; k0 < K; k0 += kSlotBatch) {
        float2 m[kSlotBatch];
#pragma unroll
        for (int i = 0; i < kSlotBatch; ++i) {
          const int k = k0 + i;
          if (k < n) {
            m[i] = pos[first + k];
          } else if (k < K) {
            const long long src = a.in.at(k, y, x);
            m[i] = make_float2(a.in.px[src], a.in.py[src]);
          }
        }
#pragma unroll
        for (int i = 0; i < kSlotBatch && k0 + i < K; ++i) {
          const long long o = a.out.at(k0 + i, y, x);
          a.out.px[o] = m[i].x;
          a.out.py[o] = m[i].y;
        }
      }
    } else {
      // gather the arrivals in OFFSETS_OWN_FIRST and k order
      const int cell = y * X + x;
      int run = 0;
      if (live && !a.dead[cell]) {
        for (int o = 0; o < 9; ++o) {
          const int dy = kOffsets[o][0], dx = kOffsets[o][1];
          const int s = (ty + 1 - dy) * L.HX + (tx + 1 - dx);
          const int want = (dy + 1) * 3 + dx + 1;
          for (int j = start[s]; j < start[s + 1]; ++j) {
            if (code[j] != want) continue;
            if (run < K) pick[run * L.T + c] = static_cast<uint16_t>(j);
            ++run;
          }
        }
      }
      const int kept = min(run, K);
      for (int d = 0; d < K; ++d) {
        const float2 m =
            d < kept ? pos[pick[d * L.T + c]] : make_float2(0.0f, 0.0f);
        const long long o = a.out.at(d, y, x);
        a.out.px[o] = m.x;
        a.out.py[o] = m.y;
      }
      if constexpr (P == Pass::kRebin)
        for (int d = 0; d < K; ++d) a.out_alive[d * plane + cell] = d < kept;
      a.out_count[cell] = kept;
      a.out_drop[cell] = run - kept;
    }
  }
}

// K1 and K4
__global__ void __launch_bounds__(kTileThreadsMax, 2)
march_rebin_tiles(TileArgs a) {
  tile_pass<Pass::kMarchRebin>(a);
}

// K6
__global__ void __launch_bounds__(kTileThreadsMax, 2)
rebin_tiles(TileArgs a) {
  tile_pass<Pass::kRebin>(a);
}

// K5
__global__ void __launch_bounds__(kTileThreadsMax, 2)
march_tiles(TileArgs a) {
  tile_pass<Pass::kMarch>(a);
}

// A whole plane's grid (clamp_ny = Y, row_offset = 0, clamp_nx = X,
// col_offset = 0); K1 on a block sets its own four.
Grid make_grid(int Y, int X, const void* u, const void* v,
               const void* fluid, const void* solid) {
  return {Y, X, Y, 0, X, 0, static_cast<const float*>(u),
          static_cast<const float*>(v), static_cast<const uint8_t*>(fluid),
          static_cast<const uint8_t*>(solid)};
}

// A launch of pass P: tiles_y x tiles_x CTAs of `threads` threads (a
// multiple of 32, at most kTileThreadsMax), each a tile of tile_y x tile_x
// cells; the tiles must cover the grid.
struct TilePlan {
  int tile_y, tile_x, tiles_y, tiles_x, threads;
};

template <Pass P>
int launch_tiles(void (*kernel)(TileArgs), TileArgs a, TilePlan p,
                 void* stream) {
  const TileLayout L(P, p.tile_y, p.tile_x, a.K);
  if (p.tile_y < 1 || p.tile_x < 1 || a.K < 1 ||
      (L.gather && L.H * a.K > 65536) || (L.masks && a.K > 64) ||
      static_cast<long long>(p.tiles_y) * p.tile_y < a.g.Y ||
      static_cast<long long>(p.tiles_x) * p.tile_x < a.g.X ||
      p.threads < 32 || p.threads > kTileThreadsMax || p.threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = L.bytes();
  static size_t allowed = 48 * 1024;  // without the opt-in below
  if (bytes > allowed) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    if (rc) return rc;
    allowed = bytes;
  }
  a.TY = p.tile_y;
  a.TX = p.tile_x;
  kernel<<<dim3(p.tiles_x, p.tiles_y), p.threads, bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
  return eu_launch_status();
}

// K1 (padded = false) and K4 (padded = true); `slots` and `out` share the
// layout.  clamp_ny, row_offset, clamp_nx, col_offset: see the top of
// this file.
int march_rebin(bool padded, int Y, int X, int K, int iters, float h,
                float inv_h, int clamp_ny, int row_offset, int clamp_nx,
                int col_offset, const void* u,
                const void* v, const void* count, const void* fluid,
                const void* solid, const void* dead, const void* slots,
                const void* dt, void* out, void* out_count, void* out_drop,
                TilePlan p, void* stream) {
  TileArgs a{};
  a.g = make_grid(Y, X, u, v, fluid, solid);
  a.g.clamp_ny = clamp_ny;
  a.g.row_offset = row_offset;
  a.g.clamp_nx = clamp_nx;
  a.g.col_offset = col_offset;
  a.count = static_cast<const int32_t*>(count);
  a.dead = static_cast<const uint8_t*>(dead);
  a.dt = static_cast<const float*>(dt);
  a.in = slot_store(static_cast<const float*>(slots), K, Y, X, padded);
  a.out = slot_store(static_cast<float*>(out), K, Y, X, padded);
  a.out_count = static_cast<int32_t*>(out_count);
  a.out_drop = static_cast<int32_t*>(out_drop);
  a.K = K;
  a.iters = iters;
  a.h = h;
  a.inv_h = inv_h;
  return launch_tiles<Pass::kMarchRebin>(march_rebin_tiles, a, p, stream);
}

}  // namespace

// K1.  slots/out: [2K, Y, X] f32; count/out_count/out_drop: [Y, X] i32;
// u, v: [Y, X] f32; fluid, solid, dead: [Y, X] u8; dt: one f32 on device;
// clamp_ny, row_offset, clamp_nx, col_offset: Y, 0, X and 0 on a whole
// plane, the global row and column counts and the global row and column
// of plane cell (0, 0) on a block's plane; the tile plan (tile_y, tile_x,
// tiles_y, tiles_x, threads) from ops/cuda/marker_fused_kernel.py
// `tile_plan`.
EU_API int eu_march_rebin(int Y, int X, int K, int iters, float h,
                          float inv_h, int clamp_ny, int row_offset,
                          int clamp_nx, int col_offset, const void* u,
                          const void* v, const void* count,
                          const void* fluid, const void* solid,
                          const void* dead, const void* slots, const void* dt,
                          void* out, void* out_count, void* out_drop,
                          int tile_y, int tile_x, int tiles_y, int tiles_x,
                          int threads, void* stream) {
  return march_rebin(false, Y, X, K, iters, h, inv_h, clamp_ny, row_offset,
                     clamp_nx, col_offset, u, v, count, fluid, solid, dead,
                     slots, dt, out, out_count, out_drop,
                     {tile_y, tile_x, tiles_y, tiles_x, threads}, stream);
}

// K4: as K1, with slots and out the padded [2K, Y+16, X+256] store
// (interior at (8, 128); pads are neither read nor written).
EU_API int eu_march_rebin_padded(int Y, int X, int K, int iters, float h,
                                 float inv_h, const void* u, const void* v,
                                 const void* count, const void* fluid,
                                 const void* solid, const void* dead,
                                 const void* slots, const void* dt,
                                 void* out, void* out_count, void* out_drop,
                                 int tile_y, int tile_x, int tiles_y,
                                 int tiles_x, int threads, void* stream) {
  return march_rebin(true, Y, X, K, iters, h, inv_h, Y, 0, X, 0, u, v, count,
                     fluid, solid, dead, slots, dt, out, out_count, out_drop,
                     {tile_y, tile_x, tiles_y, tiles_x, threads}, stream);
}

// K5: slots, out [2K, Y, X] f32 (the [2, K, Y, X] store).  Slots k < count
// are marched, the rest keep their position.  The tile plan as K1's, for
// K5's layout.
EU_API int eu_march(int Y, int X, int K, int iters, float h, float inv_h,
                    const void* u, const void* v, const void* count,
                    const void* fluid, const void* solid, const void* slots,
                    const void* dt, void* out, int tile_y, int tile_x,
                    int tiles_y, int tiles_x, int threads, void* stream) {
  TileArgs a{};
  a.g = make_grid(Y, X, u, v, fluid, solid);
  a.count = static_cast<const int32_t*>(count);
  a.dt = static_cast<const float*>(dt);
  a.in = slot_store(static_cast<const float*>(slots), K, Y, X, false);
  a.out = slot_store(static_cast<float*>(out), K, Y, X, false);
  a.K = K;
  a.iters = iters;
  a.h = h;
  a.inv_h = inv_h;
  return launch_tiles<Pass::kMarch>(
      march_tiles, a, {tile_y, tile_x, tiles_y, tiles_x, threads}, stream);
}

// K6: slots, out [2K, Y, X] f32; alive, out_alive [K, Y, X] u8 (0/1; any
// slot may be alive); dead [Y, X] u8; out_count, out_drop [Y, X] i32.  The
// tile plan as K1's, for K6's layout.
EU_API int eu_rebin(int Y, int X, int K, float inv_h, const void* slots,
                    const void* alive, const void* dead, void* out,
                    void* out_alive, void* out_count, void* out_drop,
                    int tile_y, int tile_x, int tiles_y, int tiles_x,
                    int threads, void* stream) {
  TileArgs a{};
  a.g = make_grid(Y, X, nullptr, nullptr, nullptr, nullptr);
  a.alive = static_cast<const uint8_t*>(alive);
  a.dead = static_cast<const uint8_t*>(dead);
  a.in = slot_store(static_cast<const float*>(slots), K, Y, X, false);
  a.out = slot_store(static_cast<float*>(out), K, Y, X, false);
  a.out_alive = static_cast<uint8_t*>(out_alive);
  a.out_count = static_cast<int32_t*>(out_count);
  a.out_drop = static_cast<int32_t*>(out_drop);
  a.K = K;
  a.inv_h = inv_h;
  return launch_tiles<Pass::kRebin>(
      rebin_tiles, a, {tile_y, tile_x, tiles_y, tiles_x, threads}, stream);
}
