// The slot-marker pass for Hopper: K1 (march + re-bin) and K4 (K1 over
// the persistent padded store) as one tiled launch, and the unfused pair
// that shares its march: K5 (the march alone) and K6 (the re-bin alone).
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
// What bounds them on an H100: bytes.  K1 returns a whole new [2K, Y, X]
// f32 store (64 MB at 1024², K = 8; slots at and beyond a cell's count are
// zero), and reads u, v, the masks, the counts and the live positions
// once.  The arithmetic per marker (two bilinear samples, a <= 4-step
// DDA) is small.
//
// K1 / K4 (`march_rebin_tiles`): one CTA per tile of TY x TX destination
// cells.  A marker moves at most one cell a substep (the re-bin clamps
// every offset to [-1, 1]), so the tile's arrivals all come from the
// tile and a one-cell halo around it.
//   0. Load the halo's counts into shared memory.  Where the halo holds a
//      live marker, take their block-wide exclusive prefix: live marker j
//      of the halo is slot j - start[s] of the halo cell s with
//      start[s] <= j < start[s + 1].
//   1. March every live marker of the halo, one thread per marker (no
//      thread for a dead slot), into shared memory with its destination
//      offset as a code 0..8.  A halo marker is marched by every CTA
//      whose halo holds it; each march is a pure function of its inputs,
//      so the copies agree bit for bit.
//   2. One thread per destination cell walks the source cells in
//      OFFSETS_OWN_FIRST order (own cell, then the 8 neighbours
//      lexicographically) and each source's live slots in k order,
//      picking the markers bound for it.  The running count is the
//      destination slot, so the slot assignment is the plain version's
//      exactly, with no atomics.  It then writes its K slots plane by
//      plane (a warp's 32 cells of a tile row on one plane are one
//      coalesced store), zeros beyond min(run, K), the count and the drop.
// A tile whose halo holds no live marker skips 1 and the walk of 2 and
// writes zeros (the Pallas kernel's skip_tile).  No scratch lives in device
// memory.  The store is addressed through a row pitch and an interior
// offset (`Store`), so K4 reads and writes the padded store in place and
// leaves its pads unwritten.
// K5 marches one thread per (slot, cell) and copies dead slots through;
// K6 gathers as step 2 does, from device memory, one thread per
// destination.  K1, K4 and K5 march through one function, `march_marker`.
// Built with -fmad=false so every product and sum rounds as the plain
// PyTorch version's do: positions and counts match it bit for bit.
#include "common.cuh"

namespace {

__device__ __forceinline__ float time_to(float p0, float p1, float vel) {
  return fabsf(vel) > 0.0f ? (p1 - p0) / vel : FLT_MAX;
}

// The planes the march reads: u, v and the fluid and solid masks (a read
// beyond the grid gives 0), with the velocity samples and the solid probe.
struct Grid {
  int Y, X;
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
  // interpolate_stencil of u (size (X-1, Y)) / v (size (X, Y-1))
  __device__ float interp_u(float idx_x, float idx_y, int sx, int sy) const {
    int bx, by;
    float fx, fy;
    clamped_base(idx_x, sx, X - 1, &bx, &fx);
    clamped_base(idx_y, sy, Y, &by, &fy);
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
    clamped_base(idx_x, sx, X, &bx, &fx);
    clamped_base(idx_y, sy, Y - 1, &by, &fy);
    bool v00 = vprop(by, bx), v01 = vprop(by, bx + 1);
    bool v10 = vprop(by + 1, bx), v11 = vprop(by + 1, bx + 1);
    float q00 = v00 ? ld(v, by, bx, Y, X) : 0.0f;
    float q01 = v01 ? ld(v, by, bx + 1, Y, X) : 0.0f;
    float q10 = v10 ? ld(v, by + 1, bx, Y, X) : 0.0f;
    float q11 = v11 ? ld(v, by + 1, bx + 1, Y, X) : 0.0f;
    return bilinear(q00, q01, q10, q11, fx, fy, v00, v01, v10, v11);
  }
  // solid probe within the 3x3 window of site (sy, sx)
  __device__ bool solid_at(int yy, int xx, int sy, int sx) const {
    int dy = min(max(yy - sy, -1), 1), dx = min(max(xx - sx, -1), 1);
    return ld(solid, sy + dy, sx + dx, Y, X) != 0;
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

template <typename T>
Store<T> planes(T* px, T* py, int Y, int X, bool padded) {
  const int Yp = padded ? Y + 2 * kPadY : Y, Xp = padded ? X + 2 * kPadX : X;
  return {px, py, static_cast<long long>(Yp) * Xp, Xp, padded ? kPadY : 0,
          padded ? kPadX : 0};
}

// px planes 0..K-1, then py planes K..2K-1
template <typename T>
Store<T> slot_store(T* slots, int K, int Y, int X, bool padded) {
  Store<T> s = planes(slots, slots, Y, X, padded);
  s.py = slots + K * s.plane;
  return s;
}

// March one live marker at (px, py), homed in cell (y, x), through dt:
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

// The destination of a marker at (mx, my) homed in (sy, sx): the offset
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

// K5: one thread per (slot k, cell); dead slots (k >= count) keep their
// position.
__global__ void march_kernel(Grid g,
                             const int32_t* __restrict__ count, int K,
                             Store<const float> in,
                             const float* __restrict__ dt_ptr, int iters,
                             float h, float inv_h, Store<float> out) {
  const long long plane = static_cast<long long>(g.Y) * g.X;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= K * plane) return;
  const int k = static_cast<int>(t / plane);
  const int cell = static_cast<int>(t - k * plane);
  const int y = cell / g.X, x = cell - y * g.X;
  const long long src = in.at(k, y, x), dst = out.at(k, y, x);
  if (k >= count[cell]) {
    out.px[dst] = in.px[src];
    out.py[dst] = in.py[src];
    return;
  }
  const float2 m = march_marker(g, in.px[src], in.py[src], y, x, *dt_ptr,
                                iters, h, inv_h);
  out.px[dst] = m.x;
  out.py[dst] = m.y;
}

// K6: one thread per destination cell; a source slot takes part where the
// alive plane says so.  Also writes the new alive plane.
__global__ void rebin_kernel(int Y, int X, int K,
                             const uint8_t* __restrict__ alive,
                             Store<const float> in,
                             const uint8_t* __restrict__ dead, float inv_h,
                             Store<float> out,
                             int32_t* __restrict__ out_count,
                             int32_t* __restrict__ out_drop,
                             uint8_t* __restrict__ out_alive) {
  const long long plane = static_cast<long long>(Y) * X;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= plane) return;
  const int y = cell / X, x = cell - y * X;
  int run = 0;
  if (!dead[cell]) {
    for (int o = 0; o < 9; ++o) {
      const int dy = kOffsets[o][0], dx = kOffsets[o][1];
      const int sy = y - dy, sx = x - dx;
      if (sy < 0 || sy >= Y || sx < 0 || sx >= X) continue;
      const int src = sy * X + sx;
      for (int k = 0; k < K; ++k) {
        if (!alive[k * plane + src]) continue;
        const long long s = in.at(k, sy, sx);
        const float mx = in.px[s];
        const float my = in.py[s];
        if (dest_code(mx, my, sy, sx, inv_h) != (dy + 1) * 3 + dx + 1)
          continue;
        if (run < K) {
          const long long d = out.at(run, y, x);
          out.px[d] = mx;
          out.py[d] = my;
        }
        ++run;
      }
    }
  }
  const int kept = min(run, K);
  for (int d = kept; d < K; ++d) {
    const long long o = out.at(d, y, x);
    out.px[o] = 0.0f;
    out.py[o] = 0.0f;
  }
  for (int d = 0; d < K; ++d) out_alive[d * plane + cell] = d < kept;
  out_count[cell] = kept;
  out_drop[cell] = run - kept;
}

// The shared memory of one K1 / K4 tile of TY x TX destination cells and
// its halo of H = (TY + 2)(TX + 2) source cells, in this order: the
// marched positions of the halo's live markers in (cell, slot) order, H K
// float2; the exclusive prefix of the halo's counts, H + 1 ints; the
// scan's 32 warp sums; each destination's picked markers, slot-major, TY
// TX K u16 (so H K may not exceed 65536); the destination code of each
// marched marker, H K bytes.  ops/cuda/marker_fused_kernel.py
// `tile_smem_bytes` computes the same total.
struct TileLayout {
  int HX, H, T, K;
  __host__ __device__ TileLayout(int ty, int tx, int k)
      : HX(tx + 2), H((ty + 2) * (tx + 2)), T(ty * tx), K(k) {}
  __host__ __device__ size_t bytes() const {
    return 9ull * H * K + 4ull * (H + 1) + 4ull * 32 + 2ull * T * K;
  }
};

constexpr int kTileThreadsMax = 512;

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

// K1 and K4: one CTA per tile (see the top of this file).
__global__ void __launch_bounds__(kTileThreadsMax, 2)
march_rebin_tiles(Grid g, const int32_t* __restrict__ count, int K,
                  Store<const float> in, const float* __restrict__ dt_ptr,
                  int iters, float h, float inv_h,
                  const uint8_t* __restrict__ dead, Store<float> out,
                  int32_t* __restrict__ out_count,
                  int32_t* __restrict__ out_drop, int TY, int TX) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout L(TY, TX, K);
  float2* pos = reinterpret_cast<float2*>(smem);
  int* start = reinterpret_cast<int*>(pos + L.H * K);
  int* warp_sum = start + L.H + 1;
  uint16_t* pick = reinterpret_cast<uint16_t*>(warp_sum + 32);
  uint8_t* code = reinterpret_cast<uint8_t*>(pick + L.T * K);
  const int t = threadIdx.x, nt = blockDim.x;
  const int Y = g.Y, X = g.X;
  const int hy0 = blockIdx.y * TY - 1, hx0 = blockIdx.x * TX - 1;

  // 0. the halo's counts (0 beyond the grid); where the halo holds a live
  // marker, their prefix
  int any = 0;
  for (int s = t; s < L.H; s += nt) {
    const int y = hy0 + s / L.HX, x = hx0 + s % L.HX;
    start[s] = (y >= 0 && y < Y && x >= 0 && x < X)
                   ? min(max(count[y * X + x], 0), K)
                   : 0;
    any |= start[s];
  }
  const bool live = __syncthreads_or(any);
  if (live) {
    const int total = exclusive_scan(start, L.H, warp_sum);

    // 1. march the halo's live markers into shared memory
    const float dt = *dt_ptr;
    for (int j = t; j < total; j += nt) {
      int s = 0, hi = L.H;  // start[s] <= j < start[hi]
      while (hi - s > 1) {
        const int mid = (s + hi) >> 1;
        if (start[mid] <= j) s = mid; else hi = mid;
      }
      const int y = hy0 + s / L.HX, x = hx0 + s % L.HX;
      const long long src = in.at(j - start[s], y, x);
      const float2 m = march_marker(g, in.px[src], in.py[src], y, x, dt,
                                    iters, h, inv_h);
      pos[j] = m;
      code[j] = static_cast<uint8_t>(dest_code(m.x, m.y, y, x, inv_h));
    }
    __syncthreads();
  }

  // 2. gather each destination's arrivals, then write its slots
  for (int c = t; c < L.T; c += nt) {
    const int ty = c / TX, tx = c - ty * TX;
    const int y = hy0 + 1 + ty, x = hx0 + 1 + tx;
    if (y >= Y || x >= X) continue;
    const int cell = y * X + x;
    int run = 0;
    if (live && !dead[cell]) {
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
      const long long o = out.at(d, y, x);
      out.px[o] = m.x;
      out.py[o] = m.y;
    }
    out_count[cell] = kept;
    out_drop[cell] = run - kept;
  }
}

Grid make_grid(int Y, int X, const void* u, const void* v,
               const void* fluid, const void* solid) {
  return {Y, X, static_cast<const float*>(u), static_cast<const float*>(v),
          static_cast<const uint8_t*>(fluid),
          static_cast<const uint8_t*>(solid)};
}

constexpr int kThreads = 256;

// The launch of K1 / K4: tiles_y x tiles_x CTAs of `threads` threads (a
// multiple of 32, at most kTileThreadsMax), each a tile of tile_y x tile_x
// cells; the tiles must cover the grid.
struct TilePlan {
  int tile_y, tile_x, tiles_y, tiles_x, threads;
};

// K1 (padded = false) and K4 (padded = true); `slots` and `out` share the
// layout.
int march_rebin(bool padded, int Y, int X, int K, int iters, float h,
                float inv_h, const void* u, const void* v, const void* count,
                const void* fluid, const void* solid, const void* dead,
                const void* slots, const void* dt, void* out,
                void* out_count, void* out_drop, TilePlan p, void* stream) {
  const TileLayout L(p.tile_y, p.tile_x, K);
  if (p.tile_y < 1 || p.tile_x < 1 || K < 1 || L.H * K > 65536 ||
      static_cast<long long>(p.tiles_y) * p.tile_y < Y ||
      static_cast<long long>(p.tiles_x) * p.tile_x < X ||
      p.threads < 32 || p.threads > kTileThreadsMax || p.threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = L.bytes();
  static size_t allowed = 48 * 1024;  // without the opt-in below
  if (bytes > allowed) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        march_rebin_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    if (rc) return rc;
    allowed = bytes;
  }
  march_rebin_tiles<<<dim3(p.tiles_x, p.tiles_y), p.threads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      make_grid(Y, X, u, v, fluid, solid),
      static_cast<const int32_t*>(count), K,
      slot_store(static_cast<const float*>(slots), K, Y, X, padded),
      static_cast<const float*>(dt), iters, h, inv_h,
      static_cast<const uint8_t*>(dead),
      slot_store(static_cast<float*>(out), K, Y, X, padded),
      static_cast<int32_t*>(out_count), static_cast<int32_t*>(out_drop),
      p.tile_y, p.tile_x);
  return eu_launch_status();
}

}  // namespace

// K1.  slots/out: [2K, Y, X] f32; count/out_count/out_drop: [Y, X] i32;
// u, v: [Y, X] f32; fluid, solid, dead: [Y, X] u8; dt: one f32 on device;
// the tile plan (tile_y, tile_x, tiles_y, tiles_x, threads) from
// ops/cuda/marker_fused_kernel.py `tile_plan`.
EU_API int eu_march_rebin(int Y, int X, int K, int iters, float h,
                          float inv_h, const void* u, const void* v,
                          const void* count, const void* fluid,
                          const void* solid, const void* dead,
                          const void* slots, const void* dt, void* out,
                          void* out_count, void* out_drop, int tile_y,
                          int tile_x, int tiles_y, int tiles_x, int threads,
                          void* stream) {
  return march_rebin(false, Y, X, K, iters, h, inv_h, u, v, count, fluid,
                     solid, dead, slots, dt, out, out_count, out_drop,
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
  return march_rebin(true, Y, X, K, iters, h, inv_h, u, v, count, fluid,
                     solid, dead, slots, dt, out, out_count, out_drop,
                     {tile_y, tile_x, tiles_y, tiles_x, threads}, stream);
}

// K5: px, py, out_px, out_py [K, Y, X] f32.  Slots k < count are marched,
// the rest keep their position.
EU_API int eu_march(int Y, int X, int K, int iters, float h, float inv_h,
                    const void* u, const void* v, const void* count,
                    const void* fluid, const void* solid, const void* px,
                    const void* py, const void* dt, void* out_px,
                    void* out_py, void* stream) {
  const long long n = static_cast<long long>(K) * Y * X;
  march_kernel<<<eu_blocks(n, kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      make_grid(Y, X, u, v, fluid, solid),
      static_cast<const int32_t*>(count), K,
      planes(static_cast<const float*>(px), static_cast<const float*>(py), Y,
             X, false),
      static_cast<const float*>(dt), iters, h, inv_h,
      planes(static_cast<float*>(out_px), static_cast<float*>(out_py), Y, X,
             false));
  return eu_launch_status();
}

// K6: px, py, out_px, out_py [K, Y, X] f32; alive, out_alive [K, Y, X] u8
// (0/1); dead [Y, X] u8; out_count, out_drop [Y, X] i32.
EU_API int eu_rebin(int Y, int X, int K, float inv_h, const void* px,
                    const void* py, const void* alive, const void* dead,
                    void* out_px, void* out_py, void* out_alive,
                    void* out_count, void* out_drop, void* stream) {
  rebin_kernel<<<eu_blocks(static_cast<long long>(Y) * X, kThreads),
                 kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Y, X, K, static_cast<const uint8_t*>(alive),
      planes(static_cast<const float*>(px), static_cast<const float*>(py), Y,
             X, false),
      static_cast<const uint8_t*>(dead), inv_h,
      planes(static_cast<float*>(out_px), static_cast<float*>(out_py), Y, X,
             false),
      static_cast<int32_t*>(out_count), static_cast<int32_t*>(out_drop),
      static_cast<uint8_t*>(out_alive));
  return eu_launch_status();
}
