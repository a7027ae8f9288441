// The slot-marker pass for Hopper: K1 (march + re-bin), and the variants
// that share its two halves: K4 (K1 over the persistent padded store), K5
// (the march alone) and K6 (the re-bin alone).
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
// What bounds them on an H100: bytes.  The store is [2K, Y, X] f32 (64 MB
// at 1024², K = 8); K1 reads it once, writes marched positions once,
// gathers them back (L2-resident neighbour reads) and writes the new store
// once, ~200 MB a substep against 3.35 TB/s.  The arithmetic per marker
// (two bilinear samples, a <= 4-step DDA) is small.
//
// Design: two launches, each a template over what the variants change.
//   1. march: one thread per (slot k, cell).  Dead slots (k >= count)
//      return at once (K1, K4: never read downstream) or copy their
//      position through (K5, whose output is the whole store).
//   2. re-bin as a gather: one thread per destination cell walks the
//      source cells in OFFSETS_OWN_FIRST order (own cell, then the 8
//      neighbours lexicographically) and each source's live slots in k
//      order, accepting the markers bound for it.  The running count is
//      the destination slot, so slot assignment is the plain version's
//      exactly, with no atomics: the result is deterministic.  A source
//      slot is live when k < count (K1, K4) or where the alive plane says
//      so (K6, which also writes the new alive plane).
// Every store is addressed through a row pitch and an interior offset
// (`Store`), so K4 reads and writes the padded store in place; its
// `marched` scratch stays unpadded.
// Built with -fmad=false so every product and sum rounds as the plain
// PyTorch version's do: positions and counts match it bit for bit.
#include "common.cuh"

namespace {

__device__ __forceinline__ float time_to(float p0, float p1, float vel) {
  return fabsf(vel) > 0.0f ? (p1 - p0) / vel : FLT_MAX;
}

struct Grid {
  int Y, X;
  const int32_t* __restrict__ count;
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

template <bool kCopyDead>
__global__ void march_kernel(Grid g, int K, Store<const float> in,
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
  if (k >= g.count[cell]) {  // dead slot
    if (kCopyDead) {
      out.px[dst] = in.px[src];
      out.py[dst] = in.py[src];
    }
    return;
  }

  const float dt = *dt_ptr;
  const float px = in.px[src];
  const float py = in.py[src];

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
  out.px[dst] = mx + tt * vx;
  out.py[dst] = my + tt * vy;
}

__device__ __constant__ int kOffsets[9][2] = {
    {0, 0},  {-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
    {0, 1},  {1, -1},  {1, 0},  {1, 1}};

template <bool kAlivePlane>
__global__ void rebin_kernel(int Y, int X, int K,
                             const int32_t* __restrict__ count,
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
      const int n = kAlivePlane ? K : count[src];
      for (int k = 0; k < n; ++k) {
        if (kAlivePlane && !alive[k * plane + src]) continue;
        const long long s = in.at(k, sy, sx);
        const float mx = in.px[s];
        const float my = in.py[s];
        const int ody = min(max(static_cast<int>(floorf(my * inv_h)) - sy,
                                -1), 1);
        const int odx = min(max(static_cast<int>(floorf(mx * inv_h)) - sx,
                                -1), 1);
        if (ody != dy || odx != dx) continue;
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
  if (kAlivePlane)
    for (int d = 0; d < K; ++d) out_alive[d * plane + cell] = d < kept;
  out_count[cell] = kept;
  out_drop[cell] = run - kept;
}

Grid make_grid(int Y, int X, const void* count, const void* u,
               const void* v, const void* fluid, const void* solid) {
  return {Y, X, static_cast<const int32_t*>(count),
          static_cast<const float*>(u), static_cast<const float*>(v),
          static_cast<const uint8_t*>(fluid),
          static_cast<const uint8_t*>(solid)};
}

constexpr int kThreads = 256;

// K1 (padded = false) and K4 (padded = true): march into the unpadded
// scratch, then re-bin into `out`; `slots` and `out` share the layout.
int march_rebin(bool padded, int Y, int X, int K, int iters, float h,
                float inv_h, const void* u, const void* v, const void* count,
                const void* fluid, const void* solid, const void* dead,
                const void* slots, const void* dt, void* marched, void* out,
                void* out_count, void* out_drop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g = make_grid(Y, X, count, u, v, fluid, solid);
  const long long n = static_cast<long long>(K) * Y * X;
  march_kernel<false><<<eu_blocks(n, kThreads), kThreads, 0, s>>>(
      g, K, slot_store(static_cast<const float*>(slots), K, Y, X, padded),
      static_cast<const float*>(dt), iters, h, inv_h,
      slot_store(static_cast<float*>(marched), K, Y, X, false));
  int rc = eu_launch_status();
  if (rc) return rc;
  rebin_kernel<false><<<eu_blocks(static_cast<long long>(Y) * X, kThreads),
                        kThreads, 0, s>>>(
      Y, X, K, static_cast<const int32_t*>(count), nullptr,
      slot_store(static_cast<const float*>(marched), K, Y, X, false),
      static_cast<const uint8_t*>(dead), inv_h,
      slot_store(static_cast<float*>(out), K, Y, X, padded),
      static_cast<int32_t*>(out_count), static_cast<int32_t*>(out_drop),
      nullptr);
  return eu_launch_status();
}

}  // namespace

// K1.  slots/out/marched: [2K, Y, X] f32; count/out_count/out_drop: [Y, X]
// i32; u, v: [Y, X] f32; fluid, solid, dead: [Y, X] u8; dt: one f32 on
// device.
EU_API int eu_march_rebin(int Y, int X, int K, int iters, float h,
                          float inv_h, const void* u, const void* v,
                          const void* count, const void* fluid,
                          const void* solid, const void* dead,
                          const void* slots, const void* dt, void* marched,
                          void* out, void* out_count, void* out_drop,
                          void* stream) {
  return march_rebin(false, Y, X, K, iters, h, inv_h, u, v, count, fluid,
                     solid, dead, slots, dt, marched, out, out_count,
                     out_drop, stream);
}

// K4: as K1, with slots and out the padded [2K, Y+16, X+256] store
// (interior at (8, 128); pads are neither read nor written) and marched
// the unpadded [2K, Y, X] scratch.
EU_API int eu_march_rebin_padded(int Y, int X, int K, int iters, float h,
                                 float inv_h, const void* u, const void* v,
                                 const void* count, const void* fluid,
                                 const void* solid, const void* dead,
                                 const void* slots, const void* dt,
                                 void* marched, void* out, void* out_count,
                                 void* out_drop, void* stream) {
  return march_rebin(true, Y, X, K, iters, h, inv_h, u, v, count, fluid,
                     solid, dead, slots, dt, marched, out, out_count,
                     out_drop, stream);
}

// K5: px, py, out_px, out_py [K, Y, X] f32.  Slots k < count are marched,
// the rest keep their position.
EU_API int eu_march(int Y, int X, int K, int iters, float h, float inv_h,
                    const void* u, const void* v, const void* count,
                    const void* fluid, const void* solid, const void* px,
                    const void* py, const void* dt, void* out_px,
                    void* out_py, void* stream) {
  const long long n = static_cast<long long>(K) * Y * X;
  march_kernel<true><<<eu_blocks(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      make_grid(Y, X, count, u, v, fluid, solid), K,
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
  rebin_kernel<true><<<eu_blocks(static_cast<long long>(Y) * X, kThreads),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Y, X, K, nullptr, static_cast<const uint8_t*>(alive),
      planes(static_cast<const float*>(px), static_cast<const float*>(py), Y,
             X, false),
      static_cast<const uint8_t*>(dead), inv_h,
      planes(static_cast<float*>(out_px), static_cast<float*>(out_py), Y, X,
             false),
      static_cast<int32_t*>(out_count), static_cast<int32_t*>(out_drop),
      static_cast<uint8_t*>(out_alive));
  return eu_launch_status();
}
