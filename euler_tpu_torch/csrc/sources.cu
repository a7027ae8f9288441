// S1: source emission on the slot layout, one launch a substep.
//
// Computes ops/markers_slots.py `source_pass_slots`, the port of
// euler_tpu/ops/markers_slots.py `update_fluid_sources_slots`
// (main.c:276-298).  It is not a port of a Pallas kernel: the JAX package
// runs the emission as a lax.scan over the S sources, which XLA compiles
// into one loop; done as torch ops it would be S x ~25 small launches a
// substep.
//
//   1. The colour pass: r, g, b = hsv_basis(t + 2), hsv_basis(t),
//      hsv_basis(t - 2) at every valid source cell, t = q * frame_count
//      with q = f32(0.6) / f32(source_color_period) from the host.  These
//      are exactly the cells of the scenario's source mask, so this is the
//      plain version's where(source, ...).  Every thread colours a share.
//   2. The emission, in source order, by one thread: a source emits when
//      it is valid, the stream is not exhausted, its cell holds fewer than
//      markers_per_cell and K markers, and the substep is active.  It
//      draws the Y jitter, then the X jitter (gcc's argument order at
//      main.c:288), and only then commits the new RNG state.  The marker
//      goes to slot `count` (slots are front-compacted) at ((x + rx) h,
//      (y + ry) h), its alive bit is set, the count and alive_count go up
//      by one, and the stream is exhausted once alive_count reaches
//      max_markers - 1.
// The sources are walked in chunks: the block first loads a chunk's cell
// indices, validity and counts into shared memory, so the walk itself
// waits on no load.  Sources are distinct cells (padding entries are
// invalid), so a count loaded before the walk is the count the walk sees.
//
// The global layout's form (`source_pass_global`, the port of
// euler_tpu/ops/markers.py `update_fluid_sources`, main.c:276-298) is the
// same walk with the cell limit markers_per_cell alone; its emitted
// markers go, in walk order, to the first free slots of the [2, M] store
// in index order.  The block first finds the first S free slots (a scan
// of the alive mask in chunks of the block's width, stopping once it has
// S), slot 0 standing in for any it does not find (jnp.nonzero's
// padding, markers.py:384-387), into a scratch list.  On a block of the
// grid it takes the same offsets and counts_in as the slot form: every
// block holds the whole store, in marker order, so every block appends
// the same markers to the same slots, and writes colours and counts only
// at its own cells.
//
// On a block of a grid split over ranks (parallel/spatial.py) the planes
// are the block's Y rows and X columns, grid rows row_offset ..
// row_offset + Y - 1 and columns col_offset .. col_offset + X - 1, and
// `counts_in` holds every source cell's count, all-reduced over the
// blocks: the walk reads those, so every block draws the same jitters and
// keeps the same alive_count and exhausted flag, and writes colours and
// counts (and in the slot form markers and alive bits) only where the
// source's row and column both lie in the block, at its local cell (y -
// row_offset) X + (x - col_offset).  With both offsets 0, the whole plane
// and counts_in null the pass is the unsharded one.
//
// Everything is read from and written to the card in place: the store,
// alive plane, counts and colour planes, the RNG state (uint32 [2], hi
// then lo), alive_count, the exhausted flag; active and frame_count are
// read there too, so the host never waits.  Built with -fmad=false, so
// hsv_basis rounds as the plain version's torch ops do; the generator is
// the xorshift64* of misc/rng.c on uint64_t, and randf32 is the
// correctly rounded f32 of the u32 times 2^-32 (the JAX package's
// hi24 * 256 + lo8), so the whole pass is bitwise the plain version's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

// misc/color.h:16-33, in the plain version's operand order
__device__ __forceinline__ float hsv_basis(float t) {
  t = t - 6.0f * floorf(static_cast<float>(1.0 / 6.0) * t);
  if (t < 0.0f) t = t + 6.0f;
  return t < 1.0f ? t : (t < 3.0f ? 1.0f : (t < 4.0f ? 4.0f - t : 0.0f));
}

// xorshift64_32star (misc/rng.c:4-20)
__device__ __forceinline__ uint32_t next32(uint64_t& x) {
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  return static_cast<uint32_t>((x * 0x2545F4914F6CDD1DULL) >> 32);
}

__device__ __forceinline__ float randf32(uint64_t& x) {
  return __uint2float_rn(next32(x)) * 0x1p-32f;
}

struct SourceArgs {
  int S, Y, X, K, per_cell, max_markers, row_offset, col_offset;
  float q, h;
  const int32_t* __restrict__ source_yx;  // [S, 2] (y, x)
  const uint8_t* __restrict__ valid;      // [S]
  const uint8_t* __restrict__ active;     // scalar
  const int32_t* __restrict__ frame_count;
  const int32_t* __restrict__ counts_in;  // [S] or null
  float* __restrict__ markers;            // [2, K, Y, X]
  uint8_t* __restrict__ alive;            // [K, Y, X]
  int32_t* __restrict__ count;            // [Y, X]
  float* __restrict__ r;
  float* __restrict__ g;
  float* __restrict__ b;
  uint32_t* __restrict__ rng;             // [2] (hi, lo)
  int32_t* __restrict__ alive_count;
  uint8_t* __restrict__ exhausted;
};

__global__ void __launch_bounds__(kThreads) source_pass(SourceArgs a) {
  __shared__ int32_t s_cell[kChunk];  // the local cell, -1: not the block's
  __shared__ int32_t s_y[kChunk];     // the grid row and column
  __shared__ int32_t s_x[kChunk];
  __shared__ int32_t s_count[kChunk];
  __shared__ uint8_t s_valid[kChunk];

  const float t = a.q * static_cast<float>(*a.frame_count);
  const float cr = hsv_basis(t + 2.0f);
  const float cg = hsv_basis(t);
  const float cb = hsv_basis(t - 2.0f);
  const size_t plane = static_cast<size_t>(a.K) * a.Y * a.X;

  uint64_t state = 0;
  int ac = 0;
  bool exhausted = false;
  bool active = false;
  if (threadIdx.x == 0) {
    state = (static_cast<uint64_t>(a.rng[0]) << 32) | a.rng[1];
    ac = *a.alive_count;
    exhausted = *a.exhausted != 0 || ac == a.max_markers - 1;
    active = *a.active != 0;
  }
  for (int base = 0; base < a.S; base += kChunk) {
    const int n = min(kChunk, a.S - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int i = base + j;
      const int y = a.source_yx[2 * i], x = a.source_yx[2 * i + 1];
      const int ly = y - a.row_offset, lx = x - a.col_offset;
      const int cell = ly * a.X + lx;
      const uint8_t ok = a.valid[i];
      const bool mine = ly >= 0 && ly < a.Y && lx >= 0 && lx < a.X;
      s_cell[j] = mine ? cell : -1;
      s_y[j] = y;
      s_x[j] = x;
      s_valid[j] = ok;
      s_count[j] = !ok ? 0 : (a.counts_in ? a.counts_in[i] : a.count[cell]);
      if (ok && mine) {
        a.r[cell] = cr;
        a.g[cell] = cg;
        a.b[cell] = cb;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const int c = s_count[j];
        if (s_valid[j] && !exhausted && c < a.per_cell && c < a.K &&
            active) {
          const float ry = randf32(state);
          const float rx = randf32(state);
          const int cell = s_cell[j];
          if (cell >= 0) {
            const size_t slot = static_cast<size_t>(c) * a.Y * a.X + cell;
            a.markers[slot] = (static_cast<float>(s_x[j]) + rx) * a.h;
            a.markers[plane + slot] = (static_cast<float>(s_y[j]) + ry) * a.h;
            a.alive[slot] = 1;
            a.count[cell] = c + 1;
          }
          ac += 1;
        }
        exhausted = exhausted || ac == a.max_markers - 1;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.rng[0] = static_cast<uint32_t>(state >> 32);
    a.rng[1] = static_cast<uint32_t>(state);
    *a.alive_count = ac;
    *a.exhausted = exhausted ? 1 : 0;
  }
}

struct GlobalArgs {
  int S, M, Y, X, per_cell, row_offset, col_offset;
  float q, h;
  const int32_t* __restrict__ source_yx;  // [S, 2] (y, x)
  const uint8_t* __restrict__ valid;      // [S]
  const uint8_t* __restrict__ active;     // scalar
  const int32_t* __restrict__ frame_count;
  const int32_t* __restrict__ counts_in;  // [S] or null
  float* __restrict__ markers;            // [2, M]
  uint8_t* __restrict__ alive;            // [M]
  int32_t* __restrict__ count;            // [Y, X]
  float* __restrict__ r;
  float* __restrict__ g;
  float* __restrict__ b;
  uint32_t* __restrict__ rng;             // [2] (hi, lo)
  int32_t* __restrict__ alive_count;
  uint8_t* __restrict__ exhausted;
  int32_t* __restrict__ free_slot;        // [S] scratch
};

__global__ void __launch_bounds__(kThreads) source_pass_global(
    GlobalArgs a) {
  __shared__ int32_t s_cell[kChunk];  // the local cell, -1: not the block's
  __shared__ int32_t s_y[kChunk];     // the grid row and column
  __shared__ int32_t s_x[kChunk];
  __shared__ int32_t s_count[kChunk];
  __shared__ uint8_t s_valid[kChunk];
  __shared__ int32_t s_warp[kThreads / 32];
  __shared__ int s_found;

  const float t = a.q * static_cast<float>(*a.frame_count);
  const float cr = hsv_basis(t + 2.0f);
  const float cg = hsv_basis(t);
  const float cb = hsv_basis(t - 2.0f);

  // the first S free slots in index order, 0 where there are fewer
  if (threadIdx.x == 0) s_found = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < a.M; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool is_free = i < a.M && !a.alive[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, is_free);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = s_found;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    before += __popc(ballot & ((1u << lane) - 1u));
    if (is_free && before < a.S) a.free_slot[before] = i;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kThreads / 32; ++w) s_found += s_warp[w];
    __syncthreads();
    if (s_found >= a.S) break;
  }
  for (int j = s_found + threadIdx.x; j < a.S; j += kThreads)
    a.free_slot[j] = 0;
  __syncthreads();

  uint64_t state = 0;
  int ac = 0;
  int rank = 0;
  bool exhausted = false;
  bool active = false;
  if (threadIdx.x == 0) {
    state = (static_cast<uint64_t>(a.rng[0]) << 32) | a.rng[1];
    ac = *a.alive_count;
    exhausted = *a.exhausted != 0 || ac == a.M - 1;
    active = *a.active != 0;
  }
  for (int base = 0; base < a.S; base += kChunk) {
    const int n = min(kChunk, a.S - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int i = base + j;
      const int y = a.source_yx[2 * i], x = a.source_yx[2 * i + 1];
      const int ly = y - a.row_offset, lx = x - a.col_offset;
      const int cell = ly * a.X + lx;
      const uint8_t ok = a.valid[i];
      const bool mine = ly >= 0 && ly < a.Y && lx >= 0 && lx < a.X;
      s_cell[j] = mine ? cell : -1;
      s_y[j] = y;
      s_x[j] = x;
      s_valid[j] = ok;
      s_count[j] = !ok ? 0 : (a.counts_in ? a.counts_in[i] : a.count[cell]);
      if (ok && mine) {
        a.r[cell] = cr;
        a.g[cell] = cg;
        a.b[cell] = cb;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const int c = s_count[j];
        if (s_valid[j] && !exhausted && c < a.per_cell && active) {
          const float ry = randf32(state);
          const float rx = randf32(state);
          const int cell = s_cell[j];
          const int slot = a.free_slot[rank];
          a.markers[slot] = (static_cast<float>(s_x[j]) + rx) * a.h;
          a.markers[a.M + slot] = (static_cast<float>(s_y[j]) + ry) * a.h;
          a.alive[slot] = 1;
          if (cell >= 0) a.count[cell] = c + 1;
          rank += 1;
          ac += 1;
        }
        exhausted = exhausted || ac == a.M - 1;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.rng[0] = static_cast<uint32_t>(state >> 32);
    a.rng[1] = static_cast<uint32_t>(state);
    *a.alive_count = ac;
    *a.exhausted = exhausted ? 1 : 0;
  }
}

}  // namespace

// S1's global form: as eu_source_pass on the [2, M] store and [M] alive
// mask (M = max_markers), free_slot an [S] i32 scratch.
EU_API int eu_source_pass_global(int S, int M, int Y, int X, int per_cell,
                                 int row_offset, int col_offset, float q,
                                 float h, const void* source_yx,
                                 const void* valid, const void* active,
                                 const void* frame_count,
                                 const void* counts_in, void* markers,
                                 void* alive, void* count, void* r, void* g,
                                 void* b, void* rng, void* alive_count,
                                 void* exhausted, void* free_slot,
                                 void* stream) {
  GlobalArgs a{};
  a.S = S;
  a.M = M;
  a.Y = Y;
  a.X = X;
  a.per_cell = per_cell;
  a.row_offset = row_offset;
  a.col_offset = col_offset;
  a.counts_in = static_cast<const int32_t*>(counts_in);
  a.q = q;
  a.h = h;
  a.source_yx = static_cast<const int32_t*>(source_yx);
  a.valid = static_cast<const uint8_t*>(valid);
  a.active = static_cast<const uint8_t*>(active);
  a.frame_count = static_cast<const int32_t*>(frame_count);
  a.markers = static_cast<float*>(markers);
  a.alive = static_cast<uint8_t*>(alive);
  a.count = static_cast<int32_t*>(count);
  a.r = static_cast<float*>(r);
  a.g = static_cast<float*>(g);
  a.b = static_cast<float*>(b);
  a.rng = static_cast<uint32_t*>(rng);
  a.alive_count = static_cast<int32_t*>(alive_count);
  a.exhausted = static_cast<uint8_t*>(exhausted);
  a.free_slot = static_cast<int32_t*>(free_slot);
  source_pass_global<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return eu_launch_status();
}

// S1: the planes are the Y rows and X columns from grid row row_offset and
// column col_offset (0, 0 and the whole plane, unsharded); counts_in:
// null, or [S] i32 every source cell's count (a block's walk).
EU_API int eu_source_pass(int S, int Y, int X, int K, int per_cell,
                          int max_markers, int row_offset, int col_offset,
                          float q, float h,
                          const void* source_yx, const void* valid,
                          const void* active, const void* frame_count,
                          const void* counts_in, void* markers, void* alive,
                          void* count, void* r, void* g, void* b, void* rng,
                          void* alive_count, void* exhausted, void* stream) {
  SourceArgs a{};
  a.S = S;
  a.Y = Y;
  a.X = X;
  a.K = K;
  a.per_cell = per_cell;
  a.max_markers = max_markers;
  a.row_offset = row_offset;
  a.col_offset = col_offset;
  a.counts_in = static_cast<const int32_t*>(counts_in);
  a.q = q;
  a.h = h;
  a.source_yx = static_cast<const int32_t*>(source_yx);
  a.valid = static_cast<const uint8_t*>(valid);
  a.active = static_cast<const uint8_t*>(active);
  a.frame_count = static_cast<const int32_t*>(frame_count);
  a.markers = static_cast<float*>(markers);
  a.alive = static_cast<uint8_t*>(alive);
  a.count = static_cast<int32_t*>(count);
  a.r = static_cast<float*>(r);
  a.g = static_cast<float*>(g);
  a.b = static_cast<float*>(b);
  a.rng = static_cast<uint32_t*>(rng);
  a.alive_count = static_cast<int32_t*>(alive_count);
  a.exhausted = static_cast<uint8_t*>(exhausted);
  source_pass<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return eu_launch_status();
}
