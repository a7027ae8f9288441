// The two-sweep Jacobi-PCG machinery shared by K12 (jacobi_stream.cu) and
// K8-K10 (jacobi_pcg.cu): the device scalars and flags of one solve, the
// operator's byte code, grid-wide reductions that end in the last CTA of
// the sweep that feeds them, and sweep B.
//
// Reductions in the order of the two-stage form (a sweep writing one
// partial per block of kTile threads, then one block of kChains threads
// folding them with reduce_partials), so every scalar is that form's bit
// for bit: one partial per tile of 256 consecutive cells (common.cuh's
// block_reduce tree), then reduce_partials' 1024-thread fold, in which
// "chain" c is the running value, in order, of tiles c, c + 1024,
// c + 2048, ...  So a sweep's grid is kChains CTAs of a tile's 256
// threads: CTA c walks chain c down the grid, one cell a thread, and keeps
// its running value in a register; nothing per tile reaches device
// memory, and the cross-warp halves of kSteps tiles' trees share one
// barrier pair.  Each CTA writes its chain value and takes a ticket after
// a __threadfence(); the last one folds the kChains values as
// reduce_partials' second stage does.  Changing the CTA count, or the
// tiles a CTA takes, changes the order.  The ticket never spins, so
// nothing depends on all kChains CTAs being resident at once.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 256;     // cells a partial covers: a CTA
constexpr int kChains = 1024;  // reduce_partials' threads: the grid
// CTAs an SM must hold for the whole grid to fit an H100's 132 SMs at once
constexpr int kPerSm = (kChains + 131) / 132;
constexpr int kSteps = 4;  // tiles a chain takes between two barriers

// device scalars and flags of one solve
enum { S_TOL = 0, S_SIGMA, S_ALPHA, S_BETA, S_RESID, S_N };
// F_PENDING: a p update p += alpha s waits for the next sweep A (set with
// the first alpha); F_TICKET: the last-CTA ticket, 0 between sweeps;
// F_CAP: max_iterations, at which sweep B sets F_DONE
enum { F_DONE = 0, F_ITERS, F_PENDING, F_TICKET, F_CAP, F_N };

// the operator code a_diag * fl + 8 * fl (0..12) of a cell
__device__ __forceinline__ int op_code(bool fluid, int a_diag) {
  return fluid ? a_diag + 8 : 0;
}

// invd of every code, in shared memory
__device__ __forceinline__ void load_invd(float* tab) {
  for (int c = threadIdx.x; c < 256; c += kTile)
    tab[c] = decode(static_cast<float>(c)).invd;
  __syncthreads();
}

// the tile of chain blockIdx.x at step k, and this thread's cell in it
__device__ __forceinline__ int tile_at(int k) {
  return k * kChains + static_cast<int>(blockIdx.x);
}
__device__ __forceinline__ int cell_at(int tile) {
  return tile * kTile + static_cast<int>(threadIdx.x);
}

// block_reduce<OP> (common.cuh) over a tile, in two halves so that one
// barrier pair serves kSteps tiles.  The warp half: each warp's tree over
// its lanes, into wp (the step's kTile / 32 slots).
template <int OP>
__device__ __forceinline__ void warp_stage(float v, float* wp) {
  for (int o = 16; o > 0; o >>= 1)
    v = eu_combine<OP>(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) wp[threadIdx.x >> 5] = v;
}

// After a barrier, the cross-warp half, by warp 0, for the kSteps tiles
// from step k0; each tile's value joins the chain's running value (in
// thread 0) in order, tiles past the end left out as reduce_partials'
// loop leaves them out.
template <int OP>
__device__ __forceinline__ void chain_stage(const float (*wp)[kTile / 32],
                                            float* chain, int k0,
                                            int tiles) {
  if (threadIdx.x >= 32) return;
  for (int u = 0; u < kSteps; ++u) {
    float r = threadIdx.x < kTile / 32 ? wp[u][threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      r = eu_combine<OP>(r, __shfl_down_sync(0xffffffffu, r, o));
    if (threadIdx.x == 0 && tile_at(k0 + u) < tiles)
      *chain = eu_combine<OP>(*chain, r);
  }
}

// True in every thread of the CTA that takes the last ticket, when every
// CTA's chain values are visible to it; that CTA resets the ticket.  (The
// barrier, then thread 0's fence before and after its atomic: the
// pattern of a cooperative-groups grid barrier.)
__device__ bool last_cta(int* flags) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(flags + F_TICKET);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) {
      *ticket = 0u;
      __threadfence();
    }
  }
  __syncthreads();
  return last;
}

// reduce_partials' second stage over the kChains chain values, each of
// the kTile threads holding kChains / kTile of its threads' values
// (thread threadIdx.x + q * kTile), read past L1; valid in thread 0
template <int OP>
__device__ float fold_chains(const float* chain) {
  constexpr int kReps = kChains / kTile;
  __shared__ float warp_part[kChains / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kReps; ++q) {
    float x = __ldcg(chain + threadIdx.x + q * kTile);
    for (int o = 16; o > 0; o >>= 1)
      x = eu_combine<OP>(x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) warp_part[warp + q * (kTile / 32)] = x;
  }
  __syncthreads();
  float r = 0.0f;
  if (warp == 0) {
    r = warp_part[lane];
    for (int o = 16; o > 0; o >>= 1)
      r = eu_combine<OP>(r, __shfl_down_sync(0xffffffffu, r, o));
  }
  __syncthreads();
  return r;
}

// Programmatic dependent launch (sm_90): a sweep lets the next kernel of
// its stream launch at once, so that the next sweep's CTAs take the SMs as
// this one's leave, and waits until the kernel before it has finished and
// its writes are visible.  Both return at once in a kernel launched
// without the attribute (K12's host loop).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches `kernel` on the sweep grid (kChains CTAs of kTile threads) on
// st with programmatic stream serialization: it may start while the
// kernel before it runs, and must call wait_prerequisites before reading
// anything that kernel writes.
template <class... Params, class... Args>
int launch_sweep(void (*kernel)(Params...), cudaStream_t st,
                 Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kChains);
  cfg.blockDim = dim3(kTile);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...));
}

// The head's last CTA, thread 0: sigma0 = <invd b, b>, max|b|, the
// effective tolerance, the cap and the all-zero early-out (main.c:742)
__device__ __forceinline__ void init_solve(float sigma0, float rmax0,
                                           float tol, float tol_rel,
                                           int cap, float* scal,
                                           int* flags) {
  scal[S_TOL] = nanmax(tol, tol_rel * rmax0);
  scal[S_SIGMA] = sigma0;
  scal[S_BETA] = 0.0f;
  scal[S_RESID] = rmax0;
  flags[F_DONE] = !(rmax0 != 0.0f) || cap <= 0;
  flags[F_ITERS] = 0;
  flags[F_PENDING] = 0;
  flags[F_CAP] = cap;
}

// Sweep A's last CTA, thread 0: alpha = sigma / <As, s>, and a p update
// is pending
__device__ __forceinline__ void set_alpha(float sigma, float zs,
                                          float* scal, int* flags) {
  scal[S_ALPHA] = sigma / (zs != 0.0f ? zs : 1.0f);
  flags[F_PENDING] = 1;
}

// Every sweep reads the stop flag first; all threads of the grid read the
// same value before any of them can change it, so the early return is
// uniform.  The sweeps read the scalars they need, the last CTA's too,
// into registers before their ticket (the last CTA overwrites them); sweep
// B and K8-K10's sweep A read them before the flag test, so that one
// round trip to memory brings them all, and only after their shared
// table is built and the kernel before them has finished.

// Sweep B: r -= alpha As; the chains of max|r| and <invd r, r>.  The last
// CTA: the NaN-robust stop test not (max|r| > tol), the cap, and
// beta = sigma_new / sigma.
__global__ void __launch_bounds__(kTile, kPerSm)
    sweep_b(int n, const uint8_t* __restrict__ code,
            const float* __restrict__ As, float* __restrict__ r,
            float* __restrict__ chain_sum, float* __restrict__ chain_max,
            float* scal, int* flags) {
  __shared__ float invd[256];
  __shared__ float wp_sum[kSteps][kTile / 32];
  __shared__ float wp_max[kSteps][kTile / 32];
  launch_dependents();
  load_invd(invd);
  wait_prerequisites();
  const bool done = flags[F_DONE] != 0;
  const float alpha = scal[S_ALPHA], sigma = scal[S_SIGMA];
  const float tol = scal[S_TOL];
  const int iters = flags[F_ITERS] + 1, cap = flags[F_CAP];
  if (done) return;
  const int tiles = (n + kTile - 1) / kTile;
  float cs = 0.0f, cm = 0.0f;
  for (int k0 = 0; tile_at(k0) < tiles; k0 += kSteps) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = cell_at(tile_at(k0 + u));
      float zr = 0.0f, rmax = 0.0f;
      if (t < n) {
        const float rv = r[t] - alpha * As[t];
        r[t] = rv;
        rmax = fabsf(rv);
        zr = (invd[code[t]] * rv) * rv;
      }
      warp_stage<EU_SUM>(zr, wp_sum[u]);
      warp_stage<EU_MAX>(rmax, wp_max[u]);
    }
    __syncthreads();
    chain_stage<EU_SUM>(wp_sum, &cs, k0, tiles);
    chain_stage<EU_MAX>(wp_max, &cm, k0, tiles);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    chain_sum[blockIdx.x] = cs;
    chain_max[blockIdx.x] = cm;
  }
  if (!last_cta(flags)) return;
  const float sigma_new = fold_chains<EU_SUM>(chain_sum);
  const float rm = fold_chains<EU_MAX>(chain_max);
  if (threadIdx.x == 0) {
    scal[S_BETA] = sigma_new / (sigma != 0.0f ? sigma : 1.0f);
    scal[S_SIGMA] = sigma_new;
    scal[S_RESID] = rm;
    flags[F_ITERS] = iters;
    flags[F_DONE] = !(rm > tol) || iters >= cap;
  }
}

}  // namespace
