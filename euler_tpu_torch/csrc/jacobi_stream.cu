// K12: Jacobi-PCG with the As recurrence for Hopper — the speed mode's
// solve of grids beyond K8's gate (4096² in `bench.py --size 4096
// --precon jacobi`).
//
// Replaces the Pallas kernel euler_tpu/ops/pallas/pcg_stream_kernel.py
// `_stream_kernel` (launched by `solve_pressure_stream`).  Ported is what
// it computes: Jacobi-PCG from p = 0 in the form s' = z + beta s,
// As' = A z + beta As with z = invd r recomputed on the cell and its four
// neighbours, so the operator is applied once an iteration and only to
// r.  Its TPU devices (HBM row windows, b aliased as r) are not.
//
// What bounds it on an H100: bytes.  The recurrence needs 10.5 plane
// passes an iteration (705 MB at 4096², 0.210 ms at 3.35 TB/s), and two
// grid-wide reductions (<As, s>; max|r| with <invd r, r>) that every
// CTA must wait for.
//
// Design: two launches an iteration, each a sweep whose last CTA ends
// the reduction.
//   * The operator is one byte a cell, code = a_diag * fl + 8 * fl
//     (0..12), decoded through a per-CTA table to the f32 `decode` of
//     the packed plane K8 reads, bit for bit.
//   * Sweep A: p += alpha s with the previous iteration's alpha and s,
//     then s = z + beta s and As = A z + beta As, and <As, s>.  The p
//     update is guarded by a flag on the device ("p update pending", set
//     once an alpha exists), not by alpha = 0: with an inf in b, 0 * inf
//     would be NaN.  Sweep B: r -= alpha As, max|r| and <invd r, r>.
//     Sweep A reads code, r, s, As and p and writes s, As and p (7.25
//     planes); sweep B reads code, r and As and writes r (3.25).
//   * Reductions in the order of the four-launch form this replaces (a
//     sweep and a single-block reduction each, twice), so every scalar
//     is its bit for bit: the grid is chain_reduce.cuh's 1024 CTAs, each
//     walking one of reduce_partials' strided sums down the grid, and
//     the last CTA to take the ticket folds them and computes alpha
//     (sweep A) or beta, the residual and the stop flag (sweep B, shared
//     with K8-K10).  The card never drains between a sweep and its
//     reduction.
//   * The host launches the two sweeps and reads the stop flag every
//     kCheckEvery iterations; every sweep returns at once when the flag
//     is set.  One finishing launch applies the pending p update once and
//     folds max|r| into the residual.
// Built with -fmad=false and with the plain version's operand order
// (ops/cuda/pcg_stream_kernel.py), so every sweep rounds as the plain
// PyTorch version does; only the order of the reductions differs.
#include "chain_reduce.cuh"

namespace {

constexpr int kCheckEvery = 8;

// Each kernel walks its chain kSteps steps at a time: the steps' cells
// (sweep B's loads of all kSteps at once; the others one step after the
// other, which their registers allow), the warp halves of the tile
// reductions, a barrier, the cross-warp halves, a barrier.

// code = a_diag * fl + 8 * fl; r = b, s = invd b, As = 0, p = 0; the
// chains of <invd b, b> and max |b|.  The last CTA: init_solve.
__global__ void __launch_bounds__(kTile, kPerSm)
    head(int n, int cap, float tol, float tol_rel,
         const int32_t* __restrict__ a_diag,
         const uint8_t* __restrict__ fl, const float* __restrict__ b,
         uint8_t* __restrict__ code, float* __restrict__ r,
         float* __restrict__ s, float* __restrict__ As,
         float* __restrict__ p, float* __restrict__ chain_sum,
         float* __restrict__ chain_max, float* scal, int* flags) {
  __shared__ float wp_sum[kSteps][kTile / 32];
  __shared__ float wp_max[kSteps][kTile / 32];
  const int tiles = (n + kTile - 1) / kTile;
  float cs = 0.0f, cm = 0.0f;
  for (int k0 = 0; tile_at(k0) < tiles; k0 += kSteps) {
#pragma unroll 1
    for (int u = 0; u < kSteps; ++u) {
      const int t = cell_at(tile_at(k0 + u));
      float zr = 0.0f, bmax = 0.0f;
      if (t < n) {
        const int c = op_code(fl[t] != 0, a_diag[t]);
        const float bv = b[t];
        const float z = decode(static_cast<float>(c)).invd * bv;
        code[t] = static_cast<uint8_t>(c);
        r[t] = bv;
        s[t] = z;
        As[t] = 0.0f;
        p[t] = 0.0f;
        zr = z * bv;
        bmax = fabsf(bv);
      }
      warp_stage<EU_SUM>(zr, wp_sum[u]);
      warp_stage<EU_MAX>(bmax, wp_max[u]);
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
  const float sigma0 = fold_chains<EU_SUM>(chain_sum);
  const float rmax0 = fold_chains<EU_MAX>(chain_max);
  if (threadIdx.x == 0)
    init_solve(sigma0, rmax0, tol, tol_rel, cap, scal, flags);
}

// Every sweep reads the stop flag first; all threads of the grid read the
// same value before any of them can change it, so the early return is
// uniform.

// Sweep A: the pending p += alpha s; z = invd r on the cell and its
// neighbours; s = z + beta s; As = A z + beta As; the chains of
// <As, s>.  The last CTA: alpha = sigma / <As, s>, and a p update is
// pending.
__global__ void __launch_bounds__(kTile, kPerSm)
    sweep_a(int Y, int X, const uint8_t* __restrict__ code,
            const float* __restrict__ r, float* __restrict__ s,
            float* __restrict__ As, float* __restrict__ p,
            float* __restrict__ chain, float* scal, int* flags) {
  if (flags[F_DONE]) return;
  __shared__ float invd[256];
  __shared__ float wp[kSteps][kTile / 32];
  load_invd(invd);
  const float alpha = scal[S_ALPHA], beta = scal[S_BETA];
  const bool pending = flags[F_PENDING] != 0;
  const int n = Y * X;
  const int tiles = (n + kTile - 1) / kTile;
  auto z_at = [&](int i, int j) {
    if (i < 0 || i >= Y || j < 0 || j >= X) return 0.0f;
    const int k = i * X + j;
    return invd[code[k]] * r[k];
  };
  float cs = 0.0f;
  for (int k0 = 0; tile_at(k0) < tiles; k0 += kSteps) {
#pragma unroll 1
    for (int u = 0; u < kSteps; ++u) {
      const int t = cell_at(tile_at(k0 + u));
      float acc = 0.0f;
      if (t < n) {
        const int y = t / X, x = t - y * X;
        const int c = code[t];
        const Cell cell = decode(static_cast<float>(c));
        const float z = invd[c] * r[t];
        float nb = z_at(y, x - 1) + z_at(y, x + 1);
        nb = nb + z_at(y - 1, x);
        nb = nb + z_at(y + 1, x);
        const float az = cell.fl * (cell.a * z - nb);
        const float so = s[t];
        if (pending) p[t] = p[t] + alpha * so;
        const float sn = z + beta * so;
        const float an = az + beta * As[t];
        s[t] = sn;
        As[t] = an;
        acc = an * sn;
      }
      warp_stage<EU_SUM>(acc, wp[u]);
    }
    __syncthreads();
    chain_stage<EU_SUM>(wp, &cs, k0, tiles);
    __syncthreads();
  }
  if (threadIdx.x == 0) chain[blockIdx.x] = cs;
  if (!last_cta(flags)) return;
  const float zs = fold_chains<EU_SUM>(chain);
  if (threadIdx.x == 0) set_alpha(scal[S_SIGMA], zs, scal, flags);
}

// After the loop, not guarded by the stop flag: the pending p += alpha s,
// once; the chains of max|r|, which the last CTA folds into the solve's
// final residual.
__global__ void __launch_bounds__(kTile, kPerSm)
    finish(int n, const float* __restrict__ s, const float* __restrict__ r,
           float* __restrict__ p, float* __restrict__ chain, float* scal,
           int* flags) {
  __shared__ float wp[kSteps][kTile / 32];
  const float alpha = scal[S_ALPHA];
  const bool pending = flags[F_PENDING] != 0;
  const int tiles = (n + kTile - 1) / kTile;
  float cm = 0.0f;
  for (int k0 = 0; tile_at(k0) < tiles; k0 += kSteps) {
#pragma unroll 1
    for (int u = 0; u < kSteps; ++u) {
      const int t = cell_at(tile_at(k0 + u));
      float m = 0.0f;
      if (t < n) {
        if (pending) p[t] = p[t] + alpha * s[t];
        m = fabsf(r[t]);
      }
      warp_stage<EU_MAX>(m, wp[u]);
    }
    __syncthreads();
    chain_stage<EU_MAX>(wp, &cm, k0, tiles);
    __syncthreads();
  }
  if (threadIdx.x == 0) chain[blockIdx.x] = cm;
  if (!last_cta(flags)) return;
  const float rmax = fold_chains<EU_MAX>(chain);
  if (threadIdx.x == 0) {
    scal[S_RESID] = rmax;
    flags[F_PENDING] = 0;
  }
}

}  // namespace

// K12: A p = b from p = 0, with a_diag ([Y, X] i32, the count of
// non-solid neighbours, 0-4) and fl ([Y, X] u8).  code: [Y, X] u8; r, p,
// s, As: [Y, X] f32 (p ends as the solution); chains: 2 * 1024 f32;
// scal: S_N f32; flags: F_N i32.  The iteration count and the final
// max|r| stay on the device (flags[F_ITERS], scal[S_RESID]).
EU_API int eu_jacobi_stream_solve(int Y, int X, int max_iters, float tol,
                                  float tol_rel, const void* a_diag,
                                  const void* fl, const void* b, void* code,
                                  void* r, void* p, void* s, void* As,
                                  void* chains, void* scal, void* flags,
                                  void* stream) {
  const int n = Y * X;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* cd = static_cast<uint8_t*>(code);
  float* rp = static_cast<float*>(r);
  float* pp = static_cast<float*>(p);
  float* sp = static_cast<float*>(s);
  float* ap = static_cast<float*>(As);
  float* chain_sum = static_cast<float*>(chains);
  float* chain_max = chain_sum + kChains;
  float* sc = static_cast<float*>(scal);
  int* fg = static_cast<int*>(flags);
  // the ticket starts at 0
  int rc = static_cast<int>(cudaMemsetAsync(fg, 0, sizeof(int) * F_N, st));
  if (rc) return rc;
  head<<<kChains, kTile, 0, st>>>(n, max_iters, tol, tol_rel,
                                   static_cast<const int32_t*>(a_diag),
                                   static_cast<const uint8_t*>(fl),
                                   static_cast<const float*>(b), cd, rp, sp,
                                   ap, pp, chain_sum, chain_max, sc, fg);
  if ((rc = eu_launch_status())) return rc;
  for (int it = 0; it < max_iters; ++it) {
    if (it % kCheckEvery == 0) {
      int done = 0;
      if ((rc = static_cast<int>(cudaMemcpyAsync(
               &done, fg + F_DONE, sizeof(int), cudaMemcpyDeviceToHost,
               st))))
        return rc;
      if ((rc = static_cast<int>(cudaStreamSynchronize(st)))) return rc;
      if (done) break;
    }
    sweep_a<<<kChains, kTile, 0, st>>>(Y, X, cd, rp, sp, ap, pp, chain_sum,
                                        sc, fg);
    if ((rc = eu_launch_status())) return rc;
    sweep_b<<<kChains, kTile, 0, st>>>(n, cd, ap, rp, chain_sum, chain_max,
                                        sc, fg);
    if ((rc = eu_launch_status())) return rc;
  }
  finish<<<kChains, kTile, 0, st>>>(n, sp, rp, pp, chain_max, sc, fg);
  return eu_launch_status();
}
