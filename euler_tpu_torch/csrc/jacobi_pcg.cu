// K8, K9, K10: Jacobi-preconditioned CG for Hopper — the
// reference-budget "speed mode" solve alone (K8), between the divergence
// RHS and the clamp + face update (K9), and behind K2's grid stage as well
// (K10).
//
// Replaces the Pallas kernels euler_tpu/ops/pallas/pcg_kernel.py
// `_pcg_kernel` (launched by `solve_pressure_pallas`) and
// `_project_kernel` (launched by `project_pallas`),
// euler_tpu/ops/pallas/substep_kernel.py `_substep_jacobi_kernel`
// (launched by `project_substep_jacobi`).  Ported is what they compute,
// the three-pass form As = A s of the updated s (not K12's As
// recurrence, which rounds differently); their TPU devices (row chunks,
// the VMEM plan) are not.
//
// What bounds it on an H100: bytes, iteration by iteration, and two
// grid-wide reductions an iteration (<As, s>; max|r| with <invd r, r>)
// that every CTA must wait for.  Two sweeps move 9.5 [Y, X] plane passes
// (40 MB at 1024², 11.9 us at 3.35 TB/s; the live planes fit the 50 MB
// L2, so that bounds the floor from above).
//
// Design: the schedule, the memory layout and the host's part differ
// from the plain loop; the arithmetic does not.
//   * Two launches an iteration, each a sweep whose last CTA ends the
//     reduction (chain_reduce.cuh, shared with K12) in the order of the
//     two-stage reduction of the plain loop's kernels, so every scalar is
//     theirs bit for bit.  Each sweep is launched to overlap the one
//     before it (programmatic dependent launch: its CTAs start and build
//     their table while the previous sweep's last CTAs finish, then wait
//     for it).  Sweep A of iteration k: the pending
//     p += alpha s_{k-1} (guarded by a device flag, not by alpha = 0:
//     0 * inf is NaN); s_k = invd r + beta s_{k-1} on the cell and
//     recomputed on its four neighbours (iteration 1, by the device's
//     iteration count: s_1 = invd r, no beta term); As = A s_k; the
//     chains of <As, s_k>.  Sweep B: r -= alpha As, max|r| and
//     <invd r, r>, the stop test and the cap.  Sweep A reads code, r,
//     s_{k-1} and p and writes s_k, As and p (6.25 planes); sweep B reads
//     code, r and As and writes r (3.25).
//   * s in two planes, iteration k writing s[k & 1]: sweep A reads
//     s_{k-1} at its tiles' edges while other CTAs write s_k.  A recomputed
//     neighbour s_k is the bits its owner stores (-fmad=false).
//   * The operator is one byte a cell, code = a_diag * fl + 8 * fl,
//     decoded through a per-CTA table to common.cuh's `decode`.
//   * A cached workspace (ops/cuda/pcg_kernel.py `workspace`) owns every
//     buffer and a CUDA graph of kChunk iterations.  The head writes the
//     cap, tol and the flags on the device, so one graph serves every
//     cap.  A solve replays ceil(cap / kChunk) chunks (iterations past
//     the stop or the cap return at once) in batches of kBatch chunks,
//     the speed mode's whole budget of 100 iterations, and reads the stop
//     flag only between two batches: no stream sync at that budget, and
//     at most kBatch - 1 chunks of no-ops past an early stop under any
//     cap.  Then one finishing launch applies the pending p update into
//     the caller's plane.
// The grid stage (K10) and the clamp / face update / maxsq tail (K9, K10)
// are grid_stage.cuh's, shared with K2.  Built with -fmad=false and with
// the plain version's operand order (ops/project.py apply_a), so every
// sweep rounds as the plain PyTorch version does; only the order of the
// reductions differs.
#include "chain_reduce.cuh"
#include "grid_stage.cuh"

namespace {

constexpr int kChunk = 8;  // iterations per replay of the captured graph
// chunks replayed between two reads of the stop flag: ceil(100 / kChunk),
// so that a solve at the reference's budget of 100 iterations reads none
constexpr int kBatch = 13;

// The head of every entry point, on the chain grid: per cell the RHS b
// and the operator code (`cell(t, &code)`); code, r = b and p = 0, and the
// chains of <invd b, b> and max|b|.  The last CTA: init_solve.
template <class CellFn>
__device__ __forceinline__ void head_body(int n, CellFn cell, int cap,
                                          float tol, float tol_rel,
                                          uint8_t* __restrict__ code,
                                          float* __restrict__ r,
                                          float* __restrict__ p,
                                          float* __restrict__ chain_sum,
                                          float* __restrict__ chain_max,
                                          float* scal, int* flags) {
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
        int c;
        const float bv = cell(t, &c);
        const float z = decode(static_cast<float>(c)).invd * bv;
        code[t] = static_cast<uint8_t>(c);
        r[t] = bv;
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

// K8's head: b as given, the code from a_diag and the fluid mask
__global__ void __launch_bounds__(kTile, kPerSm)
    solve_head(int n, int cap, float tol, float tol_rel,
               const int32_t* __restrict__ a_diag,
               const uint8_t* __restrict__ fl, const float* __restrict__ b,
               uint8_t* __restrict__ code, float* __restrict__ r,
               float* __restrict__ p, float* __restrict__ chains,
               float* scal, int* flags) {
  head_body(
      n,
      [&](int t, int* c) {
        *c = op_code(fl[t] != 0, a_diag[t]);
        return b[t];
      },
      cap, tol, tol_rel, code, r, p, chains, chains + kChains, scal, flags);
}

// K9's head: the code from the solid mask (pcg_kernel.py:283-284) and
// b = -div(u) * h^2 rho / dt_proj on fluid cells (main.c:713-724)
__global__ void __launch_bounds__(kTile, kPerSm)
    project_head(Masks m, const float* __restrict__ ut,
                 const float* __restrict__ vt,
                 const float* __restrict__ dtp_ptr, float inv_h, float scale,
                 int cap, float tol, float tol_rel,
                 uint8_t* __restrict__ code, float* __restrict__ r,
                 float* __restrict__ p, float* __restrict__ chains,
                 float* scal, int* flags) {
  const float k_inv_scale = scale / *dtp_ptr;
  head_body(
      m.Y * m.X,
      [&](int t, int* c) {
        const int y = t / m.X, x = t - y * m.X;
        const float pk = packed_at(m, t, y, x);
        *c = static_cast<int>(pk);
        const float div = (ut[t] - ld(ut, y, x - 1, m.Y, m.X) + vt[t] -
                           ld(vt, y - 1, x, m.Y, m.X)) * inv_h;
        return decode(pk).fl != 0.0f ? -div * k_inv_scale : 0.0f;
      },
      cap, tol, tol_rel, code, r, p, chains, chains + kChains, scal, flags);
}

// Sweep A of iteration k (flags[F_ITERS] = k - 1): the pending
// p += alpha s_{k-1}; s_k on the cell and its four neighbours, from
// s_old; As = fl (a s_k - (left + right + down + up)); s_k into s_new;
// the chains of <As, s_k>.  The last CTA: alpha = sigma / <As, s_k>.
// One cell a thread, the kSteps steps' loads at once.
__global__ void __launch_bounds__(kTile, kPerSm)
    sweep_a(int Y, int X, const uint8_t* __restrict__ code,
            const float* __restrict__ r, const float* __restrict__ s_old,
            float* __restrict__ s_new, float* __restrict__ As,
            float* __restrict__ p, float* __restrict__ chain, float* scal,
            int* flags) {
  __shared__ float invd[256];
  __shared__ float wp[kSteps][kTile / 32];
  launch_dependents();
  load_invd(invd);
  wait_prerequisites();
  const bool done = flags[F_DONE] != 0;
  const float alpha = scal[S_ALPHA], beta = scal[S_BETA];
  const float sigma = scal[S_SIGMA];
  const bool pending = flags[F_PENDING] != 0;
  const bool first = flags[F_ITERS] == 0;
  if (done) return;
  const int n = Y * X;
  const int tiles = (n + kTile - 1) / kTile;
  // update_s of the plain loop: invd r + beta s
  auto s_at = [&](int k) {
    const float z = invd[code[k]] * r[k];
    return first ? z : z + beta * s_old[k];
  };
  auto s_nb = [&](int i, int j) {
    return (i < 0 || i >= Y || j < 0 || j >= X) ? 0.0f : s_at(i * X + j);
  };
  float cs = 0.0f;
  for (int k0 = 0; tile_at(k0) < tiles; k0 += kSteps) {
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = cell_at(tile_at(k0 + u));
      float acc = 0.0f;
      if (t < n) {
        const int y = t / X, x = t - y * X;
        if (pending) p[t] = p[t] + alpha * s_old[t];
        const float sc = s_at(t);
        float nb = s_nb(y, x - 1) + s_nb(y, x + 1);
        nb = nb + s_nb(y - 1, x);
        nb = nb + s_nb(y + 1, x);
        const Cell cell = decode(static_cast<float>(code[t]));
        const float as = cell.fl * (cell.a * sc - nb);
        s_new[t] = sc;
        As[t] = as;
        acc = as * sc;
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
  if (threadIdx.x == 0) set_alpha(sigma, zs, scal, flags);
}

// After the replays, not guarded by the stop flag: p plus the pending
// alpha s_K of the last iteration K (from s[K & 1]) into out, which may
// be p.
__global__ void finish(int n, const float* p, const float* __restrict__ s0,
                       const float* __restrict__ s1,
                       const float* __restrict__ scal,
                       const int* __restrict__ flags, float* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float pv = p[t];
  if (!flags[F_PENDING]) {
    out[t] = pv;
    return;
  }
  const float* s = (flags[F_ITERS] & 1) ? s1 : s0;
  out[t] = pv + scal[S_ALPHA] * s[t];
}

// one workspace's solver: its buffers and the graph of one chunk
struct JacobiSolver {
  int Y, X;
  uint8_t* code;
  float *r, *p, *As, *s[2], *chains, *scal, *part;
  int* flags;
  cudaGraphExec_t exec;
  cudaEvent_t replayed;  // recorded after each solve's last replay

  int n() const { return Y * X; }
  unsigned blocks() const {
    return eu_blocks(static_cast<long long>(Y) * X, kThreads);
  }

  // iteration j of a chunk, iteration 8c + j + 1 of a solve: s_k into
  // s[(j + 1) & 1]; each sweep launched to overlap the one before it
  int iteration(int j, cudaStream_t st) const {
    const int rc = launch_sweep(sweep_a, st, Y, X, code, r, s[j & 1],
                                s[(j + 1) & 1], As, p, chains, scal, flags);
    if (rc) return rc;
    return launch_sweep(sweep_b, st, n(), code, As, r, chains,
                        chains + kChains, scal, flags);
  }

  // after a head: the chunks up to the cap, the stop flag read before
  // each batch but the first, then the finishing launch
  int iterate(int max_iters, float* out, cudaStream_t st) const {
    const int chunks = (max_iters + kChunk - 1) / kChunk;
    int rc = 0;
    for (int k = 0; k < chunks; ++k) {
      if (k > 0 && k % kBatch == 0) {
        int done = 0;
        if ((rc = static_cast<int>(cudaMemcpyAsync(
                 &done, flags + F_DONE, sizeof(int), cudaMemcpyDeviceToHost,
                 st))))
          return rc;
        if ((rc = static_cast<int>(cudaStreamSynchronize(st)))) return rc;
        if (done) break;
      }
      if ((rc = static_cast<int>(cudaGraphLaunch(exec, st)))) return rc;
    }
    rc = static_cast<int>(cudaEventRecord(replayed, st));
    if (rc) return rc;
    finish<<<blocks(), kThreads, 0, st>>>(n(), p, s[0], s[1], scal, flags,
                                          out);
    return eu_launch_status();
  }

  // K9's body: head, solve, clamp, face update of (ut, vt) into (u2, v2)
  // with the face-update dt, and msq
  int project(const Masks& m, int max_iters, float tol, float tol_rel,
              float inv_h, float scale, float c, const float* dt,
              const float* dt_proj, const float* ut, const float* vt,
              float* u2, float* v2, float* msq, cudaStream_t st) const {
    project_head<<<kChains, kTile, 0, st>>>(m, ut, vt, dt_proj, inv_h, scale,
                                             max_iters, tol, tol_rel, code,
                                             r, p, chains, scal, flags);
    int rc = eu_launch_status();
    if (rc) return rc;
    if ((rc = iterate(max_iters, p, st))) return rc;
    return project_tail(m, c, dt, p, p, ut, vt, u2, v2, part, msq, st);
  }
};

JacobiSolver* as_solver(void* solver) {
  return static_cast<JacobiSolver*>(solver);
}

}  // namespace

// A solver over a workspace's buffers: code: [Y, X] u8; r, p, As: [Y, X]
// f32; s: [2, Y, X] f32; chains: 2 * 1024 f32; scal: S_N f32; flags: F_N
// i32; part (K9/K10's tail): 2 * ceil(Y*X/256) f32.  Clears the flags and
// captures the graph of one chunk; *out is the handle.  The iteration
// count and the final max|r| of each solve stay on the device
// (flags[F_ITERS], scal[S_RESID]).
EU_API int eu_jacobi_create(int Y, int X, void* code, void* r, void* p,
                            void* As, void* s, void* chains, void* scal,
                            void* flags, void* part, void** out) {
  *out = nullptr;
  float* s0 = static_cast<float*>(s);
  JacobiSolver* J = new JacobiSolver{
      Y, X, static_cast<uint8_t*>(code), static_cast<float*>(r),
      static_cast<float*>(p), static_cast<float*>(As),
      {s0, s0 + static_cast<long long>(Y) * X}, static_cast<float*>(chains),
      static_cast<float*>(scal), static_cast<float*>(part),
      static_cast<int*>(flags), nullptr, nullptr};
  // the ticket starts at 0; every last CTA leaves it there
  int rc = static_cast<int>(cudaMemset(J->flags, 0, sizeof(int) * F_N));
  if (!rc) rc = static_cast<int>(cudaDeviceSynchronize());
  if (!rc)
    rc = static_cast<int>(
        cudaEventCreateWithFlags(&J->replayed, cudaEventDisableTiming));
  if (rc) {
    delete J;
    return rc;
  }
  rc = capture_graph(&J->exec, [&](cudaStream_t cs) {
    int rc_it = 0;
    for (int j = 0; !rc_it && j < kChunk; ++j) rc_it = J->iteration(j, cs);
    return rc_it;
  });
  if (rc) {
    cudaEventDestroy(J->replayed);
    delete J;
    return rc;
  }
  *out = J;
  return 0;
}

// Frees a solver once its last solve's replays have run (the buffers are
// the caller's).
EU_API int eu_jacobi_destroy(void* solver) {
  JacobiSolver* J = as_solver(solver);
  int rc = static_cast<int>(cudaEventSynchronize(J->replayed));
  const int rc_graph = static_cast<int>(cudaGraphExecDestroy(J->exec));
  const int rc_event = static_cast<int>(cudaEventDestroy(J->replayed));
  delete J;
  if (!rc) rc = rc_graph;
  return rc ? rc : rc_event;
}

// K8: A p = b from p = 0, with a_diag ([Y, X] i32) and fl ([Y, X] u8);
// the solution into p_out ([Y, X] f32).
EU_API int eu_jacobi_solve(void* solver, int max_iters, float tol,
                           float tol_rel, const void* a_diag, const void* fl,
                           const void* b, void* p_out, void* stream) {
  const JacobiSolver* J = as_solver(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  solve_head<<<kChains, kTile, 0, st>>>(
      J->n(), max_iters, tol, tol_rel, static_cast<const int32_t*>(a_diag),
      static_cast<const uint8_t*>(fl), static_cast<const float*>(b), J->code,
      J->r, J->p, J->chains, J->scal, J->flags);
  const int rc = eu_launch_status();
  if (rc) return rc;
  return J->iterate(max_iters, static_cast<float*>(p_out), st);
}

// K9: the projection of (ut, vt) into (u2, v2).  fl, so: [Y, X] u8;
// dt (face update) and dt_proj (RHS scale): one f32 each on the device;
// msq: one f32 out.
EU_API int eu_jacobi_project(void* solver, int max_iters, float tol,
                             float tol_rel, float inv_h, float scale,
                             float c, const void* fl, const void* so,
                             const void* dt, const void* dt_proj,
                             const void* ut, const void* vt, void* u2,
                             void* v2, void* msq, void* stream) {
  const JacobiSolver* J = as_solver(solver);
  const Masks m{J->Y, J->X, static_cast<const uint8_t*>(fl), nullptr,
                static_cast<const uint8_t*>(so)};
  return J->project(m, max_iters, tol, tol_rel, inv_h, scale, c,
                    static_cast<const float*>(dt),
                    static_cast<const float*>(dt_proj),
                    static_cast<const float*>(ut),
                    static_cast<const float*>(vt), static_cast<float*>(u2),
                    static_cast<float*>(v2), static_cast<float*>(msq),
                    static_cast<cudaStream_t>(stream));
}

// K10: the grid stage of (u, v) (K7's tiled launch, on tiles of ty x tx
// cells and `threads` threads, with dt) into (u2, v2), then K9's body in
// place on them.  pfl: [Y, X] u8.
EU_API int eu_jacobi_substep(void* solver, int max_iters, float tol,
                             float tol_rel, float inv_h, float g,
                             float scale, float c, const void* fl,
                             const void* pfl, const void* so, const void* dt,
                             const void* dt_proj, const void* u,
                             const void* v, void* u2, void* v2, void* msq,
                             int ty, int tx, int threads, void* stream) {
  const JacobiSolver* J = as_solver(solver);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Masks m = make_masks(J->Y, J->X, fl, pfl, so);
  float* uo = static_cast<float*>(u2);
  float* vo = static_cast<float*>(v2);
  const float* dtf = static_cast<const float*>(dt);
  const int rc = grid_passes(m, GridTile{ty, tx, threads}, inv_h, g,
                             static_cast<const float*>(u),
                             static_cast<const float*>(v), dtf, uo, vo,
                             nullptr, nullptr, st);
  if (rc) return rc;
  return J->project(m, max_iters, tol, tol_rel, inv_h, scale, c, dtf,
                    static_cast<const float*>(dt_proj), uo, vo, uo, vo,
                    static_cast<float*>(msq), st);
}
