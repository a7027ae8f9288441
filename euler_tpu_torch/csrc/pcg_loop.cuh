// P1's PCG loop (pcg_general.cu), shared with P3 (pcg_mg.cu): the kernels
// of ops/project.py `pcg_loop` and the order they are enqueued in.
//
// The all-zero early-out, the warm start x0, the tolerance max(tol,
// tol_rel ||b||_inf), the NaN-robust stop test not (max|r| > tol) after the
// p / r update, the cap.  Templated on the precision and the
// preconditioner; a preconditioner with a step of its own (IC(0), the MG
// cycle) is enqueued by the caller's `precon(stream)` between the p / r
// update and precon_dot, and once in the head.  The cap, the tolerance
// and the stop flag live on the device, and every iteration kernel
// returns at once after the stop (so does the caller's step, on
// flags[F_DONE]).  Each reduction is per-CTA partials whose last CTA
// (atomic ticket after a fence) folds them in a fixed order.
//
// P4 (pcg_shard.cu) and P5 (pcg_mg_blocks.cu) run the same kernels on one
// block of a grid split over ranks (SHARD = kHaloOrder, kGridOrder): the
// operator reads the neighbour blocks' edge rows and columns from
// exchanged buffers (`Halo`), in euler_tpu/parallel/halo.py:84's order
// (P4) or in apply_a's, P1's (P5), and each reduction's block fold goes to
// red[0] instead of being used at once; the host all-reduces it over the
// blocks, and a `shard_finish` kernel does with the global value what the
// last CTA does with the fold in P1 (the fin_* functions, shared by all).
#pragma once

#include "common.cuh"

namespace pcg {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kChunk = 8;
constexpr int kBatch = 13;

// the preconditioners: pointwise (none, the jnp-form Jacobi), or a step of
// its own that writes z before precon_dot reads it (IC(0): P2; the MG
// cycle: P3)
enum Precon { kNone = 0, kJacobi = 1, kIc0 = 2, kMg = 3 };
// scalars (T) and flags (int) on the device
enum { S_TOL, S_SIGMA, S_ALPHA, S_BETA, S_RESID, S_N };
enum { F_DONE, F_ITERS, F_CAP, F_NONZERO, F_CONV, F_TICKET, F_N };
// the loop on a whole grid (P1, P3), or on a block whose operator reads
// the neighbours' edges in halo.py's order (P4) or in apply_a's (P5)
enum ShardOrder { kWhole = 0, kHaloOrder = 1, kGridOrder = 2 };

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {  // NaN-propagating
  return (a > b || a != a) ? a : b;
}

// thread 0 gets the block's sum (OP 0) or NaN-propagating max (OP 1)
template <int OP, typename T>
__device__ T block_reduce_t(T v) {
  __shared__ T part[32];
  for (int o = 16; o > 0; o >>= 1) {
    const T n = __shfl_down_sync(0xffffffffu, v, o);
    v = OP == 0 ? v + n : tmax(v, n);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = threadIdx.x < nw ? part[threadIdx.x] : T(0);
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) {
      const T n = __shfl_down_sync(0xffffffffu, v, o);
      v = OP == 0 ? v + n : tmax(v, n);
    }
  __syncthreads();
  return v;
}

// Every CTA's partial into part[]; true in the last CTA to finish, whose
// thread 0 then holds the fold of all partials in *out (fixed order).
template <int OP, typename T>
__device__ bool last_block_reduce(T v, T* part, int* ticket, T* out) {
  __shared__ bool s_last;
  v = block_reduce_t<OP>(v);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = v;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  T acc = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
       i += blockDim.x) {
    const T v_i = __ldcg(part + i);  // other CTAs' partials: not from L1
    acc = OP == 0 ? acc + v_i : tmax(acc, v_i);
  }
  acc = block_reduce_t<OP>(acc);
  if (threadIdx.x == 0) {
    *out = acc;
    *ticket = 0;
  }
  return true;
}

// The planes are Y x X; the system's inputs (a_diag, fluid, b, x0) Yi x
// Xi, at their top left: P3 pads an odd grid to the even shape of its MG
// level 0 with non-fluid cells (P1: Yi = Y, Xi = X).
struct Ws {
  int Y, X, Yi, Xi;
  uint8_t* code;  // fluid << 3 | a_diag
  void* p;
  void* r;
  void* d;
  void* z;
  void* ad;
  void* pre;  // IC(0) E_inv
  void* q;    // IC(0) forward-solve plane (global fallback)
  void* part;
  void* scal;
  int* flags;
  void* red = nullptr;  // P4: the block fold of the last reduction
};

template <typename T>
struct Planes {
  T *p, *r, *d, *z, *ad, *pre, *q, *part, *scal, *red;
  __device__ explicit Planes(const Ws& w)
      : p(static_cast<T*>(w.p)), r(static_cast<T*>(w.r)),
        d(static_cast<T*>(w.d)), z(static_cast<T*>(w.z)),
        ad(static_cast<T*>(w.ad)), pre(static_cast<T*>(w.pre)),
        q(static_cast<T*>(w.q)), part(static_cast<T*>(w.part)),
        scal(static_cast<T*>(w.scal)), red(static_cast<T*>(w.red)) {}
};

// P4: the neighbour blocks' edges of the plane the operator reads, zeros at
// the grid's edges: the row before row 0 and after row Y - 1 ([X] each),
// the column before column 0 and after column X - 1 ([Y] each; null on a
// block that spans every column)
template <typename T>
struct Halo {
  const T* below;
  const T* above;
  const T* left;
  const T* right;
};

__device__ __forceinline__ bool fl_of(uint8_t c) { return (c & 8) != 0; }
__device__ __forceinline__ int a_of(uint8_t c) { return c & 7; }

// apply_a (ops/project.py): a s - (((s_l + s_r) + s_d) + s_u) on fluid
template <typename T>
__device__ __forceinline__ T apply_at(const T* s, uint8_t c, int i, int y,
                                      int x, int Y, int X) {
  if (!fl_of(c)) return T(0);
  const T sl = x > 0 ? s[i - 1] : T(0);
  const T sr = x + 1 < X ? s[i + 1] : T(0);
  const T sd = y > 0 ? s[i - X] : T(0);
  const T su = y + 1 < Y ? s[i + X] : T(0);
  return static_cast<T>(a_of(c)) * s[i] - (((sl + sr) + sd) + su);
}

// the operator on a block, the neighbours beyond it from the exchanged
// edges: halo.py's local operator a s - (((s_l + s_r) + s_u) + s_d) (P4,
// kHaloOrder), or apply_a's a s - (((s_l + s_r) + s_d) + s_u) (P5), on
// fluid
template <typename T, int ORDER>
__device__ __forceinline__ T apply_halo(const T* s, uint8_t c, int i, int y,
                                        int x, int Y, int X,
                                        const Halo<T>& h) {
  if (!fl_of(c)) return T(0);
  const T sl = x > 0 ? s[i - 1] : (h.left ? h.left[y] : T(0));
  const T sr = x + 1 < X ? s[i + 1] : (h.right ? h.right[y] : T(0));
  const T sd = y > 0 ? s[i - X] : h.below[x];
  const T su = y + 1 < Y ? s[i + X] : h.above[x];
  const T nb = ORDER == kHaloOrder ? ((sl + sr) + su) + sd
                                   : ((sl + sr) + sd) + su;
  return static_cast<T>(a_of(c)) * s[i] - nb;
}

template <typename T, int SHARD>
__device__ __forceinline__ T apply_op(const T* s, uint8_t c, int i, int y,
                                      int x, int Y, int X,
                                      const Halo<T>& h) {
  return SHARD == kWhole ? apply_at(s, c, i, y, x, Y, X)
                         : apply_halo<T, SHARD>(s, c, i, y, x, Y, X, h);
}

// What each reduction's fold is used for (thread 0 of P1's last CTA, or
// P4's finish kernel with the all-reduced value).
// head: max|b| -> the tolerance, the early-out
template <typename T>
__device__ void fin_head_init(const Ws& w, T* scal, T bn, int cap,
                              double tol, double tol_rel, bool warm) {
  scal[S_TOL] = tmax(static_cast<T>(tol), static_cast<T>(tol_rel) * bn);
  scal[S_RESID] = bn;
  const bool nonzero = bn != T(0);
  w.flags[F_NONZERO] = nonzero;
  w.flags[F_ITERS] = 0;
  w.flags[F_CAP] = cap;
  w.flags[F_CONV] = 0;
  w.flags[F_DONE] = (!warm && !nonzero) || cap <= 0;
}

// warm start: max|b - A x0| -> the early stop
template <typename T>
__device__ void fin_head_residual(const Ws& w, T* scal, T rm) {
  scal[S_RESID] = rm;
  w.flags[F_DONE] = !w.flags[F_NONZERO] || !(rm > scal[S_TOL]) ||
                    w.flags[F_CAP] <= 0;
}

// <z, r>: sigma (HEAD), or beta, sigma, the count and the stop
template <typename T, bool HEAD>
__device__ void fin_precon_dot(const Ws& w, T* scal, T dot) {
  if (HEAD) {
    scal[S_SIGMA] = dot;
  } else {
    const T sigma = scal[S_SIGMA];
    scal[S_BETA] = dot / (sigma != T(0) ? sigma : T(1));
    scal[S_SIGMA] = dot;
    const int it = w.flags[F_ITERS] + 1;
    w.flags[F_ITERS] = it;
    w.flags[F_DONE] = w.flags[F_CONV] || it >= w.flags[F_CAP];
  }
}

// <Ad, d> -> alpha
template <typename T>
__device__ void fin_iter_ad(T* scal, T zs) {
  scal[S_ALPHA] = scal[S_SIGMA] / (zs != T(0) ? zs : T(1));
}

// max|r| -> the convergence test
template <typename T>
__device__ void fin_iter_update(const Ws& w, T* scal, T rm) {
  scal[S_RESID] = rm;
  w.flags[F_CONV] = !(rm > scal[S_TOL]);
}

// make_preconditioner's pointwise forms
template <typename T, int PK>
__device__ __forceinline__ T precon_at(T r, uint8_t c) {
  if (!fl_of(c)) return T(0);
  if (PK == kJacobi && a_of(c) > 0) return r / static_cast<T>(a_of(c));
  return r;
}

// the finishes of P4 and P5: what the last CTA of P1 does with its fold,
// done with the all-reduced red[0] by one thread; the iteration's
// finishes return after the stop, as the iteration's kernels do
enum Fin { kFinInit, kFinResidual, kFinSigma0, kFinAlpha, kFinConv,
           kFinBeta };

template <typename T, int FIN>
__global__ void shard_finish(Ws w, int cap, double tol, double tol_rel,
                             bool warm) {
  Planes<T> P(w);
  const T v = P.red[0];
  if (FIN == kFinInit) {
    fin_head_init(w, P.scal, v, cap, tol, tol_rel, warm);
  } else if (FIN == kFinResidual) {
    fin_head_residual(w, P.scal, v);
  } else if (FIN == kFinSigma0) {
    fin_precon_dot<T, true>(w, P.scal, v);
  } else {
    if (w.flags[F_DONE]) return;
    if (FIN == kFinAlpha)
      fin_iter_ad(P.scal, v);
    else if (FIN == kFinConv)
      fin_iter_update(w, P.scal, v);
    else
      fin_precon_dot<T, false>(w, P.scal, v);
  }
}

static inline unsigned grid_blocks(int n) {
  return min(eu_blocks(n, kThreads), static_cast<unsigned>(kMaxBlocks));
}

#define GRID_STRIDE(i, n)                                               \
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (n);          \
       i += gridDim.x * blockDim.x)

// the inputs' index of plane cell i, or -1 in the pad
__device__ __forceinline__ int input_index(const Ws& w, int i) {
  if (w.Yi == w.Y && w.Xi == w.X) return i;
  const int y = i / w.X, x = i - y * w.X;
  return y < w.Yi && x < w.Xi ? y * w.Xi + x : -1;
}

// head: the operator code, r = b, p = 0, max|b| -> tol, the early-out (the
// pad: not fluid, b = 0)
template <typename T, int SHARD = kWhole>
__global__ void __launch_bounds__(kThreads)
    head_init(Ws w, const int32_t* a_diag, const uint8_t* fluid, const T* b,
              int cap, double tol, double tol_rel, bool warm) {
  Planes<T> P(w);
  const int n = w.Y * w.X;
  T m = T(0);
  GRID_STRIDE(i, n) {
    const int k = input_index(w, i);
    const uint8_t c =
        k >= 0 && fluid[k] ? static_cast<uint8_t>(8 | a_diag[k]) : 0;
    const T bv = k >= 0 ? b[k] : T(0);
    w.code[i] = c;
    P.r[i] = bv;
    P.p[i] = T(0);
    m = tmax(m, fabs(bv));
  }
  T bn;
  if (last_block_reduce<1>(m, P.part, w.flags + F_TICKET, &bn) &&
      threadIdx.x == 0) {
    if (SHARD)
      P.red[0] = bn;
    else
      fin_head_init(w, P.scal, bn, cap, tol, tol_rel, warm);
  }
}

// warm start: p = nonzero ? x0 : 0
template <typename T>
__global__ void __launch_bounds__(kThreads) head_x0(Ws w, const T* x0) {
  Planes<T> P(w);
  const bool nonzero = w.flags[F_NONZERO] != 0;
  GRID_STRIDE(i, w.Y * w.X) {
    const int k = input_index(w, i);
    P.p[i] = nonzero && k >= 0 ? x0[k] : T(0);
  }
}

// warm start: r = b - A p, and the early stop if it already converged
template <typename T, int SHARD = kWhole>
__global__ void __launch_bounds__(kThreads)
    head_residual(Ws w, Halo<T> h) {
  Planes<T> P(w);
  T m = T(0);
  GRID_STRIDE(i, w.Y * w.X) {
    const int y = i / w.X, x = i - y * w.X;
    const T r =
        P.r[i] - apply_op<T, SHARD>(P.p, w.code[i], i, y, x, w.Y, w.X, h);
    P.r[i] = r;
    m = tmax(m, fabs(r));
  }
  T rm;
  if (last_block_reduce<1>(m, P.part, w.flags + F_TICKET, &rm) &&
      threadIdx.x == 0) {
    if (SHARD)
      P.red[0] = rm;
    else
      fin_head_residual(w, P.scal, rm);
  }
}

// z = M^-1 r (IC(0), MG: already in z), <z, r>.  HEAD: d = z, sigma.
// Else: beta, sigma, the count and the stop.
template <typename T, int PK, bool HEAD, int SHARD = kWhole>
__global__ void __launch_bounds__(kThreads) precon_dot(Ws w) {
  if (!HEAD && w.flags[F_DONE]) return;
  Planes<T> P(w);
  T acc = T(0);
  GRID_STRIDE(i, w.Y * w.X) {
    const T r = P.r[i];
    T z;
    if (PK >= kIc0) {
      z = P.z[i];
    } else {
      z = precon_at<T, PK>(r, w.code[i]);
      P.z[i] = z;
    }
    if (HEAD) P.d[i] = z;
    acc = acc + z * r;
  }
  T dot;
  if (last_block_reduce<0>(acc, P.part, w.flags + F_TICKET, &dot) &&
      threadIdx.x == 0) {
    if (SHARD)
      P.red[0] = dot;
    else
      fin_precon_dot<T, HEAD>(w, P.scal, dot);
  }
}

// Ad = A d, <Ad, d>, alpha = sigma / <Ad, d> (1 for 0)
template <typename T, int SHARD = kWhole>
__global__ void __launch_bounds__(kThreads) iter_ad(Ws w, Halo<T> h) {
  if (w.flags[F_DONE]) return;
  Planes<T> P(w);
  T acc = T(0);
  GRID_STRIDE(i, w.Y * w.X) {
    const int y = i / w.X, x = i - y * w.X;
    const T ad = apply_op<T, SHARD>(P.d, w.code[i], i, y, x, w.Y, w.X, h);
    P.ad[i] = ad;
    acc = acc + ad * P.d[i];
  }
  T zs;
  if (last_block_reduce<0>(acc, P.part, w.flags + F_TICKET, &zs) &&
      threadIdx.x == 0) {
    if (SHARD)
      P.red[0] = zs;
    else
      fin_iter_ad(P.scal, zs);
  }
}

// p += alpha d, r -= alpha Ad, max|r|, conv = not (max|r| > tol)
template <typename T, int SHARD = kWhole>
__global__ void __launch_bounds__(kThreads) iter_update(Ws w) {
  if (w.flags[F_DONE]) return;
  Planes<T> P(w);
  const T alpha = P.scal[S_ALPHA];
  T m = T(0);
  GRID_STRIDE(i, w.Y * w.X) {
    P.p[i] = P.p[i] + alpha * P.d[i];
    const T r = P.r[i] - alpha * P.ad[i];
    P.r[i] = r;
    m = tmax(m, fabs(r));
  }
  T rm;
  if (last_block_reduce<1>(m, P.part, w.flags + F_TICKET, &rm) &&
      threadIdx.x == 0) {
    if (SHARD)
      P.red[0] = rm;
    else
      fin_iter_update(w, P.scal, rm);
  }
}

// d = z + beta d
template <typename T>
__global__ void __launch_bounds__(kThreads) iter_dir(Ws w) {
  if (w.flags[F_DONE]) return;
  Planes<T> P(w);
  const T beta = P.scal[S_BETA];
  GRID_STRIDE(i, w.Y * w.X) P.d[i] = P.z[i] + beta * P.d[i];
}

// One iteration: Ad = A d with <Ad, d> and alpha; the p and r updates with
// max|r| and the stop test; [the preconditioner's own step]; z = M^-1 r
// with <z, r>, beta, the count and the stop; d = z + beta d.
template <typename T, int PK, class Precon>
int enqueue_iteration(const Ws& w, Precon precon, cudaStream_t st) {
  const unsigned nb = grid_blocks(w.Y * w.X);
  iter_ad<T><<<nb, kThreads, 0, st>>>(w, Halo<T>{});
  iter_update<T><<<nb, kThreads, 0, st>>>(w);
  if (PK >= kIc0) {
    const int rc = precon(st);
    if (rc) return rc;
  }
  precon_dot<T, PK, false><<<nb, kThreads, 0, st>>>(w);
  iter_dir<T><<<nb, kThreads, 0, st>>>(w);
  return eu_launch_status();
}

// The head: the code, r, p (x0 and r = b - A x0 when warm), the
// tolerance and the early-out; [the preconditioner's own step]; z, d = z
// and sigma.
template <typename T, int PK, class Precon>
int enqueue_head(const Ws& w, const int32_t* a_diag, const uint8_t* fluid,
                 const T* b, const T* x0, int cap, double tol,
                 double tol_rel, Precon precon, cudaStream_t st) {
  const unsigned nb = grid_blocks(w.Y * w.X);
  head_init<T><<<nb, kThreads, 0, st>>>(w, a_diag, fluid, b, cap, tol,
                                        tol_rel, x0 != nullptr);
  if (x0 != nullptr) {
    head_x0<T><<<nb, kThreads, 0, st>>>(w, x0);
    head_residual<T><<<nb, kThreads, 0, st>>>(w, Halo<T>{});
  }
  int rc = eu_launch_status();
  if (rc) return rc;
  if (PK >= kIc0 && (rc = precon(st))) return rc;
  precon_dot<T, PK, true><<<nb, kThreads, 0, st>>>(w);
  return eu_launch_status();
}

// The replays of a chunk of kChunk iterations up to the cap, the stop flag
// read before each batch of `batch` chunks but the first; `replayed` is
// recorded after the last.  P1 takes kBatch: its solves mostly run to
// their cap (the Jacobi budget), which a batch of 13 chunks covers
// without a sync.  P3's converge in a few chunks (MG), so it reads the
// flag after every chunk, as K3 does, rather than replay up to 12 chunks
// of no-ops.
inline int replay(cudaGraphExec_t exec, cudaEvent_t replayed,
                  const int* flags, int cap, int batch, cudaStream_t st) {
  const int chunks = (cap + kChunk - 1) / kChunk;
  int rc = 0;
  for (int k = 0; k < chunks; ++k) {
    if (k > 0 && k % batch == 0) {
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
  return static_cast<int>(cudaEventRecord(replayed, st));
}

}  // namespace pcg
