// P2's IC(0) sweeps (ops/ic0.py, euler_tpu/ops/ic0.py:35-76, main.c:580-627),
// shared by P2 (pcg_general.cu: the whole grid) and P6 (pcg_ic0_blocks.cu:
// one block of a grid cut into ("y", "x") blocks).
//
// The E_inv recurrence, the forward solve and the back solve couple a cell
// to its left and lower (back: right and upper) neighbour, so each walks
// the anti-diagonals x + y = d of its plane, Y + X - 1 dependent steps, in
// ONE CTA with a __syncthreads() between steps; the planes live in shared
// memory when they fit (kIcSmem), in global memory otherwise.  The guard
// e < 0.25 a -> (a != 0 ? a : 1) and the rebuild from zeros each solve are
// the JAX package's.
//
// What lies one cell beyond the plane comes from a loader E: `Zeros`
// (P2: zeros beyond the grid's edges, as compiled before P6), or P6's
// `BlockEdges` (the neighbour blocks' edges, exchanged before the sweep:
// E_inv and q of the west column and the south row for the build and the
// forward solve, z of the east column and the north row for the back
// solve, which reads this cell's own E_inv).  The operand order is the
// same for both, so a block's cells are the whole grid's bit for bit.
#pragma once

#include "pcg_loop.cuh"

namespace ic0 {

using pcg::a_of;
using pcg::fl_of;

constexpr int kIcThreads = 1024;
// the shared memory P2 may take (the H100's opt-in limit is 227 KB)
constexpr size_t kIcSmem = 200 * 1024;

template <typename T>
__device__ __forceinline__ T inv_sqrt(T e) {
  return T(1) / sqrt(e);
}

// the rows of diagonal d: y in [lo, hi], x = d - y
__device__ __forceinline__ void diag_rows(int d, int Y, int X, int* lo,
                                          int* hi) {
  *lo = max(0, d - (X - 1));
  *hi = min(Y - 1, d);
}

// zeros beyond the plane: the whole grid (P2)
template <typename T>
struct Zeros {
  __device__ __forceinline__ T pre_w(int) const { return T(0); }
  __device__ __forceinline__ T pre_s(int) const { return T(0); }
  __device__ __forceinline__ T q_w(int) const { return T(0); }
  __device__ __forceinline__ T q_s(int) const { return T(0); }
  __device__ __forceinline__ T z_e(int) const { return T(0); }
  __device__ __forceinline__ T z_n(int) const { return T(0); }
};

// the neighbour blocks' edges (P6): west [Y] and south [X] of E_inv and q,
// east [Y] and north [X] of z; zeros beyond the grid's edges
template <typename T>
struct BlockEdges {
  const T* pw;
  const T* ps;
  const T* qw;
  const T* qs;
  const T* ze;
  const T* zn;
  __device__ __forceinline__ T pre_w(int y) const { return pw[y]; }
  __device__ __forceinline__ T pre_s(int x) const { return ps[x]; }
  __device__ __forceinline__ T q_w(int y) const { return qw[y]; }
  __device__ __forceinline__ T q_s(int x) const { return qs[x]; }
  __device__ __forceinline__ T z_e(int y) const { return ze[y]; }
  __device__ __forceinline__ T z_n(int x) const { return zn[x]; }
};

template <typename T>
size_t smem_bytes(int Y, int X, int planes) {
  const size_t bytes = static_cast<size_t>(planes) * Y * X * sizeof(T);
  return bytes <= kIcSmem ? bytes : 0;
}

// E_inv into pre (main.c:586-600): e = a - pl^2 - pd^2, guarded
template <typename T, class E>
__device__ __forceinline__ void build_body(int Y, int X, const uint8_t* code,
                                           T* pre_out, bool smem,
                                           const E& edge) {
  extern __shared__ __align__(16) unsigned char eu_smem[];
  const int n = Y * X;
  T* pre = smem ? reinterpret_cast<T*>(eu_smem) : pre_out;
  for (int i = threadIdx.x; i < n; i += blockDim.x) pre[i] = T(0);
  __syncthreads();
  for (int d = 0; d < Y + X - 1; ++d) {
    int lo, hi;
    diag_rows(d, Y, X, &lo, &hi);
    for (int y = lo + static_cast<int>(threadIdx.x); y <= hi;
         y += blockDim.x) {
      const int x = d - y, i = y * X + x;
      const uint8_t c = code[i];
      if (!fl_of(c)) continue;
      const T a = static_cast<T>(a_of(c));
      const T b = x > 0 ? pre[i - 1] : edge.pre_w(y);
      const T cc = y > 0 ? pre[i - X] : edge.pre_s(x);
      T e = a - b * b - cc * cc;
      if (e < T(0.25) * a) e = a != T(0) ? a : T(1);
      pre[i] = inv_sqrt(e);
    }
    __syncthreads();
  }
  if (smem)
    for (int i = threadIdx.x; i < n; i += blockDim.x) pre_out[i] = pre[i];
}

// the forward solve L q = r (main.c:602-613), diagonals ascending; q zero
// beforehand (it stays so off the fluid)
template <typename T, class E>
__device__ __forceinline__ void forward_sweep(int Y, int X,
                                              const uint8_t* code,
                                              const T* pre, const T* r, T* q,
                                              const E& edge) {
  for (int d = 0; d < Y + X - 1; ++d) {
    int lo, hi;
    diag_rows(d, Y, X, &lo, &hi);
    for (int y = lo + static_cast<int>(threadIdx.x); y <= hi;
         y += blockDim.x) {
      const int x = d - y, i = y * X + x;
      if (!fl_of(code[i])) continue;
      const T pl = x > 0 ? pre[i - 1] : edge.pre_w(y);
      const T ql = x > 0 ? q[i - 1] : edge.q_w(y);
      const T pd = y > 0 ? pre[i - X] : edge.pre_s(x);
      const T qd = y > 0 ? q[i - X] : edge.q_s(x);
      const T t = r[i] + pl * ql + pd * qd;
      q[i] = t * pre[i];
    }
    __syncthreads();
  }
}

// the back solve L^T z = q (main.c:615-626), diagonals descending; z zero
// beforehand
template <typename T, class E>
__device__ __forceinline__ void back_sweep(int Y, int X, const uint8_t* code,
                                           const T* pre, const T* q, T* z,
                                           const E& edge) {
  for (int d = Y + X - 2; d >= 0; --d) {
    int lo, hi;
    diag_rows(d, Y, X, &lo, &hi);
    for (int y = lo + static_cast<int>(threadIdx.x); y <= hi;
         y += blockDim.x) {
      const int x = d - y, i = y * X + x;
      if (!fl_of(code[i])) continue;
      const T p = pre[i];
      const T zr = x + 1 < X ? z[i + 1] : edge.z_e(y);
      const T zu = y + 1 < Y ? z[i + X] : edge.z_n(x);
      const T t = q[i] + p * zr + p * zu;
      z[i] = t * p;
    }
    __syncthreads();
  }
}

// z = M^-1 r: forward solve into q, back solve into z (P2's application)
template <typename T, class E>
__device__ __forceinline__ void apply_body(int Y, int X, const uint8_t* code,
                                           const T* pre_g, const T* r,
                                           T* z_out, T* q_g, bool smem,
                                           const E& edge) {
  extern __shared__ __align__(16) unsigned char eu_smem[];
  const int n = Y * X;
  T* pre = smem ? reinterpret_cast<T*>(eu_smem) : const_cast<T*>(pre_g);
  T* q = smem ? pre + n : q_g;
  T* z = smem ? q + n : z_out;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (smem) pre[i] = pre_g[i];
    q[i] = T(0);
    z[i] = T(0);
  }
  __syncthreads();
  forward_sweep(Y, X, code, pre, r, q, edge);
  back_sweep(Y, X, code, pre, q, z, edge);
  if (smem)
    for (int i = threadIdx.x; i < n; i += blockDim.x) z_out[i] = z[i];
}

}  // namespace ic0
