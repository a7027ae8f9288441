// Shared helpers for the euler_tpu_torch CUDA kernels: the C export
// macro, the error-string export every library carries, bounds-checked
// plane loads, the fraction-snapped bilinear of main.c:301-364, the
// Jacobi solves' operator decode, deterministic block reductions, and the
// capture of a solver's iterations into a CUDA graph.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define EU_API extern "C" __attribute__((visibility("default")))

EU_API const char* eu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline int eu_launch_status() {
  return static_cast<int>(cudaGetLastError());
}

static inline unsigned eu_blocks(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

// a[i, j] of a [Y, X] plane, `fill` outside it
template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ a, int i, int j, int Y,
                                int X, T fill = T(0)) {
  return (i >= 0 && i < Y && j >= 0 && j < X) ? a[i * X + j] : fill;
}

// max that propagates NaN from either side, like jnp.max / jnp.maximum
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), NaN-propagating
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  if (x != x) return x;
  return fminf(fmaxf(x, lo), hi);
}

// get_fraction (main.c:301-309): snap when an endpoint is missing
__device__ __forceinline__ float get_fraction(float frac, bool start_valid,
                                              bool end_valid) {
  return !start_valid ? 1.0f : (!end_valid ? 0.0f : frac);
}

// bilinear (main.c:318-331); corners already zeroed where invalid.
// First index y (0 bottom, 1 top), second x.
__device__ __forceinline__ float bilinear(float q00, float q01, float q10,
                                          float q11, float fx, float fy,
                                          bool v00, bool v01, bool v10,
                                          bool v11) {
  float lf = get_fraction(fy, v00, v10);
  float rf = get_fraction(fy, v01, v11);
  float left = (1.0f - lf) * q00 + lf * q10;
  float right = (1.0f - rf) * q01 + rf * q11;
  float hf = get_fraction(fx, v00 || v10, v01 || v11);
  return (1.0f - hf) * left + hf * right;
}

// clamp + modf of interpolate (main.c:337-346) relative to the site: the
// base is the site when floor(idx) lands on it, else the cell before it
// (the 3x3-window rule of interp_stencil).  size is the logical extent.
__device__ __forceinline__ void clamped_base(float idx, int site, int size,
                                             int* base, float* frac) {
  float hi = nextafterf(static_cast<float>(size - 1), 0.0f);
  float ix = clip(idx, 0.0f, hi);
  float whole = floorf(ix);
  *frac = ix - whole;
  *base = (static_cast<int>(whole) == site) ? site : site - 1;
}

// The Jacobi solves' packed operator a_diag * fl + 8 * fl (K8-K10's f32
// plane, K12's u8 code) decoded: the fluid flag, the diagonal, and the
// Jacobi inverse diagonal (a fluid cell with a = 0 falls back to the
// identity, pcg_kernel.py:72-75)
struct Cell {
  float fl, a, invd;
};

__device__ __forceinline__ Cell decode(float packed) {
  Cell c;
  c.fl = packed >= 8.0f ? 1.0f : 0.0f;
  c.a = packed - 8.0f * c.fl;
  c.invd = c.fl / fmaxf(c.a, 1.0f);
  return c;
}

enum { EU_SUM = 0, EU_MAX = 1 };

template <int OP, typename T>
__device__ __forceinline__ T eu_combine(T a, T b) {
  return OP == EU_SUM ? a + b : nanmax(a, b);
}

// Block-wide reduction in a fixed order (warp shuffles, then warp 0 over
// the per-warp results), in float or double (P3's f64 levels).
// blockDim.x must be a multiple of 32; the result is valid in thread 0.
// The identity is 0 for both ops (every max here is over non-negative
// values).
template <int OP, typename T>
__device__ T block_reduce(T v) {
  __shared__ T warp_part[32];
  for (int o = 16; o > 0; o >>= 1)
    v = eu_combine<OP>(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = (threadIdx.x < nwarps) ? warp_part[threadIdx.x] : T(0);
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1)
      v = eu_combine<OP>(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

// Second stage of a two-stage reduction: one block folds `n` per-block
// partials in a fixed strided order.  Valid in thread 0.
template <int OP, typename T>
__device__ T reduce_partials(const T* __restrict__ part, int n) {
  T v = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    v = eu_combine<OP>(v, part[i]);
  return block_reduce<OP>(v);
}

// Captures what `enqueue(stream)` launches into *exec, on a stream of its
// own (`enqueue` returns a CUDA error code).  On failure *exec is null.
template <class Enqueue>
inline int capture_graph(cudaGraphExec_t* exec, Enqueue enqueue) {
  *exec = nullptr;
  cudaStream_t cs;
  int rc = static_cast<int>(
      cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking));
  if (rc) return rc;
  rc = static_cast<int>(
      cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal));
  if (!rc) {
    rc = enqueue(cs);
    cudaGraph_t g = nullptr;
    const int rc_end = static_cast<int>(cudaStreamEndCapture(cs, &g));
    if (!rc) rc = rc_end;
    if (!rc) rc = static_cast<int>(cudaGraphInstantiate(exec, g, 0));
    if (g) cudaGraphDestroy(g);
  }
  const int rc_destroy = static_cast<int>(cudaStreamDestroy(cs));
  if (!rc) rc = rc_destroy;
  if (rc && *exec) {
    cudaGraphExecDestroy(*exec);
    *exec = nullptr;
  }
  return rc;
}
