// Arithmetic shared by the forward and backward raster kernels, and the
// C error-string entry point every source of this package exports.
//
// The backward kernel replays each pixel's front-to-back blend and must
// reproduce the forward's transmittance T bit for bit, so that a pixel
// stops on exactly the point where the forward stopped (no saturation
// counts are passed between the two). Everything that decides T -- the
// staged point rows, the pre-gate alpha, the clamp, the T update and the
// saturation test -- lives here and is written with the IEEE round-to-
// nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which
// the compiler never contracts into fused multiply-adds or reorders. Both
// kernels inline the same instruction sequence whatever code surrounds it.

#pragma once

#include <cuda_runtime.h>

namespace tgr {

constexpr int kMaxFeatures = 16;
constexpr int kPointRows = 7;   // staged floats per point (see stage_point)
constexpr float kLogAlphaFloor = -1e4f;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float one_minus(float x) { return __fsub_rn(1.0f, x); }

// Stage point p (packed mean, axis, sigma, alpha) as column `col` of the
// kPointRows x batch shared buffer, in the tile-local frame (ox, oy).
// Antialias keeps the packed form; the conic form stores
// (mean, qa, qb, qc, log alpha) with Q = R diag(sx, sy)^-2 R^T, so that
// u^2 + v^2 = d^T Q d. Row 6 holds the point alpha in both forms.
template <bool kAntialias>
__device__ __forceinline__ void stage_point(const float* __restrict__ p,
                                            float ox, float oy, float* s_pt,
                                            int batch, int col) {
  const float ax = p[2], ay = p[3], sx = p[4], sy = p[5], pa = p[6];
  s_pt[0 * batch + col] = __fsub_rn(p[0], ox);
  s_pt[1 * batch + col] = __fsub_rn(p[1], oy);
  if (kAntialias) {
    s_pt[2 * batch + col] = ax;
    s_pt[3 * batch + col] = ay;
    s_pt[4 * batch + col] = sx;
    s_pt[5 * batch + col] = sy;
  } else {
    const float isx2 = __fdiv_rn(1.0f, __fmul_rn(sx, sx));
    const float isy2 = __fdiv_rn(1.0f, __fmul_rn(sy, sy));
    const float axx = __fmul_rn(ax, ax), ayy = __fmul_rn(ay, ay);
    s_pt[2 * batch + col] = __fadd_rn(__fmul_rn(axx, isx2), __fmul_rn(ayy, isy2));
    s_pt[3 * batch + col] = __fmul_rn(__fmul_rn(ax, ay), __fsub_rn(isx2, isy2));
    s_pt[4 * batch + col] = __fadd_rn(__fmul_rn(ayy, isx2), __fmul_rn(axx, isy2));
    s_pt[5 * batch + col] = fmaxf(logf(fmaxf(pa, 0.0f)), kLogAlphaFloor);
  }
  s_pt[6 * batch + col] = pa;
}

// Sigmoid approximation of the gaussian CDF, S(x) = sigmoid(z (1.6 +
// 0.07 z^2)) with z = x / s; also returns z for the backward's partials.
__device__ __forceinline__ float approx_cdf(float x, float s, float* z_out) {
  const float z = __fdiv_rn(x, s);
  const float arg = __fadd_rn(__fmul_rn(1.6f, z),
                              __fmul_rn(__fmul_rn(__fmul_rn(0.07f, z), z), z));
  *z_out = z;
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-arg)));
}

// The intermediate values of the antialiased (box-integrated) pdf that
// the backward's partials reuse; the forward lets them go dead.
struct AntialiasTerms {
  float tu, tv;          // d . axis, d . perp(axis)
  float z[4], s[4];      // z and S of (tu + .5, sx), (tu - .5, sx),
                         //            (tv + .5, sy), (tv - .5, sy)
  float ix, iy, pdf;
};

// Pre-gate alpha (point alpha times pdf) of the pixel at tile-local
// centre (cx, cy) and staged point j.
template <bool kAntialias>
__device__ __forceinline__ float alpha_raw(const float* s_pt, int batch, int j,
                                           float cx, float cy,
                                           AntialiasTerms* t) {
  const float dx = __fsub_rn(cx, s_pt[0 * batch + j]);
  const float dy = __fsub_rn(cy, s_pt[1 * batch + j]);
  if (kAntialias) {
    const float ax = s_pt[2 * batch + j], ay = s_pt[3 * batch + j];
    const float sx = s_pt[4 * batch + j], sy = s_pt[5 * batch + j];
    t->tu = __fadd_rn(__fmul_rn(dx, ax), __fmul_rn(dy, ay));
    t->tv = __fsub_rn(__fmul_rn(dy, ax), __fmul_rn(dx, ay));
    t->s[0] = approx_cdf(__fadd_rn(t->tu, 0.5f), sx, &t->z[0]);
    t->s[1] = approx_cdf(__fsub_rn(t->tu, 0.5f), sx, &t->z[1]);
    t->s[2] = approx_cdf(__fadd_rn(t->tv, 0.5f), sy, &t->z[2]);
    t->s[3] = approx_cdf(__fsub_rn(t->tv, 0.5f), sy, &t->z[3]);
    t->ix = __fmul_rn(sx, __fsub_rn(t->s[0], t->s[1]));
    t->iy = __fmul_rn(sy, __fsub_rn(t->s[2], t->s[3]));
    t->pdf = __fmul_rn(__fmul_rn(kTwoPi, t->ix), t->iy);
    return __fmul_rn(s_pt[6 * batch + j], t->pdf);
  }
  const float qa = s_pt[2 * batch + j], qb = s_pt[3 * batch + j];
  const float qc = s_pt[4 * batch + j];
  const float quad = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(qa, dx), dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, qb), dx), dy)),
      __fmul_rn(__fmul_rn(qc, dy), dy));
  return expf(__fsub_rn(s_pt[5 * batch + j], __fmul_rn(0.5f, quad)));
}

// Transmittance after a point of gated alpha a.
__device__ __forceinline__ float transmit(float T, float a) {
  return __fmul_rn(T, one_minus(a));
}

// True once the accumulated weight 1 - T has reached `stop`; T never
// grows, so a pixel's gate stays closed from here on.
__device__ __forceinline__ bool stopped(float T, float stop) {
  return !(one_minus(T) < stop);
}

// Per-slot sums over a tile's pixels, without atomics: each warp sums a
// slot's values over its 32 lanes with warp_sum, lane 0 keeps the partial
// in shared memory for kSub slots at a time, and the block then adds the
// warps' partials in warp order. The order is fixed, so two runs are
// bitwise identical, and the forward's visibility and the backward's
// visibility row, summed the same way, agree bit for bit.
constexpr int kSub = 32;              // slots whose per-warp partials are held
constexpr unsigned kFullMask = 0xffffffffu;

// Sum of x over the warp's 32 lanes, in lane 0. Every lane must call it.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFullMask, x, o);
  return x;
}

}  // namespace tgr

extern "C" const char* tgr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
