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
//
// Both kernels also share the block layout (several pixels a thread), the
// threshold box that lets a thread skip a slot, the order in which a
// slot's values are summed over a tile's pixels (so the forward's
// visibility equals the backward's visibility row bit for bit) and the
// persistent tile queue.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace tgr {

// feature channels the register-resident instances hold a pixel's
// accumulators for; wider F takes the wide instances below
constexpr int kRegisterFeatures = 16;
constexpr int kPointRows = 7;   // staged floats per point (see stage_point)
constexpr int kStageStride = 8; // floats a staged point takes: two 16-byte loads
constexpr float kLogAlphaFloor = -1e4f;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float one_minus(float x) { return __fsub_rn(1.0f, x); }

// Stage point p (packed mean, axis, sigma, alpha) as the kPointRows
// floats at dst (one 32-byte column of the staged batch, see load_staged),
// in the tile-local frame (ox, oy). Antialias keeps the packed form; the
// conic form stores (mean, qa, qb, qc, log alpha) with
// Q = R diag(sx, sy)^-2 R^T, so that u^2 + v^2 = d^T Q d. Row 6 holds the
// point alpha in both forms.
template <bool kAntialias>
__device__ __forceinline__ void stage_point(const float* __restrict__ p,
                                            float ox, float oy, float* dst) {
  const float ax = p[2], ay = p[3], sx = p[4], sy = p[5], pa = p[6];
  dst[0] = __fsub_rn(p[0], ox);
  dst[1] = __fsub_rn(p[1], oy);
  if (kAntialias) {
    dst[2] = ax;
    dst[3] = ay;
    dst[4] = sx;
    dst[5] = sy;
  } else {
    const float isx2 = __fdiv_rn(1.0f, __fmul_rn(sx, sx));
    const float isy2 = __fdiv_rn(1.0f, __fmul_rn(sy, sy));
    const float axx = __fmul_rn(ax, ax), ayy = __fmul_rn(ay, ay);
    dst[2] = __fadd_rn(__fmul_rn(axx, isx2), __fmul_rn(ayy, isy2));
    dst[3] = __fmul_rn(__fmul_rn(ax, ay), __fsub_rn(isx2, isy2));
    dst[4] = __fadd_rn(__fmul_rn(ayy, isx2), __fmul_rn(axx, isy2));
    dst[5] = fmaxf(logf(fmaxf(pa, 0.0f)), kLogAlphaFloor);
  }
  dst[6] = pa;
}

// ---- the threshold box ---------------------------------------------------
//
// Half-extents (hx, hy) around a point's mean outside which no pixel's
// pre-gate alpha exceeds the threshold, so the kernels skip those (pixel,
// slot) pairs, whose gated alpha is 0: skipping them changes no value. A
// negative extent culls every pixel (the point's peak alpha is below the
// threshold); an infinite or NaN one culls none. ops/raster/bounds.py
// mirrors these formulas (threshold_extent) and holds them against the
// plain pdf; a card test holds the kernels bitwise against builds without
// the box.

// Conic pdf. log_alpha is the staged log alpha. The box holds the ellipse
// d^T Q d <= c, c = 2 (log alpha - log threshold + 1e-3) widened for the
// float rounding of Q and of the quadratic form, which grows with the
// conditioning kappa = (s_max / s_min)^2 (at most 32 eps kappa of the form,
// so 1 + 8e-6 kappa covers it); past kappa = 1e5 the box is unbounded.
__device__ __forceinline__ float2 conic_extent(const float* __restrict__ p,
                                               float log_alpha,
                                               float log_threshold) {
  const float ax = p[2], ay = p[3], sx = p[4], sy = p[5];
  const float ratio = fmaxf(sx, sy) / fminf(sx, sy);
  const float kappa = ratio * ratio;
  if (!(kappa <= 1e5f)) return make_float2(INFINITY, INFINITY);
  const float c = 2.0f * (log_alpha - log_threshold + 1e-3f) * (1.01f + 8e-6f * kappa);
  if (!(c > 0.0f)) return make_float2(-1.0f, -1.0f);
  // (Q^-1)_xx and (Q^-1)_yy from the eigen form, free of cancellation
  const float sxx = sx * sx, syy = sy * sy, norm = ax * ax + ay * ay;
  return make_float2(
      1.001f * sqrtf(c * (ax * ax * sxx + ay * ay * syy)) / norm + 0.01f,
      1.001f * sqrtf(c * (ay * ay * sxx + ax * ax * syy)) / norm + 0.01f);
}

// Antialiased pdf: alpha = pa 2 pi ix iy, ix = sx (S(a) - S(b)) with a, b
// = (tu +- 1/2) / sx, iy the same in tv and sy, S(z) = sigmoid(g(z)) and
// g(z) = 1.6 z + 0.07 z^3 (approx_cdf). S rises at most 0.4 per unit of z
// (at z = 0), so ix <= min(sx, 0.4); for |tu| > 1/2 the tail gives ix <=
// sx exp(-g((|tu| - 1/2) / sx)). Each bound gains kCdfSlack sx for the
// rounding of S - S near 1, and a log margin of 1e-3 covers the rounding
// of the products and of g. So |tu| > eu = 1/2 + sx z, with g(z) = -log(
// threshold e^-1e-3 / (2 pi pa sx iy_max) - slack), leaves alpha below the
// threshold (the same for tv), and the box is the bounding box of that
// rectangle in (tu, tv), d = (ax tu - ay tv, ay tu + ax tv) / |axis|^2.
constexpr float kCdfSlope = 0.404f;   // 0.4 and 1% for the rounding of a - b
constexpr float kCdfSlack = 5e-7f;
constexpr float kLogMargin = 1e-3f;

// The least z >= 0 with g(z) >= L, rounded up: Newton steps from an upper
// bound stay above the root of the convex, increasing g.
__device__ __forceinline__ float cdf_tail_z(float L) {
  if (!(L > 0.0f)) return 0.0f;
  float z = fminf(L / 1.6f, cbrtf(L / 0.07f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    z -= (z * (1.6f + 0.07f * z * z) - L) / (1.6f + 0.21f * z * z);
  }
  return 1.001f * z;
}

// Half-extent in tu (or tv) of sigma s; log_other = log(2 pi pa) plus the
// log of the other direction's largest integral.
__device__ __forceinline__ float antialias_half_extent(float s, float log_other,
                                                       float log_threshold) {
  const float r = expf(log_threshold - kLogMargin - log_other - logf(s)) - kCdfSlack;
  if (!(r > 0.0f)) return INFINITY;
  return 0.5f + s * cdf_tail_z(-logf(r));
}

__device__ __forceinline__ float2 antialias_extent(const float* __restrict__ p,
                                                   float log_threshold) {
  const float ax = p[2], ay = p[3], sx = p[4], sy = p[5], pa = p[6];
  if (!(pa > 0.0f && sx > 0.0f && sy > 0.0f)) return make_float2(INFINITY, INFINITY);
  const float log_ix = logf(fminf(sx, kCdfSlope) + kCdfSlack * sx);
  const float log_iy = logf(fminf(sy, kCdfSlope) + kCdfSlack * sy);
  const float log_peak = logf(kTwoPi * pa);
  if (log_peak + log_ix + log_iy < log_threshold - kLogMargin) {
    return make_float2(-1.0f, -1.0f);
  }
  const float eu = antialias_half_extent(sx, log_peak + log_iy, log_threshold);
  const float ev = antialias_half_extent(sy, log_peak + log_ix, log_threshold);
  const float norm = ax * ax + ay * ay;
  return make_float2(1.001f * (fabsf(ax) * eu + fabsf(ay) * ev) / norm + 0.01f,
                     1.001f * (fabsf(ay) * eu + fabsf(ax) * ev) / norm + 0.01f);
}

// p is the packed point row, staged its staged column (stage_point).
template <bool kAntialias>
__device__ __forceinline__ float2 threshold_extent(const float* __restrict__ p,
                                                   const float* staged,
                                                   float log_threshold) {
  return kAntialias ? antialias_extent(p, log_threshold)
                    : conic_extent(p, staged[5], log_threshold);
}

// True when the thread's pixels (column cx, rows ly0 .. ly0 + ppt - 1)
// all lie outside staged point j's threshold box: the thread skips slot j.
__device__ __forceinline__ bool outside_box(const float* s_pt, const float2* s_ext,
                                            int j, float cx, int ly0, int ppt) {
  const float2 m = *reinterpret_cast<const float2*>(s_pt + kStageStride * j);
  const float2 e = s_ext[j];
  const float ry = fmaxf(fmaxf((ly0 + 0.5f) - m.y, m.y - (ly0 + ppt - 0.5f)), 0.0f);
  return fabsf(cx - m.x) > e.x || ry > e.y;
}

// Stage slots [base, base + count) of the tile's bin as columns 0..count-1
// of s_pt ([batch][kStageStride]), s_feat ([num_features][batch]) and
// s_ext ([batch] threshold boxes): each thread stages every blockDim.x-th
// slot, its index and then its point and feature rows read from device
// memory.
template <bool kAntialias>
__device__ __forceinline__ void stage_batch(
    const float* __restrict__ points, const float* __restrict__ features,
    const int* __restrict__ overlap_to_point, int base, int count,
    int num_features, float ox, float oy, float log_threshold, float* s_pt,
    float* s_feat, float2* s_ext, int batch) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int idx = overlap_to_point[base + j];
    const float* p = points + static_cast<long long>(idx) * kPointRows;
    float* col = s_pt + kStageStride * j;
    stage_point<kAntialias>(p, ox, oy, col);
    s_ext[j] = threshold_extent<kAntialias>(p, col, log_threshold);
    const float* feat = features + static_cast<long long>(idx) * num_features;
    for (int f = 0; f < num_features; ++f) s_feat[f * batch + j] = feat[f];
  }
}

// ---- the wide instances (F > kRegisterFeatures): products of a batch ---
//
// Past kRegisterFeatures a thread cannot keep a pixel's F accumulators (or
// cotangents) in registers next to the replay. The wide instances replay
// each tile's bin once (the forward once a chunk of up to 48 channels) in
// batches of kWideBatch slots; the replay runs the same staging, pdf, gate
// and transmittance code as the register instances and writes each
// (pixel, slot) pair's gated weight W (0 where the pair is gated off) to
// shared memory. The channel sums are then products of a batch, tiled
// from shared memory: the forward's image += W F_batch, the backward's D =
// G F_batch^T and feature rows W^T G (G the tile's cotangents). A warp's
// 32 threads own 32 * kWidePPT pixels: the wide instances take one pixel a
// thread (kWidePPT), in blocks of at most kWideMaxThreads, a layout the
// forward's and the backward's visibility sums share; a pixel's image
// accumulators (the forward) take registers, so one pixel a thread keeps
// a thread's registers, and the blocks an SM holds, near the register
// instances'.
constexpr int kWidePPT = 1;
constexpr int kWideBatch = 32;        // slots a batch: one 32-bit box mask
constexpr int kWarpPixels = 32 * kWidePPT;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Stage slots [base, base + count) of the tile's bin as columns of s_pt
// and s_ext, as stage_batch does, without their features.
template <bool kAntialias>
__device__ __forceinline__ void stage_points(
    const float* __restrict__ points, const int* __restrict__ overlap_to_point,
    int base, int count, float ox, float oy, float log_threshold, float* s_pt,
    float2* s_ext) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int idx = overlap_to_point[base + j];
    const float* p = points + static_cast<long long>(idx) * kPointRows;
    float* col = s_pt + kStageStride * j;
    stage_point<kAntialias>(p, ox, oy, col);
    s_ext[j] = threshold_extent<kAntialias>(p, col, log_threshold);
  }
}

// Stage channels [first, first + width) of the batch's slots as the rows
// of s_feat ([kWideBatch][stride], slot-major), zero past the count slots
// and past the width up to `padded` channels: every entry a product reads
// is finite. The block's threads take (slot, channel) pairs in turn, so a
// slot's channels are read as one contiguous run.
__device__ __forceinline__ void stage_feature_rows(
    const float* __restrict__ features, const int* __restrict__ overlap_to_point,
    int base, int count, int num_features, int first, int width, int padded,
    float* s_feat, int stride) {
  for (int e = threadIdx.x; e < kWideBatch * padded; e += blockDim.x) {
    const int j = e / padded, f = e - j * padded;
    s_feat[j * stride + f] = j < count && f < width
        ? features[static_cast<long long>(overlap_to_point[base + j]) * num_features
                   + first + f]
        : 0.0f;
  }
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

// One staged point in registers: column j of the staged batch, which
// stage_point filled, read with two 16-byte shared loads once per slot and
// shared by the pixels a thread owns.
struct Staged {
  float r[kStageStride];
};

__device__ __forceinline__ Staged load_staged(const float* s_pt, int j) {
  const float4* col = reinterpret_cast<const float4*>(s_pt + kStageStride * j);
  const float4 a = col[0], b = col[1];
  return Staged{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// Pre-gate alpha (point alpha times pdf) of the pixel at tile-local
// centre (cx, cy) and staged point p.
template <bool kAntialias>
__device__ __forceinline__ float alpha_raw(const Staged& p, float cx, float cy,
                                           AntialiasTerms* t) {
  const float dx = __fsub_rn(cx, p.r[0]);
  const float dy = __fsub_rn(cy, p.r[1]);
  if (kAntialias) {
    const float ax = p.r[2], ay = p.r[3];
    const float sx = p.r[4], sy = p.r[5];
    t->tu = __fadd_rn(__fmul_rn(dx, ax), __fmul_rn(dy, ay));
    t->tv = __fsub_rn(__fmul_rn(dy, ax), __fmul_rn(dx, ay));
    t->s[0] = approx_cdf(__fadd_rn(t->tu, 0.5f), sx, &t->z[0]);
    t->s[1] = approx_cdf(__fsub_rn(t->tu, 0.5f), sx, &t->z[1]);
    t->s[2] = approx_cdf(__fadd_rn(t->tv, 0.5f), sy, &t->z[2]);
    t->s[3] = approx_cdf(__fsub_rn(t->tv, 0.5f), sy, &t->z[3]);
    t->ix = __fmul_rn(sx, __fsub_rn(t->s[0], t->s[1]));
    t->iy = __fmul_rn(sy, __fsub_rn(t->s[2], t->s[3]));
    t->pdf = __fmul_rn(__fmul_rn(kTwoPi, t->ix), t->iy);
    return __fmul_rn(p.r[6], t->pdf);
  }
  const float qa = p.r[2], qb = p.r[3], qc = p.r[4];
  const float quad = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(qa, dx), dx),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, qb), dx), dy)),
      __fmul_rn(__fmul_rn(qc, dy), dy));
  return expf(__fsub_rn(p.r[5], __fmul_rn(0.5f, quad)));
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

// ---- the block's layout: several pixels a thread, in pixel chunks -------
//
// A block covers a ts x ts tile in chunks of at most one block: thread t of
// a chunk owns the ppt pixels of column cx0 + t % cols in rows cy0 + (t /
// cols) * ppt + k, k < ppt (pixels past the tile are masked). A warp thus
// covers a compact band of the tile, and a thread loads each staged point
// once for its ppt pixels and adds its pixels' values in registers before
// any cross-lane step. A tile that fits in one block (ts x ceil(ts / ppt)
// threads within the kernel's launch bound) is one chunk; a larger one is
// covered in chunks of `groups` row groups (and of at most the launch
// bound's columns), one after the other, and a per-slot sum over the tile
// is the chunks' sums added in chunk order. The block is padded to whole
// warps with threads that own no pixel: they are done from the start and
// add +0 to every sum, so every live pixel keeps its sum order. Four pixels
// a thread where the tile is whole warps of four and the feature registers
// allow it, two otherwise; the F > 16 (wide) instances one, in blocks of
// at most kWideMaxThreads. Tiles of 8, 16 and 32 pixels are one chunk of
// whole warps in every instance but the wide ones at 32 (four chunks). The
// forward and backward kernels take the same layout for the same (tile
// size, F), which the per-slot sums below rely on.
constexpr int kSmallFeatures = 4;   // feature registers of the F <= 4 instances
constexpr int kWideMaxThreads = 256;

__host__ __device__ constexpr int pixels_per_thread(int tile_size, int num_features) {
  return num_features <= kSmallFeatures && (tile_size * tile_size) % 128 == 0 ? 4 : 2;
}

// the launch bound of the F <= 16 instances with ppt pixels a thread
__host__ __device__ constexpr int max_block_threads(int ppt) {
  return ppt == 4 ? 256 : 512;
}

struct TileLayout {
  int cols;       // tile columns a chunk covers
  int groups;     // row groups of ppt rows a chunk covers
  int chunks_x;   // chunks across the tile
  int chunks;     // chunks in all
  int threads;    // the block: cols * groups, padded to whole warps
};

__host__ __device__ inline TileLayout tile_layout(int tile_size, int ppt,
                                                  int max_threads) {
  TileLayout l;
  l.cols = tile_size < max_threads ? tile_size : max_threads;
  const int row_groups = (tile_size + ppt - 1) / ppt;
  const int fit = max_threads / l.cols;
  l.groups = row_groups < fit ? row_groups : fit;
  l.chunks_x = (tile_size + l.cols - 1) / l.cols;
  const int rows = l.groups * ppt;
  l.chunks = l.chunks_x * ((tile_size + rows - 1) / rows);
  l.threads = (l.cols * l.groups + 31) / 32 * 32;
  return l;
}

// The tile-local column and first row of thread `tid`'s pixels in chunk
// `chunk`; `owner` is false for a padding thread or a column past the tile.
struct ChunkPixels {
  int lx, ly0;
  bool owner;
};

__device__ __forceinline__ ChunkPixels chunk_pixels(const TileLayout& l, int chunk,
                                                    int tid, int ppt, int tile_size) {
  const int col = tid % l.cols, grp = tid / l.cols;
  ChunkPixels c;
  c.lx = (chunk % l.chunks_x) * l.cols + col;
  c.ly0 = (chunk / l.chunks_x) * l.groups * ppt + grp * ppt;
  c.owner = grp < l.groups && c.lx < tile_size;
  return c;
}

// A per-slot sum over the tile: the first chunk writes it, later chunks
// add theirs in chunk order (one thread writes a slot in every chunk).
__device__ __forceinline__ void chunk_store(float* dst, float x, bool first_chunk) {
  *dst = first_chunk ? x : __fadd_rn(*dst, x);
}

// ---- per-slot sums over a tile's pixels, without atomics ---------------
//
// A slot's value is summed in one fixed order: over the thread's pixels in
// k order, starting from 0 (a pixel that adds nothing is skipped, which is
// the same as adding +0 for the non-negative visibility weights); then over
// the warp's lanes by a butterfly of xor offsets 16, 8, 4, 2, 1; then over
// the warps in warp order, starting from 0 (block_slot_sum); then over a
// large tile's pixel chunks in chunk order (chunk_store). Two runs are
// therefore bitwise identical, and the forward's visibility (warp_sum_xor,
// one row) equals the backward's visibility row (transpose_reduce, all rows
// at once) bit for bit: both add the same pairs at every level, and a
// float add is commutative.
constexpr unsigned kFullMask = 0xffffffffu;

// Sum of x over the warp's 32 lanes, in every lane. Every lane must call it.
__device__ __forceinline__ float warp_sum_xor(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// The warp sums of kRows (16 or 32) rows at once. Each butterfly round
// halves the rows a lane holds: the lane keeps one half, sends the other
// to its partner and adds what it receives. kRows - 1 shuffles for 32
// rows, 15 + 1 for 16 (instead of 5 a row). Returns the warp sum of row
// transposed_row<kRows>(lane), which lanes lane and lane ^ 1 both hold
// for 16 rows. Every lane must call it.
template <int kRows, int kHalf>
__device__ __forceinline__ void butterfly_rounds(float (&v)[kRows], int lane) {
  if constexpr (kHalf >= 1) {
    constexpr int kOffset = kRows == 32 ? kHalf : 2 * kHalf;
    const bool upper = (lane & kOffset) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(kFullMask, send, kOffset));
    }
    butterfly_rounds<kRows, kHalf / 2>(v, lane);
  }
}

template <int kRows>
__device__ __forceinline__ float transpose_reduce(float (&v)[kRows], int lane) {
  static_assert(kRows == 16 || kRows == 32, "16 or 32 rows");
  // every index is a compile-time constant, so v stays in registers
  butterfly_rounds<kRows, kRows / 2>(v, lane);
  if (kRows == 16) v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFullMask, v[0], 1));
  return v[0];
}

template <int kRows>
__device__ __forceinline__ int transposed_row(int lane) {
  return kRows == 32 ? lane : lane >> 1;
}

// Sum over the block's warps of the partials part[w * stride], in warp
// order.
__device__ __forceinline__ float block_slot_sum(const float* part, int n_warps,
                                                int stride) {
  float s = 0.0f;
  for (int w = 0; w < n_warps; ++w) s = __fadd_rn(s, part[w * stride]);
  return s;
}

// ---- the persistent tile queue -----------------------------------------
//
// A launch runs as many blocks as fit on the card at once; each takes the
// next tile from `tile_order` (longest bin first, computed by the wrapper)
// through an atomic counter that the launch zeroes first. Which block runs
// a tile changes no output, so two runs stay bitwise identical. Returns
// the tile, or -1 once the queue is empty; uniform over the block.
__device__ __forceinline__ int next_tile(int* tile_counter, const int* tile_order,
                                         int num_tiles, int* s_slot) {
  __syncthreads();   // every thread has read the previous tile's slot
  if (threadIdx.x == 0) *s_slot = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int q = *s_slot;
  return q < num_tiles ? tile_order[q] : -1;
}

// The next work item of a queue of num_items, or -1 once it is empty;
// uniform over the block (next_tile without the tile order, for the wide
// forward's (tile, channel chunk) items).
__device__ __forceinline__ int next_item(int* counter, int num_items, int* s_slot) {
  __syncthreads();
  if (threadIdx.x == 0) *s_slot = atomicAdd(counter, 1);
  __syncthreads();
  const int q = *s_slot;
  return q < num_items ? q : -1;
}

// The persistent grid of a launch: as many blocks of `kernel` as fit on the
// device at once, at most num_tiles (the queue's length: tiles, or the wide
// forward's (tile, channel chunk) items). Sets the dynamic shared memory the
// kernel needs and zeroes the tile counter on the stream. The occupancy
// query is made once per (kernel, block size, shared memory, device) and
// cached: a launch costs little more host time than a plain one.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                              int num_tiles, int* tile_counter,
                              cudaStream_t stream, int* blocks) {
  struct Entry {
    const void* fn;
    int threads;
    size_t smem;
    int device;
    int grid;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int grid = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < cached; ++i) {
      const Entry& e = cache[i];
      if (e.fn == fn && e.threads == threads && e.smem == smem && e.device == device) {
        grid = e.grid;
      }
    }
  }
  // set on every launch: a launch with less shared memory lowers it
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid = per_sm * sms;
    std::lock_guard<std::mutex> lock(mu);
    if (cached < 64) cache[cached++] = Entry{fn, threads, smem, device, grid};
  }
  err = cudaMemsetAsync(tile_counter, 0, sizeof(int), stream);
  *blocks = num_tiles < grid ? num_tiles : grid;
  return err;
}

}  // namespace tgr

extern "C" const char* tgr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
