// Backward tile rasterizer for Hopper (sm_90a): per-overlap-slot gradient
// rows of the front-to-back alpha blend.
//
// Replaces the TPU kernel taichi_gaussian_rasterizer_tpu/ops/raster/
// backward.py `_backward_kernel` (launched by `raster_backward_pallas`). It
// computes what that kernel computes -- for every overlap slot of a tile,
// the sum over the tile's pixels of
//   * the point rows: 6 conic-transport gradients d/d(mean_x, mean_y, qa,
//     qb, qc, log alpha), or under antialias 7 eigen-form gradients
//     d/d(mean_x, mean_y, axis_x, axis_y, sigma_x, sigma_y, point alpha);
//   * optionally the two heuristic rows (prune cost, split score);
//   * optionally the visibility row (sum of blend weights);
//   * the F feature rows (sum of grad_c * weight)
// -- with the weight image differentiable through a virtual all-ones
// feature. None of its TPU workarounds come along: no flat (tile, chunk)
// list, DMA ring, cotangent prefetch, moment matmul, bf16 pairs or
// saturation counts.
//
// The replay needs no buffer of remaining features: each pixel keeps
// E = sum_c image_c grad_c (weight channel included), its transmittance T
// and the running inclusive sum C of w * D, D = sum_c feature_c grad_c, and
// dL/da_raw = gate * (T D - (E - C) / (1 - a)). The pdf, gate and T
// arithmetic is raster_common.cuh's, the forward kernel's own, so a pixel
// stops on exactly the point where the forward stopped.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3 at 700 W, measured with
// tools/time_raster_kernels.py): at 1M gaussians @2048x1536 (2.70M slots,
// 9 rows) the function needs the pdf, the replay and the rows of the 86.7M
// (pixel, slot) pairs whose alpha passes the threshold: 5.64 GFLOP and 249
// MB, a bound of 0.084 ms on FP32 operations (ops/raster/bounds.py). The
// kernel takes 2.31 ms, 3.6% of the bound, and 2.09 ms (3.8%) for the 2D
// trainer's 12 rows; the one-pixel-a-thread design before it took 7.51 and
// 7.16 ms. Cutting parts out (the tool's --ablate) shows where the time
// goes: the transposed reduction 0.61 ms; staging, the batch sums and the
// tile loop 0.37 ms (the kernel without its slot loop); the slot loop's
// arithmetic the rest, about 1.3 ms. The threshold box saves only 0.07 ms
// here (2.37 ms without it): a warp runs every slot some pixel of its 128
// needs, and 61% of its 5.40M warp-slots hold an active pixel, so the
// active pixels' gradient arithmetic runs with most lanes idle. The design
// before spent 1.98 ms of its 7.51 in 5 shuffles a row for each of 8.36M
// active warp-slots (38.7% of 21.6M).
//
// Design: a persistent grid (as many blocks as fit at once) takes tiles
// longest bin first from the tile queue (raster_common.cuh). A block of
// ts * ts / ppt threads covers a tile, each thread ppt pixels of a column
// (4, or 2 for F > 4 or 8x8 tiles), so a staged point is read from shared
// memory once for ppt pixels and each thread runs ppt independent T chains.
// A batch of 128 slots (32 for F > 4) is staged in shared memory, with each
// point's threshold box; a thread skips a slot whose box misses its
// pixels. For each slot a thread adds its pixels' rows in registers, and a
// warp where any pixel is active reduces all rows at once with
// transpose_reduce (16 shuffles for up to 16 rows, 31 for up to 32, against
// 5 a row before) and stores them with one shared store; the warps'
// partials of the whole batch are then added in warp order and written
// once, so a batch costs two block barriers however many slots it holds. A
// warp whose pixels have all stopped writes zero partials for the rest of
// the batch and leaves it. The rows are computed in one fixed register
// layout (point rows, the two heuristic rows when the instance has them,
// the visibility row, the features) and the launch's flags pick the rows
// written. A block leaves a tile once every pixel has stopped
// (__syncthreads_count); slots after that keep the caller's zeros. Each
// slot belongs to one tile and is written once: no atomics on any output,
// and two runs are bitwise identical. Tried and dropped, measured the same
// way: two pixels a thread at 16x16 tiles (slower here and in the
// visibility forward), and staging through cp.async copies into a raw
// buffer (its shared memory cost blocks an SM; slower).
//
// C interface (bound with ctypes; pointers are device pointers):
//   int tgr_raster_backward(points (N,7) f32, features (N,F) f32,
//                           overlap_to_point (K,) i32, tile_ranges (T,2) i32,
//                           tile_order (T,) i32, tile_counter (1,) i32 scratch,
//                           image (H,W,F) f32, weight (H,W) f32,
//                           grad_image (H,W,F) f32, grad_weight (H,W) f32,
//                           num_tiles, tiles_x, tile_size, width, height, F,
//                           alpha_threshold, clamp_max_alpha,
//                           saturate_threshold, antialias, heuristic,
//                           visibility, K, out (R,K) f32 zero-filled, stream)
// returns the cudaError_t of the launch (0 on success).

#include "raster_common.cuh"

using namespace tgr;

namespace {

// slots staged at a time: the F <= 16 instances hold twice the rows' partials
__host__ __device__ constexpr int batch_slots(int cap) {
  return cap <= kSmallFeatures ? 128 : 32;
}

__host__ __device__ constexpr int point_rows(bool antialias) {
  return antialias ? 7 : 6;
}

// rows of the register layout: point rows, 2 heuristic, 1 visibility, kCap
// features, padded to the transposed reduction's 16 or 32
__host__ __device__ constexpr int padded_rows(int cap) {
  return cap <= kSmallFeatures ? 16 : 32;
}

template <bool kAntialias, bool kHeuristic, int kCap, int kPPT>
__global__ void __launch_bounds__(kPPT == 4 ? 256 : 512)
raster_backward_kernel(const float* __restrict__ points,
                       const float* __restrict__ features,
                       const int* __restrict__ overlap_to_point,
                       const int* __restrict__ tile_ranges,
                       const int* __restrict__ tile_order,
                       int* __restrict__ tile_counter,
                       const float* __restrict__ image,
                       const float* __restrict__ weight,
                       const float* __restrict__ grad_image,
                       const float* __restrict__ grad_weight,
                       int num_tiles, int tiles_x, int tile_size, int width,
                       int height, int num_features, float alpha_threshold,
                       float clamp_max_alpha, float saturate_threshold,
                       int visibility, long long k_stride,
                       float* __restrict__ out) {
  constexpr int kNP = point_rows(kAntialias);
  constexpr int kHeur = kNP, kVis = kNP + 2, kFeat = kNP + 3;
  constexpr int kRows = padded_rows(kCap);
  static_assert(kFeat + kCap <= kRows, "rows exceed the reduction");
  constexpr unsigned kAllDone = (1u << kPPT) - 1;
  constexpr int batch = batch_slots(kCap);

  extern __shared__ float smem[];
  __shared__ int s_rowmap[kRows];   // output row -> register row
  __shared__ int s_slot;
  const int threads = blockDim.x;
  const int n_warps = threads / 32;
  constexpr int part_stride = batch + 1;  // padded: conflict-free stores and reads
  float* s_pt = smem;                                // [batch][kStageStride]
  float2* s_ext = reinterpret_cast<float2*>(s_pt + kStageStride * batch);  // [batch]
  float* s_feat = reinterpret_cast<float*>(s_ext + batch);  // [F][batch]
  float* s_part = s_feat + num_features * batch;     // [n_warps][kRows][batch + 1]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lx = tid % tile_size, ly0 = (tid / tile_size) * kPPT;
  const float cx = lx + 0.5f;
  const float log_threshold = logf(alpha_threshold);
  const int rows = kNP + (kHeuristic ? 2 : 0) + (visibility ? 1 : 0) + num_features;
  if (tid == 0) {
    int r = 0;
    for (int i = 0; i < kNP; ++i) s_rowmap[r++] = i;
    if (kHeuristic) { s_rowmap[r++] = kHeur; s_rowmap[r++] = kHeur + 1; }
    if (visibility) s_rowmap[r++] = kVis;
    for (int f = 0; f < num_features; ++f) s_rowmap[r++] = kFeat + f;
  }

  for (;;) {
    const int tile = next_tile(tile_counter, tile_order, num_tiles, &s_slot);
    if (tile < 0) break;
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    const float ox = static_cast<float>(tx * tile_size);
    const float oy = static_cast<float>(ty * tile_size);
    const int start = tile_ranges[2 * tile];
    const int end = tile_ranges[2 * tile + 1];

    // per pixel: cotangents, E = sum_c image_c * grad_c over the features
    // and the weight channel, T and C
    float g[kPPT][kCap], gw[kPPT], E[kPPT], T[kPPT], C[kPPT];
    unsigned done = 0;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int ly = ly0 + k;
      const int px = tx * tile_size + lx, py = ty * tile_size + ly;
      gw[k] = 0.0f;
      E[k] = 0.0f;
      T[k] = 1.0f;
      C[k] = 0.0f;
#pragma unroll
      for (int f = 0; f < kCap; ++f) g[k][f] = 0.0f;
      if (ly < tile_size && px < width && py < height) {
        const long long pix = static_cast<long long>(py) * width + px;
#pragma unroll
        for (int f = 0; f < kCap; ++f) {
          if (f < num_features) {
            g[k][f] = grad_image[pix * num_features + f];
            E[k] += image[pix * num_features + f] * g[k][f];
          }
        }
        gw[k] = grad_weight[pix];
        E[k] += weight[pix] * gw[k];
      } else {
        done |= 1u << k;
      }
    }

    for (int base = start; base < end; base += batch) {
      const int count = min(batch, end - base);   // the last batch is short
      stage_batch<kAntialias>(points, features, overlap_to_point, base, count,
                              num_features, ox, oy, log_threshold, s_pt,
                              s_feat, s_ext, batch);
      __syncthreads();

      for (int j = 0; j < count; ++j) {
        // once the warp's pixels have all stopped, its partials of the
        // batch's remaining slots are zeros
        if (__all_sync(kFullMask, done == kAllDone)) {
          float* part = s_part + warp * kRows * part_stride;
          for (int r = 0; r < kRows; ++r) {
            for (int i = j + lane; i < count; i += 32) part[r * part_stride + i] = 0.0f;
          }
          break;
        }
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
        bool any = false;
        // a thread skips a slot whose threshold box misses its pixels
        // (raster_common.cuh)
        if (done != kAllDone && !outside_box(s_pt, s_ext, j, cx, ly0, kPPT)) {
          const Staged p = load_staged(s_pt, j);
          // the conic pre-gate alphas of the thread's pixels first, as
          // independent chains; the antialiased ones below, where the
          // partials reuse their terms
          float a_raws[kPPT];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            AntialiasTerms unused;
            if (!kAntialias) {
              a_raws[k] = alpha_raw<false>(p, cx, (ly0 + k) + 0.5f, &unused);
            }
          }
          float feat[kCap];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            if (done & (1u << k)) continue;
            const float cy = (ly0 + k) + 0.5f;
            AntialiasTerms t;
            const float a_raw = kAntialias ? alpha_raw<true>(p, cx, cy, &t) : a_raws[k];
            // a stopped pixel is done, so the saturation gate is open here;
            // below the threshold the gated alpha is 0 and every row is 0
            if (!(a_raw > alpha_threshold)) continue;
            if (!any) {
#pragma unroll
              for (int f = 0; f < kCap; ++f) {
                feat[f] = f < num_features ? s_feat[f * batch + j] : 0.0f;
              }
              any = true;
            }
            const float a = fminf(a_raw, clamp_max_alpha);
            const float w = __fmul_rn(a, T[k]);
            float D = gw[k];
#pragma unroll
            for (int f = 0; f < kCap; ++f) D += feat[f] * g[k][f];
            C[k] += w * D;
            // the clamp gate: d a / d a_raw is 0 where alpha was clamped
            const float dl = a_raw < clamp_max_alpha
                ? T[k] * D - __fdividef(E[k] - C[k], 1.0f - a) : 0.0f;

            const float dx = cx - p.r[0];
            const float dy = cy - p.r[1];
            if (kAntialias) {
              const float ax = p.r[2], ay = p.r[3];
              const float sx = p.r[4], sy = p.r[5];
              const float pa = p.r[6];
              // partials of the box-integrated pdf (blend.chunk_pdf_with_grads)
              float ds_dx[4], ds_ds[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float z = t.z[q], s = t.s[q];
                const float sig = q < 2 ? sx : sy;
                const float dz = (1.6f + 0.21f * z * z) * s * (1.0f - s);
                ds_dx[q] = dz / sig;
                ds_ds[q] = -ds_dx[q] * z;
              }
              const float dpx = kTwoPi * t.iy * sx * (ds_dx[0] - ds_dx[1]);
              const float dpy = kTwoPi * t.ix * sy * (ds_dx[2] - ds_dx[3]);
              const float d_mx = -(dpx * ax - dpy * ay);
              const float d_my = -(dpx * ay + dpy * ax);
              const float d_pdf = dl * pa;
              v[0] += d_pdf * d_mx;
              v[1] += d_pdf * d_my;
              v[2] += d_pdf * (dpx * dx + dpy * dy);
              v[3] += d_pdf * (dpx * dy - dpy * dx);
              v[4] += d_pdf * (kTwoPi * t.iy
                               * (t.s[0] - t.s[1] + (ds_ds[0] - ds_ds[1]) * sx));
              v[5] += d_pdf * (kTwoPi * t.ix
                               * (t.s[2] - t.s[3] + (ds_ds[2] - ds_ds[3]) * sy));
              v[6] += dl * t.pdf;
              if (kHeuristic) {
                v[kHeur] += d_pdf * d_pdf;
                v[kHeur + 1] += fabsf(d_pdf * d_mx) + fabsf(d_pdf * d_my);
              }
            } else {
              const float qa = p.r[2], qb = p.r[3], qc = p.r[4];
              // log a = log pa - d^T Q d / 2 with d = pixel - mean
              const float B = dl * a_raw;
              const float qx = qa * dx + qb * dy, qy = qb * dx + qc * dy;
              v[0] += B * qx;
              v[1] += B * qy;
              v[2] += -0.5f * B * dx * dx;
              v[3] += -B * dx * dy;
              v[4] += -0.5f * B * dy * dy;
              v[5] += B;
              // the per-point pa^2 factor of the prune cost is applied
              // after the reduction (function.py)
              if (kHeuristic) {
                v[kHeur] += dl * dl;
                v[kHeur + 1] += fabsf(B * qx) + fabsf(B * qy);
              }
            }
            // the visibility row in the shared sum order (raster_common.cuh)
            v[kVis] = __fadd_rn(v[kVis], w);
#pragma unroll
            for (int f = 0; f < kCap; ++f) v[kFeat + f] += g[k][f] * w;
            T[k] = transmit(T[k], a);
            if (stopped(T[k], saturate_threshold)) done |= 1u << k;
          }
        }

        // this warp's partial of every row, one shared store
        float* part = s_part + warp * kRows * part_stride + j;
        const int row = transposed_row<kRows>(lane);
        if (__any_sync(kFullMask, any)) {
          const float x = transpose_reduce<kRows>(v, lane);
          if (kRows == 32 || !(lane & 1)) part[row * part_stride] = x;
        } else if (kRows == 32 || !(lane & 1)) {
          part[row * part_stride] = 0.0f;
        }
      }

      // the block's sums of the batch's slots, warps added in order
      const int alive = __syncthreads_count(done != kAllDone);
      for (int r = 0; r < rows; ++r) {
        const float* part = s_part + s_rowmap[r] * part_stride;
        for (int j = tid; j < count; j += threads) {
          out[r * k_stride + base + j] =
              block_slot_sum(part + j, n_warps, kRows * part_stride);
        }
      }
      // slots past the point where every pixel stopped keep their zeros
      if (!alive) break;
    }
  }
}

size_t shared_bytes(int threads, int num_features, int rows, int batch) {
  return sizeof(float)
      * (static_cast<size_t>(batch) * (kStageStride + 2 + num_features)
         + static_cast<size_t>(threads / 32) * rows * (batch + 1));
}

template <bool kAntialias, bool kHeuristic, int kCap, int kPPT>
cudaError_t launch(const float* points, const float* features,
                   const int* overlap_to_point, const int* tile_ranges,
                   const int* tile_order, int* tile_counter,
                   const float* image, const float* weight,
                   const float* grad_image, const float* grad_weight,
                   int num_tiles, int tiles_x, int tile_size, int width,
                   int height, int num_features, float alpha_threshold,
                   float clamp_max_alpha, float saturate_threshold,
                   int visibility, long long k_stride,
                   float* out, cudaStream_t stream) {
  auto kernel = raster_backward_kernel<kAntialias, kHeuristic, kCap, kPPT>;
  const int threads = block_threads(tile_size, kPPT);
  const size_t smem = shared_bytes(threads, num_features, padded_rows(kCap),
                                   batch_slots(kCap));
  int blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, threads, smem, num_tiles,
                                            tile_counter, stream, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      image, weight, grad_image, grad_weight, num_tiles, tiles_x, tile_size,
      width, height, num_features, alpha_threshold, clamp_max_alpha,
      saturate_threshold, visibility, k_stride, out);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const int*,
                                 const int*, const int*, int*, const float*,
                                 const float*, const float*, const float*, int,
                                 int, int, int, int, int, float, float, float,
                                 int, long long, float*, cudaStream_t);

// the template instances, indexed by (antialias * 2 + heuristic) * 3 +
// layout, layout 0: F <= 4 and 4 pixels a thread, 1: F <= 4 and 2, 2:
// F <= 16 and 2
#define TGR_LAYOUTS(AA, HEUR)                                       \
  launch<AA, HEUR, kSmallFeatures, 4>,                              \
      launch<AA, HEUR, kSmallFeatures, 2>,                          \
      launch<AA, HEUR, kRegisterFeatures, 2>
constexpr LaunchFn kLaunch[12] = {
    TGR_LAYOUTS(false, false), TGR_LAYOUTS(false, true),
    TGR_LAYOUTS(true, false),  TGR_LAYOUTS(true, true)};
#undef TGR_LAYOUTS

// ---- F > kRegisterFeatures: a point pass, then feature-row passes ---------
//
// Every point row needs D = sum_c feature_c grad_c over all F channels
// before the slot's dL/da_raw is known, and the register rows top out at
// the transposed reduction's 32. So the wide path runs two kernels, each
// writing disjoint rows of the (R, K) output: no atomics, and two runs are
// bitwise identical.
//
// The point pass (raster_backward_point_kernel) writes the point rows, the
// heuristic rows and the visibility row, 16 register rows. Before the
// replay of a batch of kWideBatch slots, each thread sums D for its pixels
// and the batch's slots whose threshold box reaches them, over the
// channels in groups of 16 in a fixed order: a group's [16][batch] feature
// slice staged in shared memory, the pixels' cotangents of the group in
// registers, and the running D in shared memory ([batch][pixels], each
// thread its own columns). E is summed over all F channels from device
// memory once a tile. The replay is the register instances' with D read
// from shared memory; its layout (two pixels a thread) and its visibility
// sum are those of the forward's visibility instances for F > 4, so the
// visibility row equals the forward's visibility bit for bit.
//
// The feature pass (raster_backward_feature_kernel) takes (tile, group of
// 32 feature rows) work items. A feature row needs only the weight w of
// each pair, so the replay keeps no D, E or C: the pixels' cotangents of
// the group in registers, sum grad_c * w per slot, the transposed
// reduction of 32 rows. Shared memory stays bounded for every F.
//
// At F = 34 on the 1M @2048x1536 frame (chip_smoke.py phase 10, NVIDIA
// H100 80GB HBM3 at 700 W) the two take 12.3 ms, 3.6% of their bound (the
// images' and the (40, K) rows' bytes). Timed at F = 17, 34, 64 and 128,
// the launch grows by about 0.23 ms a channel; cutting parts out
// (tools/time_raster_kernels.py --ablate) at F = 34 shows D's sums cost
// 1.3 ms and each batch's cotangent loads 0.02 ms, so most of that growth
// lies elsewhere; the tool's other wide ablations time the feature
// slices' staging, E and the feature passes (PERF.md section 6).
constexpr int kWideBatch = 32;     // slots a batch: one 32-bit box mask
constexpr int kFeatureRows = 32;   // feature rows a feature-pass item writes
constexpr int kPointRowsPadded = 16;

template <bool kAntialias, bool kHeuristic>
__global__ void __launch_bounds__(512)
raster_backward_point_kernel(const float* __restrict__ points,
                             const float* __restrict__ features,
                             const int* __restrict__ overlap_to_point,
                             const int* __restrict__ tile_ranges,
                             const int* __restrict__ tile_order,
                             int* __restrict__ tile_counter,
                             const float* __restrict__ image,
                             const float* __restrict__ weight,
                             const float* __restrict__ grad_image,
                             const float* __restrict__ grad_weight,
                             int num_tiles, int tiles_x, int tile_size,
                             int width, int height, int num_features,
                             float alpha_threshold, float clamp_max_alpha,
                             float saturate_threshold, int visibility,
                             long long k_stride, float* __restrict__ out) {
  constexpr int kPPT = kWidePPT;
  constexpr int kNP = point_rows(kAntialias);
  constexpr int kHeur = kNP, kVis = kNP + 2;
  constexpr int kRows = kPointRowsPadded;
  constexpr int kGroup = kRegisterFeatures;
  static_assert(kVis < kRows, "rows exceed the reduction");
  constexpr unsigned kAllDone = (1u << kPPT) - 1;
  constexpr int batch = kWideBatch;
  constexpr int part_stride = batch + 1;

  extern __shared__ float smem[];
  __shared__ int s_rowmap[kRows];
  __shared__ int s_slot;
  const int threads = blockDim.x;
  const int n_warps = threads / 32;
  float* s_pt = smem;                                // [batch][kStageStride]
  float2* s_ext = reinterpret_cast<float2*>(s_pt + kStageStride * batch);  // [batch]
  float* s_feat = reinterpret_cast<float*>(s_ext + batch);  // [kGroup][batch]
  float* s_D = s_feat + kGroup * batch;              // [batch][kPPT][threads]
  float* s_part = s_D + batch * kPPT * threads;      // [n_warps][kRows][batch + 1]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lx = tid % tile_size, ly0 = (tid / tile_size) * kPPT;
  const float cx = lx + 0.5f;
  const float log_threshold = logf(alpha_threshold);
  const int rows = kNP + (kHeuristic ? 2 : 0) + (visibility ? 1 : 0);
  if (tid == 0) {
    int r = 0;
    for (int i = 0; i < kNP; ++i) s_rowmap[r++] = i;
    if (kHeuristic) { s_rowmap[r++] = kHeur; s_rowmap[r++] = kHeur + 1; }
    if (visibility) s_rowmap[r++] = kVis;
  }
  // the running D of the thread's pixel k and the batch's slot j
  auto d_at = [&](int j, int k) -> float& { return s_D[(j * kPPT + k) * threads + tid]; };

  for (;;) {
    const int tile = next_tile(tile_counter, tile_order, num_tiles, &s_slot);
    if (tile < 0) break;
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    const float ox = static_cast<float>(tx * tile_size);
    const float oy = static_cast<float>(ty * tile_size);
    const int start = tile_ranges[2 * tile];
    const int end = tile_ranges[2 * tile + 1];

    // per pixel: its offset in the images, the weight's cotangent, E =
    // sum_c image_c * grad_c over all channels and the weight, T and C
    long long pix[kPPT];
    float gw[kPPT], E[kPPT], T[kPPT], C[kPPT];
    unsigned done = 0;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int ly = ly0 + k;
      const int px = tx * tile_size + lx, py = ty * tile_size + ly;
      pix[k] = 0;
      gw[k] = 0.0f;
      E[k] = 0.0f;
      T[k] = 1.0f;
      C[k] = 0.0f;
      if (ly < tile_size && px < width && py < height) {
        pix[k] = static_cast<long long>(py) * width + px;
        const float* img = image + pix[k] * num_features;
        const float* grd = grad_image + pix[k] * num_features;
        for (int f = 0; f < num_features; ++f) E[k] += img[f] * grd[f];
        gw[k] = grad_weight[pix[k]];
        E[k] += weight[pix[k]] * gw[k];
      } else {
        done |= 1u << k;
      }
    }

    for (int base = start; base < end; base += batch) {
      const int count = min(batch, end - base);
      stage_points<kAntialias>(points, overlap_to_point, base, count, ox, oy,
                               log_threshold, s_pt, s_ext);
      __syncthreads();

      // the slots whose threshold box reaches the thread's live pixels
      unsigned inbox = 0;
      if (done != kAllDone) {
        for (int j = 0; j < count; ++j) {
          if (!outside_box(s_pt, s_ext, j, cx, ly0, kPPT)) inbox |= 1u << j;
        }
      }
      // D over the channels, a group at a time
      for (int f0 = 0; f0 < num_features; f0 += kGroup) {
        const int nf = min(kGroup, num_features - f0);
        if (f0 > 0) __syncthreads();   // the previous slice has been read
        stage_feature_slice(features, overlap_to_point, base, count,
                            num_features, f0, nf, s_feat, batch);
        float g[kPPT][kGroup];
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
#pragma unroll
          for (int f = 0; f < kGroup; ++f) {
            g[k][f] = (inbox != 0 && f < nf && !(done & (1u << k)))
                ? grad_image[pix[k] * num_features + f0 + f] : 0.0f;
          }
        }
        __syncthreads();
        for (unsigned todo = inbox; todo != 0; todo &= todo - 1) {
          const int j = __ffs(todo) - 1;
          float d[kPPT];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) d[k] = 0.0f;
#pragma unroll
          for (int f = 0; f < kGroup; ++f) {
            const float x = s_feat[f * batch + j];
#pragma unroll
            for (int k = 0; k < kPPT; ++k) d[k] += x * g[k][f];
          }
#pragma unroll
          for (int k = 0; k < kPPT; ++k) d_at(j, k) = f0 == 0 ? d[k] : d_at(j, k) + d[k];
        }
      }

      for (int j = 0; j < count; ++j) {
        if (__all_sync(kFullMask, done == kAllDone)) {
          float* part = s_part + warp * kRows * part_stride;
          for (int r = 0; r < kRows; ++r) {
            for (int i = j + lane; i < count; i += 32) part[r * part_stride + i] = 0.0f;
          }
          break;
        }
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
        bool any = false;
        if (done != kAllDone && (inbox & (1u << j))) {
          const Staged p = load_staged(s_pt, j);
          float a_raws[kPPT];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            AntialiasTerms unused;
            if (!kAntialias) {
              a_raws[k] = alpha_raw<false>(p, cx, (ly0 + k) + 0.5f, &unused);
            }
          }
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            if (done & (1u << k)) continue;
            const float cy = (ly0 + k) + 0.5f;
            AntialiasTerms t;
            const float a_raw = kAntialias ? alpha_raw<true>(p, cx, cy, &t) : a_raws[k];
            if (!(a_raw > alpha_threshold)) continue;
            any = true;
            const float a = fminf(a_raw, clamp_max_alpha);
            const float w = __fmul_rn(a, T[k]);
            const float D = gw[k] + d_at(j, k);
            C[k] += w * D;
            const float dl = a_raw < clamp_max_alpha
                ? T[k] * D - __fdividef(E[k] - C[k], 1.0f - a) : 0.0f;

            const float dx = cx - p.r[0];
            const float dy = cy - p.r[1];
            if (kAntialias) {
              const float ax = p.r[2], ay = p.r[3];
              const float sx = p.r[4], sy = p.r[5];
              const float pa = p.r[6];
              float ds_dx[4], ds_ds[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float z = t.z[q], s = t.s[q];
                const float sig = q < 2 ? sx : sy;
                const float dz = (1.6f + 0.21f * z * z) * s * (1.0f - s);
                ds_dx[q] = dz / sig;
                ds_ds[q] = -ds_dx[q] * z;
              }
              const float dpx = kTwoPi * t.iy * sx * (ds_dx[0] - ds_dx[1]);
              const float dpy = kTwoPi * t.ix * sy * (ds_dx[2] - ds_dx[3]);
              const float d_mx = -(dpx * ax - dpy * ay);
              const float d_my = -(dpx * ay + dpy * ax);
              const float d_pdf = dl * pa;
              v[0] += d_pdf * d_mx;
              v[1] += d_pdf * d_my;
              v[2] += d_pdf * (dpx * dx + dpy * dy);
              v[3] += d_pdf * (dpx * dy - dpy * dx);
              v[4] += d_pdf * (kTwoPi * t.iy
                               * (t.s[0] - t.s[1] + (ds_ds[0] - ds_ds[1]) * sx));
              v[5] += d_pdf * (kTwoPi * t.ix
                               * (t.s[2] - t.s[3] + (ds_ds[2] - ds_ds[3]) * sy));
              v[6] += dl * t.pdf;
              if (kHeuristic) {
                v[kHeur] += d_pdf * d_pdf;
                v[kHeur + 1] += fabsf(d_pdf * d_mx) + fabsf(d_pdf * d_my);
              }
            } else {
              const float qa = p.r[2], qb = p.r[3], qc = p.r[4];
              const float B = dl * a_raw;
              const float qx = qa * dx + qb * dy, qy = qb * dx + qc * dy;
              v[0] += B * qx;
              v[1] += B * qy;
              v[2] += -0.5f * B * dx * dx;
              v[3] += -B * dx * dy;
              v[4] += -0.5f * B * dy * dy;
              v[5] += B;
              if (kHeuristic) {
                v[kHeur] += dl * dl;
                v[kHeur + 1] += fabsf(B * qx) + fabsf(B * qy);
              }
            }
            // the visibility row in the shared sum order (raster_common.cuh)
            v[kVis] = __fadd_rn(v[kVis], w);
            T[k] = transmit(T[k], a);
            if (stopped(T[k], saturate_threshold)) done |= 1u << k;
          }
        }

        float* part = s_part + warp * kRows * part_stride + j;
        const int row = transposed_row<kRows>(lane);
        if (__any_sync(kFullMask, any)) {
          const float x = transpose_reduce<kRows>(v, lane);
          if (!(lane & 1)) part[row * part_stride] = x;
        } else if (!(lane & 1)) {
          part[row * part_stride] = 0.0f;
        }
      }

      const int alive = __syncthreads_count(done != kAllDone);
      for (int r = 0; r < rows; ++r) {
        const float* part = s_part + s_rowmap[r] * part_stride;
        for (int j = tid; j < count; j += threads) {
          out[r * k_stride + base + j] =
              block_slot_sum(part + j, n_warps, kRows * part_stride);
        }
      }
      if (!alive) break;
    }
  }
}

template <bool kAntialias>
__global__ void __launch_bounds__(512)
raster_backward_feature_kernel(const float* __restrict__ points,
                               const int* __restrict__ overlap_to_point,
                               const int* __restrict__ tile_ranges,
                               const int* __restrict__ tile_order,
                               int* __restrict__ tile_counter,
                               const float* __restrict__ grad_image,
                               int num_tiles, int tiles_x, int tile_size,
                               int width, int height, int num_features,
                               float alpha_threshold, float clamp_max_alpha,
                               float saturate_threshold, int row0,
                               long long k_stride, float* __restrict__ out) {
  constexpr int kPPT = kWidePPT;
  constexpr int kRows = kFeatureRows;
  constexpr unsigned kAllDone = (1u << kPPT) - 1;
  constexpr int batch = kWideBatch;
  constexpr int part_stride = batch + 1;

  extern __shared__ float smem[];
  __shared__ int s_slot;
  const int threads = blockDim.x;
  const int n_warps = threads / 32;
  float* s_pt = smem;                                // [batch][kStageStride]
  float2* s_ext = reinterpret_cast<float2*>(s_pt + kStageStride * batch);  // [batch]
  float* s_part = reinterpret_cast<float*>(s_ext + batch);  // [n_warps][kRows][batch + 1]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lx = tid % tile_size, ly0 = (tid / tile_size) * kPPT;
  const float cx = lx + 0.5f;
  const float log_threshold = logf(alpha_threshold);
  const int groups = channel_groups(num_features, kRows);

  for (;;) {
    const int item = next_item(tile_counter, num_tiles * groups, &s_slot);
    if (item < 0) break;
    const int tile = tile_order[item / groups];
    const int f0 = (item % groups) * kRows;
    const int nf = min(kRows, num_features - f0);
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    const float ox = static_cast<float>(tx * tile_size);
    const float oy = static_cast<float>(ty * tile_size);
    const int start = tile_ranges[2 * tile];
    const int end = tile_ranges[2 * tile + 1];

    float g[kPPT][kRows], T[kPPT];
    unsigned done = 0;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int ly = ly0 + k;
      const int px = tx * tile_size + lx, py = ty * tile_size + ly;
      T[k] = 1.0f;
      const bool inside = ly < tile_size && px < width && py < height;
      const float* grd = grad_image
          + (static_cast<long long>(py) * width + px) * num_features + f0;
#pragma unroll
      for (int f = 0; f < kRows; ++f) g[k][f] = inside && f < nf ? grd[f] : 0.0f;
      if (!inside) done |= 1u << k;
    }

    for (int base = start; base < end; base += batch) {
      const int count = min(batch, end - base);
      stage_points<kAntialias>(points, overlap_to_point, base, count, ox, oy,
                               log_threshold, s_pt, s_ext);
      __syncthreads();

      for (int j = 0; j < count; ++j) {
        if (__all_sync(kFullMask, done == kAllDone)) {
          float* part = s_part + warp * kRows * part_stride;
          for (int r = 0; r < kRows; ++r) {
            for (int i = j + lane; i < count; i += 32) part[r * part_stride + i] = 0.0f;
          }
          break;
        }
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
        bool any = false;
        if (done != kAllDone && !outside_box(s_pt, s_ext, j, cx, ly0, kPPT)) {
          const Staged p = load_staged(s_pt, j);
          float a_raws[kPPT];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            AntialiasTerms unused;
            a_raws[k] = alpha_raw<kAntialias>(p, cx, (ly0 + k) + 0.5f, &unused);
          }
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            if ((done & (1u << k)) || !(a_raws[k] > alpha_threshold)) continue;
            any = true;
            const float a = fminf(a_raws[k], clamp_max_alpha);
            const float w = __fmul_rn(a, T[k]);
#pragma unroll
            for (int f = 0; f < kRows; ++f) v[f] += g[k][f] * w;
            T[k] = transmit(T[k], a);
            if (stopped(T[k], saturate_threshold)) done |= 1u << k;
          }
        }

        float* part = s_part + warp * kRows * part_stride + j;
        if (__any_sync(kFullMask, any)) {
          part[lane * part_stride] = transpose_reduce<kRows>(v, lane);
        } else {
          part[lane * part_stride] = 0.0f;
        }
      }

      const int alive = __syncthreads_count(done != kAllDone);
      for (int r = 0; r < nf; ++r) {
        const float* part = s_part + r * part_stride;
        for (int j = tid; j < count; j += threads) {
          out[(row0 + f0 + r) * k_stride + base + j] =
              block_slot_sum(part + j, n_warps, kRows * part_stride);
        }
      }
      if (!alive) break;
    }
  }
}

template <bool kAntialias, bool kHeuristic>
cudaError_t launch_wide(const float* points, const float* features,
                        const int* overlap_to_point, const int* tile_ranges,
                        const int* tile_order, int* tile_counter,
                        const float* image, const float* weight,
                        const float* grad_image, const float* grad_weight,
                        int num_tiles, int tiles_x, int tile_size, int width,
                        int height, int num_features, float alpha_threshold,
                        float clamp_max_alpha, float saturate_threshold,
                        int visibility, long long k_stride, float* out,
                        cudaStream_t stream) {
  const int threads = block_threads(tile_size, kWidePPT);
  const int n_warps = threads / 32;
  auto point_kernel = raster_backward_point_kernel<kAntialias, kHeuristic>;
  const size_t point_smem = sizeof(float)
      * (static_cast<size_t>(kWideBatch)
             * (kStageStride + 2 + kRegisterFeatures + kWidePPT * threads)
         + static_cast<size_t>(n_warps) * kPointRowsPadded * (kWideBatch + 1));
  int blocks = 0;
  cudaError_t err = persistent_blocks(point_kernel, threads, point_smem,
                                      num_tiles, tile_counter, stream, &blocks);
  if (err != cudaSuccess) return err;
  point_kernel<<<blocks, threads, point_smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      image, weight, grad_image, grad_weight, num_tiles, tiles_x, tile_size,
      width, height, num_features, alpha_threshold, clamp_max_alpha,
      saturate_threshold, visibility, k_stride, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto feature_kernel = raster_backward_feature_kernel<kAntialias>;
  const size_t feature_smem = sizeof(float)
      * (static_cast<size_t>(kWideBatch) * (kStageStride + 2)
         + static_cast<size_t>(n_warps) * kFeatureRows * (kWideBatch + 1));
  const int items = num_tiles * channel_groups(num_features, kFeatureRows);
  const int row0 = point_rows(kAntialias) + (kHeuristic ? 2 : 0) + (visibility ? 1 : 0);
  err = persistent_blocks(feature_kernel, threads, feature_smem, items,
                          tile_counter, stream, &blocks);
  if (err != cudaSuccess) return err;
  feature_kernel<<<blocks, threads, feature_smem, stream>>>(
      points, overlap_to_point, tile_ranges, tile_order, tile_counter,
      grad_image, num_tiles, tiles_x, tile_size, width, height, num_features,
      alpha_threshold, clamp_max_alpha, saturate_threshold, row0, k_stride, out);
  return cudaGetLastError();
}

// indexed by antialias * 2 + heuristic
constexpr LaunchFn kLaunchWide[4] = {
    launch_wide<false, false>, launch_wide<false, true>,
    launch_wide<true, false>, launch_wide<true, true>};

}  // namespace

extern "C" int tgr_raster_backward(
    const float* points, const float* features, const int* overlap_to_point,
    const int* tile_ranges, const int* tile_order, int* tile_counter,
    const float* image, const float* weight, const float* grad_image,
    const float* grad_weight, int num_tiles, int tiles_x, int tile_size,
    int width, int height, int num_features, float alpha_threshold,
    float clamp_max_alpha, float saturate_threshold, int antialias,
    int heuristic, int visibility, long long k_stride, float* out,
    void* stream) {
  if (num_features < 1) return cudaErrorInvalidValue;
  // whole warps only: every lane takes part in the row shuffles
  if (tile_size < 1 || tile_size * tile_size > 1024
      || (tile_size * tile_size) % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  if (num_tiles == 0) return cudaSuccess;
  if (num_features > kRegisterFeatures) {
    return kLaunchWide[(antialias ? 2 : 0) + (heuristic ? 1 : 0)](
        points, features, overlap_to_point, tile_ranges, tile_order,
        tile_counter, image, weight, grad_image, grad_weight, num_tiles,
        tiles_x, tile_size, width, height, num_features, alpha_threshold,
        clamp_max_alpha, saturate_threshold, visibility, k_stride, out,
        static_cast<cudaStream_t>(stream));
  }
  const int ppt = pixels_per_thread(tile_size, num_features);
  const int layout = num_features > kSmallFeatures ? 2 : (ppt == 4 ? 0 : 1);
  return kLaunch[((antialias ? 2 : 0) + (heuristic ? 1 : 0)) * 3 + layout](
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      image, weight, grad_image, grad_weight, num_tiles, tiles_x, tile_size,
      width, height, num_features, alpha_threshold, clamp_max_alpha,
      saturate_threshold, visibility, k_stride, out,
      static_cast<cudaStream_t>(stream));
}
