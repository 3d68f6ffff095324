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
// What bounds it on an H100: the per-slot sums over the tile's pixels,
// not FP32 throughput. Each (slot, warp) pair reduces R = 6..26 rows
// across 32 lanes with 5 shuffles per row, and the block then adds its
// warps' partials; the pdf and gradient arithmetic per (pixel, slot) pair
// is a few dozen FP32 operations. At 1M gaussians @2048x1536 (2.6M slots,
// 9 rows) it takes 7.07 ms on an H100 80GB HBM3 at 700 W, 4.4x the forward
// kernel on the same frame; the 256-thread instances use 78-99 registers
// a thread, the 1024-thread ones 64 with small spills. Design: one block per tile, one thread
// per pixel; a batch of blockDim points is staged in shared memory as in
// the forward; a warp whose pixels all miss a point (alpha below the
// threshold, or stopped) skips that point's shuffles and records zeros;
// per-warp partials of 32 slots at a time are summed over the warps in
// fixed order and written once, and the block stops once every pixel has
// stopped (__syncthreads_count). Each slot belongs to one tile, so it is
// written exactly once: no atomics anywhere, and two runs are bitwise
// identical.
//
// C interface (bound with ctypes; pointers are device pointers):
//   int tgr_raster_backward(points (N,7) f32, features (N,F) f32,
//                           overlap_to_point (K,) i32, tile_ranges (T,2) i32,
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

constexpr int kMaxRows = 7 + 2 + 1 + kMaxFeatures;

__host__ __device__ constexpr int point_rows(bool antialias) {
  return antialias ? 7 : 6;
}

// kMaxThreads bounds the block size the compiler plans registers for:
// 1024-thread blocks (32x32 tiles) leave 64 registers a thread, smaller
// tiles get the 256-thread instance and room for the row registers.
template <int kMaxThreads, bool kAntialias, bool kHeuristic, bool kVisibility>
__global__ void __launch_bounds__(kMaxThreads)
raster_backward_kernel(const float* __restrict__ points,
                       const float* __restrict__ features,
                       const int* __restrict__ overlap_to_point,
                       const int* __restrict__ tile_ranges,
                       const float* __restrict__ image,
                       const float* __restrict__ weight,
                       const float* __restrict__ grad_image,
                       const float* __restrict__ grad_weight,
                       int tiles_x, int tile_size, int width, int height,
                       int num_features, float alpha_threshold,
                       float clamp_max_alpha, float saturate_threshold,
                       long long k_stride, float* __restrict__ out) {
  constexpr int kAux0 = point_rows(kAntialias);          // first aux row
  constexpr int kFeat0 = kAux0 + (kHeuristic ? 2 : 0) + (kVisibility ? 1 : 0);
  const int rows = kFeat0 + num_features;

  extern __shared__ float smem[];
  const int batch = blockDim.x;
  const int n_warps = batch / 32;
  float* s_pt = smem;                                // [kPointRows][batch]
  float* s_feat = s_pt + kPointRows * batch;         // [num_features][batch]
  float* s_part = s_feat + num_features * batch;     // [rows][n_warps][kSub]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int lx = tid % tile_size, ly = tid / tile_size;
  const int px = tx * tile_size + lx, py = ty * tile_size + ly;
  const bool inside = px < width && py < height;
  const float ox = static_cast<float>(tx * tile_size);
  const float oy = static_cast<float>(ty * tile_size);
  const float cx = lx + 0.5f, cy = ly + 0.5f;

  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];

  // per-pixel cotangents and E = sum_c image_c * grad_c over the features
  // and the weight channel
  float g[kMaxFeatures];
  float gw = 0.0f, E = 0.0f;
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) g[f] = 0.0f;
  if (inside) {
    const long long pix = static_cast<long long>(py) * width + px;
#pragma unroll
    for (int f = 0; f < kMaxFeatures; ++f) {
      if (f < num_features) {
        g[f] = grad_image[pix * num_features + f];
        E += image[pix * num_features + f] * g[f];
      }
    }
    gw = grad_weight[pix];
    E += weight[pix] * gw;
  }

  float T = 1.0f, C = 0.0f;
  bool done = !inside;

  for (int base = start; base < end; base += batch) {
    // also the barrier before the batch buffers are overwritten
    if (__syncthreads_count(!done) == 0) break;
    const int count = min(batch, end - base);   // the last batch is short

    if (tid < count) {
      const int idx = overlap_to_point[base + tid];
      stage_point<kAntialias>(points + static_cast<long long>(idx) * 7, ox, oy,
                              s_pt, batch, tid);
      const float* feat = features + static_cast<long long>(idx) * num_features;
      for (int f = 0; f < num_features; ++f) s_feat[f * batch + tid] = feat[f];
    }
    __syncthreads();

    int alive = 1;
    for (int sub = 0; sub < count && alive; sub += kSub) {
      const int n_sub = min(kSub, count - sub);
      for (int jj = 0; jj < n_sub; ++jj) {
        const int j = sub + jj;
        float v[kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) v[r] = 0.0f;
        bool active = false;
        if (!done) {
          AntialiasTerms t;
          const float a_raw = alpha_raw<kAntialias>(s_pt, batch, j, cx, cy, &t);
          // a stopped pixel is done, so the saturation gate is open here;
          // below the threshold the gated alpha is 0 and every row is 0
          if (a_raw > alpha_threshold) {
            active = true;
            const float a = fminf(a_raw, clamp_max_alpha);
            const float w = __fmul_rn(a, T);
            float D = gw;
#pragma unroll
            for (int f = 0; f < kMaxFeatures; ++f) {
              if (f < num_features) D += s_feat[f * batch + j] * g[f];
            }
            C += w * D;
            // the clamp gate: d a / d a_raw is 0 where alpha was clamped
            const float dl = a_raw < clamp_max_alpha
                ? T * D - (E - C) / (1.0f - a) : 0.0f;

            const float dx = cx - s_pt[0 * batch + j];
            const float dy = cy - s_pt[1 * batch + j];
            if (kAntialias) {
              const float ax = s_pt[2 * batch + j], ay = s_pt[3 * batch + j];
              const float sx = s_pt[4 * batch + j], sy = s_pt[5 * batch + j];
              const float pa = s_pt[6 * batch + j];
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
              v[0] = d_pdf * d_mx;
              v[1] = d_pdf * d_my;
              v[2] = d_pdf * (dpx * dx + dpy * dy);
              v[3] = d_pdf * (dpx * dy - dpy * dx);
              v[4] = d_pdf * (kTwoPi * t.iy
                              * (t.s[0] - t.s[1] + (ds_ds[0] - ds_ds[1]) * sx));
              v[5] = d_pdf * (kTwoPi * t.ix
                              * (t.s[2] - t.s[3] + (ds_ds[2] - ds_ds[3]) * sy));
              v[6] = dl * t.pdf;
              if (kHeuristic) {
                v[kAux0] = d_pdf * d_pdf;
                v[kAux0 + 1] = fabsf(d_pdf * d_mx) + fabsf(d_pdf * d_my);
              }
            } else {
              const float qa = s_pt[2 * batch + j], qb = s_pt[3 * batch + j];
              const float qc = s_pt[4 * batch + j];
              // log a = log pa - d^T Q d / 2 with d = pixel - mean
              const float B = dl * a_raw;
              const float qx = qa * dx + qb * dy, qy = qb * dx + qc * dy;
              v[0] = B * qx;
              v[1] = B * qy;
              v[2] = -0.5f * B * dx * dx;
              v[3] = -B * dx * dy;
              v[4] = -0.5f * B * dy * dy;
              v[5] = B;
              if (kHeuristic) {
                // the per-point pa^2 factor of the prune cost is applied
                // after the reduction (function.py)
                v[kAux0] = dl * dl;
                v[kAux0 + 1] = fabsf(B * qx) + fabsf(B * qy);
              }
            }
            if (kVisibility) v[kFeat0 - 1] = w;
#pragma unroll
            for (int f = 0; f < kMaxFeatures; ++f) {
              if (f < num_features) v[kFeat0 + f] = g[f] * w;
            }
            T = transmit(T, a);
            if (stopped(T, saturate_threshold)) done = true;
          }
        }

        // this warp's partial of every row, in a fixed shuffle order
        float* part = s_part + warp * kSub + jj;
        if (__any_sync(kFullMask, active)) {
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < rows) {
              const float x = warp_sum(v[r]);
              if (lane == 0) part[r * n_warps * kSub] = x;
            }
          }
        } else if (lane == 0) {
          for (int r = 0; r < rows; ++r) part[r * n_warps * kSub] = 0.0f;
        }
      }

      // the block's sums of these n_sub slots, warps added in order
      alive = __syncthreads_count(!done);
      for (int i = tid; i < rows * n_sub; i += batch) {
        const int r = i / n_sub, jj = i - r * n_sub;
        const float* part = s_part + r * n_warps * kSub + jj;
        float sum = 0.0f;
        for (int w = 0; w < n_warps; ++w) sum += part[w * kSub];
        out[r * k_stride + base + sub + jj] = sum;
      }
      __syncthreads();
    }
    // slots past the point where every pixel stopped keep their zeros
    if (!alive) break;
  }
}

template <int kMaxThreads, bool kAntialias, bool kHeuristic, bool kVisibility>
cudaError_t launch(const float* points, const float* features,
                   const int* overlap_to_point, const int* tile_ranges,
                   const float* image, const float* weight,
                   const float* grad_image, const float* grad_weight,
                   int num_tiles, int tiles_x, int tile_size, int width,
                   int height, int num_features, float alpha_threshold,
                   float clamp_max_alpha, float saturate_threshold,
                   long long k_stride, float* out, cudaStream_t stream) {
  auto kernel =
      raster_backward_kernel<kMaxThreads, kAntialias, kHeuristic, kVisibility>;
  const int threads = tile_size * tile_size;
  const int rows = point_rows(kAntialias) + (kHeuristic ? 2 : 0)
      + (kVisibility ? 1 : 0) + num_features;
  const size_t smem = sizeof(float)
      * (static_cast<size_t>(threads) * (kPointRows + num_features)
         + static_cast<size_t>(rows) * (threads / 32) * kSub);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_tiles, threads, smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, image, weight,
      grad_image, grad_weight, tiles_x, tile_size, width, height, num_features,
      alpha_threshold, clamp_max_alpha, saturate_threshold, k_stride, out);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const int*,
                                 const int*, const float*, const float*,
                                 const float*, const float*, int, int, int, int,
                                 int, int, float, float, float, long long,
                                 float*, cudaStream_t);

// the template instances, indexed by large * 8 + antialias * 4
// + heuristic * 2 + visibility
constexpr LaunchFn kLaunch[16] = {
    launch<256, false, false, false>,  launch<256, false, false, true>,
    launch<256, false, true, false>,   launch<256, false, true, true>,
    launch<256, true, false, false>,   launch<256, true, false, true>,
    launch<256, true, true, false>,    launch<256, true, true, true>,
    launch<1024, false, false, false>, launch<1024, false, false, true>,
    launch<1024, false, true, false>,  launch<1024, false, true, true>,
    launch<1024, true, false, false>,  launch<1024, true, false, true>,
    launch<1024, true, true, false>,   launch<1024, true, true, true>};

}  // namespace

extern "C" int tgr_raster_backward(
    const float* points, const float* features, const int* overlap_to_point,
    const int* tile_ranges, const float* image, const float* weight,
    const float* grad_image, const float* grad_weight, int num_tiles,
    int tiles_x, int tile_size, int width, int height, int num_features,
    float alpha_threshold, float clamp_max_alpha, float saturate_threshold,
    int antialias, int heuristic, int visibility, long long k_stride,
    float* out, void* stream) {
  if (num_features < 1 || num_features > kMaxFeatures) return cudaErrorInvalidValue;
  const int threads = tile_size * tile_size;
  // whole warps only: every lane takes part in the row shuffles
  if (tile_size < 1 || threads > 1024 || threads % 32 != 0) return cudaErrorInvalidValue;
  if (num_tiles == 0) return cudaSuccess;
  const int which = (threads > 256 ? 8 : 0) + (antialias ? 4 : 0)
      + (heuristic ? 2 : 0) + (visibility ? 1 : 0);
  return kLaunch[which](points, features, overlap_to_point, tile_ranges, image,
                        weight, grad_image, grad_weight, num_tiles, tiles_x,
                        tile_size, width, height, num_features, alpha_threshold,
                        clamp_max_alpha, saturate_threshold, k_stride, out,
                        static_cast<cudaStream_t>(stream));
}
