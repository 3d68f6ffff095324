// Forward tile rasterizer for Hopper (sm_90a): front-to-back alpha blend of
// each tile's depth-sorted gaussians.
//
// Replaces the TPU kernel taichi_gaussian_rasterizer_tpu/ops/raster/forward.py
// `_forward_kernel` (launched by `rasterize_tiles_flat`). It computes what
// that kernel computes -- the conic or antialiased pdf, the alpha
// threshold/clamp gates, the saturation gate, F feature channels plus the
// weight image, the non-blending quantile mode and, optionally, the per-slot
// visibility (each overlap slot's blend weight summed over the tile's pixels
// inside the image; the selection indicator in quantile mode) -- and none of
// its TPU workarounds: no flat (tile, chunk) iteration list, no DMA ring, no
// bf16 feature pairs, no coefficient matmul for the alpha field and no
// triangular-matmul cumprod. Each pixel runs the sequential blend loop.
//
// What bounds it on an H100: the work is one pdf (an expf, or four sigmoids
// under antialias) plus F+1 FMAs per (pixel, overlapping point) pair, some
// twenty FP32 operations, and every pair of a pixel depends on the one
// before through T. Device-memory traffic is small: each overlap's index, 7
// point floats and F features are read once per tile. At 1M gaussians
// @2048x1536 (2.7M overlaps, ~0.7G pairs) it takes 1.56 ms on an H100 80GB
// HBM3 at 700 W, about a tenth of the card's FP32 rate by that count, so
// neither the arithmetic rate nor memory bounds it; the likely bound (not
// measured) is the latency of the dependent per-pixel loop at the
// occupancy its 53-61 registers a thread allow, and the longest bins.
// Design: one thread block per tile, one thread per pixel; the block stages
// a batch of blockDim points into shared memory (one global read per point
// per tile, then broadcast reads by every pixel); a pixel stops once its
// saturation gate has closed, and the block stops once every pixel has
// (__syncthreads_count) -- exact, because the gate never reopens. The pdf,
// gate and transmittance arithmetic lives in raster_common.cuh, shared with
// the backward kernel, whose replay must stop exactly where this pass did.
//
// The visibility instances (kVisibility) sum each slot's weights with the
// backward's per-warp shuffle and fixed-order sum over the warps
// (raster_common.cuh), so the result is deterministic and equals the
// backward's visibility row bit for bit. A full-mask shuffle needs every
// lane, so there a pixel never leaves the slot loop: a stopped or outside
// pixel contributes 0. Slots the block never reaches (after its early exit,
// past the real overlaps) keep the zeros the caller filled in. The other
// instances keep the early `continue`/`break` per pixel and pay nothing.
//
// C interface (bound with ctypes; pointers are device pointers):
//   int tgr_raster_forward(points (N,7) f32, features (N,F) f32,
//                          overlap_to_point (K,) i32, tile_ranges (T,2) i32,
//                          num_tiles, tiles_x, tile_size, width, height, F,
//                          alpha_threshold, clamp_max_alpha,
//                          saturate_threshold, antialias, blending,
//                          image (H,W,F) f32 out, weight (H,W) f32 out,
//                          visibility (K,) f32 out zero-filled or null,
//                          stream)
// returns the cudaError_t of the launch (0 on success). A non-null
// visibility needs tile_size**2 to be a multiple of 32 (whole warps).

#include "raster_common.cuh"

using namespace tgr;

namespace {

// One point j of the staged batch for this pixel: gates, weight, feature
// accumulation and the transmittance update. Returns the point's weight
// (0 when its alpha is under the threshold) and sets `done` once the
// pixel's gate has closed.
template <bool kAntialias, bool kBlending>
__device__ __forceinline__ float blend_point(
    const float* s_pt, const float* s_feat, int batch, int j, float cx,
    float cy, int num_features, float alpha_threshold, float clamp_max_alpha,
    float saturate_threshold, float* acc, float& alpha_acc, float& T,
    bool& done) {
  // quantile mode emits the point whose accumulated weight crosses c
  const float c = 1.0f - saturate_threshold;
  AntialiasTerms terms;
  const float a_raw = alpha_raw<kAntialias>(s_pt, batch, j, cx, cy, &terms);
  // below the threshold the gated alpha is 0: no weight, T unchanged
  if (!(a_raw > alpha_threshold)) return 0.0f;
  const float a = fminf(a_raw, clamp_max_alpha);
  const float total_before = one_minus(T);
  float w;
  if (kBlending) {
    w = total_before < saturate_threshold ? __fmul_rn(a, T) : 0.0f;
    alpha_acc += w;
  } else {
    const float total_after = one_minus(transmit(T, a));
    w = (total_before < c && total_after >= c) ? 1.0f : 0.0f;
    alpha_acc += a * T;
  }
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) {
    if (f < num_features) acc[f] += w * s_feat[f * batch + j];
  }
  T = transmit(T, a);
  // T never grows, so once the gate is closed it stays closed
  if (stopped(T, kBlending ? saturate_threshold : c)) done = true;
  return w;
}

template <bool kAntialias, bool kBlending, bool kVisibility>
__global__ void __launch_bounds__(1024)
raster_forward_kernel(const float* __restrict__ points,
                      const float* __restrict__ features,
                      const int* __restrict__ overlap_to_point,
                      const int* __restrict__ tile_ranges,
                      int tiles_x, int tile_size, int width, int height,
                      int num_features, float alpha_threshold,
                      float clamp_max_alpha, float saturate_threshold,
                      float* __restrict__ image, float* __restrict__ weight,
                      float* __restrict__ visibility) {
  extern __shared__ float smem[];
  const int batch = blockDim.x;
  float* s_pt = smem;                           // [kPointRows][batch]
  float* s_feat = smem + kPointRows * batch;    // [num_features][batch]
  float* s_part = s_feat + num_features * batch;  // [n_warps][kSub] (kVisibility)

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tile % tiles_x, ty = tile / tiles_x;
  const int lx = tid % tile_size, ly = tid / tile_size;
  const int px = tx * tile_size + lx, py = ty * tile_size + ly;
  const bool inside = px < width && py < height;
  const float ox = static_cast<float>(tx * tile_size);
  const float oy = static_cast<float>(ty * tile_size);
  // tile-local pixel centre (the JAX kernels' frame)
  const float cx = lx + 0.5f, cy = ly + 0.5f;

  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];

  float T = 1.0f;
  float acc[kMaxFeatures];
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) acc[f] = 0.0f;
  float alpha_acc = 0.0f;  // sum of weights, or sum of a * T in quantile mode
  bool done = !inside;

  for (int base = start; base < end; base += batch) {
    // also the barrier before the batch buffer is overwritten
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

    if (!kVisibility) {
      if (done) continue;
      for (int j = 0; j < count; ++j) {
        blend_point<kAntialias, kBlending>(
            s_pt, s_feat, batch, j, cx, cy, num_features, alpha_threshold,
            clamp_max_alpha, saturate_threshold, acc, alpha_acc, T, done);
        if (done) break;
      }
    } else {
      const int n_warps = batch / 32;
      const int warp = tid / 32, lane = tid % 32;
      int alive = 1;
      for (int sub = 0; sub < count && alive; sub += kSub) {
        const int n_sub = min(kSub, count - sub);
        // warp-uniform: every lane runs every slot, a done pixel adds 0
        for (int jj = 0; jj < n_sub; ++jj) {
          float w = 0.0f;
          if (!done) {
            w = blend_point<kAntialias, kBlending>(
                s_pt, s_feat, batch, sub + jj, cx, cy, num_features,
                alpha_threshold, clamp_max_alpha, saturate_threshold, acc,
                alpha_acc, T, done);
          }
          const float x = warp_sum(w);
          if (lane == 0) s_part[warp * kSub + jj] = x;
        }
        // the block's sums of these n_sub slots, warps added in order
        alive = __syncthreads_count(!done);
        for (int jj = tid; jj < n_sub; jj += batch) {
          float sum = 0.0f;
          for (int k = 0; k < n_warps; ++k) sum += s_part[k * kSub + jj];
          visibility[base + sub + jj] = sum;
        }
        __syncthreads();
      }
      // slots past the point where every pixel stopped keep their zeros
      if (!alive) break;
    }
  }

  if (inside) {
    const long long pix = static_cast<long long>(py) * width + px;
#pragma unroll
    for (int f = 0; f < kMaxFeatures; ++f) {
      if (f < num_features) image[pix * num_features + f] = acc[f];
    }
    weight[pix] = kBlending ? alpha_acc : (alpha_acc > 0.0f ? 1.0f : 0.0f);
  }
}

template <bool kAntialias, bool kBlending, bool kVisibility>
cudaError_t launch(const float* points, const float* features,
                   const int* overlap_to_point, const int* tile_ranges,
                   int num_tiles, int tiles_x, int tile_size, int width,
                   int height, int num_features, float alpha_threshold,
                   float clamp_max_alpha, float saturate_threshold,
                   float* image, float* weight, float* visibility,
                   cudaStream_t stream) {
  auto kernel = raster_forward_kernel<kAntialias, kBlending, kVisibility>;
  const int threads = tile_size * tile_size;
  const size_t smem = sizeof(float)
      * (static_cast<size_t>(threads) * (kPointRows + num_features)
         + (kVisibility ? static_cast<size_t>(threads / 32) * kSub : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_tiles, threads, smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, tiles_x, tile_size,
      width, height, num_features, alpha_threshold, clamp_max_alpha,
      saturate_threshold, image, weight, visibility);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const int*,
                                 const int*, int, int, int, int, int, int,
                                 float, float, float, float*, float*, float*,
                                 cudaStream_t);

// the template instances, indexed by antialias * 4 + blending * 2 + visibility
constexpr LaunchFn kLaunch[8] = {
    launch<false, false, false>, launch<false, false, true>,
    launch<false, true, false>,  launch<false, true, true>,
    launch<true, false, false>,  launch<true, false, true>,
    launch<true, true, false>,   launch<true, true, true>};

}  // namespace

extern "C" int tgr_raster_forward(
    const float* points, const float* features, const int* overlap_to_point,
    const int* tile_ranges, int num_tiles, int tiles_x, int tile_size,
    int width, int height, int num_features, float alpha_threshold,
    float clamp_max_alpha, float saturate_threshold, int antialias,
    int blending, float* image, float* weight, float* visibility,
    void* stream) {
  if (num_features < 1 || num_features > kMaxFeatures) return cudaErrorInvalidValue;
  const int threads = tile_size * tile_size;
  if (tile_size < 1 || threads > 1024) return cudaErrorInvalidValue;
  // the visibility sums shuffle over whole warps
  if (visibility != nullptr && threads % 32 != 0) return cudaErrorInvalidValue;
  if (num_tiles == 0) return cudaSuccess;
  const int which = (antialias ? 4 : 0) + (blending ? 2 : 0)
      + (visibility != nullptr ? 1 : 0);
  return kLaunch[which](points, features, overlap_to_point, tile_ranges,
                        num_tiles, tiles_x, tile_size, width, height,
                        num_features, alpha_threshold, clamp_max_alpha,
                        saturate_threshold, image, weight, visibility,
                        static_cast<cudaStream_t>(stream));
}
