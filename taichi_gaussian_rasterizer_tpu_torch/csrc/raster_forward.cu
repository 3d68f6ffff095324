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
// What bounds it on an H100 (NVIDIA H100 80GB HBM3 at 700 W, measured with
// tools/time_raster_kernels.py): at 1M gaussians @2048x1536 (2.70M slots)
// the function needs the pdf and the blend of the 86.7M (pixel, slot) pairs
// whose alpha passes the threshold: 2.60 GFLOP and 101 MB, a bound of
// 0.039 ms on FP32 operations (ops/raster/bounds.py). The kernel takes 0.65
// ms, 6.0% of the bound (1.71 ms in the one-pixel-a-thread design before
// it); with visibility 1.18 ms, 3.4% (2.36 before). Of the 691M pairs
// before the pixels stop, 119M lie inside their points' threshold boxes;
// without the box test (--ablate threshold_box) the kernel takes 1.10 ms.
// Without the slot loop (--ablate forward_slot_masks) it still takes 0.18
// ms: staging, the tile queue and the image writes, latency that the
// blocks resident on an SM hide only in part. The slot loop takes the rest,
// about 0.47 ms for what the bound counts at 0.039: lanes whose pixels a
// slot's box misses idle while their warp blends it, and each slot costs
// shared loads, an expf and the gates; which of these dominates needs a
// profiler's stall counters (ncu) and is not measured.
//
// Design: a persistent grid takes tiles longest bin first from the tile
// queue (raster_common.cuh). A block stages a batch of 256 slots in shared
// memory (one global read per point per tile, then broadcast reads), with
// each point's threshold box. Without visibility each thread owns two
// pixels of a column (one under the antialiased pdf, where that measured
// faster on a saturating frame): it scans 32 slots at a time against the
// boxes into a bit mask and blends only the slots whose box reaches its
// pixels, so a warp runs as many slots as its busiest lane needs rather
// than every slot some lane needs, and it leaves once its pixels have
// stopped. A pixel stops once its saturation gate has closed, and the block
// once every pixel has (__syncthreads_count) -- exact, because the gate
// never reopens. The pdf, gate and transmittance arithmetic lives in
// raster_common.cuh, shared with the backward kernel, whose replay must
// stop exactly where this pass did.
//
// The visibility instances (kVisibility) take the backward's layout (four
// pixels a thread where it can) and sum each slot's weights over the
// thread's pixels, the warp's lanes and the block's warps in the order
// raster_common.cuh fixes, so the result is deterministic and equals the
// backward's visibility row bit for bit. A full-mask shuffle needs every
// lane, so every lane runs every slot (a stopped pixel, or one outside the
// slot's box, adds 0) until the warp's pixels have all stopped; its
// partials of the batch's remaining slots are then zeros. Slots the block
// never reaches (after its early exit, past the real overlaps) keep the
// zeros the caller filled in.
//
// The optional per-tile saturation front (tile_front, the counterpart of
// the TPU kernel's signed `satiters`) is what saturation-front truncation
// reads: +(s + 1) when every in-image pixel of the tile stopped, s the
// largest tile-local slot index at which one of them closed its gate;
// -(bin length) when some pixel ran out of the bin unsaturated; 0 for an
// empty bin. Each thread keeps the slot where its last pixel stopped, and
// the block takes their maximum with a shared-memory atomicMax, which does
// not depend on order. It changes no other output.
//
// C interface (bound with ctypes; pointers are device pointers):
//   int tgr_raster_forward(points (N,7) f32, features (N,F) f32,
//                          overlap_to_point (K,) i32, tile_ranges (T,2) i32,
//                          tile_order (T,) i32, tile_counter (1,) i32 scratch,
//                          num_tiles, tiles_x, tile_size, width, height, F,
//                          alpha_threshold, clamp_max_alpha,
//                          saturate_threshold, antialias, blending,
//                          image (H,W,F) f32 out, weight (H,W) f32 out,
//                          visibility (K,) f32 out zero-filled or null,
//                          tile_front (T,) i32 out or null, stream)
// returns the cudaError_t of the launch (0 on success). Any tile_size >= 1
// and F >= 1: a block is padded to whole warps, a tile larger than a
// block is covered in pixel chunks (raster_common.cuh), and F > 16 takes
// the wide instances below.

#include "raster_common.cuh"

using namespace tgr;

namespace {

constexpr int kBatch = 256;   // slots staged at a time

template <bool kAntialias, bool kBlending, bool kVisibility, int kCap, int kPPT>
__global__ void __launch_bounds__(kPPT == 4 ? 256 : 512)
raster_forward_kernel(const float* __restrict__ points,
                      const float* __restrict__ features,
                      const int* __restrict__ overlap_to_point,
                      const int* __restrict__ tile_ranges,
                      const int* __restrict__ tile_order,
                      int* __restrict__ tile_counter, int num_tiles,
                      int tiles_x, int tile_size, int width, int height,
                      int num_features, float alpha_threshold,
                      float clamp_max_alpha, float saturate_threshold,
                      float* __restrict__ image,
                      float* __restrict__ weight,
                      float* __restrict__ visibility,
                      int* __restrict__ tile_front) {
  constexpr unsigned kAllDone = (1u << kPPT) - 1;
  extern __shared__ float smem[];
  __shared__ int s_slot;
  __shared__ int s_front;   // the tile's largest stop slot (tile_front)
  const int threads = blockDim.x;
  float* s_pt = smem;                             // [kBatch][kStageStride]
  float2* s_ext = reinterpret_cast<float2*>(s_pt + kStageStride * kBatch);  // [kBatch]
  float* s_feat = reinterpret_cast<float*>(s_ext + kBatch);  // [F][kBatch]
  float* s_part = s_feat + num_features * kBatch;  // [n_warps][kBatch] (kVisibility)

  const int tid = threadIdx.x;
  const TileLayout layout = tile_layout(tile_size, kPPT, max_block_threads(kPPT));
  const float log_threshold = logf(alpha_threshold);
  // quantile mode emits the point whose accumulated weight crosses c
  const float c = 1.0f - saturate_threshold;
  const float stop = kBlending ? saturate_threshold : c;
  if (tid == 0) s_front = -1;   // next_tile's barrier publishes it

  for (;;) {
    const int tile = next_tile(tile_counter, tile_order, num_tiles, &s_slot);
    if (tile < 0) break;
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    const float ox = static_cast<float>(tx * tile_size);
    const float oy = static_cast<float>(ty * tile_size);
    const int start = tile_ranges[2 * tile];
    const int end = tile_ranges[2 * tile + 1];
    int last_stop = -1;     // tile-local slot where a pixel of the thread stopped
    bool saturated = true;  // every pixel of the tile stopped

    for (int chunk = 0; chunk < layout.chunks; ++chunk) {
      const ChunkPixels cp = chunk_pixels(layout, chunk, tid, kPPT, tile_size);
      const int lx = cp.lx, ly0 = cp.ly0;
      // tile-local pixel centre (the JAX kernels' frame)
      const float cx = lx + 0.5f;
      float T[kPPT], acc[kPPT][kCap];
      float alpha_acc[kPPT];  // sum of weights, or sum of a * T in quantile mode
      unsigned done = 0;
      bool chunk_saturated = false;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        T[k] = 1.0f;
        alpha_acc[k] = 0.0f;
#pragma unroll
        for (int f = 0; f < kCap; ++f) acc[k][f] = 0.0f;
        const int ly = ly0 + k;
        if (!cp.owner || ly >= tile_size || tx * tile_size + lx >= width
            || ty * tile_size + ly >= height) {
          done |= 1u << k;
        }
      }

      for (int base = start; base < end; base += kBatch) {
        const int count = min(kBatch, end - base);   // the last batch is short
        stage_batch<kAntialias>(points, features, overlap_to_point, base, count,
                                num_features, ox, oy, log_threshold, s_pt,
                                s_feat, s_ext, kBatch);
        __syncthreads();

        // One slot for the thread's pixels: the pre-gate alphas first, as
        // independent chains, then the gates, weights and T of the pixels
        // whose alpha passes the threshold. Returns the sum of their weights.
        auto blend_slot = [&](int j) {
          float vis = 0.0f;
          const Staged p = load_staged(s_pt, j);
          float a_raws[kPPT];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            AntialiasTerms unused;
            a_raws[k] = alpha_raw<kAntialias>(p, cx, (ly0 + k) + 0.5f, &unused);
          }
          float feat[kCap];
          bool loaded = false;
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            // below the threshold the gated alpha is 0: no weight, T unchanged
            const float a_raw = a_raws[k];
            if ((done & (1u << k)) || !(a_raw > alpha_threshold)) continue;
            if (!loaded) {
#pragma unroll
              for (int f = 0; f < kCap; ++f) {
                feat[f] = f < num_features ? s_feat[f * kBatch + j] : 0.0f;
              }
              loaded = true;
            }
            const float a = fminf(a_raw, clamp_max_alpha);
            const float total_before = one_minus(T[k]);
            float w;
            if (kBlending) {
              w = total_before < saturate_threshold ? __fmul_rn(a, T[k]) : 0.0f;
              alpha_acc[k] += w;
            } else {
              const float total_after = one_minus(transmit(T[k], a));
              w = (total_before < c && total_after >= c) ? 1.0f : 0.0f;
              alpha_acc[k] += a * T[k];
            }
#pragma unroll
            for (int f = 0; f < kCap; ++f) acc[k][f] += w * feat[f];
            // the visibility sum in the shared order (raster_common.cuh)
            vis = __fadd_rn(vis, w);
            T[k] = transmit(T[k], a);
            // T never grows, so once the gate is closed it stays closed
            if (stopped(T[k], stop)) {
              done |= 1u << k;
              last_stop = max(last_stop, base + j - start);
            }
          }
          return vis;
        };

        if (!kVisibility) {
          // Each thread runs only the slots whose threshold box reaches its
          // pixels, 32 slots at a time from a bit mask, and leaves once its
          // pixels have stopped: a warp runs as many slots as its busiest
          // lane needs, not every slot some lane needs.
          for (int c0 = 0; c0 < count && done != kAllDone; c0 += 32) {
            const int n = min(32, count - c0);
            unsigned todo = 0;
            for (int i = 0; i < n; ++i) {
              if (!outside_box(s_pt, s_ext, c0 + i, cx, ly0, kPPT)) todo |= 1u << i;
            }
            while (todo != 0 && done != kAllDone) {
              blend_slot(c0 + __ffs(todo) - 1);
              todo &= todo - 1;
            }
          }
        } else {
          // every lane runs every slot for the warp's sums (a done pixel, or
          // one outside the slot's threshold box, adds 0) until the warp's
          // pixels have all stopped; its partials of the remaining slots are
          // then zeros
          float* part = s_part + (tid / 32) * kBatch;
          for (int j = 0; j < count; ++j) {
            if (__all_sync(kFullMask, done == kAllDone)) {
              for (int i = j + tid % 32; i < count; i += 32) part[i] = 0.0f;
              break;
            }
            const bool live = done != kAllDone
                && !outside_box(s_pt, s_ext, j, cx, ly0, kPPT);
            const float x = warp_sum_xor(live ? blend_slot(j) : 0.0f);
            if (tid % 32 == 0) part[j] = x;
          }
        }

        const int alive = __syncthreads_count(done != kAllDone);
        if (kVisibility) {
          // the block's sums of the batch's slots, warps added in order
          for (int j = tid; j < count; j += threads) {
            chunk_store(visibility + base + j,
                        block_slot_sum(s_part + j, threads / 32, kBatch), chunk == 0);
          }
        }
        // slots past the point where every pixel stopped keep their zeros
        if (!alive) {
          chunk_saturated = true;
          break;
        }
      }
      saturated = saturated && chunk_saturated;

#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int ly = ly0 + k;
        const int px = tx * tile_size + lx, py = ty * tile_size + ly;
        if (cp.owner && ly < tile_size && px < width && py < height) {
          const long long pix = static_cast<long long>(py) * width + px;
#pragma unroll
          for (int f = 0; f < kCap; ++f) {
            if (f < num_features) image[pix * num_features + f] = acc[k][f];
          }
          weight[pix] = kBlending ? alpha_acc[k] : (alpha_acc[k] > 0.0f ? 1.0f : 0.0f);
        }
      }
    }

    if (tile_front != nullptr) {
      if (last_stop >= 0) atomicMax(&s_front, last_stop);
      __syncthreads();
      if (tid == 0) {
        tile_front[tile] = start == end ? 0 : (saturated ? s_front + 1 : start - end);
        s_front = -1;
      }
    }
  }
}

template <bool kAntialias, bool kBlending, bool kVisibility, int kCap, int kPPT>
cudaError_t launch(const float* points, const float* features,
                   const int* overlap_to_point, const int* tile_ranges,
                   const int* tile_order, int* tile_counter, int num_tiles,
                   int tiles_x, int tile_size, int width, int height,
                   int num_features, float alpha_threshold,
                   float clamp_max_alpha, float saturate_threshold,
                   float* image, float* weight, float* visibility,
                   int* tile_front, cudaStream_t stream) {
  auto kernel =
      raster_forward_kernel<kAntialias, kBlending, kVisibility, kCap, kPPT>;
  const int threads = tile_layout(tile_size, kPPT, max_block_threads(kPPT)).threads;
  const size_t smem = sizeof(float) * static_cast<size_t>(kBatch)
      * (kStageStride + 2 + num_features + (kVisibility ? threads / 32 : 0));
  int blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, threads, smem, num_tiles,
                                            tile_counter, stream, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      num_tiles, tiles_x, tile_size, width, height, num_features,
      alpha_threshold, clamp_max_alpha, saturate_threshold, image, weight,
      visibility, tile_front);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const int*,
                                 const int*, const int*, int*, int, int, int,
                                 int, int, int, float, float, float, float*,
                                 float*, float*, int*, cudaStream_t);

// the template instances, seven for each (antialias, blending), indexed
// by (antialias * 2 + blending) * 7 + instance: 0 and 1 without
// visibility, two pixels a thread, F <= 4 and F <= 16; 2 and 3 the same
// with one pixel a thread under antialias (the conic ones repeat 0 and 1);
// 4, 5 and 6 with visibility, in the backward's layout
// (pixels_per_thread): F <= 4 and 4 pixels a thread, F <= 4 and 2,
// F <= 16 and 2
#define TGR_INSTANCES(AA, BL)                                           \
  launch<AA, BL, false, kSmallFeatures, 2>,                             \
      launch<AA, BL, false, kRegisterFeatures, 2>,                      \
      launch<AA, BL, false, kSmallFeatures, AA ? 1 : 2>,                \
      launch<AA, BL, false, kRegisterFeatures, AA ? 1 : 2>,             \
      launch<AA, BL, true, kSmallFeatures, 4>,                          \
      launch<AA, BL, true, kSmallFeatures, 2>,                          \
      launch<AA, BL, true, kRegisterFeatures, 2>
constexpr LaunchFn kLaunch[28] = {
    TGR_INSTANCES(false, false), TGR_INSTANCES(false, true),
    TGR_INSTANCES(true, false), TGR_INSTANCES(true, true)};
#undef TGR_INSTANCES

// ---- F > kRegisterFeatures: one replay a tile, image += W F_batch -------
//
// A work item is a (tile, channel chunk) pair, the chunks of a tile
// consecutive in the queue; a chunk holds up to kWideChunkChannels channels
// (F = 17 to 48 is one chunk, 64 two, 128 three), the most whose
// accumulators fit in registers. The block replays the tile's bin once an
// item, in batches of kWideBatch slots, with the register instances'
// staging, pdf, gate and transmittance code, one pixel a thread; in place of
// a per-pixel feature sum each thread writes its pixel's gated weights w (0
// where a pair is gated off; the 0/1 crossing weight in quantile mode) into
// its warp's W (kWideBatch slots x 32 pixels) in shared memory. The warp
// then takes image += W F_batch, its 32 pixels x the chunk's channels, as a
// product tiled from shared memory: over the slots some pixel of the warp
// takes a weight from, in order, two at a time, each lane adds its w times
// the slot's staged channels (broadcast 16-byte loads) to its pixel's
// accumulators in registers. Tensor cores did not pay here: the same product
// as 3xTF32 mma.sync (m16n8k8 fragments from W and the staged slice) took
// 4.8 of the kernel's 6.5 ms at F = 34 on the 1M @2048x1536 frame (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): W is 12.5% dense there, each f32
// product costs three TF32 ones, and the fragments' splits and loads
// outweigh the FMAs they replace. At F = 34 on that frame the kernel takes
// 3.4 ms, 5.4% of its bound (the 34-channel image's bytes), against 4.2 ms
// for three replays of 16 channels; at F = 17 2.6 against 2.4 ms, where the
// product's per-slot work outweighs the second replay it saves, which held
// one channel (PERF.md). Once a tile the warp writes its accumulators
// through shared memory as whole pixel rows. The first chunk also writes the
// weight image, the tile's saturation front and, with visibility, the per-
// slot sums in the visibility instances' order (every lane runs every slot).
// Shared memory: the staged points, a [32][<= 48] feature slice and 6 KB of
// W a warp (about 59 KB a block at 16x16 tiles), whatever F.
constexpr int kWideChunkChannels = 48;

__host__ __device__ constexpr int wide_chunks(int num_features) {
  return ceil_div(num_features, kWideChunkChannels);
}

// channels a chunk covers, a multiple of 4 (the staged slice's 16-byte rows)
__host__ __device__ constexpr int wide_chunk_width(int num_features) {
  return ceil_div(ceil_div(num_features, wide_chunks(num_features)), 4) * 4;
}

// a warp's W rows (kWideBatch of them, a float a pixel), also the staging
// rows (a pixel's channels) of its image writes
constexpr int kWideWStride = kWideChunkChannels + 1;

template <bool kAntialias, bool kBlending, bool kVisibility, int kNC>
__global__ void __launch_bounds__(kWideMaxThreads)
raster_forward_wide_kernel(const float* __restrict__ points,
                           const float* __restrict__ features,
                           const int* __restrict__ overlap_to_point,
                           const int* __restrict__ tile_ranges,
                           const int* __restrict__ tile_order,
                           int* __restrict__ tile_counter, int num_tiles,
                           int tiles_x, int tile_size, int width, int height,
                           int num_features, float alpha_threshold,
                           float clamp_max_alpha, float saturate_threshold,
                           float* __restrict__ image,
                           float* __restrict__ weight,
                           float* __restrict__ visibility,
                           int* __restrict__ tile_front) {
  constexpr int kPPT = kWidePPT;
  constexpr unsigned kAllDone = (1u << kPPT) - 1;
  constexpr int kB = kWideBatch;
  static_assert(kWarpPixels == 32, "a pixel a lane");
  extern __shared__ float smem[];
  __shared__ int s_slot;
  __shared__ int s_front;
  const int threads = blockDim.x, n_warps = threads / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks_f = wide_chunks(num_features);
  const int nc = wide_chunk_width(num_features);
  float* s_pt = smem;                                // [kB][kStageStride]
  float2* s_ext = reinterpret_cast<float2*>(s_pt + kStageStride * kB);  // [kB]
  float* s_feat = reinterpret_cast<float*>(s_ext + kB);  // [kB][nc]
  float* s_w = s_feat + kB * nc + warp * kB * kWideWStride;  // the warp's [kB][49]
  float* s_part = s_feat + kB * nc + n_warps * kB * kWideWStride;  // [n_warps][kB]

  const TileLayout layout = tile_layout(tile_size, kPPT, kWideMaxThreads);
  const float log_threshold = logf(alpha_threshold);
  const float c = 1.0f - saturate_threshold;
  const float stop = kBlending ? saturate_threshold : c;
  if (tid == 0) s_front = -1;

  for (;;) {
    const int item = next_item(tile_counter, num_tiles * chunks_f, &s_slot);
    if (item < 0) break;
    const int tile = tile_order[item / chunks_f];
    const int f0 = (item % chunks_f) * nc;
    const int nf = min(nc, num_features - f0);
    const bool first = f0 == 0;   // uniform over the block
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    const float ox = static_cast<float>(tx * tile_size);
    const float oy = static_cast<float>(ty * tile_size);
    const int start = tile_ranges[2 * tile];
    const int end = tile_ranges[2 * tile + 1];
    int last_stop = -1;
    bool saturated = true;

    for (int chunk = 0; chunk < layout.chunks; ++chunk) {
      const ChunkPixels cp = chunk_pixels(layout, chunk, tid, kPPT, tile_size);
      const int lx = cp.lx, ly0 = cp.ly0;
      const float cx = lx + 0.5f;
      float T[kPPT], alpha_acc[kPPT];
      unsigned done = 0;
      bool chunk_saturated = false;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        T[k] = 1.0f;
        alpha_acc[k] = 0.0f;
        const int ly = ly0 + k;
        if (!cp.owner || ly >= tile_size || tx * tile_size + lx >= width
            || ty * tile_size + ly >= height) {
          done |= 1u << k;
        }
      }
      float acc[kNC];   // the lane's pixel x the chunk's channels
#pragma unroll
      for (int f = 0; f < kNC; ++f) acc[f] = 0.0f;

      for (int base = start; base < end; base += kB) {
        const int count = min(kB, end - base);
        stage_points<kAntialias>(points, overlap_to_point, base, count, ox, oy,
                                 log_threshold, s_pt, s_ext);
        stage_feature_rows(features, overlap_to_point, base, count,
                           num_features, f0, nf, nc, s_feat, nc);
        // the lane's W entries of the batch start at 0 (gated off)
#pragma unroll
        for (int j = 0; j < kB; ++j) s_w[j * kWideWStride + lane] = 0.0f;
        unsigned wmask = 0;   // the slots the lane's pixel takes a weight from
        __syncthreads();

        // One slot for the thread's pixel: the register instances' gates,
        // weights and T; the weight goes to W. Returns the weight.
        auto blend_slot = [&](int j) {
          float vis = 0.0f;
          const Staged p = load_staged(s_pt, j);
          float a_raws[kPPT];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            AntialiasTerms unused;
            a_raws[k] = alpha_raw<kAntialias>(p, cx, (ly0 + k) + 0.5f, &unused);
          }
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            const float a_raw = a_raws[k];
            if ((done & (1u << k)) || !(a_raw > alpha_threshold)) continue;
            const float a = fminf(a_raw, clamp_max_alpha);
            const float total_before = one_minus(T[k]);
            float w;
            if (kBlending) {
              w = total_before < saturate_threshold ? __fmul_rn(a, T[k]) : 0.0f;
              alpha_acc[k] += w;
            } else {
              const float total_after = one_minus(transmit(T[k], a));
              w = (total_before < c && total_after >= c) ? 1.0f : 0.0f;
              alpha_acc[k] += a * T[k];
            }
            s_w[j * kWideWStride + k * 32 + lane] = w;
            if (w != 0.0f) wmask |= 1u << j;
            vis = __fadd_rn(vis, w);
            T[k] = transmit(T[k], a);
            if (stopped(T[k], stop)) {
              done |= 1u << k;
              last_stop = max(last_stop, base + j - start);
            }
          }
          return vis;
        };

        if (!(kVisibility && first)) {
          unsigned todo = 0;
          if (done != kAllDone) {
            for (int j = 0; j < count; ++j) {
              if (!outside_box(s_pt, s_ext, j, cx, ly0, kPPT)) todo |= 1u << j;
            }
          }
          while (todo != 0 && done != kAllDone) {
            blend_slot(__ffs(todo) - 1);
            todo &= todo - 1;
          }
        } else {
          float* part = s_part + warp * kB;
          for (int j = 0; j < count; ++j) {
            if (__all_sync(kFullMask, done == kAllDone)) {
              for (int i = j + lane; i < count; i += 32) part[i] = 0.0f;
              break;
            }
            const bool live = done != kAllDone
                && !outside_box(s_pt, s_ext, j, cx, ly0, kPPT);
            const float x = warp_sum_xor(live ? blend_slot(j) : 0.0f);
            if (lane == 0) part[j] = x;
          }
        }
        __syncwarp();

        // image += W F_batch for the warp's pixels: the slots some lane
        // takes a weight from, in order, two at a time
        unsigned todo = __reduce_or_sync(kFullMask, wmask);
        while (todo != 0) {
          const int j0 = __ffs(todo) - 1;
          todo &= todo - 1;
          const int j1 = todo != 0 ? __ffs(todo) - 1 : j0;
          todo &= todo - 1;
          const float w0 = s_w[j0 * kWideWStride + lane];
          const float w1 = j1 != j0 ? s_w[j1 * kWideWStride + lane] : 0.0f;
          const float4* row0 = reinterpret_cast<const float4*>(s_feat + j0 * nc);
          const float4* row1 = reinterpret_cast<const float4*>(s_feat + j1 * nc);
#pragma unroll
          for (int f4 = 0; f4 < kNC / 4; ++f4) {
            if (4 * f4 < nc) {
              const float4 v0 = row0[f4], v1 = row1[f4];
              acc[4 * f4] = fmaf(w1, v1.x, fmaf(w0, v0.x, acc[4 * f4]));
              acc[4 * f4 + 1] = fmaf(w1, v1.y, fmaf(w0, v0.y, acc[4 * f4 + 1]));
              acc[4 * f4 + 2] = fmaf(w1, v1.z, fmaf(w0, v0.z, acc[4 * f4 + 2]));
              acc[4 * f4 + 3] = fmaf(w1, v1.w, fmaf(w0, v0.w, acc[4 * f4 + 3]));
            }
          }
        }

        const int alive = __syncthreads_count(done != kAllDone);
        if (kVisibility && first) {
          for (int j = tid; j < count; j += threads) {
            chunk_store(visibility + base + j,
                        block_slot_sum(s_part + j, n_warps, kB), chunk == 0);
          }
        }
        if (!alive) {
          chunk_saturated = true;
          break;
        }
      }
      saturated = saturated && chunk_saturated;

      if (first) {
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
          const int ly = ly0 + k;
          const int px = tx * tile_size + lx, py = ty * tile_size + ly;
          if (cp.owner && ly < tile_size && px < width && py < height) {
            weight[static_cast<long long>(py) * width + px] =
                kBlending ? alpha_acc[k] : (alpha_acc[k] > 0.0f ? 1.0f : 0.0f);
          }
        }
      }
      // The image: the warp's 32 pixel rows through its W buffer, then
      // written a pixel's channels after another, so that lanes store
      // consecutive addresses (the lanes' pixels run along tile rows).
      __syncwarp();
#pragma unroll
      for (int f = 0; f < kNC; ++f) {
        if (f < nf) s_w[lane * kWideWStride + f] = acc[f];
      }
      __syncwarp();
      for (int e = lane; e < 32 * nf; e += 32) {
        const int r = e / nf, f = e - r * nf;
        const ChunkPixels rp = chunk_pixels(layout, chunk, warp * 32 + r, kPPT,
                                            tile_size);
        const int px = tx * tile_size + rp.lx, py = ty * tile_size + rp.ly0;
        if (rp.owner && rp.ly0 < tile_size && px < width && py < height) {
          image[(static_cast<long long>(py) * width + px) * num_features + f0 + f] =
              s_w[r * kWideWStride + f];
        }
      }
      __syncwarp();
    }

    if (tile_front != nullptr && first) {
      if (last_stop >= 0) atomicMax(&s_front, last_stop);
      __syncthreads();
      if (tid == 0) {
        tile_front[tile] = start == end ? 0 : (saturated ? s_front + 1 : start - end);
        s_front = -1;
      }
    }
  }
}

template <bool kAntialias, bool kBlending, bool kVisibility, int kNC>
cudaError_t launch_wide(const float* points, const float* features,
                        const int* overlap_to_point, const int* tile_ranges,
                        const int* tile_order, int* tile_counter, int num_tiles,
                        int tiles_x, int tile_size, int width, int height,
                        int num_features, float alpha_threshold,
                        float clamp_max_alpha, float saturate_threshold,
                        float* image, float* weight, float* visibility,
                        int* tile_front, cudaStream_t stream) {
  auto kernel = raster_forward_wide_kernel<kAntialias, kBlending, kVisibility, kNC>;
  const int threads = tile_layout(tile_size, kWidePPT, kWideMaxThreads).threads;
  const size_t smem = sizeof(float)
      * (static_cast<size_t>(kWideBatch)
             * (kStageStride + 2 + wide_chunk_width(num_features))
         + static_cast<size_t>(threads / 32) * kWideBatch * (kWideWStride + 1));
  const int items = num_tiles * wide_chunks(num_features);
  int blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, threads, smem, items,
                                            tile_counter, stream, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      num_tiles, tiles_x, tile_size, width, height, num_features,
      alpha_threshold, clamp_max_alpha, saturate_threshold, image, weight,
      visibility, tile_front);
  return cudaGetLastError();
}

// indexed by ((antialias * 2 + blending) * 2 + visibility) * 2 + (chunk
// width > 24 channels): accumulators for 24 channels, or 48
#define TGR_WIDE(AA, BL, VIS) \
  launch_wide<AA, BL, VIS, 24>, launch_wide<AA, BL, VIS, kWideChunkChannels>
constexpr LaunchFn kLaunchWide[16] = {
    TGR_WIDE(false, false, false), TGR_WIDE(false, false, true),
    TGR_WIDE(false, true, false),  TGR_WIDE(false, true, true),
    TGR_WIDE(true, false, false),  TGR_WIDE(true, false, true),
    TGR_WIDE(true, true, false),   TGR_WIDE(true, true, true)};
#undef TGR_WIDE

}  // namespace

extern "C" int tgr_raster_forward(
    const float* points, const float* features, const int* overlap_to_point,
    const int* tile_ranges, const int* tile_order, int* tile_counter,
    int num_tiles, int tiles_x, int tile_size, int width, int height,
    int num_features, float alpha_threshold, float clamp_max_alpha,
    float saturate_threshold, int antialias, int blending, float* image,
    float* weight, float* visibility, int* tile_front, void* stream) {
  if (num_features < 1 || tile_size < 1) return cudaErrorInvalidValue;
  if (num_tiles == 0) return cudaSuccess;
  if (num_features > kRegisterFeatures) {
    return kLaunchWide[(((antialias ? 2 : 0) + (blending ? 1 : 0)) * 2
                        + (visibility != nullptr ? 1 : 0)) * 2
                       + (wide_chunk_width(num_features) > 24 ? 1 : 0)](
        points, features, overlap_to_point, tile_ranges, tile_order,
        tile_counter, num_tiles, tiles_x, tile_size, width, height,
        num_features, alpha_threshold, clamp_max_alpha, saturate_threshold,
        image, weight, visibility, tile_front, static_cast<cudaStream_t>(stream));
  }
  // Without visibility each pixel is its own: two pixels a thread keep
  // more threads in flight where pixels stop early, and one under the
  // antialiased pdf, which measured faster so on a saturating frame (one
  // needs ts * ts threads, so only up to 512 pixels a tile). The
  // visibility sums take the backward's layout, whose visibility row they
  // equal bit for bit.
  const bool wide = num_features > kSmallFeatures;
  const int instance = visibility == nullptr
      ? (tile_size * tile_size <= 512 ? 2 : 0) + (wide ? 1 : 0)
      : (wide ? 6 : (pixels_per_thread(tile_size, num_features) == 4 ? 4 : 5));
  return kLaunch[((antialias ? 2 : 0) + (blending ? 1 : 0)) * 7 + instance](
      points, features, overlap_to_point, tile_ranges, tile_order,
      tile_counter, num_tiles, tiles_x, tile_size, width, height,
      num_features, alpha_threshold, clamp_max_alpha, saturate_threshold,
      image, weight, visibility, tile_front, static_cast<cudaStream_t>(stream));
}
