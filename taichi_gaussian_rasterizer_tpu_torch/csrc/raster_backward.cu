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
// ts * ts / ppt threads covers a tile (padded to whole warps; a tile
// larger than a block in pixel chunks, raster_common.cuh), each thread ppt
// pixels of a column (4, or 2 for F > 4 or 8x8 tiles), so a staged point
// is read from shared memory once for ppt pixels and each thread runs ppt
// independent T chains.
// A batch of 128 slots (32 for F > 4) is staged in shared memory, with each
// point's threshold box; a thread skips a slot whose box misses its
// pixels. For each slot a thread adds its pixels' rows in registers, and a
// warp where any pixel is active reduces all rows at once with
// transpose_reduce (16 shuffles for up to 16 rows, 31 for up to 32, against
// 5 a row before) and stores them with one shared store; the warps'
// partials of the whole batch are then added in warp order and written
// once, so a batch costs two block barriers however many slots it holds.
// The rows are stored slot-major, each slot's R values contiguous, so a
// batch's sums fill one contiguous run of count * R floats, which the
// block writes with neighbouring threads on neighbouring addresses; the
// reduction (segment_sum.cu) then reads a slot's rows as one run. A
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
//                           visibility, out (K,R) f32 zero-filled, stream)
// returns the cudaError_t of the launch (0 on success). Any tile_size >= 1
// and F >= 1: a block is padded to whole warps, a tile larger than a
// block is covered in pixel chunks (raster_common.cuh), and F > 16 takes
// the wide instance below.

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

// kChunked: the tile takes more than one pixel chunk (raster_common.cuh);
// a tile of one chunk runs the chunk loop's body once, straight through,
// which measured 7% faster than the loop at 16x16 tiles (9 rows, 1M
// @2048x1536, NVIDIA H100 80GB HBM3)
template <bool kAntialias, bool kHeuristic, int kCap, int kPPT, bool kChunked>
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
                       int visibility, float* __restrict__ out) {
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
  const TileLayout layout = tile_layout(tile_size, kPPT, max_block_threads(kPPT));
  const int chunks = kChunked ? layout.chunks : 1;
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

    for (int chunk = 0; chunk < chunks; ++chunk) {
      const ChunkPixels cp = chunk_pixels(layout, chunk, tid, kPPT, tile_size);
      const int lx = cp.lx, ly0 = cp.ly0;
      const float cx = lx + 0.5f;
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
        if (cp.owner && ly < tile_size && px < width && py < height) {
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

        // the block's sums of the batch's slots, warps added in order: the
        // slots' rows are one contiguous run of count * rows floats
        const int alive = __syncthreads_count(done != kAllDone);
        float* run = out + static_cast<long long>(base) * rows;
        for (int e = tid; e < count * rows; e += threads) {
          const int j = e / rows, r = e - j * rows;
          chunk_store(run + e,
                      block_slot_sum(s_part + s_rowmap[r] * part_stride + j,
                                     n_warps, kRows * part_stride),
                      chunk == 0);
        }
        // slots past the point where every pixel stopped keep their zeros
        if (!alive) break;
      }
    }
  }
}

size_t shared_bytes(int threads, int num_features, int rows, int batch) {
  return sizeof(float)
      * (static_cast<size_t>(batch) * (kStageStride + 2 + num_features)
         + static_cast<size_t>(threads / 32) * rows * (batch + 1));
}

template <bool kAntialias, bool kHeuristic, int kCap, int kPPT, bool kChunked>
cudaError_t launch(const float* points, const float* features,
                   const int* overlap_to_point, const int* tile_ranges,
                   const int* tile_order, int* tile_counter,
                   const float* image, const float* weight,
                   const float* grad_image, const float* grad_weight,
                   int num_tiles, int tiles_x, int tile_size, int width,
                   int height, int num_features, float alpha_threshold,
                   float clamp_max_alpha, float saturate_threshold,
                   int visibility, float* out, cudaStream_t stream) {
  auto kernel = raster_backward_kernel<kAntialias, kHeuristic, kCap, kPPT, kChunked>;
  const int threads = tile_layout(tile_size, kPPT, max_block_threads(kPPT)).threads;
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
      saturate_threshold, visibility, out);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const int*,
                                 const int*, const int*, int*, const float*,
                                 const float*, const float*, const float*, int,
                                 int, int, int, int, int, float, float, float,
                                 int, float*, cudaStream_t);

// the template instances, indexed by ((antialias * 2 + heuristic) * 3 +
// layout) * 2 + chunked, layout 0: F <= 4 and 4 pixels a thread, 1: F <= 4
// and 2, 2: F <= 16 and 2; chunked: more than one pixel chunk a tile
#define TGR_CHUNKS(AA, HEUR, CAP, PPT) \
  launch<AA, HEUR, CAP, PPT, false>, launch<AA, HEUR, CAP, PPT, true>
#define TGR_LAYOUTS(AA, HEUR)                                       \
  TGR_CHUNKS(AA, HEUR, kSmallFeatures, 4),                          \
      TGR_CHUNKS(AA, HEUR, kSmallFeatures, 2),                      \
      TGR_CHUNKS(AA, HEUR, kRegisterFeatures, 2)
constexpr LaunchFn kLaunch[24] = {
    TGR_LAYOUTS(false, false), TGR_LAYOUTS(false, true),
    TGR_LAYOUTS(true, false),  TGR_LAYOUTS(true, true)};
#undef TGR_LAYOUTS
#undef TGR_CHUNKS

// ---- F > kRegisterFeatures: one replay a tile, the channel sums as products
//
// Every point row needs D = gw + sum_c feature_c grad_c over all F channels
// before the slot's dL/da_raw is known, and a feature row needs each pair's
// weight w. One kernel replays each tile's bin once, in batches of
// kWideBatch slots, one pixel a thread (the wide forward's layout), and per
// batch:
// 1. stages the batch's points and its features F_batch (slots x channels,
//    in slices of 32 or 36 channels) and takes D = G F_batch^T (pixels x
//    slots, G the cotangents) as a product tiled from shared memory: each
//    thread loads its pixel's cotangents of the slice (staged in shared
//    memory once a slice, not once a batch where F fits one slice) into
//    registers and, slot after slot where a slot's threshold box reaches a
//    live pixel of the warp, adds their products with the slot's staged
//    channels (broadcast 16-byte loads); D goes to the batch's [slot][pixel]
//    buffer X in shared memory, the slices added in order;
// 2. runs the register instances' replay for the point, heuristic and
//    visibility rows, with D read from X, the transposed reduction of 16
//    rows and the shared visibility sum order, so the visibility row equals
//    the wide forward's visibility bit for bit; each thread overwrites its
//    pixel's D in X with the pair's weight w, 0 where the pair is gated off;
// 3. takes the feature rows W^T G (slots x F) as a product tiled from X and
//    the cotangent slice staged in shared memory (the D products' slice, the
//    slices taken in reverse order so that a batch restages all but one):
//    lane j of a warp owns slot j and the warp four channels of the slice
//    (eight where the slice has more groups of four than the block has
//    warps), and over the chunk's pixels in order, eight at a time (a group
//    no slot reaches skipped), each lane adds its w times the pixel's
//    cotangents (broadcast 16-byte loads) to its accumulators; each output
//    belongs to one lane, summed in a fixed order and written once a batch,
//    staged in shared memory a slice at a time and written at the next
//    barrier as one run of the slice's channels a slot.
// No feature-row replay, no per-slot shuffle of the feature rows and no
// cross-warp partials; every output is written by one thread, with no
// atomics, so two runs are bitwise identical. Tensor cores did not pay: both
// products as 3xTF32 mma.sync (m16n8k8) took 9.3 (D) and 10.4 (the feature
// rows) of the kernel's 22.8 ms at F = 34 on the 1M @2048x1536 frame (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md): a 32-slot batch is a small, sparse
// product, each f32 product costs three TF32 ones, and the fragments'
// splits, loads and dependent accumulations outweigh the FMAs they replace.
// At F = 34 on that frame the kernel takes 9.2 ms, 4.8% of its bound (the
// images' and the (40, K) rows' bytes), against 12.4 ms for a point pass and
// two 32-row feature passes; past 36 channels each batch restages all but
// one of the cotangent slices twice, and at F = 128 it takes 42 ms against
// their 37 (PERF.md). E is summed over all F channels from device
// memory once a tile. Shared memory: the staged points, a [32][36] feature
// slice, the chunk's pixels' cotangents of a 36-channel slice, X
// ([32][pixels + 1]) and the warps' point row partials: 97 KB a block at
// 16x16 tiles, whatever F (a slice's feature rows are staged over the
// staged batch, which step 3 does not read). Two blocks an SM then leave
// 60 KB of the SM's 256 KB to L1; with the feature rows in 4.7 KB of their
// own, two blocks needed the 228 KB carveout, left 28 KB to L1 and took 21%
// longer at F = 128 (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kWideRows = 16;            // point, heuristic and visibility rows
// channels staged at a time: one slice of up to kWideFeatureSlice where F
// fits (F = 34 in one, no restaging), else slices of kWideNarrowSlice
// (whose eight groups of four channels match eight warps)
constexpr int kWideFeatureSlice = 36;
constexpr int kWideNarrowSlice = 32;

constexpr int kWideSliceStride = kWideFeatureSlice + 4;   // a pixel's staged cotangents
constexpr int kWideRowStride = kWideFeatureSlice + 1;     // a slot's staged feature rows

// The feature rows of lane `lane`'s slot over the chunk's pixels, eight at
// a time, a group no slot of the batch reaches skipped: acc[4 h + i] +=
// w * the pixel's cotangent 4 h + i from g4 (kQuads float4s a lane).
template <int kQuads>
__device__ __forceinline__ void feature_row_sums(const float* wrow,
                                                 const float4* g4, int pixels,
                                                 int count, int lane,
                                                 float (&acc)[8]) {
  for (int q0 = 0; q0 < pixels; q0 += 8) {
    // rows past the batch's slots hold the previous batch's W
    float w[8];
    bool nz = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = lane < count ? wrow[q0 + i] : 0.0f;
      nz = nz || w[i] != 0.0f;
    }
    if (!__any_sync(kFullMask, nz)) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < kQuads; ++h) {
        const float4 v = g4[(q0 + i) * (kWideSliceStride / 4) + h];
        acc[4 * h] += w[i] * v.x;
        acc[4 * h + 1] += w[i] * v.y;
        acc[4 * h + 2] += w[i] * v.z;
        acc[4 * h + 3] += w[i] * v.w;
      }
    }
  }
}

__host__ __device__ constexpr size_t wide_shared_bytes(int threads) {
  return sizeof(float)
      * (static_cast<size_t>(kWideBatch) * (kStageStride + 2 + kWideFeatureSlice)
         + static_cast<size_t>(threads / 32 * kWarpPixels) * kWideSliceStride
         + static_cast<size_t>(kWideBatch) * (threads / 32 * kWarpPixels + 1)
         + static_cast<size_t>(threads / 32) * kWideRows * (kWideBatch + 1));
}

// two blocks of kWideMaxThreads an SM: at most 128 registers a thread
template <bool kAntialias, bool kHeuristic>
__global__ void __launch_bounds__(kWideMaxThreads, 2)
raster_backward_wide_kernel(const float* __restrict__ points,
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
                            float* __restrict__ out) {
  constexpr int kPPT = kWidePPT;
  constexpr int kNP = point_rows(kAntialias);
  constexpr int kHeur = kNP, kVis = kNP + 2;
  constexpr int kRows = kWideRows;
  static_assert(kVis < kRows, "rows exceed the reduction");
  constexpr unsigned kAllDone = (1u << kPPT) - 1;
  constexpr int kB = kWideBatch;
  constexpr int part_stride = kB + 1;
  static_assert(kPPT == 1, "a pixel a lane: the products index X by lane");

  extern __shared__ float smem[];
  __shared__ int s_rowmap[kRows];
  __shared__ int s_slot;
  const int threads = blockDim.x;
  const int n_warps = threads / 32;
  const int pixels = n_warps * kWarpPixels;      // the block's pixel rows
  const int xs = pixels + 1;   // X's row stride, odd: lane j reads row j
  float* s_pt = smem;                                // [kB][kStageStride]
  float2* s_ext = reinterpret_cast<float2*>(s_pt + kStageStride * kB);  // [kB]
  float* s_feat = reinterpret_cast<float*>(s_ext + kB);  // [kB][kWideFeatureSlice]
  // the chunk's pixels' cotangents of one slice of channels
  float* s_g = s_feat + kB * kWideFeatureSlice;      // [pixels][kWideSliceStride]
  float* s_x = s_g + pixels * kWideSliceStride;      // X: [kB][xs]
  float* s_part = s_x + kB * xs;                     // [n_warps][kRows][kB + 1]
  // one slice's feature rows of the batch, over s_pt, s_ext and s_feat,
  // which the feature rows' step reads none of
  float* s_rows = smem;                              // [kB][kWideRowStride]
  static_assert(kWideRowStride <= kStageStride + 2 + kWideFeatureSlice,
                "the staged feature rows exceed the staged batch");

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const TileLayout layout = tile_layout(tile_size, kPPT, kWideMaxThreads);
  const float log_threshold = logf(alpha_threshold);
  const int rows = kNP + (kHeuristic ? 2 : 0) + (visibility ? 1 : 0);
  const int pitch = rows + num_features;   // a slot's floats in `out`
  const int slice_w = num_features <= kWideFeatureSlice ? kWideFeatureSlice
                                                       : kWideNarrowSlice;
  const int slices = ceil_div(num_features, slice_w);
  if (tid == 0) {
    int r = 0;
    for (int i = 0; i < kNP; ++i) s_rowmap[r++] = i;
    if (kHeuristic) { s_rowmap[r++] = kHeur; s_rowmap[r++] = kHeur + 1; }
    if (visibility) s_rowmap[r++] = kVis;
  }

  for (;;) {
    const int tile = next_tile(tile_counter, tile_order, num_tiles, &s_slot);
    if (tile < 0) break;
    const int tx = tile % tiles_x, ty = tile / tiles_x;
    const float ox = static_cast<float>(tx * tile_size);
    const float oy = static_cast<float>(ty * tile_size);
    const int start = tile_ranges[2 * tile];
    const int end = tile_ranges[2 * tile + 1];

    for (int chunk = 0; chunk < layout.chunks; ++chunk) {
      const ChunkPixels cp = chunk_pixels(layout, chunk, tid, kPPT, tile_size);
      const int lx = cp.lx, ly0 = cp.ly0;
      const float cx = lx + 0.5f;
      // per pixel: the weight's cotangent, E = sum_c image_c * grad_c over
      // all channels and the weight, T and C; its row in X is k * 32 + lane
      // of the warp's 64
      long long pix[kPPT];
      float gw[kPPT], E[kPPT], T[kPPT], C[kPPT];
      unsigned done = 0;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int ly = ly0 + k;
        const int px = tx * tile_size + lx, py = ty * tile_size + ly;
        pix[k] = -1;
        gw[k] = 0.0f;
        E[k] = 0.0f;
        T[k] = 1.0f;
        C[k] = 0.0f;
        if (cp.owner && ly < tile_size && px < width && py < height) {
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
      // the pixel's cotangents of the slice resident in s_g: the D
      // products take the slices in order, the feature rows in reverse
      // order, so that a batch restages all but one of them
      int resident = -1;
      float4* g_row = reinterpret_cast<float4*>(s_g + tid * kWideSliceStride);
      auto stage_cotangents = [&](int slice) {
        const int f0 = slice * slice_w;
        const int nf = min(slice_w, num_features - f0);
        const float* grd = grad_image + pix[0] * num_features + f0;
#pragma unroll
        for (int f4 = 0; f4 < kWideFeatureSlice / 4; ++f4) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = 4 * f4 + i < nf && pix[0] >= 0 ? __ldg(grd + 4 * f4 + i) : 0.0f;
          }
          g_row[f4] = make_float4(v[0], v[1], v[2], v[3]);
        }
        resident = slice;
      };
      for (int base = start; base < end; base += kB) {
        const int count = min(kB, end - base);
        stage_points<kAntialias>(points, overlap_to_point, base, count, ox, oy,
                                 log_threshold, s_pt, s_ext);
        const bool warp_live = !__all_sync(kFullMask, done == kAllDone);

        // 1. D = G F_batch^T for the warp's pixels and the slots whose
        // threshold box reaches a live pixel of the warp (the replay reads
        // D nowhere else), a slice of slice_w channels at a time,
        // the slices' sums added in order
        unsigned inbox = 0;      // the slots whose box reaches the live pixel
        unsigned need = 0;       // ... of any lane of the warp
        float* x_warp = s_x + warp * kWarpPixels;
        for (int slice = 0; slice < slices; ++slice) {
          const int f0 = slice * slice_w;
          const int nf = min(slice_w, num_features - f0);
          const int padded = ceil_div(nf, 4) * 4;
          if (slice > 0) __syncthreads();   // the previous slice has been read
          if (resident != slice) stage_cotangents(slice);
          stage_feature_rows(features, overlap_to_point, base, count,
                             num_features, f0, nf, padded, s_feat,
                             kWideFeatureSlice);
          __syncthreads();
          if (slice == 0) {
            if (done != kAllDone) {
              for (int j = 0; j < count; ++j) {
                if (!outside_box(s_pt, s_ext, j, cx, ly0, kPPT)) inbox |= 1u << j;
              }
            }
            need = __reduce_or_sync(kFullMask, inbox);
          }
          if (!warp_live) continue;
          float gs[kWideFeatureSlice];   // the pixel's cotangents of the slice
#pragma unroll
          for (int f4 = 0; f4 < kWideFeatureSlice / 4; ++f4) {
            const float4 v = g_row[f4];
            gs[4 * f4] = v.x;
            gs[4 * f4 + 1] = v.y;
            gs[4 * f4 + 2] = v.z;
            gs[4 * f4 + 3] = v.w;
          }
          for (unsigned todo = need; todo != 0; todo &= todo - 1) {
            const int j = __ffs(todo) - 1;
            const float4* row = reinterpret_cast<const float4*>(
                s_feat + j * kWideFeatureSlice);
            // four partial sums, channels f = 4 i + r in partial r
            float d4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int f4 = 0; f4 < kWideFeatureSlice / 4; ++f4) {
              if (4 * f4 < padded) {
                const float4 v = row[f4];
                d4[0] += gs[4 * f4] * v.x;
                d4[1] += gs[4 * f4 + 1] * v.y;
                d4[2] += gs[4 * f4 + 2] * v.z;
                d4[3] += gs[4 * f4 + 3] * v.w;
              }
            }
            const float d = __fadd_rn(__fadd_rn(d4[0], d4[1]), __fadd_rn(d4[2], d4[3]));
            float* dst = x_warp + j * xs + lane;
            *dst = slice == 0 ? d : __fadd_rn(*dst, d);
          }
        }
        __syncwarp();

        // 2. the replay: point, heuristic and visibility rows; W into X
        for (int j = 0; j < count; ++j) {
          float* xj = x_warp + j * xs + lane;
          if (__all_sync(kFullMask, done == kAllDone)) {
            float* part = s_part + warp * kRows * part_stride;
            for (int r = 0; r < kRows; ++r) {
              for (int i = j + lane; i < count; i += 32) part[r * part_stride + i] = 0.0f;
            }
            for (int i = j; i < count; ++i) {
#pragma unroll
              for (int k = 0; k < kPPT; ++k) x_warp[i * xs + k * 32 + lane] = 0.0f;
            }
            break;
          }
          float v[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
          float w_out[kPPT] = {};
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
              AntialiasTerms at;
              const float a_raw = kAntialias ? alpha_raw<true>(p, cx, cy, &at) : a_raws[k];
              if (!(a_raw > alpha_threshold)) continue;
              any = true;
              const float a = fminf(a_raw, clamp_max_alpha);
              const float w = __fmul_rn(a, T[k]);
              w_out[k] = w;
              const float D = gw[k] + xj[k * 32];
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
                  const float z = at.z[q], sq = at.s[q];
                  const float sig = q < 2 ? sx : sy;
                  const float dz = (1.6f + 0.21f * z * z) * sq * (1.0f - sq);
                  ds_dx[q] = dz / sig;
                  ds_ds[q] = -ds_dx[q] * z;
                }
                const float dpx = kTwoPi * at.iy * sx * (ds_dx[0] - ds_dx[1]);
                const float dpy = kTwoPi * at.ix * sy * (ds_dx[2] - ds_dx[3]);
                const float d_mx = -(dpx * ax - dpy * ay);
                const float d_my = -(dpx * ay + dpy * ax);
                const float d_pdf = dl * pa;
                v[0] += d_pdf * d_mx;
                v[1] += d_pdf * d_my;
                v[2] += d_pdf * (dpx * dx + dpy * dy);
                v[3] += d_pdf * (dpx * dy - dpy * dx);
                v[4] += d_pdf * (kTwoPi * at.iy
                                 * (at.s[0] - at.s[1] + (ds_ds[0] - ds_ds[1]) * sx));
                v[5] += d_pdf * (kTwoPi * at.ix
                                 * (at.s[2] - at.s[3] + (ds_ds[2] - ds_ds[3]) * sy));
                v[6] += dl * at.pdf;
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
#pragma unroll
          for (int k = 0; k < kPPT; ++k) xj[k * 32] = w_out[k];

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
        float* run = out + static_cast<long long>(base) * pitch;
        for (int e = tid; e < count * rows; e += threads) {
          const int j = e / rows, r = e - j * rows;
          chunk_store(run + static_cast<long long>(j) * pitch + r,
                      block_slot_sum(s_part + s_rowmap[r] * part_stride + j,
                                     n_warps, kRows * part_stride),
                      chunk == 0);
        }

        // 3. the feature rows W^T G, a slice of channels at a time (the
        // resident one first): lane j of a warp owns slot j, the warp four
        // channels of the slice, or eight where the slice has more groups
        // of four than the block has warps; over the chunk's pixels in
        // order, eight at a time, a group no slot of the batch reaches
        // skipped. A slice's sums are staged in s_rows and written at the
        // next barrier, a run of nf floats a slot.
        int staged = -1;   // the slice whose sums s_rows holds
        auto store_feature_rows = [&]() {
          const int f0 = staged * slice_w;
          const int nf = min(slice_w, num_features - f0);
          for (int e = tid; e < count * nf; e += threads) {
            const int j = e / nf, c = e - j * nf;
            chunk_store(run + static_cast<long long>(j) * pitch + rows + f0 + c,
                        s_rows[j * kWideRowStride + c], chunk == 0);
          }
          staged = -1;
        };
        for (int slice = slices - 1; slice >= 0; --slice) {
          const int f0 = slice * slice_w;
          const int nf = min(slice_w, num_features - f0);
          if (resident != slice || staged >= 0) {
            // every warp has read the previous slice and staged its sums
            __syncthreads();
            if (staged >= 0) store_feature_rows();
            if (resident != slice) stage_cotangents(slice);
            __syncthreads();
          }
          const int quads = ceil_div(nf, 4) > n_warps ? 2 : 1;   // float4s a lane
          for (int c0 = 4 * quads * warp; c0 < nf; c0 += 4 * quads * n_warps) {
            float acc[8] = {};
            const float* wrow = s_x + lane * xs;
            const float4* g4 = reinterpret_cast<const float4*>(s_g + c0);
            if (quads == 2) {
              feature_row_sums<2>(wrow, g4, pixels, count, lane, acc);
            } else {
              feature_row_sums<1>(wrow, g4, pixels, count, lane, acc);
            }
            if (lane < count) {
#pragma unroll
              for (int f = 0; f < 8; ++f) {
                if (f < 4 * quads && c0 + f < nf) {
                  s_rows[lane * kWideRowStride + c0 + f] = acc[f];
                }
              }
            }
          }
          staged = slice;
        }
        __syncthreads();   // the last slice's sums are staged
        store_feature_rows();
        // slots past the point where every pixel stopped keep their zeros
        if (!alive) break;
        __syncthreads();   // X has been read before the next batch's D
      }
      __syncthreads();   // s_g and X have been read before the next chunk's
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
                        int visibility, float* out, cudaStream_t stream) {
  auto kernel = raster_backward_wide_kernel<kAntialias, kHeuristic>;
  const int threads = tile_layout(tile_size, kWidePPT, kWideMaxThreads).threads;
  const size_t smem = wide_shared_bytes(threads);
  int blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, threads, smem, num_tiles,
                                            tile_counter, stream, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      image, weight, grad_image, grad_weight, num_tiles, tiles_x, tile_size,
      width, height, num_features, alpha_threshold, clamp_max_alpha,
      saturate_threshold, visibility, out);
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
    int heuristic, int visibility, float* out, void* stream) {
  if (num_features < 1 || tile_size < 1) return cudaErrorInvalidValue;
  if (num_tiles == 0) return cudaSuccess;
  if (num_features > kRegisterFeatures) {
    return kLaunchWide[(antialias ? 2 : 0) + (heuristic ? 1 : 0)](
        points, features, overlap_to_point, tile_ranges, tile_order,
        tile_counter, image, weight, grad_image, grad_weight, num_tiles,
        tiles_x, tile_size, width, height, num_features, alpha_threshold,
        clamp_max_alpha, saturate_threshold, visibility, out,
        static_cast<cudaStream_t>(stream));
  }
  const int ppt = pixels_per_thread(tile_size, num_features);
  const int layout = num_features > kSmallFeatures ? 2 : (ppt == 4 ? 0 : 1);
  const bool chunked = tile_layout(tile_size, ppt, max_block_threads(ppt)).chunks > 1;
  return kLaunch[(((antialias ? 2 : 0) + (heuristic ? 1 : 0)) * 3 + layout) * 2
                 + (chunked ? 1 : 0)](
      points, features, overlap_to_point, tile_ranges, tile_order, tile_counter,
      image, weight, grad_image, grad_weight, num_tiles, tiles_x, tile_size,
      width, height, num_features, alpha_threshold, clamp_max_alpha,
      saturate_threshold, visibility, out, static_cast<cudaStream_t>(stream));
}
