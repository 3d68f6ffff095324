// Per-point sums of slot rows for Hopper (sm_90a), two entry points:
//
// * tgr_point_sums, the gradient reduction: the backward kernel's slot rows
//   as it stores them, slot-major (each slot's R values contiguous), are
//   gathered through the stable sort of the slots by point and summed per
//   point in one pass.
// * tgr_segment_sum: dense per-point sums of (R, K) slot rows that are
//   already sorted by point.
//
// Both replace the TPU kernel taichi_gaussian_rasterizer_tpu/ops/raster/
// reduce.py `_segment_sum_kernel` (launched by `segment_sums_by_sorted_key`),
// which on the TPU turns the point-sorted stream into per-point sums with
// one-hot matmuls on the matrix unit, after XLA's gather of the rows into
// point order. Here the mapper's point_offsets give each point's segment
// [offsets[i], offsets[i+1]) of the sorted order directly, and each sum is
// taken by one thread in slot order, starting from 0: no search, no
// atomics, and the same sum on every run. Both entry points add the same
// values in the same order, so tgr_point_sums over slot-major rows equals,
// bit for bit, tgr_segment_sum over the same rows gathered into point
// order. Sentinel slots sort past offsets[N] and are never read.
//
// What bounds tgr_point_sums on an H100: device memory. Each slot's row is
// read once and each sum written once ((K + N) x R floats, and the order).
// A point's slots lie anywhere in the tile-sorted slot order, so a gather
// from (R, K) rows reads one float from each 32-byte sector it touches;
// from slot-major rows a group of threads reads a slot's R floats as one
// contiguous run. The group is the smallest power of two of threads that
// holds R in at most four columns a thread, at most a warp (1 thread at
// R = 1, 4 at R = 9, 32 at R = 137, each thread then five columns); thread
// c of a group sums columns c, c + group, ..., and neighbouring groups take
// neighbouring points, whose segments abut in the order. A thread issues
// the loads of four slots before it adds the first of them.
//
// C interface (bound with ctypes; pointers are device pointers):
//   int tgr_point_sums(storage (K,R) f32, order (K,) i64, offsets (N+1,)
//                      i32, R, N, out (N,R) f32, stream)
//   int tgr_segment_sum(values (R,K) f32, offsets (N+1,) i32, R, K, N,
//                       out (R,N) f32, stream)
// each returns the cudaError_t of the launch (0 on success).

#include "raster_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;     // slots whose loads are in flight before their adds

// threads summing one point: the least power of two >= R / 4, at most 32
__host__ __device__ constexpr int group_threads(int rows) {
  int g = 1;
  while (g < 32 && 4 * g < rows) g *= 2;
  return g;
}

// kColumns: the columns a thread sums in one pass over its segment, 4
// where R fits (R <= 128: fewer registers, more threads resident), else 8
template <int kColumns>
__global__ void __launch_bounds__(kThreads)
point_sums_kernel(const float* __restrict__ storage,
                  const long long* __restrict__ order,
                  const int* __restrict__ offsets, int rows, int log_group,
                  int n, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = t >> log_group;
  if (i >= n) return;
  const int group = 1 << log_group;
  const int c = static_cast<int>(t & (group - 1));
  const int q0 = offsets[i], q1 = offsets[i + 1];
  // R > group * kColumns takes more than one pass over the segment
  for (int c0 = c; c0 < rows; c0 += group * kColumns) {
    float sum[kColumns];
#pragma unroll
    for (int m = 0; m < kColumns; ++m) sum[m] = 0.0f;
    int q = q0;
    for (; q + kAhead <= q1; q += kAhead) {
      float v[kAhead][kColumns];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const float* row = storage + order[q + a] * rows;
#pragma unroll
        for (int m = 0; m < kColumns; ++m) {
          const int col = c0 + m * group;
          v[a][m] = col < rows ? __ldg(row + col) : 0.0f;
        }
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
#pragma unroll
        for (int m = 0; m < kColumns; ++m) sum[m] = __fadd_rn(sum[m], v[a][m]);
      }
    }
    for (; q < q1; ++q) {
      const float* row = storage + order[q] * rows;
#pragma unroll
      for (int m = 0; m < kColumns; ++m) {
        const int col = c0 + m * group;
        if (col < rows) sum[m] = __fadd_rn(sum[m], __ldg(row + col));
      }
    }
    float* dst = out + i * rows;
#pragma unroll
    for (int m = 0; m < kColumns; ++m) {
      const int col = c0 + m * group;
      if (col < rows) dst[col] = sum[m];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ values,
                   const int* __restrict__ offsets, int rows, long long k,
                   int n, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(rows) * n) return;
  const int r = static_cast<int>(t / n);
  const int i = static_cast<int>(t - static_cast<long long>(r) * n);
  const float* v = values + r * k;
  float sum = 0.0f;
  for (int q = offsets[i]; q < offsets[i + 1]; ++q) sum += v[q];
  out[t] = sum;
}

cudaError_t launch_blocks(long long threads, long long* blocks) {
  *blocks = (threads + kThreads - 1) / kThreads;
  return *blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

template <int kColumns>
cudaError_t launch_point_sums(const float* storage, const long long* order,
                              const int* offsets, int rows, int log_group,
                              int n, float* out, cudaStream_t stream) {
  long long blocks = 0;
  const cudaError_t err = launch_blocks(static_cast<long long>(n) << log_group, &blocks);
  if (err != cudaSuccess) return err;
  point_sums_kernel<kColumns><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      storage, order, offsets, rows, log_group, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tgr_point_sums(const float* storage, const long long* order,
                              const int* offsets, int rows, int n, float* out,
                              void* stream) {
  if (rows < 0 || n < 0) return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  int log_group = 0;
  while ((1 << log_group) < group_threads(rows)) ++log_group;
  const auto launch = rows <= (4 << log_group) ? launch_point_sums<4>
                                               : launch_point_sums<8>;
  return launch(storage, order, offsets, rows, log_group, n, out,
                static_cast<cudaStream_t>(stream));
}

extern "C" int tgr_segment_sum(const float* values, const int* offsets,
                               int rows, long long k, int n, float* out,
                               void* stream) {
  if (rows < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(rows) * n;
  if (total == 0) return cudaSuccess;
  long long blocks = 0;
  const cudaError_t err = launch_blocks(total, &blocks);
  if (err != cudaSuccess) return err;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      values, offsets, rows, k, n, out);
  return cudaGetLastError();
}
