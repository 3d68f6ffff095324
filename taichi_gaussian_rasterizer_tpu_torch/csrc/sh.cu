// Spherical-harmonics shading for Hopper (sm_90a): the view-dependent
// colour clamp(sum_k sh[n, c, k] * Y_k(dir_n) + 0.5, 0, 1) of every point
// and channel, and its backward.
//
// Replaces no TPU kernel: the JAX package evaluates SH in plain jnp
// (taichi_gaussian_rasterizer_tpu/ops/sh.py `evaluate_sh_at`), which XLA
// fuses into one pass. Written out in PyTorch the same function is ~30
// elementwise passes, a stack of the (N, K) basis and a batched cuBLAS gemv
// for the contraction, and autograd's backward an outer product run as a
// small-N batched GEMM; at 6.1M points of degree 3 that took 14.2 ms
// forward and 21.7 ms for the GEMM alone backward on an H100.
//
// What bounds it on an H100 (3.35 TB/s): device memory. The forward reads
// the coefficients (N*C*K values) and the positions (3N) and writes the
// colours (N*C) and, when a gradient will be taken, a byte mask (N*C): at
// 6.1M points, C = 3, K = 16 in float32, 1.171 GB + 73 MB + 73 MB (+ 18 MB)
// = 1.317 GB, 0.39 ms. The backward reads the colour cotangent, the
// positions and the mask and writes d_sh: about 1.34 GB, 0.40 ms. The
// arithmetic, ~150 FP32 operations a point, is negligible.
//
// Design: L lanes of a warp share one (point, channel) row of K
// coefficients, each lane holding K / L contiguous ones, so that the
// lanes of a warp read (forward) and write (backward) consecutive 16-byte
// vectors: in float32 at K = 16 four lanes a row, eight rows a 512-byte
// access of a warp. Each lane builds its point's basis in registers (the
// constants of ops/sh.py `rsh_cart`), multiplies its coefficients by their
// basis values in FP32 (FP64) fused multiply-adds, and a row's partial
// sums are added across its lanes with warp shuffles. Nothing but the
// colour and the mask is written: no basis, no intermediate. The mask is
// torch.clamp's gradient gate, inclusive at both ends (0 <= x <= 1, false
// for NaN). The backward recomputes the basis from the positions and
// writes d_sh[n, c, k] = g[n, c] * mask[n, c] * Y_k; it reads the
// coefficients only in its instances for the positions' gradient, which
// write each row's share of d(direction) chained through the
// normalisation, one (x, y, z) a row, for the wrapper to add up per point.
// Rows whose K values are not whole 16-byte vectors (K = 1 and 9) take one
// lane a row and scalar loads.
//
// C interface (bound with ctypes; pointers are device pointers, the
// coefficient pointers 16-byte aligned; double_precision 0 reads float32,
// 1 float64; N * C * K < 2^31):
//   int tgr_sh_forward(sh (N,C,K), positions (N,3), camera (3,), N, C, K,
//                      double_precision, color (N,C), mask (N,C) u8 or
//                      null, stream)
//   int tgr_sh_backward(grad (N,C), mask (N,C) u8, positions, camera,
//                       sh or null, N, C, K, double_precision,
//                       d_sh (N,C,K) or null, d_dir (N,C,3) or null, stream)
//     (d_dir needs sh; at least one of d_sh and d_dir)
//   const char* tgr_error_string(int)
// each returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// lanes a row: one a 16-byte vector of the row, or one a row when its K
// values are not whole vectors
template <typename T, int K>
struct Layout {
  static constexpr bool kVector = (K * sizeof(T)) % 16 == 0;
  static constexpr int kLanes = kVector ? static_cast<int>(K * sizeof(T) / 16) : 1;
  static constexpr int kPerLane = K / kLanes;
};

template <typename T, int E>
__device__ __forceinline__ void load_values(const T* __restrict__ p, T (&v)[E]) {
  if constexpr (E * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (E * sizeof(T) == 16) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __ldg(p + e);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_values(T* __restrict__ p, const T (&v)[E]) {
  if constexpr (E * sizeof(T) == 16 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (E * sizeof(T) == 16) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = v[e];
  }
}

// lane q's E values of a row's K: compile-time indices only, so the row
// stays in registers
template <typename T, int K, int L, int E>
__device__ __forceinline__ void lane_part(const T (&full)[K], int q, T (&part)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) part[e] = full[e];
#pragma unroll
  for (int j = 1; j < L; ++j) {
    if (q == j) {
#pragma unroll
      for (int e = 0; e < E; ++e) part[e] = full[j * E + e];
    }
  }
}

// the sum of v over the L lanes of a row (L a power of two dividing 32);
// every lane of the warp takes part
template <int L, typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int offset = L / 2; offset > 0; offset /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// lib.safe_normalize(position - camera): d, and r = |position - camera|;
// false (d = 0, r = 1) when |v|^2 <= 1e-32
template <typename T>
__device__ __forceinline__ bool view_direction(const T* __restrict__ pos,
                                               const T* __restrict__ cam,
                                               unsigned n, T (&d)[3], T& r) {
  T v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    v[j] = __ldg(pos + 3ull * n + j) - __ldg(cam + j);
  const T sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const bool ok = sq > T(1e-32);
  r = ok ? sqrt(sq) : T(1);
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = ok ? v[j] / r : T(0);
  return ok;
}

// the real cartesian SH basis of degree sqrt(K) - 1 (ops/sh.py `rsh_cart`)
template <typename T, int K>
__device__ __forceinline__ void sh_basis(T x, T y, T z, T (&b)[K]) {
  b[0] = T(0.282094791773878);
  if constexpr (K >= 4) {
    b[1] = T(-0.48860251190292) * y;
    b[2] = T(0.48860251190292) * z;
    b[3] = T(-0.48860251190292) * x;
  }
  if constexpr (K >= 9) {
    const T x2 = x * x, y2 = y * y, z2 = z * z;
    b[4] = T(1.09254843059208) * (x * y);
    b[5] = T(-1.09254843059208) * (y * z);
    b[6] = T(0.94617469575756) * z2 - T(0.31539156525252);
    b[7] = T(-1.09254843059208) * (x * z);
    b[8] = T(0.54627421529604) * (x2 - y2);
    if constexpr (K >= 16) {
      b[9] = T(-0.590043589926644) * y * (T(3) * x2 - y2);
      b[10] = T(2.89061144264055) * (x * y) * z;
      b[11] = T(0.304697199642977) * y * (T(1.5) - T(7.5) * z2);
      b[12] = T(1.24392110863372) * z * (T(1.5) * z2 - T(0.5))
              - T(0.497568443453487) * z;
      b[13] = T(0.304697199642977) * x * (T(1.5) - T(7.5) * z2);
      b[14] = T(1.44530572132028) * z * (x2 - y2);
      b[15] = T(-0.590043589926644) * x * (x2 - T(3) * y2);
    }
  }
}

// d Y_k / d(x, y, z) of the basis above
template <typename T, int K>
__device__ __forceinline__ void sh_basis_grad(T x, T y, T z, T (&gx)[K],
                                              T (&gy)[K], T (&gz)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) gx[k] = gy[k] = gz[k] = T(0);
  if constexpr (K >= 4) {
    const T c1 = T(0.48860251190292);
    gy[1] = -c1;
    gz[2] = c1;
    gx[3] = -c1;
  }
  if constexpr (K >= 9) {
    const T c2 = T(1.09254843059208), c5 = T(0.54627421529604);
    gx[4] = c2 * y;  gy[4] = c2 * x;
    gy[5] = -c2 * z; gz[5] = -c2 * y;
    gz[6] = T(2 * 0.94617469575756) * z;
    gx[7] = -c2 * z; gz[7] = -c2 * x;
    gx[8] = T(2) * c5 * x; gy[8] = T(-2) * c5 * y;
    if constexpr (K >= 16) {
      const T x2 = x * x, y2 = y * y, z2 = z * z;
      const T c6 = T(0.590043589926644), c7 = T(2.89061144264055);
      const T c8 = T(0.304697199642977), c9 = T(1.24392110863372);
      const T c11 = T(1.44530572132028);
      gx[9] = T(-6) * c6 * x * y;   gy[9] = T(-3) * c6 * (x2 - y2);
      gx[10] = c7 * y * z;          gy[10] = c7 * x * z;  gz[10] = c7 * x * y;
      gy[11] = c8 * (T(1.5) - T(7.5) * z2); gz[11] = T(-15) * c8 * y * z;
      gz[12] = T(4.5) * c9 * z2 - T(0.5) * c9 - T(0.497568443453487);
      gx[13] = c8 * (T(1.5) - T(7.5) * z2); gz[13] = T(-15) * c8 * x * z;
      gx[14] = T(2) * c11 * x * z;  gy[14] = T(-2) * c11 * y * z;
      gz[14] = c11 * (x2 - y2);
      gx[15] = T(-3) * c6 * (x2 - y2); gy[15] = T(6) * c6 * x * y;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
sh_forward_kernel(const T* __restrict__ sh, const T* __restrict__ pos,
                  const T* __restrict__ cam, unsigned rows, unsigned channels,
                  T* __restrict__ color, unsigned char* __restrict__ mask) {
  constexpr int L = Layout<T, K>::kLanes, E = Layout<T, K>::kPerLane;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned row = t / L;
  const int q = static_cast<int>(t % L);
  T acc = T(0);
  if (row < rows) {
    T coef[E];
    load_values<T, E>(sh + static_cast<size_t>(row) * K + q * E, coef);
    T d[3], r;
    view_direction(pos, cam, row / channels, d, r);
    T b[K], part[E];
    sh_basis<T, K>(d[0], d[1], d[2], b);
    lane_part<T, K, L, E>(b, q, part);
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fma(coef[e], part[e], acc);
  }
  acc = row_sum<L>(acc);
  if (row < rows && q == 0) {
    const T x = acc + T(0.5);
    color[row] = x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
    if (mask != nullptr) mask[row] = x >= T(0) && x <= T(1);
  }
}

template <typename T, int K, bool kDSh, bool kDDir>
__global__ void __launch_bounds__(kThreads)
sh_backward_kernel(const T* __restrict__ grad,
                   const unsigned char* __restrict__ mask,
                   const T* __restrict__ pos, const T* __restrict__ cam,
                   const T* __restrict__ sh, unsigned rows, unsigned channels,
                   T* __restrict__ d_sh, T* __restrict__ d_dir) {
  constexpr int L = Layout<T, K>::kLanes, E = Layout<T, K>::kPerLane;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned row = t / L;
  const int q = static_cast<int>(t % L);
  T gd[3] = {T(0), T(0), T(0)};
  T d[3] = {T(0), T(0), T(0)}, r = T(1);
  bool ok = false;
  if (row < rows) {
    const size_t at = static_cast<size_t>(row) * K + q * E;
    T coef[E];
    if constexpr (kDDir) load_values<T, E>(sh + at, coef);
    const T g = __ldg(mask + row) ? __ldg(grad + row) : T(0);
    ok = view_direction(pos, cam, row / channels, d, r);
    if constexpr (kDSh) {
      T b[K], part[E];
      sh_basis<T, K>(d[0], d[1], d[2], b);
      lane_part<T, K, L, E>(b, q, part);
#pragma unroll
      for (int e = 0; e < E; ++e) part[e] = g * part[e];
      store_values<T, E>(d_sh + at, part);
    }
    if constexpr (kDDir) {
      T gx[K], gy[K], gz[K], px[E], py[E], pz[E];
      sh_basis_grad<T, K>(d[0], d[1], d[2], gx, gy, gz);
      lane_part<T, K, L, E>(gx, q, px);
      lane_part<T, K, L, E>(gy, q, py);
      lane_part<T, K, L, E>(gz, q, pz);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        gd[0] = fma(coef[e], px[e], gd[0]);
        gd[1] = fma(coef[e], py[e], gd[1]);
        gd[2] = fma(coef[e], pz[e], gd[2]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) gd[j] *= g;
    }
  }
  if constexpr (kDDir) {
#pragma unroll
    for (int j = 0; j < 3; ++j) gd[j] = row_sum<L>(gd[j]);
    if (row < rows && q == 0) {
      // through d = v / |v|: (gd - d (d . gd)) / |v|; zero where
      // safe_normalize gave the zero direction
      const T along = d[0] * gd[0] + d[1] * gd[1] + d[2] * gd[2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        d_dir[3ull * row + j] = ok ? (gd[j] - d[j] * along) / r : T(0);
    }
  }
}

unsigned blocks_for(unsigned rows, int lanes) {
  return static_cast<unsigned>(
      (static_cast<unsigned long long>(rows) * lanes + kThreads - 1) / kThreads);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, int K>
int forward_launch(const void* sh, const void* pos, const void* cam,
                   unsigned rows, unsigned channels, void* color, void* mask,
                   cudaStream_t stream) {
  if (Layout<T, K>::kVector && !aligned16(sh)) return cudaErrorMisalignedAddress;
  sh_forward_kernel<T, K><<<blocks_for(rows, Layout<T, K>::kLanes), kThreads, 0,
                            stream>>>(
      static_cast<const T*>(sh), static_cast<const T*>(pos),
      static_cast<const T*>(cam), rows, channels, static_cast<T*>(color),
      static_cast<unsigned char*>(mask));
  return cudaGetLastError();
}

template <typename T, int K, bool kDSh, bool kDDir>
int backward_instance(const void* grad, const void* mask, const void* pos,
                      const void* cam, const void* sh, unsigned rows,
                      unsigned channels, void* d_sh, void* d_dir,
                      cudaStream_t stream) {
  sh_backward_kernel<T, K, kDSh, kDDir>
      <<<blocks_for(rows, Layout<T, K>::kLanes), kThreads, 0, stream>>>(
          static_cast<const T*>(grad), static_cast<const unsigned char*>(mask),
          static_cast<const T*>(pos), static_cast<const T*>(cam),
          static_cast<const T*>(sh), rows, channels, static_cast<T*>(d_sh),
          static_cast<T*>(d_dir));
  return cudaGetLastError();
}

template <typename T, int K>
int backward_launch(const void* grad, const void* mask, const void* pos,
                    const void* cam, const void* sh, unsigned rows,
                    unsigned channels, void* d_sh, void* d_dir,
                    cudaStream_t stream) {
  if (Layout<T, K>::kVector && !(aligned16(d_sh) && aligned16(sh)))
    return cudaErrorMisalignedAddress;
  if (d_dir != nullptr && sh == nullptr) return cudaErrorInvalidValue;
  if (d_sh != nullptr && d_dir != nullptr)
    return backward_instance<T, K, true, true>(grad, mask, pos, cam, sh, rows,
                                               channels, d_sh, d_dir, stream);
  if (d_sh != nullptr)
    return backward_instance<T, K, true, false>(grad, mask, pos, cam, sh, rows,
                                                channels, d_sh, d_dir, stream);
  if (d_dir != nullptr)
    return backward_instance<T, K, false, true>(grad, mask, pos, cam, sh, rows,
                                                channels, d_sh, d_dir, stream);
  return cudaErrorInvalidValue;
}

// the instance of degree sqrt(k) - 1 and dtype T of a launch
template <typename T, template <typename, int> class Launch, typename... Args>
int by_degree(int k, Args... args) {
  switch (k) {
    case 1: return Launch<T, 1>::run(args...);
    case 4: return Launch<T, 4>::run(args...);
    case 9: return Launch<T, 9>::run(args...);
    case 16: return Launch<T, 16>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K>
struct Forward {
  template <typename... Args>
  static int run(Args... args) { return forward_launch<T, K>(args...); }
};

template <typename T, int K>
struct Backward {
  template <typename... Args>
  static int run(Args... args) { return backward_launch<T, K>(args...); }
};

// rows = n * channels as an unsigned index, and n * channels * k within
// 32 bits; false when the shapes are out of range
bool row_count(long long n, int channels, int k, unsigned* rows) {
  if (n < 0 || channels < 1 || k < 1) return false;
  if (n * channels * static_cast<long long>(k) >= (1LL << 31)) return false;
  *rows = static_cast<unsigned>(n * channels);
  return true;
}

}  // namespace

extern "C" int tgr_sh_forward(const void* sh, const void* positions,
                              const void* camera, long long n, int channels,
                              int k, int double_precision, void* color,
                              void* mask, void* stream) {
  unsigned rows;
  if (!row_count(n, channels, k, &rows)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned c = static_cast<unsigned>(channels);
  return double_precision
      ? by_degree<double, Forward>(k, sh, positions, camera, rows, c, color, mask, s)
      : by_degree<float, Forward>(k, sh, positions, camera, rows, c, color, mask, s);
}

extern "C" int tgr_sh_backward(const void* grad, const void* mask,
                               const void* positions, const void* camera,
                               const void* sh, long long n, int channels,
                               int k, int double_precision, void* d_sh,
                               void* d_dir, void* stream) {
  unsigned rows;
  if (!row_count(n, channels, k, &rows)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned c = static_cast<unsigned>(channels);
  return double_precision
      ? by_degree<double, Backward>(k, grad, mask, positions, camera, sh, rows,
                                    c, d_sh, d_dir, s)
      : by_degree<float, Backward>(k, grad, mask, positions, camera, sh, rows,
                                   c, d_sh, d_dir, s);
}

extern "C" const char* tgr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
