// The optimizer step for Hopper (sm_90a): fractional Adam and LaProp over
// one parameter group, in one pass, in place (optim/parameter_class.py
// `ParameterClass.step` on CUDA tensors).
//
// Replaces no TPU kernel: the JAX package's optimizer is plain jnp outside
// any Pallas kernel (taichi_gaussian_rasterizer_tpu/optim/kernels.py), which
// XLA fuses. Written out in PyTorch (optim/kernels.py, which CPU tensors
// still take) a group's update is about a dozen full-size passes: the
// gradient's mask, two EMAs of three products each, the square, the root
// and its clamp, the quotient and the bias factor, the damping and the
// rate, the subtraction and two copies, ~160 bytes of traffic an element;
// at 6.1M points x 59 values that took 23.65 ms on an H100.
//
// What bounds it on an H100 (3.35 TB/s): device memory. A scalar group
// must read param, grad, m and v and write param, m and v: 28 bytes an
// element in float32. Per point it reads the weight and the total weight
// (written once a step by the caller's one per-point add). At 6.1M x 59
// that is 10.15 GB with the per-point traffic, 3.03 ms; the arithmetic,
// ~20 operations an element and ~5 transcendentals a point, is below it.
//
// Design: a scalar group (v of the shape of m) is one flat array of N*D
// elements, cut into tiles of 256 threads x one 16-byte vector
// (4 float32 or 2 float64 values of each array a thread); blocks walk the
// tiles grid-stride, as many as fit on the card at once. A thread issues
// its four 16-byte loads (streaming, evict-first), then the block computes
// the scalars of the points the tile touches once a point into shared
// memory (beta^w, the bias factors, the damping 1 - exp(-2w), the gate
// w > 0, the visibility-aware gradient scale, the point's rate), and each
// element finds its point with one division of its offset in the tile by
// a magic-number divider, and steps from there; four 16-byte stores. The
// tile's first point and offset advance by a fixed quotient and remainder
// each stride, so no 64-bit division runs in the loop. A vector or
// local_vector group (one second moment a point, the squared norm of its
// gradient row) takes one thread a row.
//
// Each product, quotient, sum and root is rounded on its own (the _rn
// intrinsics: nothing contracted into fused multiply-adds), in the order
// and the types in which the plain version's passes compute them: the
// per-point scalars and the gradient's products in float32, the moments
// and the step in the parameters' type. So the kernel gives the plain
// version's values.
//
// C interface (bound with ctypes; pointers are device pointers; double
// precision 0 reads param, m and v as float32, 1 as float64; every other
// array is float32; rule 0 Adam, 1 LaProp; vector_kind 0 scalar (v (N, D)),
// 1 vector (v (N,)); visibility, point_lr, mask_lr and basis may be null,
// basis only with vector_kind 1):
//   int tgr_optim_step(param (N,D), grad (N,D), m (N,D), v, N, D,
//                      double_precision, rule, vector_kind, weight (N,),
//                      total_weight (N,), visibility (N,) or null,
//                      grad_scale, vis_smooth, point_lr (N,) or null,
//                      mask_lr (D,) or null, basis (N,D,D) or null,
//                      lr (1,), beta1, beta2, eps, bias_correction, stream)
//   const char* tgr_error_string(int)
// each returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kAdam = 0;
constexpr int kLaProp = 1;

// each operation rounded once, as a plain pass rounds it
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) { return x < lo ? lo : x; }

// n / d for n < 2^31 (PyTorch's IntDivider): shift = ceil(log2 d),
// magic = floor(2^32 (2^shift - d) / d) + 1
struct Divider {
  unsigned d, magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

Divider make_divider(unsigned d) {
  unsigned shift = 0;
  while ((1ull << shift) < d) ++shift;
  const unsigned long long magic = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return Divider{d, static_cast<unsigned>(magic), shift};
}

template <typename T>
struct Group {
  T* param;
  const float* grad;
  T* m;
  T* v;
  unsigned long long points;     // N
  unsigned long long elements;   // N * D
  Divider d;
  const float* weight;
  const float* total_weight;
  const float* visibility;       // visibility-aware: the gradient's scale and gate
  float grad_scale, vis_smooth;
  const float* point_lr;
  const float* mask_lr;
  const float* basis;            // local_vector: the step rotated by it
  const float* lr;
  float beta1, beta2;
  T eps;
  bool bias_correction;
};

// what a point's elements share (optim/kernels.py's per-point tensors)
struct Point {
  float b1w, b2w;   // beta^w, the EMAs' decays
  float c1, c2;     // Adam: sqrt(bias2) / bias1, unused; LaProp: bias1, bias2
  float damp;       // saturate(w) = 1 - exp(-2w)
  float scale;      // the gradient's scale: grad_scale / (visibility + smooth), or 1
  float plr;        // point_lr[n], or 1
  bool gate;        // w > 0 (and visibility > 0): the gradient kept
};

template <int kRule, typename T>
__device__ Point point_scalars(const Group<T>& a, unsigned long long n) {
  const float w = a.weight[n];
  const float total = a.total_weight[n];
  Point s;
  s.b1w = powf(a.beta1, w);
  s.b2w = powf(a.beta2, w);
  // _bias_factors: 1 - beta^total where total > 0, else 1
  float bias1 = 1.f, bias2 = 1.f;
  if (a.bias_correction && total > 0.f) {
    bias1 = sub(1.f, powf(a.beta1, total));
    bias2 = sub(1.f, powf(a.beta2, total));
  }
  if (kRule == kAdam) {
    s.c1 = quot(root(bias2), bias1);
    s.c2 = 1.f;
  } else {
    s.c1 = bias1;
    s.c2 = bias2;
  }
  s.damp = sub(1.f, expf(mul(-2.f, w)));
  s.gate = w > 0.f;
  s.scale = 1.f;
  if (a.visibility != nullptr) {
    // grad_scale / (visibility + smooth), which torch takes as a
    // reciprocal times grad_scale
    const float vis = a.visibility[n];
    s.gate = s.gate && vis > 0.f;
    s.scale = mul(__frcp_rn(add(vis, a.vis_smooth)), a.grad_scale);
  }
  s.plr = a.point_lr != nullptr ? a.point_lr[n] : 1.f;
  return s;
}

__device__ __forceinline__ float gated(float g, const Point& s) {
  return s.gate ? mul(g, s.scale) : 0.f;
}

// the new first moment of an element, from its gated gradient and the
// point's denominator (LaProp normalises the gradient by it first)
template <int kRule, typename T>
__device__ __forceinline__ T first_moment(T m, float g, T den, const Point& s) {
  const float keep = sub(1.f, s.b1w);
  if (kRule == kAdam) return add(mul(m, T(s.b1w)), T(mul(g, keep)));
  const T normed = quot(T(g), den);
  return add(mul(m, T(s.b1w)), mul(normed, T(keep)));
}

// the step an element's new first moment gives, before the rates
template <int kRule, typename T>
__device__ __forceinline__ T moment_step(T m, T den, const Point& s) {
  if (kRule == kAdam) return mul(quot(m, den), T(s.c1));
  return quot(m, T(s.c1));
}

// the second moment's denominator: clamp(sqrt(v), eps) (Adam),
// clamp(sqrt(v / bias2), eps) (LaProp)
template <int kRule, typename T>
__device__ __forceinline__ T denominator(T v, const Point& s, T eps) {
  if (kRule == kAdam) return at_least(root(v), eps);
  return at_least(root(quot(v, T(s.c2))), eps);
}

template <typename T>
__device__ __forceinline__ T ema(T old, float decay, float value) {
  return add(mul(old, T(decay)), T(mul(value, sub(1.f, decay))));
}

// param - step * mask_lr[j] * point_lr * damp * lr
template <typename T>
__device__ __forceinline__ T apply(T p, T step, const Group<T>& a, unsigned j,
                                   const Point& s, T lr) {
  if (a.mask_lr != nullptr) step = mul(step, T(a.mask_lr[j]));
  if (a.point_lr != nullptr) step = mul(step, T(s.plr));
  return sub(p, mul(mul(step, T(s.damp)), lr));
}

// E values of type T as one 16-byte (or, for the float32 gradient beside
// float64 moments, 8-byte) access
template <typename T, int E>
struct Packed;
template <>
struct Packed<float, 4> {
  using type = float4;
  __device__ static void split(const float4& x, float (&v)[4]) {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static float4 join(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Packed<float, 2> {
  using type = float2;
  __device__ static void split(const float2& x, float (&v)[2]) {
    v[0] = x.x; v[1] = x.y;
  }
};
template <>
struct Packed<double, 2> {
  using type = double2;
  __device__ static void split(const double2& x, double (&v)[2]) {
    v[0] = x.x; v[1] = x.y;
  }
  __device__ static double2 join(const double (&v)[2]) {
    return make_double2(v[0], v[1]);
  }
};

// the E values at p (all, when `whole`; else the first `left` of them),
// read once: streaming, evict-first
template <typename T, int E>
__device__ __forceinline__ void load(const T* p, bool whole, unsigned left, T (&v)[E]) {
  if (whole) {
    Packed<T, E>::split(__ldcs(reinterpret_cast<const typename Packed<T, E>::type*>(p)), v);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = e < static_cast<int>(left) ? __ldcs(p + e) : T(0);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store(T* p, bool whole, unsigned left, const T (&v)[E]) {
  if (whole) {
    __stcs(reinterpret_cast<typename Packed<T, E>::type*>(p), Packed<T, E>::join(v));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < static_cast<int>(left)) __stcs(p + e, v[e]);
  }
}

// scalar groups: tiles of kThreads 16-byte vectors of the flat arrays
template <typename T, int kRule>
__global__ void __launch_bounds__(kThreads)
scalar_step_kernel(const Group<T> a, bool aligned) {
  constexpr int kV = 16 / sizeof(T);
  constexpr unsigned kTile = kThreads * kV;   // elements, and at most points
  __shared__ float s_b1w[kTile], s_b2w[kTile], s_c1[kTile], s_damp[kTile],
      s_scale[kTile], s_plr[kTile];
  __shared__ float s_c2[kRule == kLaProp ? kTile : 1];
  __shared__ bool s_gate[kTile];

  const unsigned d = a.d.d;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kTile;
  const unsigned long long stride_points = stride / d;
  const unsigned stride_rest = static_cast<unsigned>(stride % d);
  unsigned long long start = static_cast<unsigned long long>(blockIdx.x) * kTile;
  unsigned long long first = start / d;            // the tile's first point
  unsigned rest = static_cast<unsigned>(start - first * d);   // start - first * d
  const T lr = T(__ldg(a.lr));
  const unsigned offset = threadIdx.x * kV;

  for (; start < a.elements; start += stride) {
    const unsigned len = static_cast<unsigned>(
        a.elements - start < kTile ? a.elements - start : kTile);
    const bool mine = offset < len;
    const unsigned left = mine ? len - offset : 0;
    const bool whole = aligned && left >= kV;
    T p[kV], m[kV], v[kV];
    float g[kV];
    if (mine) {
      const unsigned long long e = start + offset;
      load(a.param + e, whole, left, p);
      load(a.grad + e, whole, left, g);
      load(a.m + e, whole, left, m);
      load(a.v + e, whole, left, v);
    }
    // the scalars of the tile's points, once a point
    const unsigned points = a.d.div(rest + len - 1) + 1;
    for (unsigned q = threadIdx.x; q < points; q += kThreads) {
      const Point s = point_scalars<kRule>(a, first + q);
      s_b1w[q] = s.b1w; s_b2w[q] = s.b2w; s_c1[q] = s.c1; s_damp[q] = s.damp;
      s_scale[q] = s.scale; s_plr[q] = s.plr; s_gate[q] = s.gate;
      if constexpr (kRule == kLaProp) s_c2[q] = s.c2;
    }
    __syncthreads();
    if (mine) {
      unsigned q = a.d.div(rest + offset);        // point within the tile
      unsigned j = rest + offset - q * d;         // column within the point
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        if (e < static_cast<int>(left)) {
          Point s;
          s.b1w = s_b1w[q]; s.b2w = s_b2w[q]; s.c1 = s_c1[q];
          s.c2 = 1.f;
          if constexpr (kRule == kLaProp) s.c2 = s_c2[q];
          s.damp = s_damp[q]; s.scale = s_scale[q]; s.plr = s_plr[q];
          s.gate = s_gate[q];
          const float gk = gated(g[e], s);
          v[e] = ema(v[e], s.b2w, mul(gk, gk));
          const T den = denominator<kRule>(v[e], s, a.eps);
          m[e] = first_moment<kRule>(m[e], gk, den, s);
          p[e] = apply(p[e], moment_step<kRule>(m[e], den, s), a, j, s, lr);
        }
        if (++j == d) {
          j = 0;
          ++q;
        }
      }
      const unsigned long long e = start + offset;
      store(a.param + e, whole, left, p);
      store(a.m + e, whole, left, m);
      store(a.v + e, whole, left, v);
    }
    __syncthreads();
    first += stride_points;
    rest += stride_rest;
    if (rest >= d) {
      rest -= d;
      ++first;
    }
  }
}

// vector and local_vector groups: one thread a row of D values, one second
// moment a point from the squared norm of the row's gradient; with a
// basis, the row's step is rotated by it before the rates
template <typename T, int kRule>
__global__ void __launch_bounds__(kThreads) row_step_kernel(const Group<T> a) {
  const unsigned d = a.d.d;
  const T lr = T(__ldg(a.lr));
  for (unsigned long long n = blockIdx.x * static_cast<unsigned long long>(kThreads) + threadIdx.x;
       n < a.points; n += static_cast<unsigned long long>(gridDim.x) * kThreads) {
    const Point s = point_scalars<kRule>(a, n);
    const unsigned long long row = n * d;
    const float* g = a.grad + row;
    T* m = a.m + row;
    T* p = a.param + row;
    float norm = 0.f;   // torch.sum(grad * grad, dim=1), in order
    for (unsigned j = 0; j < d; ++j) {
      const float gk = gated(g[j], s);
      norm = add(norm, mul(gk, gk));
    }
    const T v = ema(a.v[n], s.b2w, norm);
    a.v[n] = v;
    const T den = denominator<kRule>(v, s, a.eps);
    for (unsigned j = 0; j < d; ++j) {
      m[j] = first_moment<kRule>(m[j], gated(g[j], s), den, s);
      if (a.basis == nullptr) p[j] = apply(p[j], moment_step<kRule>(m[j], den, s), a, j, s, lr);
    }
    if (a.basis != nullptr) {
      // rotate_to_basis(step, basis): step'_i = sum_j basis[i, j] step_j
      const float* b = a.basis + row * d;
      for (unsigned i = 0; i < d; ++i) {
        T step = T(0);
        for (unsigned j = 0; j < d; ++j)
          step = add(step, mul(T(b[i * d + j]), moment_step<kRule>(m[j], den, s)));
        p[i] = apply(p[i], step, a, i, s, lr);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// blocks for `work` threads' worth of rows or vectors: no more than fit on
// the card at once (the kernel's occupancy, asked once an instance), and
// the kernels walk the rest grid-stride
template <auto Kernel>
unsigned grid_for(unsigned long long work) {
  static const int per_sm = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel, kThreads, 0);
    return blocks > 0 ? blocks : 1;
  }();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const unsigned long long fit = static_cast<unsigned long long>(sms) * per_sm;
  const unsigned long long want = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < fit ? want : fit);
}

template <typename T, int kRule>
int launch(const Group<T>& a, bool vector_kind, cudaStream_t stream) {
  if (vector_kind) {
    constexpr auto kernel = row_step_kernel<T, kRule>;
    kernel<<<grid_for<kernel>(a.points), kThreads, 0, stream>>>(a);
  } else {
    constexpr auto kernel = scalar_step_kernel<T, kRule>;
    constexpr unsigned kV = 16 / sizeof(T);
    const bool aligned = aligned16(a.param) && aligned16(a.m) && aligned16(a.v) &&
                         aligned16(a.grad);
    kernel<<<grid_for<kernel>((a.elements + kV - 1) / kV), kThreads, 0, stream>>>(
        a, aligned);
  }
  return cudaGetLastError();
}

template <typename T>
int run(void* param, const void* grad, void* m, void* v, long long n, long long d,
        int rule, int vector_kind, const void* weight, const void* total_weight,
        const void* visibility, float grad_scale, float vis_smooth,
        const void* point_lr, const void* mask_lr, const void* basis,
        const void* lr, float beta1, float beta2, double eps, int bias_correction,
        cudaStream_t stream) {
  Group<T> a;
  a.param = static_cast<T*>(param);
  a.grad = static_cast<const float*>(grad);
  a.m = static_cast<T*>(m);
  a.v = static_cast<T*>(v);
  a.points = static_cast<unsigned long long>(n);
  a.elements = static_cast<unsigned long long>(n) * static_cast<unsigned long long>(d);
  a.d = make_divider(static_cast<unsigned>(d));
  a.weight = static_cast<const float*>(weight);
  a.total_weight = static_cast<const float*>(total_weight);
  a.visibility = static_cast<const float*>(visibility);
  a.grad_scale = grad_scale;
  a.vis_smooth = vis_smooth;
  a.point_lr = static_cast<const float*>(point_lr);
  a.mask_lr = static_cast<const float*>(mask_lr);
  a.basis = static_cast<const float*>(basis);
  a.lr = static_cast<const float*>(lr);
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.eps = static_cast<T>(eps);
  a.bias_correction = bias_correction != 0;
  return rule == kAdam ? launch<T, kAdam>(a, vector_kind != 0, stream)
                       : launch<T, kLaProp>(a, vector_kind != 0, stream);
}

}  // namespace

extern "C" int tgr_optim_step(void* param, const void* grad, void* m, void* v,
                              long long n, long long d, int double_precision,
                              int rule, int vector_kind, const void* weight,
                              const void* total_weight, const void* visibility,
                              float grad_scale, float vis_smooth,
                              const void* point_lr, const void* mask_lr,
                              const void* basis, const void* lr, float beta1,
                              float beta2, double eps, int bias_correction,
                              void* stream) {
  // D below 2^30, so that offsets within a tile stay in 32 bits
  if (n < 0 || d < 1 || d >= (1LL << 30)) return cudaErrorInvalidValue;
  if (rule != kAdam && rule != kLaProp) return cudaErrorInvalidValue;
  if (basis != nullptr && !vector_kind) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  return double_precision
      ? run<double>(param, grad, m, v, n, d, rule, vector_kind, weight, total_weight,
                    visibility, grad_scale, vis_smooth, point_lr, mask_lr, basis, lr,
                    beta1, beta2, eps, bias_correction, s)
      : run<float>(param, grad, m, v, n, d, rule, vector_kind, weight, total_weight,
                   visibility, grad_scale, vis_smooth, point_lr, mask_lr, basis, lr,
                   beta1, beta2, eps, bias_correction, s);
}

extern "C" const char* tgr_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
