// Kernels C and D: integer-factor linear resampling along time.
//
// C replaces tinyvc_tpu/ops/pallas/resample.py::pallas_upsample_t, which the
// energy estimator calls with factor 64 (tinyvc_tpu/dsp/energy.py) and the
// fused U-Net's five up stages with factors 2, 3, 4, 4, 5 on B*C rows
// (tinyvc_tpu/ops/fused_filternet.py). x [rows, T] -> y [rows, T*f] with
// F.interpolate(mode='linear', align_corners=False) semantics and the edge
// clamp: output q*f + j reads input q and its neighbour on the side of
// a = (j + 0.5)/f - 0.5.
//
// D replaces pallas_downsample_t, the fused U-Net's four decimations
// (factors 5, 4, 4, 3 on B*C rows): x [rows, T] -> y [rows, T/f], output q
// the centre input sample q*f + (f-1)/2 for odd f, the mean of the two centre
// samples q*f + f/2 - 1 and q*f + f/2 for even f.
//
// The TPU kernels write both as banded matmuls so that they land on the
// matrix unit and keep time on the lanes; they also pad the batch to 8 rows
// for the sublanes. On the GPU each is a gather of one or two taps per
// output, one thread per output, no padding. Bound on the H100: bytes (the
// input read once, the output written once): 0.6 MB for the energy upsample
// and 17.7 MB for the largest U-Net resample (D on [24, 153600] / 5), 5 us.
//
// C forms its weights in double and rounds them to float, as the plain
// version's table is; C and D use explicit _rn operations in the plain
// version's order, so kernel and plain version agree bit for bit.
//
// bf16 (the serving profile, tinyvc_tpu/config.py::serving_config): input
// and output are bf16, and C's two tap weights are rounded to bf16, as the
// TPU kernel casts its band matrix (resample.py:116) and the XLA tent conv
// its kernel (dsp/interp.py:141-205). The rounding of the weights of f = 3
// and 5 is part of the result. Products of two bf16 values are exact in
// fp32; the sum is fp32, rounded to bf16 once. D's 0.5 is exact in bf16.
// Half the bytes of fp32, so half the bound.
//
// Kernel J: the gradients of C and D (the transposes of the two linear
// maps), replacing tinyvc_tpu/ops/pallas/resample.py::_up_bwd (with
// _up_transpose_band's edge-clamp corrections) and ::_down_bwd
// (_down_bwd_band), the backward halves of upsample_vjp and downsample_vjp
// on the training step's waveform-rate resamples. Each is a gather, one
// thread per input sample, no atomics:
//   up:   gx[q] = sum_j g[q f + j] w_cur(j) + sum_j g[(q+1) f + j] w_prev(j)
//               + sum_j g[(q-1) f + j] w_next(j), and at q = 0 and q = T-1
//               the clamped neighbour's share (w_prev of frame 0, w_next of
//               frame T-1);
//   down: gx[p] = g[q] for p = q f + (f-1)/2 (odd f), g[q]/2 for
//               p = q f + f/2 - 1 and q f + f/2 (even f), else 0.
// bf16 g (the down path's bf16 activations): the band weights are rounded
// to bf16 as the TPU casts its band matrix, the edge corrections stay fp32
// (the TPU applies them to g outside the kernel), sums are fp32 and gx is
// rounded to bf16 once. Bound: bytes, g read once and gx written once.

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

template <typename S>
__global__ void upsample_linear_kernel(const S* __restrict__ x, S* __restrict__ y,
                                       long long total, int T, int f) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const long long out_len = static_cast<long long>(T) * f;
  const long long r = n / out_len;
  const int i = static_cast<int>(n - r * out_len);
  const int q = i / f;
  const int j = i - q * f;
  const double a = (static_cast<double>(j) + 0.5) / f - 0.5;
  float w_prev = static_cast<float>(a < 0.0 ? -a : 0.0);
  float w_cur = static_cast<float>(1.0 - (a < 0.0 ? -a : a));
  float w_next = static_cast<float>(a > 0.0 ? a : 0.0);
  if constexpr (sizeof(S) == 2) {
    w_prev = round_bf16(w_prev);
    w_cur = round_bf16(w_cur);
    w_next = round_bf16(w_next);
  }
  const S* xr = x + r * T;
  const float prev = to_f32(xr[q > 0 ? q - 1 : 0]);
  const float cur = to_f32(xr[q]);
  const float nxt = to_f32(xr[q + 1 < T ? q + 1 : T - 1]);
  y[n] = from_f32<S>(__fadd_rn(__fadd_rn(__fmul_rn(prev, w_prev), __fmul_rn(cur, w_cur)),
                               __fmul_rn(nxt, w_next)));
}

}  // namespace

// x, y: fp32, or bf16 when bf16 != 0
extern "C" int tvc_upsample_linear(const void* x, void* y, long long rows, int T, int f,
                                   int bf16, void* stream) {
  if (rows <= 0 || T <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * T * static_cast<long long>(f);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    upsample_linear_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), total, T, f);
  else
    upsample_linear_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total, T, f);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <typename S>
__global__ void downsample_linear_kernel(const S* __restrict__ x, S* __restrict__ y,
                                         long long total, int T, int f) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int out_len = T / f;
  const long long r = n / out_len;
  const int q = static_cast<int>(n - r * out_len);
  const S* xr = x + r * T + static_cast<long long>(q) * f;
  if (f & 1) {
    y[n] = xr[(f - 1) / 2];
  } else {
    const int c = f / 2 - 1;
    y[n] = from_f32<S>(
        __fadd_rn(__fmul_rn(to_f32(xr[c]), 0.5f), __fmul_rn(to_f32(xr[c + 1]), 0.5f)));
  }
}

}  // namespace

// x, y: fp32, or bf16 when bf16 != 0
extern "C" int tvc_downsample_linear(const void* x, void* y, long long rows, int T, int f,
                                     int bf16, void* stream) {
  if (rows <= 0 || f <= 0 || T < f) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * static_cast<long long>(T / f);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    downsample_linear_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), total, T, f);
  else
    downsample_linear_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total, T, f);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// the (previous, current, next) tent weights of output phase j, as C forms
// them; rounded to bf16 when the cotangent is bf16
__device__ __forceinline__ void tent(int j, int f, bool round, float* w) {
  const double a = (static_cast<double>(j) + 0.5) / f - 0.5;
  w[0] = static_cast<float>(a < 0.0 ? -a : 0.0);
  w[1] = static_cast<float>(1.0 - (a < 0.0 ? -a : a));
  w[2] = static_cast<float>(a > 0.0 ? a : 0.0);
  if (round) {
    for (int k = 0; k < 3; ++k) w[k] = round_bf16(w[k]);
  }
}

template <typename S>
__global__ void upsample_grad_kernel(const S* __restrict__ g, S* __restrict__ gx,
                                     long long total, int T, int f) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const long long r = n / T;
  const int q = static_cast<int>(n - r * T);
  const S* gr = g + r * static_cast<long long>(T) * f;
  const bool round = sizeof(S) == 2;
  float cur = 0.f, from_next = 0.f, from_prev = 0.f, edge = 0.f;
  for (int j = 0; j < f; ++j) {
    float w[3], we[3];
    tent(j, f, round, w);
    tent(j, f, false, we);
    cur += to_f32(gr[static_cast<long long>(q) * f + j]) * w[1];
    if (q + 1 < T) from_next += to_f32(gr[static_cast<long long>(q + 1) * f + j]) * w[0];
    if (q > 0) from_prev += to_f32(gr[static_cast<long long>(q - 1) * f + j]) * w[2];
    if (q == 0) edge += to_f32(gr[j]) * we[0];
    if (q == T - 1) edge += to_f32(gr[static_cast<long long>(T - 1) * f + j]) * we[2];
  }
  gx[n] = from_f32<S>(cur + from_next + from_prev + edge);
}

template <typename S>
__global__ void downsample_grad_kernel(const S* __restrict__ g, S* __restrict__ gx,
                                       long long total, int T, int f) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int out_len = T / f;
  const long long r = n / T;
  const int p = static_cast<int>(n - r * T);
  const int q = p / f;
  const int j = p - q * f;
  float v = 0.f;
  if (q < out_len) {
    const float gq = to_f32(g[r * out_len + q]);
    if (f & 1) {
      if (j == (f - 1) / 2) v = gq;
    } else if (j == f / 2 - 1 || j == f / 2) {
      v = gq * 0.5f;
    }
  }
  gx[n] = from_f32<S>(v);
}

}  // namespace

// Kernel J. up != 0: g [rows, T*f] -> gx [rows, T] (the gradient of C);
// up == 0: g [rows, T/f] -> gx [rows, T] (the gradient of D). g and gx are
// fp32, or bf16 when bf16 != 0.
extern "C" int tvc_resample_grad(const void* g, void* gx, long long rows, int T, int f, int up,
                                 int bf16, void* stream) {
  if (rows <= 0 || T <= 0 || f <= 0 || (!up && T < f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * static_cast<long long>(T);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (up && bf16)
    upsample_grad_kernel<<<nb, threads, 0, st>>>(static_cast<const __nv_bfloat16*>(g),
                                                 static_cast<__nv_bfloat16*>(gx), total, T, f);
  else if (up)
    upsample_grad_kernel<<<nb, threads, 0, st>>>(static_cast<const float*>(g),
                                                 static_cast<float*>(gx), total, T, f);
  else if (bf16)
    downsample_grad_kernel<<<nb, threads, 0, st>>>(static_cast<const __nv_bfloat16*>(g),
                                                   static_cast<__nv_bfloat16*>(gx), total, T, f);
  else
    downsample_grad_kernel<<<nb, threads, 0, st>>>(static_cast<const float*>(g),
                                                   static_cast<float*>(gx), total, T, f);
  return static_cast<int>(cudaGetLastError());
}
