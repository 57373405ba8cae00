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
// output, no padding. Bound on the H100: bytes (the input read once, the
// output written once): 0.6 MB for the energy upsample, 17.7 MB for the
// largest U-Net resample (D on [24, 153600] / 5), 5 us; a serving B=8
// request's five C launches write 104 MB of bf16 and read 25 MB, 39 us.
//
// C's design. Its work a byte is small, so what holds it is instructions
// and latency per output; the output is stored in whole 16-byte vectors (4
// fp32 or 8 bf16 outputs) of the flat [rows, T*f] array. For the U-Net's
// factors 2, 3, 4, 5, when every row holds whole runs of lcm(vector, f)
// outputs (T a multiple of run/f: every shape of the converter's 64-frame
// buckets), a thread computes one run: it starts at phase 0, so every
// phase, tap and input index is fixed at compile time, and its run/f + 2
// inputs are loaded at once; runs of several vectors (f = 3, 5) are staged
// in shared memory and stored by the block as consecutive vectors. Any other shape (rows of
// T*f not a multiple of a run, odd T in bf16, T = 1, one row, other factors
// such as the energy's 64) takes the vector kernel: a thread writes one
// vector aligned in the flat array, carrying (row, input sample, phase) from
// output to output, across a row's end where the vector runs into the next
// row; only the flat array's last partial vector is stored element by
// element. Rows and columns come from 32-bit divisions (64-bit past 2^32
// outputs), once per thread. The tap weights of the f phases come from a
// table that the wrapper builds once per factor and dtype from the plain
// version's own (kernels/resample.py::_tap_table): no double arithmetic in
// the kernel. Every output is the same three products and two sums in the
// same order on both paths. D keeps one thread per output.
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
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int UP_THREADS = 256;

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// the outputs of a run: whole 16-byte vectors of V outputs that start at
// phase 0 of factor F
__host__ __device__ constexpr int run_len(int V, int F) { return V / gcd(V, F) * F; }

__device__ __forceinline__ float tap(float prev, float cur, float nxt, float4 w) {
  return __fadd_rn(__fadd_rn(__fmul_rn(prev, w.x), __fmul_rn(cur, w.y)), __fmul_rn(nxt, w.z));
}

// one 16-byte vector of outputs
template <typename S>
__device__ __forceinline__ void store16(S* y, const float* o) {
  if constexpr (sizeof(S) == 2) {
    uint32_t p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
      p[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(y) = make_uint4(p[0], p[1], p[2], p[3]);
  } else {
    *reinterpret_cast<float4*>(y) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// row r and column i of flat output g of rows of L outputs (32-bit
// division below 2^32 outputs)
__device__ __forceinline__ void row_col(long long g, long long total, int L, long long& r,
                                        int& i) {
  if (total <= 0xffffffffLL) {
    const unsigned gu = static_cast<unsigned>(g), rr = gu / static_cast<unsigned>(L);
    r = rr;
    i = static_cast<int>(gu - rr * static_cast<unsigned>(L));
  } else {
    r = g / L;
    i = static_cast<int>(g - r * L);
  }
}

// F > 0: a thread computes one run of factor F (rows whose length is a
// multiple of run_len): its inputs loaded at once, every phase and tap
// index fixed at compile time; a run of several vectors goes through shared
// memory, so that the block stores consecutive vectors. F == 0: a thread
// writes one vector of any factor f, carrying (row, input sample, phase)
// from output to output.
template <typename S, int F>
__global__ void __launch_bounds__(UP_THREADS)
upsample_linear_kernel(const S* __restrict__ x, const float4* __restrict__ wt,
                       S* __restrict__ y, long long total, int T, int f) {
  constexpr int V = 16 / sizeof(S);  // outputs of a 16-byte vector
  if constexpr (F > 0) {
    constexpr int U = run_len(V, F), NQ = U / F + 2;
    const long long runs = total / U;
    const long long b0 = static_cast<long long>(blockIdx.x) * UP_THREADS;  // the block's first run
    const long long t = b0 + threadIdx.x;
    float o[U];
    if (t < runs) {
      long long r;
      int i;
      row_col(t * U, total, T * F, r, i);
      const int q0 = i / F;
      const S* xr = x + r * T;
      float xs[NQ];  // inputs q0 - 1 .. q0 + U / F, clamped to the row
#pragma unroll
      for (int d = 0; d < NQ; ++d) xs[d] = to_f32(xr[min(max(q0 - 1 + d, 0), T - 1)]);
#pragma unroll
      for (int e = 0; e < U; ++e) o[e] = tap(xs[e / F], xs[e / F + 1], xs[e / F + 2], wt[e % F]);
    }
    if constexpr (U == V) {
      if (t < runs) store16(y + t * U, o);
    } else {
      __shared__ __align__(16) S sy[UP_THREADS * U];
      if (t < runs) {
#pragma unroll
        for (int v = 0; v < U / V; ++v) store16(sy + threadIdx.x * U + v * V, o + v * V);
      }
      __syncthreads();
      const int nv = static_cast<int>(runs - b0 < UP_THREADS ? runs - b0 : UP_THREADS) * (U / V);
      for (int k = threadIdx.x; k < nv; k += UP_THREADS)
        *reinterpret_cast<uint4*>(y + b0 * U + k * V) = *reinterpret_cast<const uint4*>(sy + k * V);
    }
  } else {
    const long long g0 = (static_cast<long long>(blockIdx.x) * UP_THREADS + threadIdx.x) * V;
    if (g0 >= total) return;
    long long r;
    int i;
    row_col(g0, total, T * f, r, i);
    int q = i / f;
    int j = i - q * f;
    const S* xr = x + r * T;
    float prev = to_f32(xr[q > 0 ? q - 1 : 0]);
    float cur = to_f32(xr[q]);
    float nxt = to_f32(xr[q + 1 < T ? q + 1 : T - 1]);
    const int n = total - g0 < V ? static_cast<int>(total - g0) : V;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      o[e] = tap(prev, cur, nxt, wt[j]);
      if (e + 1 < n && ++j == f) {
        j = 0;
        if (++q == T) {  // the next row
          q = 0;
          xr += T;
          prev = cur = to_f32(xr[0]);
          nxt = to_f32(xr[T > 1 ? 1 : 0]);
        } else {
          prev = cur;
          cur = nxt;
          nxt = to_f32(xr[q + 1 < T ? q + 1 : T - 1]);
        }
      }
    }
    if (n == V) {
      store16(y + g0, o);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < n) y[g0 + e] = from_f32<S>(o[e]);
    }
  }
}

template <typename S, int F>
int launch_up(const S* x, const float4* wt, S* y, long long total, int T, int f,
              cudaStream_t st) {
  const long long per_block = static_cast<long long>(UP_THREADS) *
                              (F > 0 ? run_len(16 / sizeof(S), F) : 16 / sizeof(S));
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  upsample_linear_kernel<S, F>
      <<<static_cast<unsigned>(blocks), UP_THREADS, 0, st>>>(x, wt, y, total, T, f);
  return static_cast<int>(cudaGetLastError());
}

// the run kernel of the U-Net's factors 2, 3, 4, 5 when whole runs tile
// every row, else the vector kernel (the energy's 64 among them: its vectors
// never cross an input sample)
template <typename S>
int dispatch_up(const S* x, const float4* wt, S* y, long long rows, int T, int f,
                cudaStream_t st) {
  constexpr int V = 16 / sizeof(S);
  const long long total = rows * T * static_cast<long long>(f);
  switch (f) {
    case 2:
      if (T % (run_len(V, 2) / 2) == 0) return launch_up<S, 2>(x, wt, y, total, T, f, st);
      break;
    case 3:
      if (T % (run_len(V, 3) / 3) == 0) return launch_up<S, 3>(x, wt, y, total, T, f, st);
      break;
    case 4:
      if (T % (run_len(V, 4) / 4) == 0) return launch_up<S, 4>(x, wt, y, total, T, f, st);
      break;
    case 5:
      if (T % (run_len(V, 5) / 5) == 0) return launch_up<S, 5>(x, wt, y, total, T, f, st);
      break;
  }
  return launch_up<S, 0>(x, wt, y, total, T, f, st);
}

}  // namespace

// x [rows, T], y [rows, T*f]: fp32, or bf16 when bf16 != 0; w [f, 4] fp32,
// phase j's (previous, current, next, 0) tap weights, rounded to bf16 for a
// bf16 x; w and y 16-byte aligned
extern "C" int tvc_upsample_linear(const void* x, const void* w, void* y, long long rows, int T,
                                   int f, int bf16, void* stream) {
  if (rows <= 0 || T <= 0 || f <= 0 || static_cast<long long>(T) * f > 0x7fffffffLL ||
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wt = static_cast<const float4*>(w);
  if (bf16)
    return dispatch_up(static_cast<const __nv_bfloat16*>(x), wt, static_cast<__nv_bfloat16*>(y),
                       rows, T, f, st);
  return dispatch_up(static_cast<const float*>(x), wt, static_cast<float*>(y), rows, T, f, st);
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

// the (previous, current, next) tent weights of output phase j, as C's
// table holds them; rounded to bf16 when the cotangent is bf16
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
