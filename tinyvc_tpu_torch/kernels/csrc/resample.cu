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
// on the training step's waveform-rate resamples (down /5 on 24 channels,
// /4 on 48, up x4 on 48, x5 on 24). Each is a gather, no atomics:
//   up:   gx[q] = sum_j g[q f + j] w_cur(j) + sum_j g[(q+1) f + j] w_prev(j)
//               + sum_j g[(q-1) f + j] w_next(j), and at q = 0 and q = T-1
//               the clamped neighbour's share (w_prev of frame 0, w_next of
//               frame T-1);
//   down: gx[p] = g[q] for p = q f + (f-1)/2 (odd f), g[q]/2 for
//               p = q f + f/2 - 1 and q f + f/2 (even f), else 0.
// bf16 g (the down path's bf16 activations): the band weights are rounded
// to bf16 as the TPU casts its band matrix, the edge corrections stay fp32
// (the TPU applies them to g outside the kernel), sums are fp32 and gx is
// rounded to bf16 once. Bound on the H100: bytes, g read once and gx
// written once (a bf16 pre-join step's four calls move 125 MB, 37 us).
//
// J's design is C's, transposed. Its work a byte is small, so what holds
// it is instructions and memory transactions per output. Both modes write
// gx as whole 16-byte vectors. Up mode: the weights come from a per-launch
// table that the wrapper builds from the plain version's (kernels/
// resample.py::_grad_tap_table: the band weights as C's table, then the
// fp32 edge weights), no double arithmetic; with f in 2..5 and T a
// multiple of the vector, a block stages its cotangent through shared
// memory with 16-byte loads (neighbouring threads on neighbouring
// addresses) and each thread reads its f*V + 2f samples from there, every
// phase and tap static. Every output is an FMA chain per band, summed as
// the plain version groups them: (cur + next) + prev, then + edge. Down
// mode: with f in 3..5 and rows of whole runs of lcm(V, f) outputs, a
// thread writes a run from its run/f cotangent samples, its non-zero lanes
// at static positions, stored through shared memory as consecutive
// vectors (C's staging); gx stays dense, since autograd consumes it. Any
// other shape (T not a multiple of the run, T = 1, other factors) takes the
// vector kernels, which carry (row, sample, phase) across row ends. Rows
// and columns come from one 32-bit division a thread (64-bit past 2^32
// outputs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "launch_count.cuh"

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

// the V values of the 16-byte vector at p, in fp32 (bf16 widened by a shift)
template <typename S>
__device__ __forceinline__ void load16(const S* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(S) == 2) {
      v[2 * e] = __uint_as_float(w[e] << 16);
      v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    } else {
      v[e] = __uint_as_float(w[e]);
    }
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

// The block's runs of U outputs, run b0 + threadIdx.x in o (when below
// runs), stored as consecutive 16-byte vectors: a run of one vector
// directly, runs of several through shared memory, so that neighbouring
// threads store neighbouring vectors (kernels C and J).
template <typename S, int U>
__device__ __forceinline__ void store_runs(S* __restrict__ y, long long b0, long long runs,
                                           const float* o) {
  constexpr int V = 16 / sizeof(S);
  const long long t = b0 + threadIdx.x;
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
    store_runs<S, U>(y, b0, runs, o);
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
      <<<static_cast<unsigned>(blocks), UP_THREADS, 0, tvc::counted(st)>>>(x, wt, y, total, T, f);
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
    downsample_linear_kernel<<<static_cast<unsigned>(blocks), threads, 0, tvc::counted(st)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), total, T, f);
  else
    downsample_linear_kernel<<<static_cast<unsigned>(blocks), threads, 0, tvc::counted(st)>>>(
        static_cast<const float*>(x), static_cast<float*>(y), total, T, f);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Kernel J, up mode: the gradient gx[q] of output q of a row (q of T) from
// the cotangent near f*q: fn(k) is g[q f + k] for k in [-f, 2f). The
// plain version's grouping: (cur + next) + prev, then + edge, each an FMA
// chain over the f phases in order from 0.f. wt[j] are phase j's band
// weights (rounded to bf16 for bf16 g), wt[f + j] its fp32 edge weights.
// FS > 0: f == FS, every loop unrolled and every index static.
template <int FS, typename G>
__device__ __forceinline__ float up_grad_one(G fn, int q, int T, int f, const float4* wt) {
  const int n = FS > 0 ? FS : f;
  float cur = 0.f, nxt = 0.f, prv = 0.f, edge = 0.f;
#pragma unroll
  for (int j = 0; j < n; ++j) cur = __fmaf_rn(fn(j), wt[j].y, cur);
  if (q + 1 < T) {
#pragma unroll
    for (int j = 0; j < n; ++j) nxt = __fmaf_rn(fn(n + j), wt[j].x, nxt);
  }
  if (q > 0) {
#pragma unroll
    for (int j = 0; j < n; ++j) prv = __fmaf_rn(fn(j - n), wt[j].z, prv);
  }
  if (q == 0 || q == T - 1) {  // the clamped neighbour's share, in fp32
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (q == 0) edge = __fmaf_rn(fn(j), wt[n + j].x, edge);
      if (q == T - 1) edge = __fmaf_rn(fn(j), wt[n + j].z, edge);
    }
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(cur, nxt), prv), edge);
}

// shared-memory slot of staged vector k: for even F one slot in nine is
// skipped, so that a quarter warp's 16-byte reads at a stride of F vectors
// fall in distinct banks (odd strides already do)
template <int F>
__host__ __device__ constexpr int grad_slot(int k) { return F % 2 == 0 ? k + (k >> 3) : k; }

// F > 0 (the run path: F in 2..5, T a multiple of V, g 16-byte aligned): a
// block stages its g, f*V*UP_THREADS samples and HV vectors either side,
// through shared memory with 16-byte loads; each thread then reads its
// window of (F + 2 HV) vectors into registers and writes the V gradients
// of one 16-byte vector, every phase, tap and index static. F == 0: a
// thread writes one vector of any f and T, its outputs carried across row
// ends, g read from global memory.
template <typename S, int F>
__global__ void __launch_bounds__(UP_THREADS)
resample_grad_up(const S* __restrict__ g, const float4* __restrict__ wt, S* __restrict__ gx,
                 long long total, int T, int f) {
  constexpr int V = 16 / sizeof(S);
  if constexpr (F > 0) {
    constexpr int HV = (F + V - 1) / V;  // vectors of halo a side
    constexpr int W = F + 2 * HV;        // a thread's window, in vectors
    __shared__ __align__(16) S sg[grad_slot<F>(UP_THREADS * F + 2 * HV) * V];
    const long long q0 = static_cast<long long>(blockIdx.x) * UP_THREADS * V;
    const int nq = static_cast<int>(total - q0 < UP_THREADS * V ? total - q0 : UP_THREADS * V);
    const long long v0 = q0 / V * F - HV;  // g's vector at slot 0
    const long long nvg = total / V * F;
    for (int k = threadIdx.x; k < nq / V * F + 2 * HV; k += UP_THREADS) {
      const long long v = v0 + k;
      if (v >= 0 && v < nvg)
        *reinterpret_cast<uint4*>(sg + grad_slot<F>(k) * V) =
            *reinterpret_cast<const uint4*>(g + v * V);
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) * V >= nq) return;
    float w[W * V];  // g from HV vectors before this thread's first output
#pragma unroll
    for (int k = 0; k < W; ++k)
      load16(sg + grad_slot<F>(static_cast<int>(threadIdx.x) * F + k) * V, w + k * V);
    float4 wr[2 * F];
#pragma unroll
    for (int j = 0; j < 2 * F; ++j) wr[j] = wt[j];
    long long r;
    int i;
    row_col(q0 + threadIdx.x * V, total, T, r, i);
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float* c = w + HV * V + e * F;
      o[e] = up_grad_one<F>([&](int k) { return c[k]; }, i + e, T, F, wr);
    }
    store16(gx + q0 + threadIdx.x * V, o);
  } else {
    const long long g0 = (static_cast<long long>(blockIdx.x) * UP_THREADS + threadIdx.x) * V;
    if (g0 >= total) return;
    long long r;
    int q;
    row_col(g0, total, T, r, q);
    const S* gr = g + r * T * f;
    const int n = total - g0 < V ? static_cast<int>(total - g0) : V;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < n) {
        const S* c = gr + q * f;
        o[e] = up_grad_one<0>([&](int k) { return to_f32(c[k]); }, q, T, f, wt);
        if (++q == T) {
          q = 0;
          gr += static_cast<long long>(T) * f;
        }
      }
    }
    if (n == V) {
      store16(gx + g0, o);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < n) gx[g0 + e] = from_f32<S>(o[e]);
    }
  }
}

// Kernel J, down mode: gx at phase j of input sample q of a row, from
// v = g[q] (0 past the last whole block of f)
__device__ __forceinline__ float down_grad_one(float v, int j, int f) {
  if (f & 1) return j == (f - 1) / 2 ? v : 0.f;
  return j == f / 2 - 1 || j == f / 2 ? v * 0.5f : 0.f;
}

// F > 0 (the run path: F in 3..5, T a multiple of run_len(V, F), g 16-byte
// aligned): a thread writes one run of run_len outputs from its run/F
// cotangent samples, its non-zero lanes at static positions, and the block
// stores its runs as consecutive 16-byte vectors. F == 0: a thread writes
// one vector of any f and T, (row, sample, phase) carried from output to
// output.
template <typename S, int F>
__global__ void __launch_bounds__(UP_THREADS)
resample_grad_down(const S* __restrict__ g, S* __restrict__ gx, long long total, int T, int f) {
  constexpr int V = 16 / sizeof(S);
  if constexpr (F > 0) {
    constexpr int U = run_len(V, F), NQ = U / F;
    const long long runs = total / U;
    const long long b0 = static_cast<long long>(blockIdx.x) * UP_THREADS;
    const long long t = b0 + threadIdx.x;
    float o[U];
    if (t < runs) {  // rows of whole runs: run t reads g[t NQ .. t NQ + NQ)
      float x[NQ];
      if constexpr (NQ == V) {
        load16(g + t * NQ, x);
      } else {
#pragma unroll
        for (int d = 0; d < NQ; ++d) x[d] = to_f32(g[t * NQ + d]);
      }
#pragma unroll
      for (int e = 0; e < U; ++e) o[e] = down_grad_one(x[e / F], e % F, F);
    }
    store_runs<S, U>(gx, b0, runs, o);
  } else {
    const long long g0 = (static_cast<long long>(blockIdx.x) * UP_THREADS + threadIdx.x) * V;
    if (g0 >= total) return;
    long long r;
    int i;
    row_col(g0, total, T, r, i);
    const int out_len = T / f;
    int q = i / f;
    int j = i - q * f;
    const S* gr = g + r * out_len;
    const int n = total - g0 < V ? static_cast<int>(total - g0) : V;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < n) {
        o[e] = q < out_len ? down_grad_one(to_f32(gr[q]), j, f) : 0.f;
        if (++i == T) {
          i = q = j = 0;
          gr += out_len;
        } else if (++j == f) {
          j = 0;
          ++q;
        }
      }
    }
    if (n == V) {
      store16(gx + g0, o);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < n) gx[g0 + e] = from_f32<S>(o[e]);
    }
  }
}

template <typename S, int F>
int launch_grad(const S* g, const float4* wt, S* gx, long long total, int T, int f, bool up,
                cudaStream_t st) {
  constexpr int V = 16 / sizeof(S);
  const long long per_block =
      static_cast<long long>(UP_THREADS) * (!up && F > 0 ? run_len(V, F) : V);
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (up)
    resample_grad_up<S, F><<<nb, UP_THREADS, 0, tvc::counted(st)>>>(g, wt, gx, total, T, f);
  else if constexpr (F == 0 || F >= 3)
    resample_grad_down<S, F><<<nb, UP_THREADS, 0, tvc::counted(st)>>>(g, gx, total, T, f);
  return static_cast<int>(cudaGetLastError());
}

// the run kernels where their shape conditions hold, else the vector ones
template <typename S>
int dispatch_grad(const S* g, const float4* wt, S* gx, long long rows, int T, int f, bool up,
                  bool aligned, cudaStream_t st) {
  constexpr int V = 16 / sizeof(S);
  const long long total = rows * T;
  if (up && aligned && T % V == 0) {
    switch (f) {
      case 2: return launch_grad<S, 2>(g, wt, gx, total, T, f, true, st);
      case 3: return launch_grad<S, 3>(g, wt, gx, total, T, f, true, st);
      case 4: return launch_grad<S, 4>(g, wt, gx, total, T, f, true, st);
      case 5: return launch_grad<S, 5>(g, wt, gx, total, T, f, true, st);
    }
  }
  if (!up && aligned) {
    switch (f) {
      case 3:
        if (T % run_len(V, 3) == 0) return launch_grad<S, 3>(g, wt, gx, total, T, f, false, st);
        break;
      case 4:
        if (T % run_len(V, 4) == 0) return launch_grad<S, 4>(g, wt, gx, total, T, f, false, st);
        break;
      case 5:
        if (T % run_len(V, 5) == 0) return launch_grad<S, 5>(g, wt, gx, total, T, f, false, st);
        break;
    }
  }
  return launch_grad<S, 0>(g, wt, gx, total, T, f, up, st);
}

}  // namespace

// Kernel J. up != 0: g [rows, T*f] -> gx [rows, T] (the gradient of C),
// with w [2f, 4] fp32: phase j's band weights (previous, current, next, 0),
// rounded to bf16 for a bf16 g, then its fp32 edge weights; up == 0: g
// [rows, T/f] -> gx [rows, T] (the gradient of D), w unused. g and gx are
// fp32, or bf16 when bf16 != 0; w and gx 16-byte aligned.
extern "C" int tvc_resample_grad(const void* g, const void* w, void* gx, long long rows, int T,
                                 int f, int up, int bf16, void* stream) {
  if (rows <= 0 || T <= 0 || f <= 0 || static_cast<long long>(T) * f > 0x7fffffffLL ||
      (!up && T < f) || (up && (w == nullptr || (reinterpret_cast<uintptr_t>(w) & 15) != 0)) ||
      (reinterpret_cast<uintptr_t>(gx) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wt = static_cast<const float4*>(w);
  if (bf16)
    return dispatch_grad(static_cast<const __nv_bfloat16*>(g), wt,
                         static_cast<__nv_bfloat16*>(gx), rows, T, f, up != 0, aligned, st);
  return dispatch_grad(static_cast<const float*>(g), wt, static_cast<float*>(gx), rows, T, f,
                       up != 0, aligned, st);
}
