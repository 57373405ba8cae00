// Kernels K and L: the gradients of the fused U-Net's conv chains, for the
// decoder's training step.
//
// K replaces tinyvc_tpu/ops/pallas/filter_stage.py::fused_upsample_chain_t_bwd
// (_up_bwd_kernel, _spill_add; wired by up_chain_vjp): the vjp of kernel F's
// Upsample body, with and without the folded k=7 output conv. L replaces
// _run_down_bwd (fused_downsample_chain_t_bwd, fused_conv3_t_bwd; wired by
// down_chain_vjp and stem_conv_vjp): the vjp of kernel E's Downsample body
// and of the stem.
//
// Function computed. The forward is "pad the chain input by edge
// replication by R, run every conv valid, crop" (filter_stage.cu). Here
// every tensor lives in the extended coordinates [0, E), E = T + 2R, where
// column e is input sample e - R; the chain is recomputed over the ranges
// the later convs need, the cotangent enters at [R, R+T), and each
// gradient is taken over the range its tensor was computed on. The pad's
// gradient folds onto the first and last input sample (the TPU's
// _spill_add), so the result is the exact vjp of the forward kernel.
//
// Design (the TPU kernel recomputes and backpropagates tile by tile in
// VMEM and accumulates weight gradients across its sequential grid): a
// sequence of launches over a workspace of [B, rows, E] fp32 buffers,
//   - the recompute: the FiLM rows (one [4C, C] product over cond), then
//     each conv as in the forward, keeping u (before the FiLM) and r (after
//     it);
//   - each input gradient: the transposed conv (the weights' taps reversed
//     and transposed by the wrapper, as upsample_bwd_weights does) with the
//     leaky-ReLU mask and the residual add in its epilogue; the FiLM's
//     elementwise backward; cond's gradient through the FiLM rows;
//   - each weight gradient: a product reduced over (B, time), each block
//     summing one 1024-column chunk of one batch row into its own partial,
//     then a second pass summing the partials in a fixed order: no float
//     atomics, so runs are reproducible. Bias gradients ride along.
// Launches per call: K 27, L 15 for a down chain and 4 for the stem.
//
// Precision (the TPU's dtype_name): fp32, or bf16 operands with fp32
// accumulation, rounded where the TPU's backward kernels round them: every
// product's two operands (the activation after its leaky ReLU, the weight,
// the cotangent entering a transposed conv or a weight gradient, cond and
// the input as stored in bf16); the folded output conv, fp32 in the
// forward, also takes bf16 operands in the backward, as _up_bwd_kernel's
// gw5/g_r2. Biases, masks, FiLM and residual steps stay fp32.
//
// Bound on the H100: operations. The backward does twice the forward's
// products (each conv's transpose and its weight gradient) plus the
// recompute: 96 C^2 FLOPs per sample for the up chain, at up_4 (B=16, C=24,
// T=48000) 42 GFLOP, 0.63 ms at 67 TFLOP/s; its bytes (the inputs and the
// cotangent read once, the gradients written once) 0.3 GB, 0.09 ms.
// All products run on the CUDA cores in fp32; wgmma would be a later PR's.

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int TCOL = 64;      // columns per block
constexpr int CI_CHUNK = 16;  // input rows per shared-memory stage
constexpr int THREADS = 256;
constexpr int MAX_D3 = 27;    // largest dilation of a k=3 conv

// A [B, rows, rstride] operand read at extended column e (t = e - off):
// outside [0, len) the edge value (zero == 0, the chain input's edge
// replication) or 0 (zero != 0, a tensor defined only on a range).
struct Src {
  const void* p;
  long long bstride;
  int rstride;
  int off;
  int len;
  int zero;
  int bf16;
};

__device__ __forceinline__ float src_at(const Src& s, int b, int row, int col) {
  int t = col - s.off;
  if (t < 0 || t >= s.len) {
    if (s.zero) return 0.f;
    t = t < 0 ? 0 : s.len - 1;
  }
  const long long i = b * s.bstride + static_cast<long long>(row) * s.rstride + t;
  return s.bf16 ? to_f32(static_cast<const __nv_bfloat16*>(s.p)[i])
                : static_cast<const float*>(s.p)[i];
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

enum Epilogue { EP_STORE = 0, EP_FILM = 1, EP_DLRELU = 2 };

// out[b, o, e] = sum_{k, i} w[o, k*cin + i] * f(in[b, i, e + (k - (K-1)/2) d])
// (+ bias[o]) over e in [lo, hi), f = leaky ReLU if act, then bf16 rounding
// (of w too) if round; then the epilogue:
//   EP_FILM:   out2 = out * s + t + res (out keeps the value before the FiLM)
//   EP_DLRELU: out = out * (m > 0 ? 1 : 0.1) (+ add)
struct Conv {
  Src in;
  int cin;
  int act;
  int round;
  const float* w;
  const float* bias;
  int co;
  int d;
  int ep;
  Src s, t, res;
  Src m, add;
  int has_add;
  float* out;
  float* out2;
  long long out_bstride;
  int out_rstride;
  int lo, hi;
};

template <int K, int NI>
__device__ __forceinline__ void conv_body(const Conv& c) {
  constexpr int TCO = 16 * NI;
  constexpr int HMAX = K == 3 ? MAX_D3 : (K - 1) / 2;
  constexpr int SPAN = TCOL + 2 * HMAX;
  __shared__ float sx[CI_CHUNK][SPAN];
  __shared__ float sw[K][CI_CHUNK][TCO + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col0 = c.lo + blockIdx.x * TCOL;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const int half = (K - 1) / 2 * c.d;
  const int span = TCOL + 2 * half;

  float acc[NI][4];
#pragma unroll
  for (int a = 0; a < NI; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;

  for (int ci0 = 0; ci0 < c.cin; ci0 += CI_CHUNK) {
    for (int e = tid; e < CI_CHUNK * span; e += THREADS) {
      const int r = e / span, cc = e - r * span;
      float v = 0.f;
      if (ci0 + r < c.cin) {
        v = src_at(c.in, b, ci0 + r, col0 - half + cc);
        if (c.act) v = lrelu(v);
        if (c.round) v = round_bf16(v);
      }
      sx[r][cc] = v;
    }
    for (int e = tid; e < K * CI_CHUNK * TCO; e += THREADS) {
      const int o = e / (K * CI_CHUNK);
      const int rem = e - o * (K * CI_CHUNK);
      const int k = rem / CI_CHUNK, i = rem - k * CI_CHUNK;
      float v = 0.f;
      if (co0 + o < c.co && ci0 + i < c.cin)
        v = __ldg(c.w + static_cast<long long>(co0 + o) * K * c.cin + k * c.cin + ci0 + i);
      sw[k][i][o] = c.round ? round_bf16(v) : v;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < CI_CHUNK; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float wv[NI], xv[4];
#pragma unroll
        for (int a = 0; a < NI; ++a) wv[a] = sw[k][i][ty + 16 * a];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sx[i][tx + 16 * j + k * c.d];
#pragma unroll
        for (int a = 0; a < NI; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(wv[a], xv[j], acc[a][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < NI; ++a) {
    const int o = co0 + ty + 16 * a;
    if (o >= c.co) continue;
    const float bias = c.bias ? c.bias[o] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= c.hi) continue;
      float v = acc[a][j] + bias;
      const long long idx =
          b * c.out_bstride + static_cast<long long>(o) * c.out_rstride + col;
      if (c.ep == EP_FILM) {
        c.out[idx] = v;
        c.out2[idx] = v * src_at(c.s, b, o, col) + src_at(c.t, b, o, col) +
                      src_at(c.res, b, o, col);
      } else if (c.ep == EP_DLRELU) {
        v = v * (src_at(c.m, b, o, col) > 0.f ? 1.f : 0.1f);
        if (c.has_add) v += src_at(c.add, b, o, col);
        c.out[idx] = v;
      } else {
        c.out[idx] = v;
      }
    }
  }
}

// Weight gradient: gw[o, k*cin + i] = sum_{b, e in [lo, hi)} round(g[b, o, e])
// * round(f(a[b, i, e + (k - (K-1)/2) d])), and gb[o] = sum g[b, o, e]; one
// block per (chunk of one batch row, 16 rows o, 16 rows i), each writing
// its own partial.
struct WGrad {
  Src g;
  int co;
  Src a;
  int cin;
  int act;
  int round;
  int d;
  int lo, hi;
  int chunk;
  int nct;  // chunks per batch row
  float* partial;   // [B * nct, co, K * cin]
  float* bpartial;  // [B * nct, co], or null
};

template <int K>
__device__ __forceinline__ void wgrad_body(const WGrad& w) {
  constexpr int HMAX = K == 3 ? MAX_D3 : (K - 1) / 2;
  constexpr int SPAN = TCOL + 2 * HMAX;
  __shared__ float sg[16][TCOL + 1];
  __shared__ float sa[16][SPAN + 1];

  const int tid = threadIdx.x;
  const int to = tid >> 4;
  const int ti = tid & 15;
  const int chunk_id = blockIdx.x;
  const int b = chunk_id / w.nct;
  const int ct = chunk_id - b * w.nct;
  const int o0 = blockIdx.y * 16;
  const int i0 = blockIdx.z * 16;
  const int clo = w.lo + ct * w.chunk;
  const int chi = min(clo + w.chunk, w.hi);
  const int half = (K - 1) / 2 * w.d;
  const int span = TCOL + 2 * half;
  const bool do_bias = w.bpartial != nullptr && blockIdx.z == 0;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  float bacc = 0.f;

  for (int c0 = clo; c0 < chi; c0 += TCOL) {
    for (int e = tid; e < 16 * TCOL; e += THREADS) {
      const int r = e / TCOL, cc = e - r * TCOL;
      sg[r][cc] = (o0 + r < w.co && c0 + cc < chi) ? src_at(w.g, b, o0 + r, c0 + cc) : 0.f;
    }
    for (int e = tid; e < 16 * span; e += THREADS) {
      const int r = e / span, cc = e - r * span;
      const int col = c0 - half + cc;
      float v = 0.f;
      if (i0 + r < w.cin && col >= clo - half && col < chi + half) {
        v = src_at(w.a, b, i0 + r, col);
        if (w.act) v = lrelu(v);
        if (w.round) v = round_bf16(v);
      }
      sa[r][cc] = v;
    }
    __syncthreads();
    if (do_bias && tid < 16) {
      for (int cc = 0; cc < TCOL; ++cc) bacc += sg[tid][cc];
    }
    for (int cc = 0; cc < TCOL; ++cc) {
      float gv = sg[to][cc];
      if (w.round) gv = round_bf16(gv);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(gv, sa[ti][cc + k * w.d], acc[k]);
    }
    __syncthreads();
  }

  const int ncols = K * w.cin;
  if (o0 + to < w.co && i0 + ti < w.cin) {
    float* out = w.partial + (static_cast<long long>(chunk_id) * w.co + o0 + to) * ncols + i0 + ti;
#pragma unroll
    for (int k = 0; k < K; ++k) out[k * w.cin] = acc[k];
  }
  if (do_bias && tid < 16 && o0 + tid < w.co)
    w.bpartial[static_cast<long long>(chunk_id) * w.co + o0 + tid] = bacc;
}

// out[n] = sum over chunks of partial[chunk][n], in chunk order; bout the same
// over bpartial.
__device__ __forceinline__ void reduce_body(const float* partial, const float* bpartial,
                                            int nchunks, int co, int ncols, float* out,
                                            float* bout) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per = static_cast<long long>(co) * ncols;
  if (n < per) {
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += partial[c * per + n];
    out[n] = s;
  } else if (bout != nullptr && n < per + co) {
    const int m = static_cast<int>(n - per);
    float s = 0.f;
    for (int c = 0; c < nchunks; ++c) s += bpartial[static_cast<long long>(c) * co + m];
    bout[m] = s;
  }
}

// out[b, r, t] (t < Tout) = ext[b, r, t + R] for t < T, else 0; the columns
// of ext's valid range [vlo, vhi) left of R fold onto t = 0 and those right
// of R + T onto t = T - 1 (the edge-replicated pad's gradient).
__device__ __forceinline__ void fold_body(const float* ext, int E, int vlo, int vhi, int R, int T,
                                          int Tout, float* out, long long total) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int t = static_cast<int>(n % Tout);
  const float* row = ext + (n / Tout) * E;
  float v = 0.f;
  if (t < T) {
    v = row[t + R];
    if (t == 0) {
      float s = 0.f;
      for (int e = vlo; e < R; ++e) s += row[e];
      v += s;
    }
    if (t == T - 1) {
      float s = 0.f;
      for (int e = R + T; e < vhi; ++e) s += row[e];
      v += s;
    }
  }
  out[n] = v;
}

// The FiLM's backward over [lo, hi): gu = gr * s, gs = gr * u, gt = gr.
struct FilmGrad {
  Src gr, u, s;
  float* gu;
  float* gs;
  float* gt;
  long long gu_bstride, gf_bstride;
  int E, C, lo, hi;
};

__device__ __forceinline__ void film_body(const FilmGrad& f, long long total) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int W = f.hi - f.lo;
  const int col = f.lo + static_cast<int>(n % W);
  const int r = static_cast<int>((n / W) % f.C);
  const int b = static_cast<int>(n / (static_cast<long long>(W) * f.C));
  const float g = src_at(f.gr, b, r, col);
  const long long rc = static_cast<long long>(r) * f.E + col;
  f.gu[b * f.gu_bstride + rc] = g * src_at(f.s, b, r, col);
  f.gs[b * f.gf_bstride + rc] = g * src_at(f.u, b, r, col);
  f.gt[b * f.gf_bstride + rc] = g;
}

// Kernel names: up_grad_* are kernel K's, down_grad_* kernel L's.
template <int K, int NI>
__global__ void __launch_bounds__(THREADS) up_grad_conv(Conv c) { conv_body<K, NI>(c); }
template <int K, int NI>
__global__ void __launch_bounds__(THREADS) down_grad_conv(Conv c) { conv_body<K, NI>(c); }
template <int K>
__global__ void __launch_bounds__(THREADS) up_grad_wgrad(WGrad w) { wgrad_body<K>(w); }
template <int K>
__global__ void __launch_bounds__(THREADS) down_grad_wgrad(WGrad w) { wgrad_body<K>(w); }
__global__ void up_grad_reduce(const float* p, const float* bp, int n, int co, int ncols,
                               float* out, float* bout) {
  reduce_body(p, bp, n, co, ncols, out, bout);
}
__global__ void down_grad_reduce(const float* p, const float* bp, int n, int co, int ncols,
                                 float* out, float* bout) {
  reduce_body(p, bp, n, co, ncols, out, bout);
}
__global__ void up_grad_fold(const float* ext, int E, int vlo, int vhi, int R, int T, int Tout,
                             float* out, long long total) {
  fold_body(ext, E, vlo, vhi, R, T, Tout, out, total);
}
__global__ void down_grad_fold(const float* ext, int E, int vlo, int vhi, int R, int T, int Tout,
                               float* out, long long total) {
  fold_body(ext, E, vlo, vhi, R, T, Tout, out, total);
}
__global__ void up_grad_film(FilmGrad f, long long total) { film_body(f, total); }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <bool UP, int K>
int run_conv(const Conv& c, int B, cudaStream_t st) {
  if (c.hi <= c.lo || c.cin <= 0 || c.co <= 0) return kInvalid;
  if ((K == 3 && (c.d < 1 || c.d > MAX_D3)) || (K != 3 && c.d != 1)) return kInvalid;
  const int ni = c.co <= 32 ? 2 : 4;
  const dim3 grid((c.hi - c.lo + TCOL - 1) / TCOL, (c.co + 16 * ni - 1) / (16 * ni), B);
  if constexpr (UP) {
    if (ni == 2) up_grad_conv<K, 2><<<grid, THREADS, 0, st>>>(c);
    else up_grad_conv<K, 4><<<grid, THREADS, 0, st>>>(c);
  } else {
    if (ni == 2) down_grad_conv<K, 2><<<grid, THREADS, 0, st>>>(c);
    else down_grad_conv<K, 4><<<grid, THREADS, 0, st>>>(c);
  }
  return static_cast<int>(cudaGetLastError());
}

// gw [co, K*cin] and gb [co] (gb may be null) of `w`, through `scratch`
template <bool UP, int K>
int run_wgrad(WGrad w, int B, float* gw, float* gb, float* scratch, cudaStream_t st) {
  if (w.hi <= w.lo || w.chunk <= 0) return kInvalid;
  if ((K == 3 && (w.d < 1 || w.d > MAX_D3)) || (K != 3 && w.d != 1)) return kInvalid;
  const int ncols = K * w.cin;
  w.nct = (w.hi - w.lo + w.chunk - 1) / w.chunk;
  const int nchunks = B * w.nct;
  w.partial = scratch;
  w.bpartial = gb ? scratch + static_cast<long long>(nchunks) * w.co * ncols : nullptr;
  const dim3 grid(nchunks, (w.co + 15) / 16, (w.cin + 15) / 16);
  if constexpr (UP) up_grad_wgrad<K><<<grid, THREADS, 0, st>>>(w);
  else down_grad_wgrad<K><<<grid, THREADS, 0, st>>>(w);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const long long total = static_cast<long long>(w.co) * ncols + (gb ? w.co : 0);
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if constexpr (UP) up_grad_reduce<<<blocks, 256, 0, st>>>(w.partial, w.bpartial, nchunks, w.co,
                                                             ncols, gw, gb);
  else down_grad_reduce<<<blocks, 256, 0, st>>>(w.partial, w.bpartial, nchunks, w.co, ncols, gw,
                                                 gb);
  return static_cast<int>(cudaGetLastError());
}

template <bool UP>
int run_fold(const float* ext, int B, int rows, int E, int vlo, int vhi, int R, int T, int Tout,
             float* out, cudaStream_t st) {
  const long long total = static_cast<long long>(B) * rows * Tout;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if constexpr (UP) up_grad_fold<<<blocks, 256, 0, st>>>(ext, E, vlo, vhi, R, T, Tout, out, total);
  else down_grad_fold<<<blocks, 256, 0, st>>>(ext, E, vlo, vhi, R, T, Tout, out, total);
  return static_cast<int>(cudaGetLastError());
}

// the chain input, cond or the cotangent: [B, rows, stride] read over [0, T)
Src input(const void* p, int rows, int stride, int R, int T, int zero, int bf16) {
  return Src{p, static_cast<long long>(rows) * stride, stride, R, T, zero, bf16};
}

// a workspace buffer [B, rows, E] defined on [vlo, vhi), 0 elsewhere
Src buf(const float* p, int rows, int E, int vlo, int vhi) {
  return Src{p + vlo, static_cast<long long>(rows) * E, E, vlo, vhi - vlo, 1, 0};
}

Conv conv(Src in, int cin, int act, int round, const float* w, const float* bias, int co, int d,
          float* out, int E, int lo, int hi) {
  Conv c{};
  c.in = in;
  c.cin = cin;
  c.act = act;
  c.round = round;
  c.w = w;
  c.bias = bias;
  c.co = co;
  c.d = d;
  c.ep = EP_STORE;
  c.out = out;
  c.out_bstride = static_cast<long long>(co) * E;
  c.out_rstride = E;
  c.lo = lo;
  c.hi = hi;
  return c;
}

// the input gradient of a conv: the transposed weights over the cotangent
// `g`, times the leaky ReLU's slope at `m`, plus `add`
Conv conv_dlrelu(Src g, int cin, int round, const float* wT, int co, int d, Src m, const Src* add,
                 float* out, int E, int lo, int hi) {
  Conv c = conv(g, cin, 0, round, wT, nullptr, co, d, out, E, lo, hi);
  c.ep = EP_DLRELU;
  c.m = m;
  if (add) {
    c.add = *add;
    c.has_add = 1;
  }
  return c;
}

WGrad wgrad(Src g, int co, Src a, int cin, int act, int round, int d, int lo, int hi, int chunk) {
  WGrad w{};
  w.g = g;
  w.co = co;
  w.a = a;
  w.cin = cin;
  w.act = act;
  w.round = round;
  w.d = d;
  w.lo = lo;
  w.hi = hi;
  w.chunk = chunk;
  return w;
}

long long chunks(int B, int E, int chunk) { return static_cast<long long>(B) * ((E + chunk - 1) / chunk); }

#define TRY(x)               \
  do {                       \
    const int rc_ = (x);     \
    if (rc_) return rc_;     \
  } while (0)

}  // namespace

// Kernel K. Forward inputs xu [B, C, xu_stride] (read over [0, T)), cond
// [B, C, T], both bf16 when bf16 != 0; the forward weights of kernel F
// (wconv [4, C, 3C], bconv [4, C], wfilm [4C, C], bfilm [4C]), the
// transposed ones (wconvT [4, C, 3C] with the taps reversed, wfilmT
// [C, 4C]) and w5T: [C, co] (the output 1x1 transposed), or with fold_k = 7
// [C, 7] (tap k of row i is w5c[6 - k, i]); the cotangent gy [B, co, T]
// fp32 (co = 1 folded). Out (fp32): gx [B, C, xu_stride], gc [B, C, T],
// gwconv, gbconv, gwfilm, gbfilm, gw5 ([co, C], or [7, C] folded) and gb5
// ([co], or folded [1]: the sum of gy, every folded tap's bias gradient and
// the output bias's). ws: at least 22 B C E + B ceil(E/chunk) max(4C^2+4C,
// co C+co, 7C+1) floats, E = T + 2R, R = 40 (+3 folded).
extern "C" int tvc_up_chain_grad(const void* xu, const void* cond, const float* wconv,
                                 const float* bconv, const float* wfilm, const float* bfilm,
                                 const float* wconvT, const float* wfilmT, const float* w5T,
                                 const float* gy, float* gx, float* gc, float* gwconv,
                                 float* gbconv, float* gwfilm, float* gbfilm, float* gw5,
                                 float* gb5, float* ws, long long ws_floats, int B, int C, int co,
                                 int T, int xu_stride, int fold_k, int bf16, int chunk,
                                 void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || co <= 0 || T <= 0 || xu_stride < T || chunk <= 0 ||
      (fold_k != 0 && fold_k != 7) || (fold_k && co != 1))
    return kInvalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = 40 + (fold_k ? (fold_k - 1) / 2 : 0), E = T + 2 * R;
  const long long n = static_cast<long long>(B) * C * E;
  long long cols = 4LL * C * C + 4 * C;
  cols = cols > static_cast<long long>(co) * C + co ? cols : static_cast<long long>(co) * C + co;
  cols = cols > 7LL * C + 1 ? cols : 7LL * C + 1;
  if (ws_floats < 22 * n + chunks(B, E, chunk) * cols) return kInvalid;
  float* films = ws;
  float* u1 = films + 4 * n;
  float* u2 = u1 + n;
  float* r1 = u2 + n;
  float* u3 = r1 + n;
  float* u4 = u3 + n;
  float* r2 = u4 + n;
  float* gfilms = r2 + n;
  float* gr2 = gfilms + 4 * n;
  float* gu4 = gr2 + n;
  float* gu3 = gu4 + n;
  float* gr1 = gu3 + n;
  float* gu2 = gr1 + n;
  float* gu1 = gu2 + n;
  float* gxe = gu1 + n;
  float* gce = gxe + n;
  float* scratch = gce + n;
  const long long CE = static_cast<long long>(C) * E;
  const long long CC3 = 3LL * C * C;
  const Src xin = input(xu, C, xu_stride, R, T, 0, bf16);
  const Src cin = input(cond, C, T, R, T, 0, bf16);
  const Src gyz = input(gy, co, T, R, T, 1, 0);
  auto film_rows = [&](const float* base, int j) {  // rows [jC, (j+1)C) of a [B, 4C, E] buffer
    Src s = buf(base + j * CE, 4 * C, E, 4, E - 4);
    return s;
  };

  // ---- recompute ----
  Conv c = conv(cin, C, 0, bf16, wfilm, bfilm, 4 * C, 1, films, E, 4, E - 4);
  TRY((run_conv<true, 1>(c, B, st)));
  TRY((run_conv<true, 3>(conv(xin, C, 1, bf16, wconv, bconv, C, 1, u1, E, 1, E - 1), B, st)));
  c = conv(buf(u1, C, E, 1, E - 1), C, 1, bf16, wconv + CC3, bconv + C, C, 3, u2, E, 4, E - 4);
  c.ep = EP_FILM;
  c.s = film_rows(films, 0);
  c.t = film_rows(films, 1);
  c.res = xin;
  c.out2 = r1;
  TRY((run_conv<true, 3>(c, B, st)));
  TRY((run_conv<true, 3>(conv(buf(r1, C, E, 4, E - 4), C, 1, bf16, wconv + 2 * CC3,
                              bconv + 2 * C, C, 9, u3, E, 13, E - 13), B, st)));
  c = conv(buf(u3, C, E, 13, E - 13), C, 1, bf16, wconv + 3 * CC3, bconv + 3 * C, C, 27, u4, E,
           40, E - 40);
  c.ep = EP_FILM;
  c.s = film_rows(films, 2);
  c.t = film_rows(films, 3);
  c.res = buf(r1, C, E, 4, E - 4);
  c.out2 = r2;
  TRY((run_conv<true, 3>(c, B, st)));

  // ---- backward ----
  const Src r2s = buf(r2, C, E, 40, E - 40);
  if (fold_k) {  // g_r2[i, e] = sum_j w5c[j, i] gy[e + 3 - j]
    TRY((run_conv<true, 7>(conv(gyz, 1, 0, bf16, w5T, nullptr, C, 1, gr2, E, 40, E - 40), B,
                           st)));
  } else {
    TRY((run_conv<true, 1>(conv(gyz, co, 0, bf16, w5T, nullptr, C, 1, gr2, E, 40, E - 40), B,
                           st)));
  }
  auto film_grad = [&](Src gr, Src u, int j, float* gu) {
    FilmGrad f{};
    f.gr = gr;
    f.u = u;
    f.s = film_rows(films, 2 * j);
    f.gu = gu;
    f.gs = gfilms + 2 * j * CE;
    f.gt = gfilms + (2 * j + 1) * CE;
    f.gu_bstride = CE;
    f.gf_bstride = 4 * CE;
    f.E = E;
    f.C = C;
    f.lo = 4;
    f.hi = E - 4;
    const long long total = static_cast<long long>(B) * C * (E - 8);
    up_grad_film<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(f, total);
    return static_cast<int>(cudaGetLastError());
  };
  TRY(film_grad(buf(gr2, C, E, 40, E - 40), buf(u4, C, E, 40, E - 40), 1, gu4));
  const float* wT = wconvT;
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu4, C, E, 40, E - 40), C, bf16, wT + 3 * CC3, C, 27,
                                     buf(u3, C, E, 13, E - 13), nullptr, gu3, E, 13, E - 13),
                         B, st)));
  const Src gr2s = buf(gr2, C, E, 40, E - 40);
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu3, C, E, 13, E - 13), C, bf16, wT + 2 * CC3, C, 9,
                                     buf(r1, C, E, 4, E - 4), &gr2s, gr1, E, 4, E - 4),
                         B, st)));
  TRY(film_grad(buf(gr1, C, E, 4, E - 4), buf(u2, C, E, 4, E - 4), 0, gu2));
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu2, C, E, 4, E - 4), C, bf16, wT + CC3, C, 3,
                                     buf(u1, C, E, 1, E - 1), nullptr, gu1, E, 1, E - 1),
                         B, st)));
  const Src gr1s = buf(gr1, C, E, 4, E - 4);
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu1, C, E, 1, E - 1), C, bf16, wT, C, 1, xin, &gr1s,
                                     gxe, E, 0, E),
                         B, st)));
  TRY((run_conv<true, 1>(conv(buf(gfilms, 4 * C, E, 4, E - 4), 4 * C, 0, bf16, wfilmT, nullptr,
                              C, 1, gce, E, 4, E - 4),
                         B, st)));

  // ---- weight gradients ----
  TRY((run_wgrad<true, 3>(wgrad(buf(gu4, C, E, 40, E - 40), C, buf(u3, C, E, 13, E - 13), C, 1,
                                bf16, 27, 40, E - 40, chunk),
                          B, gwconv + 3 * CC3, gbconv + 3 * C, scratch, st)));
  TRY((run_wgrad<true, 3>(wgrad(buf(gu3, C, E, 13, E - 13), C, buf(r1, C, E, 4, E - 4), C, 1,
                                bf16, 9, 13, E - 13, chunk),
                          B, gwconv + 2 * CC3, gbconv + 2 * C, scratch, st)));
  TRY((run_wgrad<true, 3>(wgrad(buf(gu2, C, E, 4, E - 4), C, buf(u1, C, E, 1, E - 1), C, 1, bf16,
                                3, 4, E - 4, chunk),
                          B, gwconv + CC3, gbconv + C, scratch, st)));
  TRY((run_wgrad<true, 3>(wgrad(buf(gu1, C, E, 1, E - 1), C, xin, C, 1, bf16, 1, 1, E - 1,
                                chunk),
                          B, gwconv, gbconv, scratch, st)));
  TRY((run_wgrad<true, 1>(wgrad(buf(gfilms, 4 * C, E, 4, E - 4), 4 * C, cin, C, 0, bf16, 1, 4,
                                E - 4, chunk),
                          B, gwfilm, gbfilm, scratch, st)));
  if (fold_k) {  // gw5c[j, i] = sum_e gy[e] r2[i, e + j - 3]
    TRY((run_wgrad<true, 7>(wgrad(gyz, 1, r2s, C, 0, bf16, 1, R, R + T, chunk), B, gw5, gb5,
                            scratch, st)));
  } else {
    TRY((run_wgrad<true, 1>(wgrad(gyz, co, r2s, C, 0, bf16, 1, R, R + T, chunk), B, gw5, gb5,
                            scratch, st)));
  }

  // ---- the edge-replicated pads' gradients onto the end samples ----
  TRY(run_fold<true>(gxe, B, C, E, 0, E, R, T, xu_stride, gx, st));
  return run_fold<true>(gce, B, C, E, 4, E - 4, R, T, T, gc, st);
}

// Kernel L, down chain. z [B, cin, z_stride] (read over [0, T), bf16 when
// bf16 != 0); the forward's w1, b1, w2, b2 and the transposed w1T, w2T
// ([cin, 3 cin]), w3T ([cin, 3 co]) with the taps reversed and wresT
// [cin, co]; gy [B, co, T] fp32. Out (fp32): gz [B, cin, z_stride], gwres
// [co, cin], gbres, gw1, gb1, gw2, gb2, gw3 [co, 3 cin], gb3. ws: at least
// 6 B cin E + B ceil(E/chunk) max(3 co cin + co, 3 cin^2 + cin) floats,
// E = T + 14.
extern "C" int tvc_down_chain_grad(const void* z, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const float* w1T,
                                   const float* w2T, const float* w3T, const float* wresT,
                                   const float* gy, float* gz, float* gwres, float* gbres,
                                   float* gw1, float* gb1, float* gw2, float* gb2, float* gw3,
                                   float* gb3, float* ws, long long ws_floats, int B, int cin,
                                   int co, int T, int z_stride, int bf16, int chunk,
                                   void* stream) {
  if (B <= 0 || B > 65535 || cin <= 0 || co <= 0 || T <= 0 || z_stride < T || chunk <= 0)
    return kInvalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = 7, E = T + 2 * R;
  const long long n = static_cast<long long>(B) * cin * E;
  long long cols = 3LL * co * cin + co;
  cols = cols > 3LL * cin * cin + cin ? cols : 3LL * cin * cin + cin;
  if (ws_floats < 6 * n + chunks(B, E, chunk) * cols) return kInvalid;
  float* u1 = ws;
  float* u2 = u1 + n;
  float* gu2 = u2 + n;
  float* gu1 = gu2 + n;
  float* gres = gu1 + n;
  float* gxe = gres + n;
  float* scratch = gxe + n;
  const Src zin = input(z, cin, z_stride, R, T, 0, bf16);
  const Src gyz = input(gy, co, T, R, T, 1, 0);
  const Src u1s = buf(u1, cin, E, 1, E - 1), u2s = buf(u2, cin, E, 3, E - 3);
  const Src gu2s = buf(gu2, cin, E, 3, E - 3), gu1s = buf(gu1, cin, E, 1, E - 1);

  // ---- recompute ----
  TRY((run_conv<false, 3>(conv(zin, cin, 1, bf16, w1, b1, cin, 1, u1, E, 1, E - 1), B, st)));
  TRY((run_conv<false, 3>(conv(u1s, cin, 1, bf16, w2, b2, cin, 2, u2, E, 3, E - 3), B, st)));

  // ---- backward ----
  TRY((run_conv<false, 3>(
      conv_dlrelu(gyz, co, bf16, w3T, cin, 4, u2s, nullptr, gu2, E, 3, E - 3), B, st)));
  TRY((run_conv<false, 3>(
      conv_dlrelu(gu2s, cin, bf16, w2T, cin, 2, u1s, nullptr, gu1, E, 1, E - 1), B, st)));
  TRY((run_conv<false, 1>(conv(gyz, co, 0, bf16, wresT, nullptr, cin, 1, gres, E, 0, E), B,
                          st)));
  const Src gress = buf(gres, cin, E, 0, E);
  TRY((run_conv<false, 3>(
      conv_dlrelu(gu1s, cin, bf16, w1T, cin, 1, zin, &gress, gxe, E, 0, E), B, st)));

  // ---- weight gradients ----
  TRY((run_wgrad<false, 3>(wgrad(gyz, co, u2s, cin, 1, bf16, 4, R, R + T, chunk), B, gw3, gb3,
                           scratch, st)));
  TRY((run_wgrad<false, 3>(wgrad(gu2s, cin, u1s, cin, 1, bf16, 2, 3, E - 3, chunk), B, gw2, gb2,
                           scratch, st)));
  TRY((run_wgrad<false, 3>(wgrad(gu1s, cin, zin, cin, 1, bf16, 1, 1, E - 1, chunk), B, gw1, gb1,
                           scratch, st)));
  TRY((run_wgrad<false, 1>(wgrad(gyz, co, zin, cin, 0, bf16, 1, R, R + T, chunk), B, gwres,
                           gbres, scratch, st)));
  return run_fold<false>(gxe, B, cin, E, 0, E, R, T, z_stride, gz, st);
}

// Kernel L, stem. x [B, cin, x_stride] (read over [0, T), bf16 when
// bf16 != 0), wT [cin, 3 co] (the stem's taps reversed and transposed), gy
// [B, co, T] fp32 -> gx [B, cin, x_stride], gw [co, 3 cin], gb [co] (fp32).
// ws: at least B cin (T+2) + B ceil((T+2)/chunk) (3 co cin + co) floats.
extern "C" int tvc_conv3_grad(const void* x, const float* wT, const float* gy, float* gx,
                              float* gw, float* gb, float* ws, long long ws_floats, int B,
                              int cin, int co, int T, int x_stride, int bf16, int chunk,
                              void* stream) {
  if (B <= 0 || B > 65535 || cin <= 0 || co <= 0 || T <= 0 || x_stride < T || chunk <= 0)
    return kInvalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = 1, E = T + 2 * R;
  const long long n = static_cast<long long>(B) * cin * E;
  if (ws_floats < n + chunks(B, E, chunk) * (3LL * co * cin + co)) return kInvalid;
  float* gxe = ws;
  float* scratch = gxe + n;
  const Src xin = input(x, cin, x_stride, R, T, 0, bf16);
  const Src gyz = input(gy, co, T, R, T, 1, 0);
  TRY((run_conv<false, 3>(conv(gyz, co, 0, bf16, wT, nullptr, cin, 1, gxe, E, 0, E), B, st)));
  TRY((run_wgrad<false, 3>(wgrad(gyz, co, xin, cin, 0, bf16, 1, R, R + T, chunk), B, gw, gb,
                           scratch, st)));
  return run_fold<false>(gxe, B, cin, E, 0, E, R, T, x_stride, gx, st);
}
