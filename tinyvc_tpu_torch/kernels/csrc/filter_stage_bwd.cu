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
// sequence of launches over a workspace, in two routes.
//
// fp32 operands (tvc_up_chain_grad, tvc_down_chain_grad, tvc_conv3_grad;
// exact products, TF32 would break the tolerance): CUDA-core tiles over
// [B, rows, E] fp32 buffers,
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
//   Launches per call: K 27, L 15 for a down chain and 4 for the stem.
// bf16 operands (tvc_up_chain_grad_bf16, tvc_down_chain_grad_bf16,
// tvc_conv3_grad_bf16): the tensor-core tiles of unet_tiles.cuh over
// position-major bf16 copies; fp32 buffers only for what an epilogue reads
// in fp32 (the pre-activations whose sign makes a mask, u2 and u4 for gs,
// r1, the FiLM rows, g_r1 and g_r2). Launches per call: one that writes the
// inputs' copies and packs the weights (from the forward's weights, their
// transposes read in place), one per conv (the FiLM's backward and the bias
// gradients' partial sums in the epilogues), one per weight gradient, one
// that adds the partials and folds the pads: K 19, L 12 for a down chain
// and 4 for the stem. Each entry sizes its own workspace: called with a
// null ws it writes the bytes it needs to *ws_bytes and launches nothing.
//
// Precision (the TPU's dtype_name): fp32, or bf16 operands with fp32
// accumulation, rounded where the TPU's backward kernels round them (the
// bf16 route; conv_body's and wgrad_body's round flag is always 0): every
// product's two operands (the activation after its leaky ReLU, the weight,
// the cotangent entering a transposed conv or a weight gradient, cond and
// the input as stored in bf16); the folded output conv, fp32 in the
// forward, also takes bf16 operands in the backward, as _up_bwd_kernel's
// gw5/g_r2. Biases, masks, FiLM and residual steps stay fp32.
//
// Bound on the H100: operations. The backward does twice the forward's
// products (each conv's transpose and its weight gradient) plus the
// recompute: 96 C^2 FLOPs per sample for the up chain, at up_4 (B=16, C=24,
// T=48000) 42 GFLOP, 0.63 ms at 67 TFLOP/s in fp32, 0.04 ms at 989 TFLOP/s
// on the tensor cores; its bytes (the inputs and the cotangent read once,
// the gradients written once) 0.3 GB, 0.09 ms.

#include <cuda_runtime.h>

#include "unet_tiles.cuh"
#include "launch_count.cuh"

namespace {

constexpr int TCOL = 64;      // columns per block
constexpr int CI_CHUNK = 16;  // input rows per shared-memory stage
constexpr int THREADS = 256;
constexpr int MAX_D3 = 27;    // largest dilation of a k=3 conv

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
    if (ni == 2) up_grad_conv<K, 2><<<grid, THREADS, 0, tvc::counted(st)>>>(c);
    else up_grad_conv<K, 4><<<grid, THREADS, 0, tvc::counted(st)>>>(c);
  } else {
    if (ni == 2) down_grad_conv<K, 2><<<grid, THREADS, 0, tvc::counted(st)>>>(c);
    else down_grad_conv<K, 4><<<grid, THREADS, 0, tvc::counted(st)>>>(c);
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
  if constexpr (UP) up_grad_wgrad<K><<<grid, THREADS, 0, tvc::counted(st)>>>(w);
  else down_grad_wgrad<K><<<grid, THREADS, 0, tvc::counted(st)>>>(w);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const long long total = static_cast<long long>(w.co) * ncols + (gb ? w.co : 0);
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if constexpr (UP)
    up_grad_reduce<<<blocks, 256, 0, tvc::counted(st)>>>(w.partial, w.bpartial, nchunks, w.co,
                                                         ncols, gw, gb);
  else
    down_grad_reduce<<<blocks, 256, 0, tvc::counted(st)>>>(w.partial, w.bpartial, nchunks, w.co,
                                                           ncols, gw, gb);
  return static_cast<int>(cudaGetLastError());
}

template <bool UP>
int run_fold(const float* ext, int B, int rows, int E, int vlo, int vhi, int R, int T, int Tout,
             float* out, cudaStream_t st) {
  const long long total = static_cast<long long>(B) * rows * Tout;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if constexpr (UP)
    up_grad_fold<<<blocks, 256, 0, tvc::counted(st)>>>(ext, E, vlo, vhi, R, T, Tout, out, total);
  else
    down_grad_fold<<<blocks, 256, 0, tvc::counted(st)>>>(ext, E, vlo, vhi, R, T, Tout, out, total);
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

// Kernel K, fp32 operands. Forward inputs xu [B, C, xu_stride] (read over
// [0, T)), cond [B, C, T]; the forward weights of kernel F
// (wconv [4, C, 3C], bconv [4, C], wfilm [4C, C], bfilm [4C]), the
// transposed ones (wconvT [4, C, 3C] with the taps reversed, wfilmT
// [C, 4C]) and w5T: [C, co] (the output 1x1 transposed), or with fold_k = 7
// [C, 7] (tap k of row i is w5c[6 - k, i]); the cotangent gy [B, co, T]
// fp32 (co = 1 folded). Out (fp32): gx [B, C, xu_stride], gc [B, C, T],
// gwconv, gbconv, gwfilm, gbfilm, gw5 ([co, C], or [7, C] folded) and gb5
// ([co], or folded [1]: the sum of gy, every folded tap's bias gradient and
// the output bias's). pre: null, or the forward's pre-activations
// (tvc_up_chain's pre, [3, B, C, E]), whose signs then choose the inner
// leaky ReLUs' branches in place of the recomputed ones'. ws: at least
// 22 B C E + B ceil(E/chunk) max(4C^2+4C, co C+co, 7C+1) floats, E = T + 2R,
// R = 40 (+3 folded).
extern "C" int tvc_up_chain_grad(const void* xu, const void* cond, const float* wconv,
                                 const float* bconv, const float* wfilm, const float* bfilm,
                                 const float* wconvT, const float* wfilmT, const float* w5T,
                                 const float* gy, const float* pre, float* gx, float* gc, float* gwconv,
                                 float* gbconv, float* gwfilm, float* gbfilm, float* gw5,
                                 float* gb5, float* ws, long long ws_floats, int B, int C, int co,
                                 int T, int xu_stride, int fold_k, int chunk, void* stream) {
  constexpr int bf16 = 0;  // bf16 operands take tvc_up_chain_grad_bf16
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
  // the pre-activations whose signs the leaky ReLUs' derivatives take
  const float* m1 = pre ? pre : u1;
  const float* mr1 = pre ? pre + n : r1;
  const float* m3 = pre ? pre + 2 * n : u3;
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
    up_grad_film<<<static_cast<unsigned>((total + 255) / 256), 256, 0, tvc::counted(st)>>>(f,
                                                                                          total);
    return static_cast<int>(cudaGetLastError());
  };
  TRY(film_grad(buf(gr2, C, E, 40, E - 40), buf(u4, C, E, 40, E - 40), 1, gu4));
  const float* wT = wconvT;
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu4, C, E, 40, E - 40), C, bf16, wT + 3 * CC3, C, 27,
                                     buf(m3, C, E, 13, E - 13), nullptr, gu3, E, 13, E - 13),
                         B, st)));
  const Src gr2s = buf(gr2, C, E, 40, E - 40);
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu3, C, E, 13, E - 13), C, bf16, wT + 2 * CC3, C, 9,
                                     buf(mr1, C, E, 4, E - 4), &gr2s, gr1, E, 4, E - 4),
                         B, st)));
  TRY(film_grad(buf(gr1, C, E, 4, E - 4), buf(u2, C, E, 4, E - 4), 0, gu2));
  TRY((run_conv<true, 3>(conv_dlrelu(buf(gu2, C, E, 4, E - 4), C, bf16, wT + CC3, C, 3,
                                     buf(m1, C, E, 1, E - 1), nullptr, gu1, E, 1, E - 1),
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

// Kernel L, down chain, fp32 operands. z [B, cin, z_stride] (read over
// [0, T)); the forward's w1, b1, w2, b2 and the transposed w1T, w2T
// ([cin, 3 cin]), w3T ([cin, 3 co]) with the taps reversed and wresT
// [cin, co]; gy [B, co, T] fp32. Out (fp32): gz [B, cin, z_stride], gwres
// [co, cin], gbres, gw1, gb1, gw2, gb2, gw3 [co, 3 cin], gb3. pre: null, or
// the forward's h1 and h2 (tvc_down_chain's pre, [2, B, cin, E]), whose
// signs then choose the leaky ReLUs' branches in place of the recomputed
// ones'. ws: at least 6 B cin E + B ceil(E/chunk) max(3 co cin + co,
// 3 cin^2 + cin) floats, E = T + 14.
extern "C" int tvc_down_chain_grad(const void* z, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const float* w1T,
                                   const float* w2T, const float* w3T, const float* wresT,
                                   const float* gy, const float* pre, float* gz, float* gwres, float* gbres,
                                   float* gw1, float* gb1, float* gw2, float* gb2, float* gw3,
                                   float* gb3, float* ws, long long ws_floats, int B, int cin,
                                   int co, int T, int z_stride, int chunk, void* stream) {
  constexpr int bf16 = 0;  // bf16 operands take tvc_down_chain_grad_bf16
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
  // the pre-activations whose signs the leaky ReLUs' derivatives take
  const Src m1 = pre ? buf(pre, cin, E, 1, E - 1) : u1s;
  const Src m2 = pre ? buf(pre + n, cin, E, 3, E - 3) : u2s;

  // ---- recompute ----
  TRY((run_conv<false, 3>(conv(zin, cin, 1, bf16, w1, b1, cin, 1, u1, E, 1, E - 1), B, st)));
  TRY((run_conv<false, 3>(conv(u1s, cin, 1, bf16, w2, b2, cin, 2, u2, E, 3, E - 3), B, st)));

  // ---- backward ----
  TRY((run_conv<false, 3>(
      conv_dlrelu(gyz, co, bf16, w3T, cin, 4, m2, nullptr, gu2, E, 3, E - 3), B, st)));
  TRY((run_conv<false, 3>(
      conv_dlrelu(gu2s, cin, bf16, w2T, cin, 2, m1, nullptr, gu1, E, 1, E - 1), B, st)));
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

// Kernel L, stem, fp32 operands. x [B, cin, x_stride] (read over [0, T)),
// wT [cin, 3 co] (the stem's taps reversed and transposed), gy
// [B, co, T] fp32 -> gx [B, cin, x_stride], gw [co, 3 cin], gb [co] (fp32).
// ws: at least B cin (T+2) + B ceil((T+2)/chunk) (3 co cin + co) floats.
extern "C" int tvc_conv3_grad(const void* x, const float* wT, const float* gy, float* gx,
                              float* gw, float* gb, float* ws, long long ws_floats, int B,
                              int cin, int co, int T, int x_stride, int chunk, void* stream) {
  constexpr int bf16 = 0;  // bf16 operands take tvc_conv3_grad_bf16
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

// ===========================================================================
// The bf16 route (unet_tiles.cuh): tensor-core tiles over position-major
// copies. Launches per call: K 19, L 12 for a down chain and 4 for the stem.
// ===========================================================================
namespace {

// blocks an SM the conv tiles are built for (their register budget): on
// the H100 the 32 x 128 tile ran faster at 6 (80 registers) than at 4 or 8
// (spills), the 48- and 64-row ones at 5 than at 4, the 32 x 256 one at 4
template <int MT, int NT>
constexpr int conv_blocks() { return MT == 2 && NT == 4 ? 6 : NT == 4 ? 5 : 4; }

template <int MT, int NT>
__global__ void __launch_bounds__(TC_THREADS, conv_blocks<MT, NT>())
    up_grad_tc_conv(TcConv c) { tc_conv<MT, NT>(c); }
template <int MT, int NT>
__global__ void __launch_bounds__(TC_THREADS, conv_blocks<MT, NT>())
    down_grad_tc_conv(TcConv c) { tc_conv<MT, NT>(c); }
template <int MT, int NT>
__global__ void __launch_bounds__(TC_THREADS) up_grad_tc_wgrad(TcWgrad w) { tc_wgrad<MT, NT>(w); }
template <int MT, int NT>
__global__ void __launch_bounds__(TC_THREADS) down_grad_tc_wgrad(TcWgrad w) { tc_wgrad<MT, NT>(w); }
__global__ void __launch_bounds__(TC_THREADS) up_grad_tc_prep(Prep p) { prep_body(p); }
__global__ void __launch_bounds__(TC_THREADS) down_grad_tc_prep(Prep p) { prep_body(p); }
__global__ void __launch_bounds__(TC_THREADS) up_grad_tc_finish(Finish f) { finish_body(f); }
__global__ void __launch_bounds__(TC_THREADS) down_grad_tc_finish(Finish f) { finish_body(f); }

constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

template <typename Kern, typename Arg>
int launch_tc(Kern kern, dim3 grid, int smem, const Arg& arg, cudaStream_t st) {
  if (smem > kMaxSmem || grid.x == 0 || grid.y > 65535 || grid.z > 65535) return kInvalid;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return kInvalid;
  kern<<<grid, TC_THREADS, smem, tvc::counted(st)>>>(arg);
  return static_cast<int>(cudaGetLastError());
}

// the conv's blocks along the positions of a batch row
int conv_tiles(int co, int ep, int len) { return cdiv(len, 32 * conv_nt(tc_mt(co), ep)); }

template <bool UP>
int run_tc_conv(const TcConv& c, int B, cudaStream_t st) {
  if (c.hi <= c.lo || c.co <= 0 || c.cin_p <= 0 || c.cin_p % 8 || c.taps < 1 || c.d < 1 ||
      c.kp % 16 || c.kp < c.taps * c.cin_p || (c.taps - 1) / 2 * c.d > MAX_D3)
    return kInvalid;
  const int mt = tc_mt(c.co);
  const dim3 grid(conv_tiles(c.co, c.ep, c.hi - c.lo), cdiv(c.co, 16 * mt), B);
  const int smem = conv_smem(mt, c);
  if (mt == 2 && c.ep == TC_STORE)
    return launch_tc(UP ? up_grad_tc_conv<2, 8> : down_grad_tc_conv<2, 8>, grid, smem, c, st);
  if (mt == 2)
    return launch_tc(UP ? up_grad_tc_conv<2, 4> : down_grad_tc_conv<2, 4>, grid, smem, c, st);
  if (mt == 3)
    return launch_tc(UP ? up_grad_tc_conv<3, 4> : down_grad_tc_conv<3, 4>, grid, smem, c, st);
  return launch_tc(UP ? up_grad_tc_conv<4, 4> : down_grad_tc_conv<4, 4>, grid, smem, c, st);
}

template <bool UP>
int run_tc_wgrad(const TcWgrad& w, cudaStream_t st) {
  const int mt = tc_mt(w.gm);
  const dim3 grid(cdiv(w.gm, 16 * mt) * cdiv(w.taps * (w.ac / 8), wgrad_nt(mt)), w.splits);
  const int smem = wgrad_smem(mt, w);
  if (mt == 2)
    return launch_tc(UP ? up_grad_tc_wgrad<2, wgrad_nt(2)> : down_grad_tc_wgrad<2, wgrad_nt(2)>,
                     grid, smem, w, st);
  if (mt == 3)
    return launch_tc(UP ? up_grad_tc_wgrad<3, wgrad_nt(3)> : down_grad_tc_wgrad<3, wgrad_nt(3)>,
                     grid, smem, w, st);
  return launch_tc(UP ? up_grad_tc_wgrad<4, wgrad_nt(4)> : down_grad_tc_wgrad<4, wgrad_nt(4)>,
                   grid, smem, w, st);
}

// The call's workspace, taken region by region, each 256-byte aligned; on
// a null base it only counts the bytes (the entries' size query)
struct Arena {
  void* base;
  long long used;
  template <typename T>
  T* take(long long n) {
    T* p = base ? reinterpret_cast<T*>(static_cast<char*>(base) + used) : nullptr;
    used += (n * static_cast<long long>(sizeof(T)) + 255) / 256 * 256;
    return p;
  }
};

// after the regions: the query's answer (null ws), or the size check
int sized(const Arena& ar, long long* ws_bytes) {
  if (!ar.base) {
    *ws_bytes = ar.used;
    return 1;
  }
  return 0;
}

using bf16_t = __nv_bfloat16;

// a copy [B][E][cp] of `src`'s rows over [lo, hi), with its bias partials in
// bp (or null)
CopyJob copy_job(Src src, int rows, int act, bf16_t* dst, int cp, int E, int lo, int hi,
                 float* bp) {
  return CopyJob{src, rows, act, dst, cp, E, lo, hi, cdiv(hi - lo, TC_POS), bp};
}

// weights [co][kp] (kp = taps pad8(cin) rounded up to 16) from w [co][taps][cin]
PackJob pack_job(const float* w, bf16_t* wp, int co, int taps, int cin) {
  return PackJob{w, wp, co, taps, cin, pad8(cin), pad16(taps * pad8(cin)), 0, 1LL * taps * cin,
                 cin, 1};
}

// the transposed conv's weights [co][kp] from the forward's w [cin][taps][co]
// (this conv's cin and co), its taps reversed: the input gradient's
PackJob pack_taps_t(const float* w, bf16_t* wp, int co, int taps, int cin) {
  return PackJob{w, wp, co, taps, cin, pad8(cin), pad16(taps * pad8(cin)),
                 (taps - 1LL) * co, 1, -co, 1LL * taps * co};
}

template <bool UP>
int run_prep(Prep p, int B, cudaStream_t st) {
  int blocks = 0, cp = 8;
  for (int j = 0; j < p.ncopy; ++j) {
    if (p.copy[j].cp > PREP_MAX_CP) return kInvalid;
    cp = p.copy[j].cp > cp ? p.copy[j].cp : cp;
    p.first[j] = blocks;
    blocks += B * p.copy[j].tiles;
  }
  p.ss = cp + 8;
  const int smem = 2 * TC_POS * p.ss;  // below 48 KB
  for (int j = 0; j < p.npack; ++j) {
    p.first[p.ncopy + j] = blocks;
    blocks += cdiv(p.pack[j].co * p.pack[j].kp, TC_THREADS);
  }
  p.first[p.ncopy + p.npack] = blocks;
  if constexpr (UP) up_grad_tc_prep<<<blocks, TC_THREADS, smem, tvc::counted(st)>>>(p);
  else down_grad_tc_prep<<<blocks, TC_THREADS, smem, tvc::counted(st)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool UP>
int run_finish(Finish f, cudaStream_t st) {
  int blocks = 0;
  for (int j = 0; j < f.nsum; ++j) {
    f.first[j] = blocks;
    blocks += cdiv(f.sum[j].n, FIN_WARPS);
  }
  for (int j = 0; j < f.nfold; ++j) {
    f.first[f.nsum + j] = blocks;
    blocks += cdiv(f.fold[j].rows, TC_THREADS);
  }
  f.first[f.nsum + f.nfold] = blocks;
  if constexpr (UP) up_grad_tc_finish<<<blocks, TC_THREADS, 0, tvc::counted(st)>>>(f);
  else down_grad_tc_finish<<<blocks, TC_THREADS, 0, tvc::counted(st)>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// a conv over [lo, hi) of `in` (a copy defined on [in_lo, in_hi)) with the
// packed weights w [co][kp]
TcConv tc_conv_of(const bf16_t* in, int cin_p, int in_lo, int in_hi, const bf16_t* w, int taps,
                  int d, int co, int E, int lo, int hi) {
  TcConv c{};
  c.in = in;
  c.cin_p = cin_p;
  c.in_lo = in_lo;
  c.in_hi = in_hi;
  c.w = w;
  c.kp = pad16(taps * cin_p);
  c.taps = taps;
  c.d = d;
  c.co = co;
  c.E = E;
  c.lo = lo;
  c.hi = hi;
  c.ep = TC_STORE;
  return c;
}

// one weight gradient of a call: the cotangent's copy (gc channels, co
// rows; with grp, rows in groups of grp, each group pad8(grp) channels: the
// FiLM rows), the operand's copy (defined on [a_lo, a_hi)), taps, dilation,
// the product's range and the gradient [co, taps cin]
struct Wg {
  const bf16_t* g;
  int gc, co, grp;
  const bf16_t* a;
  int a_lo, a_hi, taps, d, lo, hi;
  float* out;
};

// product q over a [B][E][ac] copy of cin channels, with `splits` partials
TcWgrad tc_wgrad_of(const Wg& q, int ac, int cin, int B, int E, int splits, float* partial) {
  const int rg = q.grp ? q.grp : q.co, rgp = q.grp ? pad8(q.grp) : q.co;
  return TcWgrad{q.g,  q.gc, q.co, cdiv(q.co, rg) * rgp, rg, rgp, q.a, ac, q.a_lo, q.a_hi,
                 cin,  q.taps, q.d, B, E, q.lo, q.hi, splits, partial};
}

// splits within [1, chunks] of a product over [lo, hi)
bool splits_ok(int splits, int B, int lo, int hi) {
  return splits >= 1 && splits <= B * cdiv(hi - lo, TC_CHUNK);
}

void add_sum(Finish& f, const float* part, int parts, int n, float* out) {
  f.sum[f.nsum++] = SumJob{part, out, parts, n};
}

void add_fold(Finish& f, float* gx, const float* edges, int rows, int stride, int T, int R,
              int vlo, int vhi) {
  f.fold[f.nfold++] = FoldJob{gx, edges, rows, stride, T, R, vlo, vhi};
}

}  // namespace

// Kernel K, bf16 operands: xu [B, C, xu_stride] (read over [0, T)) and cond
// [B, C, T] bf16, any C; the forward weights wconv [4, C, 3C], bconv,
// wfilm [4C, C], bfilm and w5 ([co, C], or with fold_k = 7 the folded conv
// [7, C]); gy, pre and the outputs as tvc_up_chain_grad's. splits: the partials
// of the call's six weight gradients (kernels/filter_stage.py::
// up_grad_products, in their order: the four convs from the last, the FiLM
// rows, the output conv), each in [1, its chunks]. ws: 16-byte aligned, of
// *ws_bytes bytes, at least the regions taken below; with ws null the entry
// writes that size to *ws_bytes and launches nothing.
extern "C" int tvc_up_chain_grad_bf16(const void* xu, const void* cond, const float* wconv,
                                      const float* bconv, const float* wfilm, const float* bfilm,
                                      const float* w5, const float* gy, const float* pre,
                                      float* gx, float* gc,
                                      float* gwconv, float* gbconv, float* gwfilm, float* gbfilm,
                                      float* gw5, float* gb5, void* ws, long long* ws_bytes,
                                      const int* splits, int B, int C, int co, int T,
                                      int xu_stride, int fold_k, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || co <= 0 || T <= 0 || xu_stride < T ||
      (fold_k != 0 && fold_k != 7) || (fold_k && co != 1) || !ws_bytes ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return kInvalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = 40 + (fold_k ? (fold_k - 1) / 2 : 0), E = T + 2 * R;
  const long long n = static_cast<long long>(B) * C * E, pe = static_cast<long long>(B) * E;
  const long long CE = static_cast<long long>(C) * E;
  const int Cp = pad8(C), taps5 = fold_k ? fold_k : 1, gyc_c = pad8(co), kp3 = pad16(3 * Cp);
  auto tiles = [&](int len) { return static_cast<long long>(B) * cdiv(len, TC_POS); };
  Arena ar{ws, 0};
  // fp32, read by the epilogues' elementwise steps
  float* films = ar.take<float>(4 * n);  // s1 | t1 | s2 | t2
  float* u1 = ar.take<float>(n);
  float* u2 = ar.take<float>(n);
  float* r1 = ar.take<float>(n);
  float* u3 = ar.take<float>(n);
  float* u4 = ar.take<float>(n);
  float* gr2 = ar.take<float>(n);
  float* gr1 = ar.take<float>(n);
  // the products' operands, position-major bf16
  bf16_t* xa = ar.take<bf16_t>(pe * Cp);  // lrelu(x)
  bf16_t* ce = ar.take<bf16_t>(pe * Cp);  // cond
  bf16_t* a1 = ar.take<bf16_t>(pe * Cp);  // lrelu(u1)
  bf16_t* a2 = ar.take<bf16_t>(pe * Cp);  // lrelu(r1)
  bf16_t* a3 = ar.take<bf16_t>(pe * Cp);  // lrelu(u3)
  bf16_t* r2c = ar.take<bf16_t>(pe * Cp);
  bf16_t* gu4c = ar.take<bf16_t>(pe * Cp);
  bf16_t* gu3c = ar.take<bf16_t>(pe * Cp);
  bf16_t* gu2c = ar.take<bf16_t>(pe * Cp);
  bf16_t* gu1c = ar.take<bf16_t>(pe * Cp);
  bf16_t* gfc = ar.take<bf16_t>(pe * 4 * Cp);  // gs1 | gt1 | gs2 | gt2, Cp channels each
  bf16_t* gyc = ar.take<bf16_t>(pe * gyc_c);
  // the packed weights
  bf16_t* wcp = ar.take<bf16_t>(4LL * C * kp3);
  bf16_t* wfp = ar.take<bf16_t>(4LL * C * pad16(Cp));
  bf16_t* wtp = ar.take<bf16_t>(4LL * C * kp3);
  bf16_t* wftp = ar.take<bf16_t>(static_cast<long long>(C) * pad16(4 * Cp));
  bf16_t* w5p = ar.take<bf16_t>(static_cast<long long>(C) * pad16(taps5 * gyc_c));
  // the pads' columns of gx and gc
  float* ex = ar.take<float>(2LL * R * B * C);
  float* ec = ar.take<float>(2LL * R * B * C);
  // bias partials
  float* gb5p = ar.take<float>(tiles(T) * co);
  float* gb4p = ar.take<float>(tiles(E - 8) * C);
  float* gbf2p = ar.take<float>(tiles(E - 8) * 2 * C);
  float* gb3p = ar.take<float>(tiles(E - 26) * C);
  float* gb2p = ar.take<float>(tiles(E - 8) * C);
  float* gbf1p = ar.take<float>(tiles(E - 8) * 2 * C);
  float* gb1p = ar.take<float>(tiles(E - 2) * C);
  const Wg wg[6] = {
      {gu4c, Cp, C, 0, a3, 13, E - 13, 3, 27, 40, E - 40, gwconv + 3 * 3LL * C * C},
      {gu3c, Cp, C, 0, a2, 4, E - 4, 3, 9, 13, E - 13, gwconv + 2 * 3LL * C * C},
      {gu2c, Cp, C, 0, a1, 1, E - 1, 3, 3, 4, E - 4, gwconv + 3LL * C * C},
      {gu1c, Cp, C, 0, xa, 0, E, 3, 1, 1, E - 1, gwconv},
      {gfc, 4 * Cp, 4 * C, C, ce, 4, E - 4, 1, 1, 4, E - 4, gwfilm},
      {gyc, gyc_c, co, 0, r2c, 40, E - 40, taps5, 1, R, R + T, gw5}};
  float* part[6];
  for (int i = 0; i < 6; ++i) {
    if (!splits_ok(splits[i], B, wg[i].lo, wg[i].hi)) return kInvalid;
    part[i] = ar.take<float>(static_cast<long long>(splits[i]) * wg[i].co * wg[i].taps * C);
  }
  if (sized(ar, ws_bytes)) return 0;
  if (ar.used > *ws_bytes) return kInvalid;

  const Src xin = input(xu, C, xu_stride, R, T, 0, 1);
  auto film_rows = [&](int j) { return buf(films + j * CE, 4 * C, E, 4, E - 4); };

  // ---- the inputs' copies and the packed weights ----
  Prep p{};
  p.copy[p.ncopy++] = copy_job(xin, C, 1, xa, Cp, E, 0, E, nullptr);
  p.copy[p.ncopy++] = copy_job(input(cond, C, T, R, T, 0, 1), C, 0, ce, Cp, E, 4, E - 4, nullptr);
  p.copy[p.ncopy++] = copy_job(input(gy, co, T, R, T, 1, 0), co, 0, gyc, gyc_c, E, R, R + T, gb5p);
  p.pack[p.npack++] = pack_job(wconv, wcp, 4 * C, 3, C);
  p.pack[p.npack++] = pack_job(wfilm, wfp, 4 * C, 1, C);
  for (int j = 0; j < 4; ++j)
    p.pack[p.npack++] = pack_taps_t(wconv + j * 3LL * C * C, wtp + j * C * kp3, C, 3, C);
  // cond's gradient through the FiLM rows: [C][4 Cp] from wfilm [4][C][C]
  p.pack[p.npack++] = PackJob{wfilm, wftp, C, 4, C, Cp, pad16(4 * Cp), 0, 1, 1LL * C * C, C};
  // the output 1x1 transposed, or the folded k=7 conv as one over the
  // 1-row cotangent: tap k of row i is w5[6 - k, i]
  p.pack[p.npack++] = fold_k ? pack_taps_t(w5, w5p, C, taps5, 1) : pack_taps_t(w5, w5p, C, 1, co);
  TRY(run_prep<true>(p, B, st));

  // ---- recompute ----
  TcConv c = tc_conv_of(ce, Cp, 4, E - 4, wfp, 1, 1, 4 * C, E, 4, E - 4);
  c.bias = bfilm;
  c.out = films;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(xa, Cp, 0, E, wcp, 3, 1, C, E, 1, E - 1);
  c.bias = bconv;
  c.out = u1;
  c.cp0 = a1;
  c.act = 1;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(a1, Cp, 1, E - 1, wcp + C * kp3, 3, 3, C, E, 4, E - 4);
  c.bias = bconv + C;
  c.ep = TC_FILM;
  c.s = film_rows(0);
  c.t = film_rows(1);
  c.res = xin;
  c.out = u2;
  c.out2 = r1;
  c.cp0 = a2;
  c.act = 1;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(a2, Cp, 4, E - 4, wcp + 2 * C * kp3, 3, 9, C, E, 13, E - 13);
  c.bias = bconv + 2 * C;
  c.out = u3;
  c.cp0 = a3;
  c.act = 1;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(a3, Cp, 13, E - 13, wcp + 3 * C * kp3, 3, 27, C, E, 40, E - 40);
  c.bias = bconv + 3 * C;
  c.ep = TC_FILM;
  c.s = film_rows(2);
  c.t = film_rows(3);
  c.res = buf(r1, C, E, 4, E - 4);
  c.out = u4;
  c.cp0 = r2c;
  TRY(run_tc_conv<true>(c, B, st));

  // ---- backward: each input gradient with its elementwise steps ----
  // g_r2 over [4, E - 4) (zero outside [40, E - 40), where gy is zero), so
  // that gs2 and gt2 fill the same range of gfc as gs1 and gt1
  c = tc_conv_of(gyc, gyc_c, R, R + T, w5p, taps5, 1, C, E, 4, E - 4);
  c.ep = TC_FILMGRAD;
  c.s = film_rows(2);
  c.u = buf(u4, C, E, 40, E - 40);
  c.out = gr2;
  c.cp0 = gu4c;
  c.bp0 = gb4p;
  c.cp1 = gfc;
  c.cp1_c = 4 * Cp;
  c.cp1_row = 2 * Cp;
  c.bp1 = gbf2p;
  TRY(run_tc_conv<true>(c, B, st));
  // the leaky ReLUs' branches: the signs of the forward's pre-activations,
  // or without them of the recomputed ones
  c = tc_conv_of(gu4c, Cp, 4, E - 4, wtp + 3 * C * kp3, 3, 27, C, E, 13, E - 13);
  c.m = buf(pre ? pre + 2 * n : u3, C, E, 13, E - 13);
  c.has_m = 1;
  c.cp0 = gu3c;
  c.bp0 = gb3p;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(gu3c, Cp, 13, E - 13, wtp + 2 * C * kp3, 3, 9, C, E, 4, E - 4);
  c.m = buf(pre ? pre + n : r1, C, E, 4, E - 4);
  c.has_m = 1;
  c.add = buf(gr2, C, E, 4, E - 4);
  c.has_add = 1;
  c.ep = TC_FILMGRAD;
  c.s = film_rows(0);
  c.u = buf(u2, C, E, 4, E - 4);
  c.out = gr1;
  c.cp0 = gu2c;
  c.bp0 = gb2p;
  c.cp1 = gfc;
  c.cp1_c = 4 * Cp;
  c.cp1_row = 0;
  c.bp1 = gbf1p;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(gu2c, Cp, 4, E - 4, wtp + C * kp3, 3, 3, C, E, 1, E - 1);
  c.m = buf(pre ? pre : u1, C, E, 1, E - 1);
  c.has_m = 1;
  c.cp0 = gu1c;
  c.bp0 = gb1p;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(gu1c, Cp, 1, E - 1, wtp, 3, 1, C, E, 0, E);
  c.m = xin;
  c.has_m = 1;
  c.add = buf(gr1, C, E, 4, E - 4);
  c.has_add = 1;
  c.ep = TC_GX;
  c.gx = gx;
  c.edges = ex;
  c.gx_stride = xu_stride;
  c.R = R;
  c.T = T;
  TRY(run_tc_conv<true>(c, B, st));
  c = tc_conv_of(gfc, 4 * Cp, 4, E - 4, wftp, 1, 1, C, E, 4, E - 4);
  c.ep = TC_GX;
  c.gx = gc;
  c.edges = ec;
  c.gx_stride = T;
  c.R = R;
  c.T = T;
  TRY(run_tc_conv<true>(c, B, st));

  // ---- weight gradients ----
  for (int i = 0; i < 6; ++i)
    TRY(run_tc_wgrad<true>(tc_wgrad_of(wg[i], Cp, C, B, E, splits[i], part[i]), st));

  // ---- the partials' sums and the pads' gradients ----
  Finish f{};
  for (int i = 0; i < 6; ++i) add_sum(f, part[i], splits[i], wg[i].co * wg[i].taps * C, wg[i].out);
  const int t8 = B * conv_tiles(C, TC_FILMGRAD, E - 8);  // g_r2's and g_r1's launches
  add_sum(f, gb4p, t8, C, gbconv + 3 * C);
  add_sum(f, gb3p, B * conv_tiles(C, TC_STORE, E - 26), C, gbconv + 2 * C);
  add_sum(f, gb2p, t8, C, gbconv + C);
  add_sum(f, gb1p, B * conv_tiles(C, TC_STORE, E - 2), C, gbconv);
  add_sum(f, gbf1p, t8, 2 * C, gbfilm);
  add_sum(f, gbf2p, t8, 2 * C, gbfilm + 2 * C);
  add_sum(f, gb5p, static_cast<int>(tiles(T)), co, gb5);
  add_fold(f, gx, ex, B * C, xu_stride, T, R, 0, E);
  add_fold(f, gc, ec, B * C, T, T, R, 4, E - 4);
  return run_finish<true>(f, st);
}

// Kernel L, down chain, bf16 operands: z [B, cin, z_stride] (read over
// [0, T)) bf16, any cin; the forward's w1, b1, w2, b2, w3 [co, 3 cin] and
// wres [co, cin]; gy, pre and the outputs as tvc_down_chain_grad's. splits: the
// partials of gw3, gw2, gw1, gwres (kernels/filter_stage.py::
// down_grad_products), each in [1, its chunks]. ws and ws_bytes as
// tvc_up_chain_grad_bf16's.
extern "C" int tvc_down_chain_grad_bf16(const void* z, const float* w1, const float* b1,
                                        const float* w2, const float* b2, const float* w3,
                                        const float* wres, const float* gy, const float* pre,
                                        float* gz,
                                        float* gwres, float* gbres, float* gw1, float* gb1,
                                        float* gw2, float* gb2, float* gw3, float* gb3, void* ws,
                                        long long* ws_bytes, const int* splits, int B, int cin,
                                        int co, int T, int z_stride, void* stream) {
  if (B <= 0 || B > 65535 || cin <= 0 || co <= 0 || T <= 0 || z_stride < T || !ws_bytes ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return kInvalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = 7, E = T + 2 * R, cp = pad8(cin), gyc_c = pad8(co), kp3 = pad16(3 * cp);
  const long long n = static_cast<long long>(B) * cin * E, pe = static_cast<long long>(B) * E;
  auto tiles = [&](int len) { return static_cast<long long>(B) * cdiv(len, TC_POS); };
  Arena ar{ws, 0};
  float* u1 = ar.take<float>(n);
  float* u2 = ar.take<float>(n);
  float* gres = ar.take<float>(n);
  bf16_t* za = ar.take<bf16_t>(pe * cp);  // lrelu(z)
  bf16_t* zr = ar.take<bf16_t>(pe * cp);  // z
  bf16_t* a1 = ar.take<bf16_t>(pe * cp);  // lrelu(u1)
  bf16_t* a2 = ar.take<bf16_t>(pe * cp);  // lrelu(u2)
  bf16_t* gu2c = ar.take<bf16_t>(pe * cp);
  bf16_t* gu1c = ar.take<bf16_t>(pe * cp);
  bf16_t* gyc = ar.take<bf16_t>(pe * gyc_c);
  bf16_t* w1p = ar.take<bf16_t>(static_cast<long long>(cin) * kp3);
  bf16_t* w2p = ar.take<bf16_t>(static_cast<long long>(cin) * kp3);
  bf16_t* w1Tp = ar.take<bf16_t>(static_cast<long long>(cin) * kp3);
  bf16_t* w2Tp = ar.take<bf16_t>(static_cast<long long>(cin) * kp3);
  bf16_t* w3Tp = ar.take<bf16_t>(static_cast<long long>(cin) * pad16(3 * gyc_c));
  bf16_t* wresTp = ar.take<bf16_t>(static_cast<long long>(cin) * pad16(gyc_c));
  float* ez = ar.take<float>(2LL * R * B * cin);
  float* gyp = ar.take<float>(tiles(T) * co);
  float* gb2p = ar.take<float>(tiles(E - 6) * cin);
  float* gb1p = ar.take<float>(tiles(E - 2) * cin);
  const Wg wg[4] = {{gyc, gyc_c, co, 0, a2, 3, E - 3, 3, 4, R, R + T, gw3},
                    {gu2c, cp, cin, 0, a1, 1, E - 1, 3, 2, 3, E - 3, gw2},
                    {gu1c, cp, cin, 0, za, 0, E, 3, 1, 1, E - 1, gw1},
                    {gyc, gyc_c, co, 0, zr, R, R + T, 1, 1, R, R + T, gwres}};
  float* part[4];
  for (int i = 0; i < 4; ++i) {
    if (!splits_ok(splits[i], B, wg[i].lo, wg[i].hi)) return kInvalid;
    part[i] = ar.take<float>(static_cast<long long>(splits[i]) * wg[i].co * wg[i].taps * cin);
  }
  if (sized(ar, ws_bytes)) return 0;
  if (ar.used > *ws_bytes) return kInvalid;

  const Src zin = input(z, cin, z_stride, R, T, 0, 1);
  Prep p{};
  p.copy[p.ncopy++] = copy_job(zin, cin, 1, za, cp, E, 0, E, nullptr);
  p.copy[p.ncopy++] = copy_job(zin, cin, 0, zr, cp, E, R, R + T, nullptr);
  p.copy[p.ncopy++] = copy_job(input(gy, co, T, R, T, 1, 0), co, 0, gyc, gyc_c, E, R, R + T, gyp);
  p.pack[p.npack++] = pack_job(w1, w1p, cin, 3, cin);
  p.pack[p.npack++] = pack_job(w2, w2p, cin, 3, cin);
  p.pack[p.npack++] = pack_taps_t(w1, w1Tp, cin, 3, cin);
  p.pack[p.npack++] = pack_taps_t(w2, w2Tp, cin, 3, cin);
  p.pack[p.npack++] = pack_taps_t(w3, w3Tp, cin, 3, co);
  p.pack[p.npack++] = pack_taps_t(wres, wresTp, cin, 1, co);
  TRY(run_prep<false>(p, B, st));

  // ---- recompute ----
  TcConv c = tc_conv_of(za, cp, 0, E, w1p, 3, 1, cin, E, 1, E - 1);
  c.bias = b1;
  c.out = u1;
  c.cp0 = a1;
  c.act = 1;
  TRY(run_tc_conv<false>(c, B, st));
  c = tc_conv_of(a1, cp, 1, E - 1, w2p, 3, 2, cin, E, 3, E - 3);
  c.bias = b2;
  c.out = u2;
  c.cp0 = a2;
  c.act = 1;
  TRY(run_tc_conv<false>(c, B, st));

  // ---- backward ----
  // the leaky ReLUs' branches: the signs of the forward's pre-activations,
  // or without them of the recomputed ones
  c = tc_conv_of(gyc, gyc_c, R, R + T, w3Tp, 3, 4, cin, E, 3, E - 3);
  c.m = buf(pre ? pre + n : u2, cin, E, 3, E - 3);
  c.has_m = 1;
  c.cp0 = gu2c;
  c.bp0 = gb2p;
  TRY(run_tc_conv<false>(c, B, st));
  c = tc_conv_of(gu2c, cp, 3, E - 3, w2Tp, 3, 2, cin, E, 1, E - 1);
  c.m = buf(pre ? pre : u1, cin, E, 1, E - 1);
  c.has_m = 1;
  c.cp0 = gu1c;
  c.bp0 = gb1p;
  TRY(run_tc_conv<false>(c, B, st));
  c = tc_conv_of(gyc, gyc_c, R, R + T, wresTp, 1, 1, cin, E, R, R + T);
  c.out = gres;
  TRY(run_tc_conv<false>(c, B, st));
  c = tc_conv_of(gu1c, cp, 1, E - 1, w1Tp, 3, 1, cin, E, 0, E);
  c.m = zin;
  c.has_m = 1;
  c.add = buf(gres, cin, E, R, R + T);
  c.has_add = 1;
  c.ep = TC_GX;
  c.gx = gz;
  c.edges = ez;
  c.gx_stride = z_stride;
  c.R = R;
  c.T = T;
  TRY(run_tc_conv<false>(c, B, st));

  // ---- weight gradients ----
  for (int i = 0; i < 4; ++i)
    TRY(run_tc_wgrad<false>(tc_wgrad_of(wg[i], cp, cin, B, E, splits[i], part[i]), st));

  Finish f{};
  for (int i = 0; i < 4; ++i)
    add_sum(f, part[i], splits[i], wg[i].co * wg[i].taps * cin, wg[i].out);
  add_sum(f, gyp, static_cast<int>(tiles(T)), co, gb3);
  add_sum(f, gb2p, B * conv_tiles(cin, TC_STORE, E - 6), cin, gb2);
  add_sum(f, gb1p, B * conv_tiles(cin, TC_STORE, E - 2), cin, gb1);
  add_sum(f, gyp, static_cast<int>(tiles(T)), co, gbres);
  add_fold(f, gz, ez, B * cin, z_stride, T, R, 0, E);
  return run_finish<false>(f, st);
}

// Kernel L, stem, bf16 operands: x [B, cin, x_stride] (read over [0, T))
// bf16; the forward's w [co, 3 cin]; gy and the outputs as tvc_conv3_grad's.
// splits: the partials of gw (conv3_grad_products), in [1, its chunks]. ws
// and ws_bytes as tvc_up_chain_grad_bf16's.
extern "C" int tvc_conv3_grad_bf16(const void* x, const float* w, const float* gy, float* gx,
                                   float* gw, float* gb, void* ws, long long* ws_bytes,
                                   const int* splits, int B, int cin, int co, int T, int x_stride,
                                   void* stream) {
  if (B <= 0 || B > 65535 || cin <= 0 || co <= 0 || T <= 0 || x_stride < T || !ws_bytes ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return kInvalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = 1, E = T + 2 * R, xc_c = pad8(cin), gyc_c = pad8(co);
  const long long pe = static_cast<long long>(B) * E;
  const long long tiles = static_cast<long long>(B) * cdiv(T, TC_POS);
  Arena ar{ws, 0};
  bf16_t* xc = ar.take<bf16_t>(pe * xc_c);
  bf16_t* gyc = ar.take<bf16_t>(pe * gyc_c);
  bf16_t* wTp = ar.take<bf16_t>(static_cast<long long>(cin) * pad16(3 * gyc_c));
  float* ex = ar.take<float>(2LL * R * B * cin);
  float* gyp = ar.take<float>(tiles * co);
  if (!splits_ok(splits[0], B, R, R + T)) return kInvalid;
  float* part = ar.take<float>(static_cast<long long>(splits[0]) * co * 3 * cin);
  if (sized(ar, ws_bytes)) return 0;
  if (ar.used > *ws_bytes) return kInvalid;

  const Src xin = input(x, cin, x_stride, R, T, 0, 1);
  Prep p{};
  p.copy[p.ncopy++] = copy_job(xin, cin, 0, xc, xc_c, E, 0, E, nullptr);
  p.copy[p.ncopy++] = copy_job(input(gy, co, T, R, T, 1, 0), co, 0, gyc, gyc_c, E, R, R + T, gyp);
  p.pack[p.npack++] = pack_taps_t(w, wTp, cin, 3, co);
  TRY(run_prep<false>(p, B, st));
  TcConv c = tc_conv_of(gyc, gyc_c, R, R + T, wTp, 3, 1, cin, E, 0, E);
  c.ep = TC_GX;
  c.gx = gx;
  c.edges = ex;
  c.gx_stride = x_stride;
  c.R = R;
  c.T = T;
  TRY(run_tc_conv<false>(c, B, st));
  const Wg q{gyc, gyc_c, co, 0, xc, 0, E, 3, 1, R, R + T, gw};
  TRY(run_tc_wgrad<false>(tc_wgrad_of(q, xc_c, cin, B, E, splits[0], part), st));
  Finish f{};
  add_sum(f, part, splits[0], co * 3 * cin, gw);
  add_sum(f, gyp, static_cast<int>(tiles), co, gb);
  add_fold(f, gx, ex, B * cin, x_stride, T, R, 0, E);
  return run_finish<false>(f, st);
}
