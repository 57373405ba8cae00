// Kernels M, N and O: the fused MRD discriminator chain in the phase-plane
// layout, its input gradient and its weight gradient, for the decoder's
// post-join training step.
//
// M replaces tinyvc_tpu/ops/pallas/mrd.py::_fwd_pallas (_fwd_kernel): every
// layer of one MRD resolution's conv stack. N replaces the dx sweep of
// _mrd_bwd (_bwd_kernel_dx): top-down, each layer's masked cotangent dy and
// the gradient of its input (dspec at layer 0). O replaces the dW/db sweep
// (_bwd_kernel_dw): each tap's weight gradient and the bias gradient, summed
// over the batch.
//
// Layout (tinyvc_tpu_torch/ops/mrd_planes.py): a feature map is flat
// [B, C, S * (G + 4) * Wp]; plane p's block holds G + 4 rows of Wp columns,
// the first and last two rows zero. Output plane q of a layer reads, for h-tap
// i, input plane phi at row offset delta (t = stride*q + i - ph,
// phi = t mod s_in, delta = t div s_in, floored), and for w-tap j the flat
// slice starting at (2 + delta) * Wp + j - 1, L = g_out * Wp long. Output
// position l of plane q is valid when its row l / Wp is below the plane's
// valid rows ceil((h_out - q) / s_out) and its column l % Wp is in [1, W];
// every other position, halos included, is exactly zero.
//
// Design. The TPU keeps a batch row's whole chain in VMEM (a layer's fp32
// output for one row is up to 3.5 MiB here, far beyond a block's 227 KB of
// shared memory), so here every layer is its own launch over device memory:
//   M: a tiled product per (batch row, output plane): 64 output channels x
//      64 positions a block, 4 x 4 a thread; for each h-tap the input span of
//      66 positions is staged once in shared memory and read by the three
//      w-taps at shifts 0, 1, 2. The epilogue adds the bias, applies the
//      validity mask, writes the halo rows and casts to the operand type.
//   N: per layer, one elementwise launch forms dy = mask(cot + dx from the
//      layer above) in the operand type, then a gather product writes the
//      input's gradient: each input position sums, over the (q, i, j) taps
//      that read it, W_t^T dy_q at the shifted offset. A gather, not a
//      scatter, so no float atomics.
//   O: per layer, each block sums x_slice dy_q^T over one fixed chunk of
//      1024 positions of one (batch row, plane) for one h-tap's three w-taps
//      into its own partial; a second launch adds the partials in chunk order,
//      a third sums dy per output channel for the bias. Bit-reproducible.
// Launches per call: M one per layer, N two per layer, O three per layer.
//
// Precision (the TPU's dtype_name): fp32, or bf16 operands and stored maps
// with fp32 accumulation; the bias, the masks and the dx carried between
// layers stay fp32; dspec leaves N in the operand type (mrd.py:355).
//
// Bound on the H100: operations. One forward of the step's crop (B=16,
// T=8000, four resolutions) is ~223 GFLOP of products in this layout, 3.3 ms
// at 67 TFLOP/s on the CUDA cores where all products here run; N and O each
// about as much again. wgmma bf16 products would be a later PR's.

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TP = 64;   // positions per block
constexpr int TCH = 64;  // channels per block
constexpr int CI = 16;   // reduction rows per shared-memory stage
constexpr int KW = 3;    // every MRD conv is 3 wide (pw = 1)

struct Layer {
  int B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_out;
  __device__ int L() const { return g_out * Wp; }
  __device__ int blk_in() const { return (g_in + 4) * Wp; }
  __device__ int blk_out() const { return (g_out + 4) * Wp; }
  __device__ long long in_len() const { return static_cast<long long>(s_in) * blk_in(); }
  __device__ long long out_len() const { return static_cast<long long>(s_out) * blk_out(); }
  // floored (phi, delta) of output plane q's h-tap i
  __device__ void tap(int q, int i, int& phi, int& delta) const {
    const int t = stride * q + i - ph;
    phi = ((t % s_in) + s_in) % s_in;
    delta = (t - phi) / s_in;
  }
  __device__ int valid_rows(int q) const {
    return q < h_out ? (h_out - q + s_out - 1) / s_out : 0;
  }
  // position l in [0, L) of output plane q holds a valid output
  __device__ bool valid(int q, int l) const {
    const int row = l / Wp, col = l - row * Wp;
    return row < valid_rows(q) && col >= 1 && col <= W;
  }
};

template <typename T>
__device__ __forceinline__ float load(const T* p, long long i) {
  return to_f32(p[i]);
}

// ---------------------------------------------------------------------------
// M: one layer forward. grid (ceil(L/TP), ceil(cout/TCH), B*s_out)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) mrd_fwd_kernel(const T* __restrict__ x,
                                                          const float* __restrict__ w,
                                                          const float* __restrict__ bias,
                                                          T* __restrict__ out, Layer ly,
                                                          int round) {
  __shared__ float sx[CI][TP + 2];
  __shared__ float sw[KW][CI][TCH + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = ly.L(), blk_in = ly.blk_in(), blk_out = ly.blk_out();
  const long long in_len = ly.in_len();
  const int l0 = blockIdx.x * TP, o0 = blockIdx.y * TCH;
  const int b = blockIdx.z / ly.s_out, q = blockIdx.z - b * ly.s_out;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int i = 0; i < ly.kh; ++i) {
    int phi, delta;
    ly.tap(q, i, phi, delta);
    const long long start = static_cast<long long>(phi) * blk_in + (2 + delta) * ly.Wp - 1 + l0;
    for (int c0 = 0; c0 < ly.cin; c0 += CI) {
      const int nci = min(CI, ly.cin - c0);
      for (int e = tid; e < CI * (TP + 2); e += THREADS) {
        const int r = e / (TP + 2), k = e - r * (TP + 2);
        const long long idx = start + k;
        float v = 0.f;
        if (r < nci && idx >= 0 && idx < in_len)
          v = load(x, (static_cast<long long>(b) * ly.cin + c0 + r) * in_len + idx);
        sx[r][k] = v;
      }
      for (int e = tid; e < KW * CI * TCH; e += THREADS) {
        const int o = e % TCH, rem = e / TCH, r = rem % CI, j = rem / CI;
        float v = 0.f;
        if (r < nci && o0 + o < ly.cout)
          v = w[(static_cast<long long>(i * KW + j) * ly.cin + c0 + r) * ly.cout + o0 + o];
        sw[j][r][o] = round ? round_bf16(v) : v;
      }
      __syncthreads();
      for (int r = 0; r < nci; ++r) {
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          float wv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) wv[a] = sw[j][r][ty + 16 * a];
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] = sx[r][tx + 16 * k + j];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(wv[a], xv[k], acc[a][k]);
        }
      }
      __syncthreads();
    }
  }

  const long long plane0 = static_cast<long long>(q) * blk_out;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty + 16 * a;
    if (o >= ly.cout) continue;
    T* row = out + (static_cast<long long>(b) * ly.cout + o) * ly.out_len() + plane0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l0 + tx + 16 * k;
      if (l >= L) continue;
      const float v = ly.valid(q, l) ? acc[a][k] + bias[o] : 0.f;
      row[2 * ly.Wp + l] = from_f32<T>(v);
    }
  }
  // the plane's zero halo rows: the first block writes the head, the last the tail
  const int halo = 2 * ly.Wp, tail = blk_out - halo - L;
  if (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) {
    for (int e = tid; e < TCH * max(halo, tail); e += THREADS) {
      const int o = o0 + e / max(halo, tail), p = e % max(halo, tail);
      if (o >= ly.cout) continue;
      T* row = out + (static_cast<long long>(b) * ly.cout + o) * ly.out_len() + plane0;
      if (blockIdx.x == 0 && p < halo) row[p] = from_f32<T>(0.f);
      if (blockIdx.x == gridDim.x - 1 && p < tail) row[halo + L + p] = from_f32<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// N, first launch: dy = mask(cot + above) over one layer's flat output
// ---------------------------------------------------------------------------
template <typename T>
__global__ void mrd_dy_kernel(const T* __restrict__ cot, const float* __restrict__ above,
                              T* __restrict__ dy, Layer ly, long long total) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= total) return;
  const int blk = ly.blk_out();
  const int p = static_cast<int>(n % ly.out_len());
  const int q = p / blk;
  const int within = p - q * blk - 2 * ly.Wp;
  float v = 0.f;
  if (within >= 0 && within < ly.L() && ly.valid(q, within)) {
    v = load(cot, n);
    if (above) v += above[n];
  }
  dy[n] = from_f32<T>(v);
}

// ---------------------------------------------------------------------------
// N, second launch: the input's gradient. grid (ceil(blk_in/TP),
// ceil(cin/TCH), B*s_in); wt is the weight as [kh*3, cout, cin]
// ---------------------------------------------------------------------------
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) mrd_dx_kernel(const TI* __restrict__ dy,
                                                         const float* __restrict__ wt,
                                                         TO* __restrict__ dx, Layer ly,
                                                         int round) {
  __shared__ float sd[CI][TP + 2];
  __shared__ float sw[KW][CI][TCH + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = ly.L(), blk_in = ly.blk_in(), blk_out = ly.blk_out();
  const long long out_len = ly.out_len();
  const int p0 = blockIdx.x * TP, c0 = blockIdx.y * TCH;
  const int b = blockIdx.z / ly.s_in, phi = blockIdx.z - b * ly.s_in;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int q = 0; q < ly.s_out; ++q) {
    for (int i = 0; i < ly.kh; ++i) {
      int tphi, delta;
      ly.tap(q, i, tphi, delta);
      if (tphi != phi) continue;
      // input position p reads dy_q at l = p - (2 + delta) * Wp + 1 - j
      const int lstart = p0 - (2 + delta) * ly.Wp - 1;
      for (int o0 = 0; o0 < ly.cout; o0 += CI) {
        const int nco = min(CI, ly.cout - o0);
        for (int e = tid; e < CI * (TP + 2); e += THREADS) {
          const int r = e / (TP + 2), k = e - r * (TP + 2);
          const int l = lstart + k;
          float v = 0.f;
          if (r < nco && l >= 0 && l < L)
            v = load(dy, (static_cast<long long>(b) * ly.cout + o0 + r) * out_len +
                             static_cast<long long>(q) * blk_out + 2 * ly.Wp + l);
          sd[r][k] = v;
        }
        for (int e = tid; e < KW * CI * TCH; e += THREADS) {
          const int c = e % TCH, rem = e / TCH, r = rem % CI, j = rem / CI;
          float v = 0.f;
          if (r < nco && c0 + c < ly.cin)
            v = wt[(static_cast<long long>(i * KW + j) * ly.cout + o0 + r) * ly.cin + c0 + c];
          sw[j][r][c] = round ? round_bf16(v) : v;
        }
        __syncthreads();
        for (int r = 0; r < nco; ++r) {
#pragma unroll
          for (int j = 0; j < KW; ++j) {
            float wv[4], dv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) wv[a] = sw[j][r][ty + 16 * a];
#pragma unroll
            for (int k = 0; k < 4; ++k) dv[k] = sd[r][tx + 16 * k + 2 - j];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(wv[a], dv[k], acc[a][k]);
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = c0 + ty + 16 * a;
    if (c >= ly.cin) continue;
    TO* row = dx + (static_cast<long long>(b) * ly.cin + c) * ly.in_len() +
              static_cast<long long>(phi) * blk_in;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + tx + 16 * k;
      if (p < blk_in) row[p] = from_f32<TO>(acc[a][k]);
    }
  }
}

// ---------------------------------------------------------------------------
// O, first launch: partial weight gradients. grid (chunks, tiles, kh); chunk
// = (b, q, 1024-position slice of [0, L)); ws[chunk][i*3+j][cin][cout]
// ---------------------------------------------------------------------------
constexpr int LS = 16;  // positions per shared-memory stage

template <typename T>
__global__ void __launch_bounds__(THREADS) mrd_dw_partial_kernel(const T* __restrict__ x,
                                                                 const T* __restrict__ dy,
                                                                 float* __restrict__ ws,
                                                                 Layer ly, int wch) {
  __shared__ float sx[TCH][LS + 2];
  __shared__ float sd[LS][TCH + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = ly.L(), blk_in = ly.blk_in(), blk_out = ly.blk_out();
  const long long in_len = ly.in_len(), out_len = ly.out_len();
  const int nlc = (L + wch - 1) / wch;
  const int chunk = blockIdx.x;
  const int bq = chunk / nlc, lc = chunk - bq * nlc;
  const int b = bq / ly.s_out, q = bq - b * ly.s_out;
  const int n_ot = (ly.cout + TCH - 1) / TCH;
  const int c0 = (blockIdx.y / n_ot) * TCH, o0 = (blockIdx.y % n_ot) * TCH;
  const int i = blockIdx.z;
  int phi, delta;
  ly.tap(q, i, phi, delta);
  const long long xstart = static_cast<long long>(phi) * blk_in + (2 + delta) * ly.Wp - 1;
  const long long dstart = static_cast<long long>(q) * blk_out + 2 * ly.Wp;
  const int lbeg = lc * wch, lend = min(L, lbeg + wch);

  float acc[KW][4][4];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][a][k] = 0.f;

  for (int l0 = lbeg; l0 < lend; l0 += LS) {
    for (int e = tid; e < TCH * (LS + 2); e += THREADS) {
      const int r = e / (LS + 2), k = e - r * (LS + 2);
      const long long idx = xstart + l0 + k;
      float v = 0.f;
      if (c0 + r < ly.cin && idx >= 0 && idx < in_len)
        v = load(x, (static_cast<long long>(b) * ly.cin + c0 + r) * in_len + idx);
      sx[r][k] = v;
    }
    for (int e = tid; e < LS * TCH; e += THREADS) {
      const int o = e % TCH, k = e / TCH;
      float v = 0.f;
      if (o0 + o < ly.cout && l0 + k < lend)
        v = load(dy, (static_cast<long long>(b) * ly.cout + o0 + o) * out_len + dstart + l0 + k);
      sd[k][o] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < LS; ++k) {
      float dv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = sd[k][tx + 16 * a];
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sx[ty + 16 * c][k + j];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[j][c][a] = fmaf(xv[c], dv[a], acc[j][c][a]);
      }
    }
    __syncthreads();
  }

  const long long per_chunk = static_cast<long long>(ly.kh) * KW * ly.cin * ly.cout;
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ci = c0 + ty + 16 * c;
      if (ci >= ly.cin) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int o = o0 + tx + 16 * a;
        if (o >= ly.cout) continue;
        ws[chunk * per_chunk + (static_cast<long long>(i * KW + j) * ly.cin + ci) * ly.cout + o] =
            acc[j][c][a];
      }
    }
}

// O, second launch: dw = the partials summed in chunk order
__global__ void mrd_dw_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                  long long n, int chunks) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += ws[c * n + e];
  dw[e] = s;
}

// O, third launch: db[o] = the sum of dy over the batch and every position
// (dy is zero off the valid positions), one block per channel, a fixed tree
template <typename T>
__global__ void __launch_bounds__(THREADS) mrd_db_kernel(const T* __restrict__ dy,
                                                         float* __restrict__ db, int B, int cout,
                                                         long long len) {
  __shared__ float red[THREADS];
  const int o = blockIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const T* row = dy + (static_cast<long long>(b) * cout + o) * len;
    for (long long p = threadIdx.x; p < len; p += THREADS) s += load(row, p);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) db[o] = red[0];
}

Layer make_layer(int B, int cin, int cout, int kh, int stride, int ph, int s_in, int s_out,
                 int g_in, int g_out, int Wp, int W, int h_out) {
  return Layer{B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_out};
}

bool bad(const Layer& l) {
  return l.B <= 0 || l.cin <= 0 || l.cout <= 0 || l.kh <= 0 || l.stride <= 0 || l.s_in <= 0 ||
         l.s_out <= 0 || l.g_in <= 0 || l.g_out <= 0 || l.g_out > l.g_in + 1 || l.Wp <= 2 ||
         l.W != l.Wp - 2 || l.B * l.s_out > 65535 || l.B * l.s_in > 65535;
}

unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

}  // namespace

#define MRD_LAYER_ARGS                                                                    \
  int B, int cin, int cout, int kh, int stride, int ph, int s_in, int s_out, int g_in, \
      int g_out, int Wp, int W, int h_out
#define MRD_LAYER make_layer(B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_out)

// M: x [B, cin, s_in*(g_in+4)*Wp] in the operand type, w [kh*3, cin, cout]
// fp32 (rounded to bf16 here under bf16), bias [cout] fp32 -> out
// [B, cout, s_out*(g_out+4)*Wp] in the operand type.
extern "C" int tvc_mrd_fwd(const void* x, const float* w, const float* bias, void* out,
                           MRD_LAYER_ARGS, int bf16, void* stream) {
  const Layer ly = MRD_LAYER;
  if (bad(ly)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(g_out * Wp, TP), cdiv(cout, TCH), B * s_out);
  if (bf16)
    mrd_fwd_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x), w, bias,
                                             static_cast<__nv_bfloat16*>(out), ly, 1);
  else
    mrd_fwd_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), w, bias,
                                             static_cast<float*>(out), ly, 0);
  return static_cast<int>(cudaGetLastError());
}

// N for one layer: dy = mask(cot + above) (above fp32, or null at the top),
// then dx [B, cin, s_in*(g_in+4)*Wp] from dy and wt [kh*3, cout, cin] fp32:
// fp32 (dx_bf16 = 0, carried to the layer below) or in the operand type.
extern "C" int tvc_mrd_dx(const void* cot, const float* above, void* dy, void* dx,
                          const float* wt, MRD_LAYER_ARGS, int bf16, int dx_bf16,
                          void* stream) {
  const Layer ly = MRD_LAYER;
  if (bad(ly)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * cout * s_out * (g_out + 4) * Wp;
  const dim3 grid(cdiv((g_in + 4) * Wp, TP), cdiv(cin, TCH), B * s_in);
  if (bf16) {
    auto* d = static_cast<__nv_bfloat16*>(dy);
    mrd_dy_kernel<<<cdiv(total, 256), 256, 0, st>>>(static_cast<const __nv_bfloat16*>(cot),
                                                    above, d, ly, total);
    if (dx_bf16)
      mrd_dx_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(d), wt,
                                              static_cast<__nv_bfloat16*>(dx), ly, 1);
    else
      mrd_dx_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(d), wt,
                                              static_cast<float*>(dx), ly, 1);
  } else {
    auto* d = static_cast<float*>(dy);
    mrd_dy_kernel<<<cdiv(total, 256), 256, 0, st>>>(static_cast<const float*>(cot), above, d,
                                                    ly, total);
    mrd_dx_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(d), wt,
                                            static_cast<float*>(dx), ly, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// O for one layer: x (the layer's input) and dy in the operand type ->
// dw [kh*3, cin, cout] and db [cout] fp32; ws holds the partials,
// chunks * kh*3*cin*cout floats, chunks = B * s_out * ceil(L / wch).
extern "C" int tvc_mrd_dw(const void* x, const void* dy, float* ws, long long ws_len, float* dw,
                          float* db, MRD_LAYER_ARGS, int bf16, int wch, void* stream) {
  const Layer ly = MRD_LAYER;
  if (bad(ly) || wch <= 0 || wch % LS) return static_cast<int>(cudaErrorInvalidValue);
  const int L = g_out * Wp;
  const long long chunks = static_cast<long long>(B) * s_out * ((L + wch - 1) / wch);
  const long long n = static_cast<long long>(kh) * KW * cin * cout;
  if (chunks > 0x7fffffffLL || chunks * n > ws_len) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks), cdiv(cin, TCH) * cdiv(cout, TCH), kh);
  const long long len = static_cast<long long>(s_out) * (g_out + 4) * Wp;
  if (bf16) {
    mrd_dw_partial_kernel<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                    static_cast<const __nv_bfloat16*>(dy), ws, ly,
                                                    wch);
    mrd_db_kernel<<<cout, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(dy), db, B, cout,
                                            len);
  } else {
    mrd_dw_partial_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(dy), ws, ly, wch);
    mrd_db_kernel<<<cout, THREADS, 0, st>>>(static_cast<const float*>(dy), db, B, cout, len);
  }
  mrd_dw_sum_kernel<<<cdiv(n, 256), 256, 0, st>>>(ws, dw, n, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}
