// Kernel O: the fused MRD chain's weight-gradient sweep, for the decoder's
// post-join training step. Replaces the dW/db sweep of
// tinyvc_tpu/ops/pallas/mrd.py::_mrd_bwd (_bwd_kernel_dw, launched at :385):
// each tap's weight gradient and the bias gradient, summed over the batch, in
// the phase-plane layout (mrd.cuh). Kernels M and N are in mrd_fwd.cu and
// mrd_dx.cu.
//
// Design: per layer, each block sums x_slice dy_q^T over one fixed chunk of
// 1024 positions of one (batch row, plane) for one h-tap's three w-taps into
// its own partial; a second launch adds the partials in chunk order, a third
// sums dy per output channel for the bias. Bit-reproducible; three launches a
// layer. Operands fp32, or bf16 with fp32 accumulation; dW and db in fp32.
//
// Bound on the H100: operations. The step's crop (B=16, T=8000, four
// resolutions) is ~200 GFLOP of valid products per sweep, 3.0 ms at 67
// TFLOP/s on the CUDA cores, where all products here run; 0.23 ms on the
// tensor cores in bf16, a later PR's.

#include "mrd.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TCH = 64;  // channels per block

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

}  // namespace

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
