// The phase-plane layout shared by kernels M (mrd_fwd.cu), N (mrd_dx.cu) and
// O (mrd_dw.cu): one MRD layer's geometry, its taps, and the launchers' checks.
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
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int KW = 3;     // every MRD conv is 3 wide (pw = 1)
constexpr int MAXT = 16;  // taps a plane reads (M) or gathers (N), at most

struct Layer {
  int B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_in, h_out;
  __host__ __device__ int L() const { return g_out * Wp; }
  __host__ __device__ int blk_in() const { return (g_in + 4) * Wp; }
  __host__ __device__ int blk_out() const { return (g_out + 4) * Wp; }
  __host__ __device__ int in_len() const { return s_in * blk_in(); }
  __host__ __device__ int out_len() const { return s_out * blk_out(); }
  // floored (phi, delta) of output plane q's h-tap i
  __host__ __device__ void tap(int q, int i, int& phi, int& delta) const {
    const int t = stride * q + i - ph;
    phi = ((t % s_in) + s_in) % s_in;
    delta = (t - phi) / s_in;
  }
  __host__ __device__ int valid_rows(int q) const {
    return q < h_out ? (h_out - q + s_out - 1) / s_out : 0;
  }
  // rows of input plane phi that hold the layer below's valid outputs
  __host__ __device__ int rows_in(int phi) const {
    return phi < h_in ? (h_in - phi + s_in - 1) / s_in : 0;
  }
  // position l in [0, L) of output plane q holds a valid output
  __host__ __device__ bool valid(int q, int l) const {
    const int row = l / Wp, col = l - row * Wp;
    return row < valid_rows(q) && col >= 1 && col <= W;
  }
};

// One tap of a plane: the source row's positions start + pos + shift feed
// position pos of the tile, read where they lie in [lo, hi), zero elsewhere;
// wi is the h-tap of the weight.
struct Tap {
  int start, lo, hi, wi;
};

// The block's taps of one plane into shared `taps` (MAXT slots) and `ntaps`,
// in h-tap order. M (dx = false): output plane `plane` reads, for each h-tap
// i, input plane phi at (2 + delta) rows, w-tap j at shift j, where it lies
// in phi's interior rows (its halo rows, and the neighbouring planes' that
// the first and last w-tap touch, hold zeros). N (dx = true): input plane
// `plane` gathers the (q, i)
// whose tap lands on it; position p takes dy_q at l = p - (2 + delta) * Wp +
// 1 - j (shift 2 - j), l in [0, L). As s_in = stride * s_out, the planes q
// of one h-tap i land on distinct input planes, so each i gives at most one
// tap: threads i < kh work one out each, thread 0 compacts.
__device__ void block_taps(const Layer& ly, bool dx, int plane, Tap* taps, int* ntaps) {
  const int i = threadIdx.x;
  if (i < ly.kh) {
    int q = plane, phi, delta;
    bool hit = true;
    if (dx) {
      const int r = ((plane + ly.ph - i) % ly.s_in + ly.s_in) % ly.s_in;
      hit = r % ly.stride == 0;
      q = r / ly.stride;
    }
    ly.tap(q, i, phi, delta);
    const int lo = q * ly.blk_out() + 2 * ly.Wp;
    taps[i] = !hit ? Tap{0, 0, 0, -1}
              : dx ? Tap{q * ly.blk_out() - delta * ly.Wp - 1, lo, lo + ly.L(), i}
                   : Tap{phi * ly.blk_in() + (2 + delta) * ly.Wp - 1, phi * ly.blk_in() + 2 * ly.Wp,
                         phi * ly.blk_in() + (2 + ly.g_in) * ly.Wp, i};
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < ly.kh; ++k)
      if (taps[k].wi >= 0) taps[n++] = taps[k];
    *ntaps = n;
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float load(const T* p, long long i) {
  return to_f32(p[i]);
}

Layer make_layer(int B, int cin, int cout, int kh, int stride, int ph, int s_in, int s_out,
                 int g_in, int g_out, int Wp, int W, int h_in, int h_out) {
  return Layer{B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_in, h_out};
}

bool bad(const Layer& l) {
  return l.B <= 0 || l.cin <= 0 || l.cout <= 0 || l.kh <= 0 || l.stride <= 0 || l.s_in <= 0 ||
         l.s_out <= 0 || l.g_in <= 0 || l.g_out <= 0 || l.g_out > l.g_in + 1 || l.Wp <= 2 ||
         l.W != l.Wp - 2 || l.h_in <= 0 || l.B * l.s_out > 65535 || l.B * l.s_in > 65535 ||
         l.kh > MAXT || l.s_in != l.stride * l.s_out;
}

unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

}  // namespace

#define MRD_LAYER_ARGS                                                                    \
  int B, int cin, int cout, int kh, int stride, int ph, int s_in, int s_out, int g_in, \
      int g_out, int Wp, int W, int h_in, int h_out
#define MRD_LAYER \
  make_layer(B, cin, cout, kh, stride, ph, s_in, s_out, g_in, g_out, Wp, W, h_in, h_out)
