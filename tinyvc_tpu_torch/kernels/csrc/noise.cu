// Kernel B: filtered noise from hashed phases, by an inverse FFT inside the
// kernel.
//
// Replaces tinyvc_tpu/ops/pallas/noise.py::pallas_oscillate_noise. A
// magnitude spectrum mag [B, F, bins] gets unit phases, one zero frame is
// prepended, and the inverse STFT (n_fft = 4*hop, hann window, centre trim,
// window-envelope normalisation) gives noise [B, F*hop]. The phases come from
// the same murmur3 counter hash as the TPU kernel, bit for bit: the index is
// (b*rows_total + p)*1024 + bin, with p the row of the spectrum padded by two
// leading zero rows and rows_total the TPU kernel's padded row count, which
// the wrapper computes. An explicit angle tensor replaces the hash for
// parity runs. The TPU kernel runs the inverse DFT as matrix products.
//
// Bound on the H100: bytes. An FFT-based iSTFT needs ~60 thousand fp32
// operations per frame (0.02 GFLOP at F=320: under 0.3 us at the fp32
// peak); mag in and noise out once are 1.8 MB at B=1, F=320 (0.55 us at
// 3.35 TB/s). Each bin also takes a hash and an accurate sincosf.
//
// Design. A block takes HOPS consecutive output hops of one batch row and
// builds the HOPS + 3 frames that overlap them, one warp per frame, each
// once, in shared memory (frames outside [0, F) are skipped; frame -1 is the
// prepended zero frame). Per frame the warp takes bins k and M-k together
// (M = n_fft/2): the hashed or given phase, sincosf without fast math, times
// mag, the imaginary parts at DC and Nyquist dropped (irfft ignores them);
// runs the split step backwards into the packed spectrum Z at the FFT's bin
// positions, then the inverse M-point FFT of fft.cuh (960 = 8 x 8 x 15 for
// n_fft = 1920), which leaves the frame's n_fft real samples in natural
// order. Then every thread of the block overlap-adds the four frames of its
// output samples in a fixed order, times 1/M and the window, and divides by
// the window envelope: each output is written once, no atomics, the same
// result from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft.cuh"

namespace {

constexpr int RATIO = 4;                  // n_fft / hop
constexpr int FRAMES = 8;                 // frames per block, one warp each
constexpr int HOPS = FRAMES - RATIO + 1;  // output hops per block

__device__ __forceinline__ uint32_t murmur_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Uniform phase in [-pi, pi) of padded row p, bin k; the explicit _rn
// intrinsics keep nvcc from contracting the two roundings into one FMA.
__device__ __forceinline__ float hash_angle(int b, int p, int k, int rows_total, int seed) {
  const uint32_t idx =
      (static_cast<uint32_t>(b) * static_cast<uint32_t>(rows_total) + static_cast<uint32_t>(p)) *
          1024u +
      static_cast<uint32_t>(k);
  const uint32_t h = murmur_mix(idx ^ static_cast<uint32_t>(seed));
  const float u = __fmul_rn(static_cast<float>(static_cast<int>(h >> 9)), 1.1920928955078125e-07f);
  return __fsub_rn(__fmul_rn(u, 6.28318530717958647692f), 3.14159265358979323846f);
}

// mag * (cos, sin) of bin k's phase
__device__ __forceinline__ float2 bin_value(const float* __restrict__ mag,
                                            const float* __restrict__ angle, size_t row, int k,
                                            int b, int p, int rows_total, int seed) {
  const float th = angle != nullptr ? angle[row + k] : hash_angle(b, p, k, rows_total, seed);
  float s, c;
  sincosf(th, &s, &c);
  const float mg = mag[row + k];
  return make_float2(mg * c, mg * s);
}

__global__ void __launch_bounds__(FRAMES * 32)
noise_fft(const float* __restrict__ mag, const float* __restrict__ angle,
          const float* __restrict__ cos_tab, const float* __restrict__ sin_tab,
          const float* __restrict__ win, float* __restrict__ out, int F, int hop, int rows_total,
          int seed, const tvc_fft::Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* frames = tw + p.n_tw;
  unsigned short* ptab = reinterpret_cast<unsigned short*>(frames + FRAMES * p.frame_elems);
  tvc_fft::load_tables(tw, ptab, cos_tab, sin_tab, -1.f, p, threadIdx.x, blockDim.x);
  __syncthreads();

  const int m = p.m;
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * HOPS;  // first output hop of the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // output hop o sums frames j = o + 1 - r (r = 0..3) of the data; local
  // frame `warp` is data frame o0 - 2 + warp, padded spectrum row j + 2
  const int j = o0 - (RATIO - 2) + warp;
  if (j >= 0 && j < F) {
    float2* z = frames + warp * p.frame_elems;
    const float2* w = tw + p.split_off;
    const size_t row = (static_cast<size_t>(b) * F + j) * (m + 1);
#pragma unroll 4
    for (int k = lane; k <= m / 2; k += 32) {
      float2 xk = bin_value(mag, angle, row, k, b, j + 2, rows_total, seed);
      float2 xm = bin_value(mag, angle, row, m - k, b, j + 2, rows_total, seed);
      if (k == 0) xk.y = xm.y = 0.f;  // DC and Nyquist
      // E = (X[k] + conj X[M-k]) / 2, O = conj(W^k) (X[k] - conj X[M-k]) / 2
      const float2 e = make_float2(0.5f * (xk.x + xm.x), 0.5f * (xk.y - xm.y));
      const float2 o =
          tvc_fft::cmulc(make_float2(0.5f * (xk.x - xm.x), 0.5f * (xk.y + xm.y)), w[k]);
      z[ptab[k]] = make_float2(e.x - o.y, e.y + o.x);  // E + i O
      if (k > 0 && 2 * k != m)
        z[ptab[m - k]] = make_float2(e.x + o.y, o.x - e.y);  // conj(E) + i conj(O)
    }
    __syncwarp();
    tvc_fft::fft_inverse(z, tw, p, lane);
  }
  __syncthreads();

  const float inv_m = 1.f / static_cast<float>(m);
  for (int oo = 0; oo < HOPS && o0 + oo < F; ++oo) {
    const int o = o0 + oo;
    for (int s = threadIdx.x; s < hop; s += blockDim.x) {
      float acc = 0.f, env = 0.f;
      for (int r = 0; r < RATIO; ++r) {
        const int g = o + RATIO - 2 - r;  // istft frame; g = 0 is the zero frame
        if (g < 0 || g > F) continue;
        const int n = r * hop + s;  // sample inside the frame
        const float wn = win[n];
        env += wn * wn;
        if (g == 0) continue;
        const float* zf =
            reinterpret_cast<const float*>(frames + (oo + RATIO - 1 - r) * p.frame_elems);
        acc += zf[2 * tvc_fft::pad_index(n >> 1, p) + (n & 1)] * inv_m * wn;
      }
      out[(static_cast<size_t>(b) * F + o) * hop + s] = acc / fmaxf(env, 1e-11f);
    }
  }
}

}  // namespace

// mag [B, F, bins] (and angle of the same shape, or null), cos_tab / sin_tab
// [n_fft] (cos, sin of 2*pi*m/n_fft), win [n_fft] -> out [B, F*hop].
// n_fft = 4*hop: even, <= 2048, n_fft/2 with prime factors 2, 3, 5 only.
extern "C" int tvc_noise(const float* mag, const float* angle, const float* cos_tab,
                         const float* sin_tab, const float* win, float* out, int B, int F,
                         int bins, int n_fft, int hop, int rows_total, int seed, void* stream) {
  tvc_fft::Plan p;
  if (B <= 0 || F <= 0 || B > 65535 || hop <= 0 || n_fft != RATIO * hop ||
      bins != n_fft / 2 + 1 || !tvc_fft::make_plan(n_fft, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tvc_fft::smem_bytes(p, FRAMES);
  const cudaError_t err = cudaFuncSetAttribute(
      noise_fft, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + HOPS - 1) / HOPS, B);
  noise_fft<<<grid, FRAMES * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, angle, cos_tab, sin_tab, win, out, F, hop, rows_total, seed, p);
  return static_cast<int>(cudaGetLastError());
}
