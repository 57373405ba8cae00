// Kernel B: filtered noise from hashed phases.
//
// Replaces tinyvc_tpu/ops/pallas/noise.py::pallas_oscillate_noise. A
// magnitude spectrum mag [B, F, bins] gets unit phases, one zero frame is
// prepended, and the inverse STFT (n_fft = 4*hop, hann window, centre trim,
// window-envelope normalisation) gives noise [B, F*hop]. The phases come from
// the same murmur3 counter hash as the TPU kernel, bit for bit: the index is
// (b*rows_total + p)*1024 + bin, with p the row of the spectrum padded by two
// leading zero rows and rows_total the TPU kernel's padded row count, which
// the wrapper computes. An explicit angle tensor replaces the hash for
// parity runs.
//
// Bound on the H100: operations. The direct inverse DFT that the TPU kernel
// runs as matmuls costs F*n_fft*bins*2 multiply-adds (2.4 GFLOP at F=320,
// 35 us at the 67 TFLOP/s fp32 peak); the bytes (1.8 MB) take under 1 us.
// One block computes one output hop of one batch row: it rebuilds the four
// overlapping frames' spectra (hash, sincosf) in shared memory and each
// thread sums the DFT for one sample, reading cos/sin from a table of
// n_fft entries in shared memory indexed by (k*m mod n_fft), so the inner
// loop has no transcendental. Overlap-add, the trim and the envelope divide
// fall out of the index arithmetic; each output is written once.
// fp32 throughout, without fast math: sinf/cosf precision sets the phases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void noise_synth(const float* __restrict__ mag, const float* __restrict__ angle,
                            const float* __restrict__ cos_tab, const float* __restrict__ sin_tab,
                            const float* __restrict__ win, float* __restrict__ out, int F,
                            int bins, int n_fft, int hop, int rows_total, int seed) {
  extern __shared__ float smem[];
  float* ct = smem;
  float* st = ct + n_fft;
  float* re = st + n_fft;
  float* im = re + bins;
  const int o = blockIdx.x;  // output hop
  const int b = blockIdx.y;
  const int tid = static_cast<int>(threadIdx.x);
  const int ratio = n_fft / hop;
  for (int m = tid; m < n_fft; m += blockDim.x) {
    ct[m] = cos_tab[m];
    st[m] = sin_tab[m];
  }
  const float inv_n = 1.f / static_cast<float>(n_fft);
  float acc = 0.f;
  for (int r = 0; r < ratio; ++r) {
    // output hop o takes sub-block r of istft frame g = o + 2 - r, which is
    // padded spectrum row p = g + 1 and data frame j = p - 2 (g = 0 is the
    // prepended zero frame)
    const int p = o + ratio - 1 - r;
    const int j = p - 2;
    if (j < 0 || j >= F) continue;  // uniform across the block
    __syncthreads();  // the previous frame's re/im are no longer read
    const size_t row = (static_cast<size_t>(b) * F + j) * bins;
    for (int k = tid; k < bins; k += blockDim.x) {
      const float th = angle != nullptr ? angle[row + k] : hash_angle(b, p, k, rows_total, seed);
      float s, c;
      sincosf(th, &s, &c);
      const float mg = mag[row + k];
      re[k] = mg * c;
      im[k] = mg * s;
    }
    __syncthreads();
    if (tid < hop) {
      const int m = r * hop + tid;  // sample inside the frame
      // irfft with hermitian weights: 1 for DC and Nyquist, 2 otherwise
      float v = re[0];
      int idx = m;
      for (int k = 1; k < bins - 1; ++k) {
        v += 2.f * (re[k] * ct[idx] - im[k] * st[idx]);
        idx += m;
        if (idx >= n_fft) idx -= n_fft;
      }
      v += re[bins - 1] * ct[idx] - im[bins - 1] * st[idx];
      acc += v * inv_n * win[m];
    }
  }
  if (tid < hop) {
    float env = 0.f;
    for (int r = 0; r < ratio; ++r) {
      const int g = o + ratio - 2 - r;
      if (g >= 0 && g <= F) {
        const float w = win[r * hop + tid];
        env += w * w;
      }
    }
    out[(static_cast<size_t>(b) * F + o) * hop + tid] = acc / fmaxf(env, 1e-11f);
  }
}

}  // namespace

extern "C" int tvc_noise(const float* mag, const float* angle, const float* cos_tab,
                         const float* sin_tab, const float* win, float* out, int B, int F,
                         int bins, int n_fft, int hop, int rows_total, int seed, void* stream) {
  if (B <= 0 || F <= 0 || B > 65535 || hop <= 0 || hop > 1024 || n_fft % hop != 0 ||
      bins != n_fft / 2 + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (hop + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(2 * n_fft + 2 * bins) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  noise_synth<<<dim3(F, B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, angle, cos_tab, sin_tab, win, out, F, bins, n_fft, hop, rows_total, seed);
  return static_cast<int>(cudaGetLastError());
}
