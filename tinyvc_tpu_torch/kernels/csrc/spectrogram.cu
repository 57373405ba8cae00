// Kernel G: the magnitude spectrogram as a windowed DFT product.
//
// Replaces tinyvc_tpu/ops/pallas/spectrogram.py::pallas_spectrogram
// (_spec_kernel), which the bf16 serving profile runs at B*F >= 2048
// (tinyvc_tpu/infer/generator.py::serving_spectrogram): wave x [B, L] ->
// |X| [B, L/hop, n_fft/2 + 1] fp32, with the centre reflect padding by n_fft/2
// and frame 0 dropped: frame t (t = 0..F-1) covers padded samples
// [(t+1)*hop, (t+1)*hop + n_fft), i.e. x[(t+1)*hop - n_fft/2 + n] reflected
// into [0, L).
//
// Function: each frame's samples times the fp32 hann window, then one product
// with the packed (cos | -sin) DFT matrix of n_fft x 2*bins, then
// sqrt(re^2 + im^2) in fp32.
//
// Design. The frames are never materialised: the block stages each chunk of
// its frames straight from x, reflecting at the ends, and windows it as it
// is staged (the TPU kernel DMAs hop-sized block rows instead). The DFT
// matrix is not read either: entry (n, k) is cos/-sin of 2*pi*((n*k) mod N)/N,
// taken from a table of N cos and N -sin values (computed in float64 and
// rounded to fp32 by the wrapper) that the block keeps in shared memory.
// A block computes 64 frames (rows of the flattened [B*F] frame axis) x 32
// bins, re and im; 256 threads, each 4 frames x 2 bins x (re, im); the
// reduction runs over chunks of 32 samples. Sums are fp32 FMAs on the CUDA
// cores, ~1e-6 of the peak (the TPU's bf16x3 gets ~1.5e-5 relative): a 2e-3
// perturbation of the spectrogram flips 3% of kNN neighbours.
//
// Bound on the H100: operations. As a DFT product the spectrogram is
// 2 * B*F * n_fft * 2*bins flops: 18.9 GFLOP at B=8, F=320, 0.28 ms at the
// fp32 peak; its bytes (wave in, magnitudes out) take microseconds. An FFT
// needs ~100x fewer operations, so cuFFT (torch.stft) is expected to win.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;       // frames per block
constexpr int TK = 32;       // bins per block
constexpr int NC = 32;       // samples per reduction chunk
constexpr int THREADS = 256; // 16 bin lanes x 16 frame lanes
constexpr int MAX_NFFT = 2048;

__global__ void __launch_bounds__(THREADS)
spectrogram_dft(const float* __restrict__ x, const float* __restrict__ table,
                const float* __restrict__ win, float* __restrict__ out, int B, int L, int n_fft,
                int hop) {
  __shared__ float s_cos[MAX_NFFT];
  __shared__ float s_nsin[MAX_NFFT];
  __shared__ float sf[NC][TM + 1];
  __shared__ float sc[NC][TK];
  __shared__ float ss[NC][TK];

  const int F = L / hop;
  const int R = B * F;
  const int bins = n_fft / 2 + 1;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = blockIdx.x * TM;
  const int k0 = blockIdx.y * TK;

  for (int m = tid; m < n_fft; m += THREADS) {
    s_cos[m] = table[m];
    s_nsin[m] = table[n_fft + m];
  }

  float re[4][2], im[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j) re[a][j] = im[a][j] = 0.f;

  for (int n0 = 0; n0 < n_fft; n0 += NC) {
    __syncthreads();  // the table is in place; the last chunk is consumed
    // frames: element (m, n) reads x[b, (t+1)*hop - n_fft/2 + n0 + n], reflected
    for (int e = tid; e < TM * NC; e += THREADS) {
      const int n = e % NC, m = e / NC;
      const int r = r0 + m;
      float v = 0.f;
      if (r < R) {
        const int b = r / F, t = r - b * F;
        int s = (t + 1) * hop - n_fft / 2 + n0 + n;
        s = s < 0 ? -s : s;
        s = s >= L ? 2 * (L - 1) - s : s;
        v = __fmul_rn(x[static_cast<long long>(b) * L + s], win[n0 + n]);
      }
      sf[n][m] = v;
    }
    // DFT entries of the chunk: (n0 + n) * k mod n_fft indexes the table
    for (int e = tid; e < NC * TK; e += THREADS) {
      const int kk = e % TK, n = e / TK;
      const int k = k0 + kk;
      float c = 0.f, s = 0.f;
      if (k < bins) {
        const int idx = static_cast<int>((static_cast<long long>(n0 + n) * k) % n_fft);
        c = s_cos[idx];
        s = s_nsin[idx];
      }
      sc[n][kk] = c;
      ss[n][kk] = s;
    }
    __syncthreads();
#pragma unroll 8
    for (int n = 0; n < NC; ++n) {
      float f[4], c[2], s[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) f[a] = sf[n][ty + 16 * a];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c[j] = sc[n][tx + 16 * j];
        s[j] = ss[n][tx + 16 * j];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          re[a][j] = fmaf(f[a], c[j], re[a][j]);
          im[a][j] = fmaf(f[a], s[j], im[a][j]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + 16 * a;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k >= bins) continue;
      out[static_cast<long long>(r) * bins + k] =
          sqrtf(__fadd_rn(__fmul_rn(re[a][j], re[a][j]), __fmul_rn(im[a][j], im[a][j])));
    }
  }
}

}  // namespace

// x [B, L] fp32 (L a multiple of hop, L > n_fft/2), table [2, n_fft]
// (cos | -sin of 2*pi*m/n_fft), win [n_fft] -> out [B, L/hop, n_fft/2 + 1].
extern "C" int tvc_spectrogram(const float* x, const float* table, const float* win, float* out,
                               int B, int L, int n_fft, int hop, void* stream) {
  if (B <= 0 || hop <= 0 || n_fft <= 0 || n_fft > MAX_NFFT || n_fft % NC != 0 ||
      L % hop != 0 || L <= n_fft / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(B) * (L / hop);
  const int bins = n_fft / 2 + 1;
  const dim3 grid(static_cast<unsigned>((R + TM - 1) / TM), (bins + TK - 1) / TK);
  spectrogram_dft<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, table, win, out, B,
                                                                          L, n_fft, hop);
  return static_cast<int>(cudaGetLastError());
}
