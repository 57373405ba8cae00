// Kernel G: the magnitude spectrogram by an FFT inside the kernel.
//
// Replaces tinyvc_tpu/ops/pallas/spectrogram.py::pallas_spectrogram
// (_spec_kernel), which the bf16 serving profile runs at B*F >= 2048
// (tinyvc_tpu/infer/generator.py::serving_spectrogram): wave x [B, L] ->
// |X| [B, L/hop, n_fft/2 + 1] fp32, with the centre reflect padding by n_fft/2
// and frame 0 dropped: frame t (t = 0..F-1) covers padded samples
// [(t+1)*hop, (t+1)*hop + n_fft), i.e. x[(t+1)*hop - n_fft/2 + n] reflected
// into [0, L). The TPU kernel multiplies the frames with a DFT matrix on its
// matrix unit.
//
// Bound on the H100: bytes. The window, a real FFT and the magnitudes are
// 0.15 GFLOP at B=8, F=320 (2.2 us at the fp32 peak); moving the wave in
// and the magnitudes out once is 14.8 MB (4.4 us at 3.35 TB/s).
//
// Design. One warp per frame of the flattened [B*F] frame axis, FRAMES
// frames per block. The warp stages its frame's n_fft samples straight
// from x (coalesced; neighbouring frames overlap 4x and hit in L1/L2),
// reflecting at the ends and windowing with the fp32 hann window as it
// stages, into a padded shared-memory buffer read as M = n_fft/2 complex
// values z[n] = x[2n] + i x[2n+1]. It runs the M-point FFT of fft.cuh
// (960 = 8 x 8 x 15 for n_fft = 1920; twiddles from the wrapper's float64
// table, rounded to fp32, held in shared memory), then the split step gives
// bins k and M-k together and the warp writes sqrt(re^2 + im^2), coalesced.
// fp32 throughout; an FFT's rounding error grows with log N, and the kernel
// stays within ~1e-6 of the peak of the exact transform.

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int FRAMES = 8;  // frames per block, one warp each

__global__ void __launch_bounds__(FRAMES * 32)
spectrogram_fft(const float* __restrict__ x, const float* __restrict__ table,
                const float* __restrict__ win, float* __restrict__ out, int B, int L, int hop,
                const tvc_fft::Plan p) {
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* frames = tw + p.n_tw;
  unsigned short* ptab = reinterpret_cast<unsigned short*>(frames + FRAMES * p.frame_elems);
  const int n_fft = 2 * p.m;
  // table = [cos | -sin] of 2*pi*m/n_fft
  tvc_fft::load_tables(tw, ptab, table, table + n_fft, 1.f, p, threadIdx.x, blockDim.x);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = L / hop;
  const long long r = static_cast<long long>(blockIdx.x) * FRAMES + warp;
  if (r >= static_cast<long long>(B) * F) return;
  const int b = static_cast<int>(r / F), t = static_cast<int>(r - static_cast<long long>(b) * F);
  float2* z = frames + warp * p.frame_elems;
  float* zf = reinterpret_cast<float*>(z);
  const float* xb = x + static_cast<long long>(b) * L;
  const int s0 = (t + 1) * hop - p.m;  // p.m = n_fft / 2
#pragma unroll 4
  for (int n = lane; n < n_fft; n += 32) {
    int s = s0 + n;
    s = s < 0 ? -s : s;
    s = s >= L ? 2 * (L - 1) - s : s;
    zf[2 * tvc_fft::pad_index(n >> 1, p) + (n & 1)] = __fmul_rn(xb[s], win[n]);
  }
  __syncwarp();
  tvc_fft::fft_forward(z, tw, p, lane);

  const float2* w = tw + p.split_off;
  float* o = out + r * (p.m + 1);
  for (int k = lane; k <= p.m / 2; k += 32) {
    const float2 a = z[ptab[k]];
    const float2 c = z[ptab[k == 0 ? 0 : p.m - k]];  // Z[M-k]; Z[M] = Z[0]
    // E = (A + conj C) / 2, O = -i (A - conj C) / 2
    const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 od = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    const float2 wo = tvc_fft::cmul(od, w[k]);
    const float re1 = e.x + wo.x, im1 = e.y + wo.y;  // X[k]
    const float re2 = e.x - wo.x, im2 = e.y - wo.y;  // conj X[M-k]
    o[k] = sqrtf(__fadd_rn(__fmul_rn(re1, re1), __fmul_rn(im1, im1)));
    if (2 * k != p.m) o[p.m - k] = sqrtf(__fadd_rn(__fmul_rn(re2, re2), __fmul_rn(im2, im2)));
  }
}

}  // namespace

// x [B, L] fp32 (L a multiple of hop, L > n_fft/2), table [2, n_fft]
// (cos | -sin of 2*pi*m/n_fft), win [n_fft] -> out [B, L/hop, n_fft/2 + 1].
// n_fft: even, <= 2048, n_fft/2 with prime factors 2, 3, 5 only.
extern "C" int tvc_spectrogram(const float* x, const float* table, const float* win, float* out,
                               int B, int L, int n_fft, int hop, void* stream) {
  tvc_fft::Plan p;
  if (B <= 0 || hop <= 0 || L % hop != 0 || L <= n_fft / 2 || !tvc_fft::make_plan(n_fft, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = static_cast<long long>(B) * (L / hop);
  const size_t smem = tvc_fft::smem_bytes(p, FRAMES);
  const cudaError_t err = cudaFuncSetAttribute(
      spectrogram_fft, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((R + FRAMES - 1) / FRAMES);
  spectrogram_fft<<<grid, FRAMES * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, table, win, out, B, L, hop, p);
  return static_cast<int>(cudaGetLastError());
}
