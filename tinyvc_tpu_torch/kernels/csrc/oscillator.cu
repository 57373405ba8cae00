// Kernel A: the additive oscillator bank, forward.
//
// Replaces tinyvc_tpu/ops/pallas/oscillator.py::_pallas_forward (reached
// through oscillator_bank). f0 [B, F] and amps [B, F, H1] at frame rate ->
// out [B, H1, F*frame] = sin(2*pi*frac(h*phase)) * uv * amp_h, with f0, the
// voiced flag and the amplitudes interpolated to sample rate as
// F.interpolate(mode='linear', align_corners=False) does (edge-clamped
// previous/current/next frames), and the phase integrated mod 1.
//
// Bound on the H100: the bytes of the output (H1 float32 per sample,
// 9.2 MB at B=1, F=320) over 3.35 TB/s, about 3 us; the inputs are ~20 KB
// and the arithmetic (one sinf and a few FMAs per output) is below the
// memory time. The design writes each output once, coalesced along time,
// and reads only frame-rate inputs.
//
// The TPU kernel carries the phase from one grid step to the next in SMEM,
// which relies on the TPU running its grid in order. Blocks here run in no
// order, so the phase is integrated in two passes, one block per (frame,
// batch row):
//   1. osc_frame_sums: a block scan in fp32 of f0/sr over the frame's
//      samples; the frame's total is stored wrapped mod 1.
//   2. osc_synth: each block reduces the wrapped totals of the frames
//      before it (every partial sum wrapped mod 1, so no accumulator grows
//      past ~2 and fp32 keeps ~1e-7 cycles at any length), recomputes its
//      own intra-frame scan with the same code as pass 1, and writes the
//      H1 harmonics.
// The reduction in pass 2 is O(F) per block; at serving lengths (hundreds
// of frames) it is one load per thread. A decoupled look-back scan would
// make it O(1) for hour-long inputs.
//
// Kernel I: the amplitude gradient of the oscillator bank.
//
// Replaces tinyvc_tpu/ops/pallas/oscillator.py::_pallas_backward_amps
// (_osc_bwd_kernel, wired by the _osc custom_vjp; f0 gets no gradient, as
// with grad_f0=False). g [B, H1, F*frame] -> damps [B, F, H1]. Pass 1 is
// kernel A's. Then one block per (frame, batch row), osc_amps_grad_parts,
// recomputes each sample's phase and voiced weight with kernel A's own
// device function (osc_phase_uv, shared, so the phase is A's bit for bit)
// and reduces, per harmonic, sum g * sin(2 pi frac(h phase)) * uv * w over
// the frame for the three interpolation weights w (previous, current, next
// frame), warp by warp in shuffles, then across warps in a fixed order in
// shared memory: no atomics, so runs are reproducible. osc_amps_grad_combine
// shift-adds the three sums into damps[p] = cur[p] + prev[p+1] + next[p-1],
// the clamped edges folding onto frames 0 and F-1, as the TPU's wrapper
// does.
//
// Bound on the H100: bytes, the one read of g (46 MB at the training
// path's B=16, F=100: 14 us); the sinf per element (11.5 M) is below it.
// Each thread reads its sample of every harmonic, coalesced along time.

#include <cuda_runtime.h>
#include <math.h>

#include "launch_count.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float interp3(float prev, float cur, float nxt, float a) {
  return a < 0.f ? prev * (-a) + cur * (1.f + a) : cur * (1.f - a) + nxt * a;
}

// align_corners=False coordinate of sample i inside its frame, relative to
// the frame centre: (i + 0.5)/frame - 0.5, in [-0.5, 0.5).
__device__ __forceinline__ float frame_coord(int i, int frame) {
  return (static_cast<float>(i) + 0.5f) / static_cast<float>(frame) - 0.5f;
}

// Phase increment of sample i of frame p (cycles per sample).
__device__ __forceinline__ float phase_step(const float* f0row, int p, int F, int i,
                                            int frame, float sample_rate) {
  if (i >= frame) return 0.f;
  const float prev = f0row[p > 0 ? p - 1 : 0];
  const float cur = f0row[p];
  const float nxt = f0row[p + 1 < F ? p + 1 : F - 1];
  return interp3(prev, cur, nxt, frame_coord(i, frame)) / sample_rate;
}

// Inclusive scan over the block's threads; blockDim.x is a multiple of 32.
__device__ float block_inclusive_scan(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  return v;
}

__device__ __forceinline__ float wrap1(float x) { return x - floorf(x); }

__global__ void osc_frame_sums(const float* __restrict__ f0, float* __restrict__ fs_mod,
                               int F, int frame, float sample_rate) {
  __shared__ float warp_sums[32];
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const float* f0row = f0 + static_cast<size_t>(b) * F;
  const float d = phase_step(f0row, p, F, static_cast<int>(threadIdx.x), frame, sample_rate);
  const float intra = block_inclusive_scan(d, warp_sums);
  if (static_cast<int>(threadIdx.x) == frame - 1) fs_mod[static_cast<size_t>(b) * F + p] = wrap1(intra);
}

// Phase (cycles) and voiced weight of sample i of frame p of row b, shared
// by kernels A and I. Every thread of the block calls it (it synchronises);
// threads with i >= frame get phase and uv of no sample.
struct PhaseUv {
  float phase;
  float uv;
};

__device__ PhaseUv osc_phase_uv(const float* f0row, const float* fsrow, int p, int F, int i,
                                int frame, float sample_rate, float min_frequency,
                                float* warp_sums, float* partial) {
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = blockDim.x >> 5;

  // offset = (sum of the wrapped totals of frames 0..p-1) mod 1
  float acc = 0.f;
  for (int q = i; q < p; q += blockDim.x) acc = wrap1(acc + fsrow[q]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = wrap1(acc + __shfl_down_sync(kFull, acc, o));
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < n_warps ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc = wrap1(acc + __shfl_down_sync(kFull, acc, o));
    if (lane == 0) partial[0] = acc;
  }
  __syncthreads();
  const float offset = partial[0];

  const float intra =
      block_inclusive_scan(phase_step(f0row, p, F, i, frame, sample_rate), warp_sums);
  const int pp = p > 0 ? p - 1 : 0;
  const int pn = p + 1 < F ? p + 1 : F - 1;
  const float uv = interp3(f0row[pp] > min_frequency ? 1.f : 0.f,
                           f0row[p] > min_frequency ? 1.f : 0.f,
                           f0row[pn] > min_frequency ? 1.f : 0.f, frame_coord(i, frame));
  return PhaseUv{offset + intra, uv};
}

constexpr float kTwoPi = 6.28318530717958647692f;

__global__ void osc_synth(const float* __restrict__ f0, const float* __restrict__ amps,
                          const float* __restrict__ fs_mod, float* __restrict__ out,
                          int F, int H1, int frame, float sample_rate, float min_frequency) {
  __shared__ float warp_sums[32];
  __shared__ float partial[32];
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int i = static_cast<int>(threadIdx.x);
  const float* f0row = f0 + static_cast<size_t>(b) * F;
  const PhaseUv s = osc_phase_uv(f0row, fs_mod + static_cast<size_t>(b) * F, p, F, i, frame,
                                 sample_rate, min_frequency, warp_sums, partial);
  if (i >= frame) return;

  const int pp = p > 0 ? p - 1 : 0;
  const int pn = p + 1 < F ? p + 1 : F - 1;
  const float a = frame_coord(i, frame);
  const float* arow = amps + static_cast<size_t>(b) * F * H1;
  const size_t L = static_cast<size_t>(F) * frame;
  const size_t t = static_cast<size_t>(p) * frame + i;
  float* orow = out + static_cast<size_t>(b) * H1 * L + t;
  for (int h = 0; h < H1; ++h) {
    const float amp = interp3(arow[pp * H1 + h], arow[p * H1 + h], arow[pn * H1 + h], a);
    const float ph = s.phase * static_cast<float>(h + 1);
    orow[h * L] = sinf(kTwoPi * (ph - floorf(ph))) * s.uv * amp;
  }
}

constexpr int kMaxH1 = 32;  // harmonics kernel I reduces per block

// parts [B, F, 3, H1]: per frame and harmonic, the sums of g * sin * uv
// times the previous, current and next frame's interpolation weight.
__global__ void osc_amps_grad_parts(const float* __restrict__ f0,
                                    const float* __restrict__ fs_mod,
                                    const float* __restrict__ g, float* __restrict__ parts,
                                    int F, int H1, int frame, float sample_rate,
                                    float min_frequency) {
  __shared__ float warp_sums[32];
  __shared__ float partial[32];
  __shared__ float red[32][3 * kMaxH1];
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int i = static_cast<int>(threadIdx.x);
  const int lane = i & 31;
  const int warp = i >> 5;
  const int n_warps = blockDim.x >> 5;
  const PhaseUv s = osc_phase_uv(f0 + static_cast<size_t>(b) * F,
                                 fs_mod + static_cast<size_t>(b) * F, p, F, i, frame,
                                 sample_rate, min_frequency, warp_sums, partial);
  const bool valid = i < frame;
  const float a = frame_coord(i, frame);
  const float w_prev = a < 0.f ? -a : 0.f;
  const float w_cur = a < 0.f ? 1.f + a : 1.f - a;
  const float w_next = a < 0.f ? 0.f : a;
  const size_t L = static_cast<size_t>(F) * frame;
  const float* grow = g + static_cast<size_t>(b) * H1 * L + static_cast<size_t>(p) * frame + i;
  for (int h = 0; h < H1; ++h) {
    float m = 0.f;
    if (valid) {
      const float ph = s.phase * static_cast<float>(h + 1);
      m = sinf(kTwoPi * (ph - floorf(ph))) * s.uv * grow[h * L];
    }
    float v0 = m * w_prev, v1 = m * w_cur, v2 = m * w_next;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v0 += __shfl_down_sync(kFull, v0, o);
      v1 += __shfl_down_sync(kFull, v1, o);
      v2 += __shfl_down_sync(kFull, v2, o);
    }
    if (lane == 0) {
      red[warp][h] = v0;
      red[warp][kMaxH1 + h] = v1;
      red[warp][2 * kMaxH1 + h] = v2;
    }
  }
  __syncthreads();
  if (i < 3 * H1) {
    const int k = i / H1, h = i - k * H1;
    float acc = 0.f;
    for (int w = 0; w < n_warps; ++w) acc += red[w][k * kMaxH1 + h];
    parts[((static_cast<size_t>(b) * F + p) * 3 + k) * H1 + h] = acc;
  }
}

// damps[b, p, h] = cur[p] + prev[p+1] + next[p-1], edges folded
__global__ void osc_amps_grad_combine(const float* __restrict__ parts,
                                      float* __restrict__ damps, int B, int F, int H1) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= static_cast<long long>(B) * F * H1) return;
  const int h = static_cast<int>(n % H1);
  const int p = static_cast<int>((n / H1) % F);
  const long long b = n / (static_cast<long long>(F) * H1);
  const float* row = parts + b * F * 3 * H1;
  auto at = [&](int q, int k) { return row[(static_cast<long long>(q) * 3 + k) * H1 + h]; };
  float v = at(p, 1);
  if (p + 1 < F) v += at(p + 1, 0);
  if (p == 0) v += at(0, 0);
  if (p > 0) v += at(p - 1, 2);
  if (p == F - 1) v += at(F - 1, 2);
  damps[n] = v;
}

}  // namespace

extern "C" int tvc_oscillator(const float* f0, const float* amps, float* fs_mod, float* out,
                              int B, int F, int H1, int frame, float sample_rate,
                              float min_frequency, void* stream) {
  if (B <= 0 || F <= 0 || H1 <= 0 || frame <= 0 || frame > 1024 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (frame + 31) / 32 * 32;
  const dim3 grid(F, B);
  osc_frame_sums<<<grid, threads, 0, tvc::counted(s)>>>(f0, fs_mod, F, frame, sample_rate);
  osc_synth<<<grid, threads, 0, tvc::counted(s)>>>(f0, amps, fs_mod, out, F, H1, frame,
                                                    sample_rate, min_frequency);
  return static_cast<int>(cudaGetLastError());
}

// Kernel I: g [B, H1, F*frame] -> damps [B, F, H1]; fs_mod [B, F] and
// parts [B, F, 3, H1] are scratch.
extern "C" int tvc_oscillator_amps_grad(const float* f0, const float* g, float* fs_mod,
                                        float* parts, float* damps, int B, int F, int H1,
                                        int frame, float sample_rate, float min_frequency,
                                        void* stream) {
  if (B <= 0 || F <= 0 || H1 <= 0 || H1 > kMaxH1 || frame <= 0 || frame > 1024 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (frame + 31) / 32 * 32;
  const dim3 grid(F, B);
  osc_frame_sums<<<grid, threads, 0, tvc::counted(s)>>>(f0, fs_mod, F, frame, sample_rate);
  osc_amps_grad_parts<<<grid, threads, 0, tvc::counted(s)>>>(f0, fs_mod, g, parts, F, H1, frame,
                                                              sample_rate, min_frequency);
  const long long n = static_cast<long long>(B) * F * H1;
  osc_amps_grad_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, tvc::counted(s)>>>(
      parts, damps, B, F, H1);
  return static_cast<int>(cudaGetLastError());
}
