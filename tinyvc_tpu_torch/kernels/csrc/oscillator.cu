// Kernel A: the additive oscillator bank, forward.
//
// Replaces tinyvc_tpu/ops/pallas/oscillator.py::_pallas_forward (reached
// through oscillator_bank). f0 [B, F] and amps [B, F, H1] at frame rate ->
// out [B, H1, F*frame] = sin(2*pi*h*phase) * uv * amp_h, h = 1..H1, with f0,
// the voiced flag and the amplitudes interpolated to sample rate as
// F.interpolate(mode='linear', align_corners=False) does (edge-clamped
// previous/current/next frames), and the phase the running sum of the
// interpolated f0 / sample_rate, taken mod 1.
//
// Bound on the H100: the bytes of the output (H1 float32 per sample,
// 9.2 MB at B=1, F=320) over 3.35 TB/s, about 3 us; the inputs are ~20 KB.
// One launch writes each output once, in 16-byte stores along time.
//
// The phase in closed form. The TPU kernel carries the phase from one grid
// step to the next, which relies on the TPU running its grid in order;
// blocks here run in no order, so each computes its phase from the frames
// before it. Inside a half-frame the interpolated f0 is linear in the
// sample (interp3 has one branch for a < 0 and one for a >= 0), so the
// phase's prefix over the half-frame is a quadratic in the sample index,
// evaluated in double (FramePhase). A frame's offset is the sum of the
// earlier frames' totals, each wrapped mod 1 and held as Q0.64 fixed point:
// integer addition mod 2^64 is exact and order-free, so the offset neither
// drifts nor depends on the order of the sum at any length. Each sample
// then takes one sincospif of its phase, rounded to fp32 once in [-1, 1]
// (2 x the phase mod 1, centred), and the harmonics come from the Chebyshev
// recurrence sin((h+1)x) = 2 cos x sin(hx) - sin((h-1)x) in fp32. Against
// the float64 truth this is ~1e-5 at amplitude 3 (the fp32 scan of the first
// design was ~1e-3).
//
// A row's seed. Chunked conversion starts each row (a chunk of one
// utterance) at a carried phase, phase0[b] cycles (null: every row at 0).
// It enters once, where the frame offsets are summed: wrapped mod 1 to
// Q0.64 and added to the block's offset as one more integer term, so the
// phase stays wrapped at any length and a null phase0 leaves every bit as
// it was. Kernel I takes no seed.
//
// The offsets' cost: every block sums the Q0.64 totals of the frames before
// its own, each total a few double operations on three f0 values read from
// L1/L2, so a call does O(F^2) of them. At a serving request's F = 320 that
// is under one load a thread; at F = 3000 (60 s) a block of 128 threads
// takes ~24 totals a thread, ~9M in all (~12 KB of f0 re-read per block from
// L2), below the 86 MB the output takes to write. A decoupled look-back
// scan would make it O(F) for hour-long inputs.
//
// Kernel I: the amplitude gradient of the oscillator bank.
//
// Replaces tinyvc_tpu/ops/pallas/oscillator.py::_pallas_backward_amps
// (_osc_bwd_kernel, wired by the _osc custom_vjp; f0 gets no gradient, as
// with grad_f0=False). g [B, H1, F*frame] -> damps [B, F, H1] =
// sum over the frame's samples of g * sin_h * uv * w, for the previous,
// current and next frame's interpolation weight w, the clamped edges folding
// onto frames 0 and F-1, as the TPU's wrapper does. Two launches:
//   1. osc_amps_grad_halves: one block a (frame, row), enough warps a
//      half-frame for a unit of VEC samples a lane. Its phase and harmonics
//      come from kernel A's device functions, so they are A's bit for bit.
//      A lane reads g in 16-byte loads along time, four harmonics ahead,
//      and keeps the sums of one round of 8 harmonics for the half-frame's
//      two weights (2 x 8 sums; the recurrence carries on into the next
//      round). A reduce-scatter by four compile-time steps and one more
//      shuffle leaves sum `lane` on lanes 0-15, which store it in the
//      warp's row in shared memory. The block then writes, per harmonic, the frame's sum
//      for the previous, current and next frame's weight: parts [B, F, 3,
//      H1].
//   2. osc_amps_grad_combine shift-adds them: damps[p] = cur[p] + prev[p+1]
//      + next[p-1].
// Every sum is taken in a fixed order, with no atomics, so two calls give
// the same bits. Registers and latency set the design. A lane's live values
// are its 16 sums, the ring of 4 x VEC loads and VEC samples' recurrences;
// one unit a lane (64 x ceil(units / 32) threads a frame, 128 at frame 480)
// leaves no loop around them that would keep the phase's doubles live, and
// the first four harmonics' loads go out before the phase is computed. (A
// form that kept 2 x 16 sums and a halo half-frame a side, to shift-add in
// one launch, spilled at eight frames a block and ran slower at fewer, with
// one or two blocks an SM.)
//
// Bound on the H100: bytes, the one read of g (46 MB at the training path's
// B=16, F=100: 14 us); the parts are 0.3 MB. A block's frame offset is A's
// O(F) sum.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGradWarps = 32;              // a block of kernel I: one frame
constexpr int kRound = 8;                       // harmonics a round of kernel I
constexpr int kMaxH1 = 4 * kRound;              // harmonics kernel I takes
constexpr int kAhead = 4;                       // g loads in flight a lane

__device__ __forceinline__ float interp3(float prev, float cur, float nxt, float a) {
  return a < 0.f ? prev * (-a) + cur * (1.f + a) : cur * (1.f - a) + nxt * a;
}

// align_corners=False coordinate of sample i inside its frame, relative to
// the frame centre: (i + 0.5)/frame - 0.5, in [-0.5, 0.5).
__device__ __forceinline__ float frame_coord(int i, int frame) {
  return (static_cast<float>(i) + 0.5f) / static_cast<float>(frame) - 0.5f;
}

// The phase of frame p of one row: f0 / sample_rate of the frame (cur) and
// the slopes of its two halves (s0 = cur - prev below the centre, s1 = next
// - cur from it), in cycles per sample. Samples i < i0 = frame / 2 have
// a < 0 (the first half), the rest a >= 0. Over a half that starts at j0,
//   sum_{j=j0..i} f(j) = n (cur + s ((j0 + i + 1) / (2 frame) - 0.5)),
// n = i - j0 + 1; the second half adds the first half's total, base1.
struct FramePhase {
  double cur, s0, s1, base1, inv2f;
  int i0;

  __device__ __forceinline__ FramePhase(const float* f0row, int p, int F, int frame,
                                        double inv_sr) {
    const double prev = static_cast<double>(f0row[p > 0 ? p - 1 : 0]) * inv_sr;
    cur = static_cast<double>(f0row[p]) * inv_sr;
    const double nxt = static_cast<double>(f0row[p + 1 < F ? p + 1 : F - 1]) * inv_sr;
    s0 = cur - prev;
    s1 = nxt - cur;
    inv2f = 0.5 / static_cast<double>(frame);
    i0 = frame / 2;
    base1 = 0.0;
    base1 = prefix(i0 - 1);
  }

  // phase (cycles) from the frame's start through sample i, inclusive
  __device__ __forceinline__ double prefix(int i) const {
    const bool second = i >= i0;
    const int j0 = second ? i0 : 0;
    const double a = fma(static_cast<double>(j0 + i + 1), inv2f, -0.5);
    return fma(static_cast<double>(i - j0 + 1), fma(second ? s1 : s0, a, cur),
               second ? base1 : 0.0);
  }
};

// A phase in cycles wrapped mod 1, as Q0.64.
__device__ __forceinline__ unsigned long long wrap_q(double t) {
  const double fr = t - floor(t);
  return fr < 1.0 ? __double2ull_rz(fr * 0x1p64) : 0ull;
}

// The frame's total phase wrapped mod 1, as Q0.64.
__device__ __forceinline__ unsigned long long frame_q(const float* f0row, int q, int F, int frame,
                                                      double inv_sr) {
  return wrap_q(FramePhase(f0row, q, F, frame, inv_sr).prefix(frame - 1));
}

// sum over q in [q0, q1) of frame_q, mod 2^64, by every thread of the block;
// `red` holds a value a warp. Integer sums: any order gives the same bits.
__device__ __forceinline__ unsigned long long block_q_sum(const float* f0row, int q0, int q1,
                                                          int F, int frame, double inv_sr,
                                                          unsigned long long* red) {
  unsigned long long acc = 0;
  for (int q = q0 + static_cast<int>(threadIdx.x); q < q1; q += blockDim.x)
    acc += frame_q(f0row, q, F, frame, inv_sr);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  unsigned long long total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

// sin and 2 cos of 2 pi x for sample i of a frame whose offset is `off`
// (Q0.64): the phase in double, centred mod 1, rounded to fp32 once.
__device__ __forceinline__ void base_harmonic(const FramePhase& fp, unsigned long long off, int i,
                                              float* sn, float* c2) {
  const double x = fma(__ull2double_rn(off), 0x1p-64, fp.prefix(i));
  float cs;
  sincospif(static_cast<float>(2.0 * (x - rint(x))), sn, &cs);
  *c2 = 2.f * cs;
}

// One step of the Chebyshev recurrence: (sin hx, sin (h-1)x) -> (sin (h+1)x, sin hx).
__device__ __forceinline__ void next_harmonic(float c2, float& cur, float& prev) {
  const float nxt = fmaf(c2, cur, -prev);
  prev = cur;
  cur = nxt;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

// Kernel A: one block a (frame, row), VEC samples a thread.
template <int VEC>
__global__ void __launch_bounds__(VEC == 4 ? 256 : 1024) osc_bank(const float* __restrict__ f0,
                                                 const float* __restrict__ amps,
                                                 const float* __restrict__ phase0,
                                                 float* __restrict__ out, int F, int H1,
                                                 int frame, double inv_sr, float min_frequency) {
  extern __shared__ float s_amps[];  // [3][H1]: the previous, current and next frame's
  __shared__ unsigned long long red[32];
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const float* f0row = f0 + static_cast<size_t>(b) * F;
  unsigned long long off = block_q_sum(f0row, 0, p, F, frame, inv_sr, red);
  if (phase0 != nullptr) off += wrap_q(static_cast<double>(phase0[b]));  // the row's seed
  const int pp = p > 0 ? p - 1 : 0;
  const int pn = p + 1 < F ? p + 1 : F - 1;
  const float* arow = amps + static_cast<size_t>(b) * F * H1;
  for (int k = threadIdx.x; k < 3 * H1; k += blockDim.x) {
    const int r = k / H1;
    s_amps[k] = arow[static_cast<size_t>(r == 0 ? pp : r == 1 ? p : pn) * H1 + (k - r * H1)];
  }
  __syncthreads();
  const int i = static_cast<int>(threadIdx.x) * VEC;
  if (i >= frame) return;

  const FramePhase fp(f0row, p, F, frame, inv_sr);
  const float v_prev = f0row[pp] > min_frequency ? 1.f : 0.f;
  const float v_cur = f0row[p] > min_frequency ? 1.f : 0.f;
  const float v_next = f0row[pn] > min_frequency ? 1.f : 0.f;
  float a[VEC], uv[VEC], sc[VEC], sp[VEC], c2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    a[v] = frame_coord(i + v, frame);
    uv[v] = interp3(v_prev, v_cur, v_next, a[v]);
    base_harmonic(fp, off, i + v, &sc[v], &c2[v]);
    sp[v] = 0.f;
  }
  const size_t L = static_cast<size_t>(F) * frame;
  float* o = out + static_cast<size_t>(b) * H1 * L + static_cast<size_t>(p) * frame + i;
  for (int h = 0; h < H1; ++h) {
    float y[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      y[v] = sc[v] * uv[v] * interp3(s_amps[h], s_amps[H1 + h], s_amps[2 * H1 + h], a[v]);
      next_harmonic(c2[v], sc[v], sp[v]);
    }
    Vec<VEC>::store(o + h * L, y);
  }
}

// Reduce-scatter of a lane's 2*HALF sums across the HALF-apart lanes: the
// lane whose HALF bit is set keeps the upper half, the other the lower.
template <int HALF>
__device__ __forceinline__ void reduce_scatter_step(float* v, int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? v[k] : v[k + HALF];
    const float keep = upper ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
}

// Kernel I, launch 1: one block a (frame, row), `wph` = blockDim.x / 64
// warps a half-frame, one unit of VEC samples a lane: warp w takes half w /
// wph, units (w % wph) * 32 + lane. sums[w][r * 16 + k]: round r's sum k of
// the warp, k < 8 the half's first weight (the previous frame's in the
// first half, the current frame's in the second) of harmonic 8 r + k, k >=
// 8 its second weight (current, next) of harmonic 8 r + k - 8.
// parts[b][p][0 / 1 / 2][h]: the frame's sums for the previous, current and
// next frame's weight.
template <int VEC>
// The bounds: VEC 4 takes frames to 1024 (256 threads); at least 3 such blocks
// an SM caps it at 85 registers (71 used, no spills: six blocks of the main
// path's 128 threads an SM), where the bound alone let ptxas spill.
__global__ void __launch_bounds__(VEC == 4 ? 256 : 1024, VEC == 4 ? 3 : 1) osc_amps_grad_halves(
    const float* __restrict__ f0, const float* __restrict__ g, float* __restrict__ parts, int F,
    int H1, int frame, double inv_sr, float min_frequency) {
  __shared__ unsigned long long red[kMaxGradWarps];
  __shared__ float sums[kMaxGradWarps][2 * kMaxH1];
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int wph = static_cast<int>(blockDim.x) >> 6;
  const int half = warp / wph;
  const int i0 = frame / 2;  // FramePhase's: the first half's samples
  const int j0 = half ? i0 : 0;
  const int unit = (warp - half * wph) * 32 + lane;
  const bool active = unit < ((half ? frame - i0 : i0) + VEC - 1) / VEC;
  const int i = j0 + unit * VEC;
  const int L = F * frame;  // < 2^31, as the entry checks
  const float* gp = g + static_cast<size_t>(b) * H1 * L + static_cast<size_t>(p) * frame + i;
  // the first kAhead harmonics go out before the phase, which they do not need
  float ring[kAhead][VEC];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (active && k < H1) {
      Vec<VEC>::load(gp + k * L, ring[k]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) ring[k][v] = 0.f;
    }
  }

  const float* f0row = f0 + static_cast<size_t>(b) * F;
  const unsigned long long off = block_q_sum(f0row, 0, p, F, frame, inv_sr, red);
  float w1[VEC], w2[VEC], sc[VEC], sp[VEC], c2[VEC];
  {
    const FramePhase fp(f0row, p, F, frame, inv_sr);
    const int pp = p > 0 ? p - 1 : 0;
    const int pn = p + 1 < F ? p + 1 : F - 1;
    const float v_prev = f0row[pp] > min_frequency ? 1.f : 0.f;
    const float v_cur = f0row[p] > min_frequency ? 1.f : 0.f;
    const float v_next = f0row[pn] > min_frequency ? 1.f : 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float a = frame_coord(i + v, frame);
      const float uv = active ? interp3(v_prev, v_cur, v_next, a) : 0.f;
      w1[v] = uv * (half ? 1.f - a : -a);
      w2[v] = uv * (half ? a : 1.f + a);
      base_harmonic(fp, off, i + v, &sc[v], &c2[v]);
      sp[v] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxH1 / kRound; ++r) {
    if (r * kRound < H1) {
      float acc[2 * kRound];
#pragma unroll
      for (int k = 0; k < 2 * kRound; ++k) acc[k] = 0.f;
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        const int h = r * kRound + k;
        if (h < H1) {
          float gv[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) gv[v] = ring[h % kAhead][v];
          if (active && h + kAhead < H1) Vec<VEC>::load(gp + (h + kAhead) * L, ring[h % kAhead]);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float m = gv[v] * sc[v];
            acc[k] = fmaf(m, w1[v], acc[k]);
            acc[kRound + k] = fmaf(m, w2[v], acc[kRound + k]);
            next_harmonic(c2[v], sc[v], sp[v]);
          }
        }
      }
      reduce_scatter_step<8>(acc, lane);
      reduce_scatter_step<4>(acc, lane);
      reduce_scatter_step<2>(acc, lane);
      reduce_scatter_step<1>(acc, lane);
      acc[0] += __shfl_xor_sync(kFull, acc[0], 16);
      if (lane < 2 * kRound) sums[warp][r * 2 * kRound + lane] = acc[0];
    }
  }
  __syncthreads();

  // a half's sum: its warps' in order
  auto half_sum = [&](int hf, int k) {
    float v = sums[hf * wph][k];
    for (int w = 1; w < wph; ++w) v += sums[hf * wph + w][k];
    return v;
  };
  for (int t = threadIdx.x; t < 3 * H1; t += blockDim.x) {
    const int kind = t / H1;  // 0 previous, 1 current, 2 next frame's weight
    const int h = t - kind * H1;
    const int k1 = (h / kRound) * 2 * kRound + h % kRound;  // the first weight's sum
    const int k2 = k1 + kRound;                             // the second's
    const float v = kind == 0 ? half_sum(0, k1)
                    : kind == 1 ? half_sum(0, k2) + half_sum(1, k1)
                                : half_sum(1, k2);
    parts[((static_cast<size_t>(b) * F + p) * 3 + kind) * H1 + h] = v;
  }
}

// Kernel I, launch 2: damps[b, p, h] = cur[p] + prev[p+1] + next[p-1], edges folded
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

bool vectors(int frame) { return frame % 8 == 0; }  // 16-byte runs in both halves

}  // namespace

// Kernel A: f0 [B, F], amps [B, F, H1], phase0 [B] cycles or null -> out
// [B, H1, F*frame].
extern "C" int tvc_oscillator(const float* f0, const float* amps, const float* phase0, float* out,
                              int B, int F, int H1, int frame, float sample_rate,
                              float min_frequency, void* stream) {
  if (B <= 0 || F <= 0 || H1 <= 0 || frame <= 0 || frame > 1024 || B > 65535 ||
      3 * H1 * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double inv_sr = 1.0 / static_cast<double>(sample_rate);
  const dim3 grid(F, B);
  const size_t smem = 3 * H1 * sizeof(float);
  if (vectors(frame))
    osc_bank<4><<<grid, (frame / 4 + 31) / 32 * 32, smem, tvc::counted(s)>>>(
        f0, amps, phase0, out, F, H1, frame, inv_sr, min_frequency);
  else
    osc_bank<1><<<grid, (frame + 31) / 32 * 32, smem, tvc::counted(s)>>>(
        f0, amps, phase0, out, F, H1, frame, inv_sr, min_frequency);
  return static_cast<int>(cudaGetLastError());
}

// Kernel I: g [B, H1, F*frame] -> damps [B, F, H1]; parts [B, F, 3, H1] is
// scratch; g 16-byte aligned when frame is a multiple of 8 (its 16-byte
// loads).
extern "C" int tvc_oscillator_amps_grad(const float* f0, const float* g, float* parts,
                                        float* damps, int B, int F, int H1, int frame,
                                        float sample_rate, float min_frequency, void* stream) {
  if (B <= 0 || F <= 0 || H1 <= 0 || H1 > kMaxH1 || frame <= 0 || frame > 1024 || B > 65535 ||
      static_cast<long long>(F) * frame > INT_MAX ||
      (vectors(frame) && reinterpret_cast<uintptr_t>(g) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double inv_sr = 1.0 / static_cast<double>(sample_rate);
  const dim3 grid(F, B);
  const int vec = vectors(frame) ? 4 : 1;
  const int threads = 64 * (((frame - frame / 2 + vec - 1) / vec + 31) / 32);  // a unit a lane
  if (vec == 4)
    osc_amps_grad_halves<4><<<grid, threads, 0, tvc::counted(s)>>>(f0, g, parts, F, H1, frame,
                                                                   inv_sr, min_frequency);
  else
    osc_amps_grad_halves<1><<<grid, threads, 0, tvc::counted(s)>>>(f0, g, parts, F, H1, frame,
                                                                   inv_sr, min_frequency);
  const long long n = static_cast<long long>(B) * F * H1;
  osc_amps_grad_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, tvc::counted(s)>>>(
      parts, damps, B, F, H1);
  return static_cast<int>(cudaGetLastError());
}
