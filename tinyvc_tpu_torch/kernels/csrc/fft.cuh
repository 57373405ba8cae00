// The FFT shared by kernels G (spectrogram.cu, forward) and B (noise.cu,
// inverse): one warp transforms one frame held in shared memory.
//
// A real transform of length N = n_fft runs as a complex FFT of M = N/2
// points on the packed frame z[n] = x[2n] + i x[2n+1]. M may have the prime
// factors 2, 3 and 5 only, N <= 2048. The passes (make_plan): radix 8 while
// it divides the power of two, then 4 or 2; radix 15 (a 3 x 5 Good-Thomas
// DFT, no twiddles inside) while 3 and 5 both divide, then 3s, then 5s. For
// N = 1920: 960 = 8 x 8 x 15.
//
// Forward (G): decimation in frequency, in place. Pass p of radix r and span
// S = M / (r_0 ... r_p) splits the buffer into blocks of L = r*S; the
// butterfly at offset j of a block takes the r values S apart, transforms
// them and multiplies output m by W_L^(j*m). Bin k ends at the
// mixed-radix digit-reversed position sum_p digit_p(k) * S_p (ptab). The
// real spectrum follows by the split step, bins k and M-k together:
//   E = (Z[k] + conj Z[M-k]) / 2,  O = -i (Z[k] - conj Z[M-k]) / 2,
//   X[k] = E + W_N^k O,  X[M-k] = conj(E - W_N^k O).
// Inverse (B): the same passes backwards (decimation in time): the split
// step run backwards writes Z[k] = E + i O at ptab[k], each butterfly
// multiplies input m by conj(W_L^(j*m)) and takes the conjugate DFT, and
// the frame comes out in natural order, x[2n] and x[2n+1] side by side.
//
// Twiddles: every W_L^(j*m) and W_N^k is an entry of the wrapper's table
// (cos, sin of 2*pi*m/N computed in float64, rounded to fp32), gathered
// once per block into shared memory in the order the butterflies read it,
// so that a warp's 32 lanes read neighbouring entries. The small DFTs take
// fixed constants (the same fp32 roundings). No sincosf, no fast math.
//
// Shared memory: a frame is M float2 with 2 elements of padding every
// 2*S_0 elements (S_0 = M / r_0, 240 for N = 1920). With the c-fast lane
// order of the middle passes below, every radix pass of N = 1920 is free of
// bank conflicts (a half-warp's 16 float2 fall into 16 distinct bank pairs);
// the split step's digit-reversed reads conflict at most 2-way.
//
// `kernels/fft.py` mirrors this decomposition step by step in PyTorch.

#pragma once

#include <cuda_runtime.h>

namespace tvc_fft {
namespace {

constexpr int MAX_NFFT = 2048;
constexpr int MAX_PASSES = 12;

struct Plan {
  int m;                          // complex points, n_fft / 2
  int n_pass;
  int radix[MAX_PASSES];
  int span[MAX_PASSES];           // S_p
  int tw_off[MAX_PASSES];         // pass p's (r-1)*S twiddles in the shared table
  unsigned nb_magic[MAX_PASSES];  // ceil(2^32 / blocks of pass p), for blocks > 1
  unsigned radix_magic[MAX_PASSES];  // ceil(2^32 / r_p)
  unsigned span_magic[MAX_PASSES];   // ceil(2^32 / S_p), for S_p > 1
  int split_off;                  // W_N^k, k = 0..M/2
  int n_tw;                       // shared twiddle entries
  unsigned pad_magic;             // ceil(2^32 / (2*S_0))
  int frame_elems;                // padded float2 elements of one frame
};

// ceil(2^32 / d); floor(i / d) = __umulhi(i, magic) exactly for i * d < 2^32.
inline unsigned div_magic(int d) {
  return static_cast<unsigned>((0x100000000ull + static_cast<unsigned long long>(d) - 1) /
                               static_cast<unsigned long long>(d));
}

// False unless n_fft is even, 4 <= n_fft <= 2048 and n_fft / 2 has no prime
// factor but 2, 3 and 5 (fft.py::check_n_fft, fft_radices).
inline bool make_plan(int n_fft, Plan* p) {
  if (n_fft < 4 || n_fft % 2 != 0 || n_fft > MAX_NFFT) return false;
  const int m = n_fft / 2;
  int rest = m, twos = 0, threes = 0, fives = 0;
  while (rest % 2 == 0) { rest /= 2; ++twos; }
  while (rest % 3 == 0) { rest /= 3; ++threes; }
  while (rest % 5 == 0) { rest /= 5; ++fives; }
  if (rest != 1) return false;
  int n = 0;
  for (; twos >= 3; twos -= 3) p->radix[n++] = 8;
  if (twos == 2) p->radix[n++] = 4;
  if (twos == 1) p->radix[n++] = 2;
  for (; threes > 0 && fives > 0; --threes, --fives) p->radix[n++] = 15;
  for (; threes > 0; --threes) p->radix[n++] = 3;
  for (; fives > 0; --fives) p->radix[n++] = 5;
  p->m = m;
  p->n_pass = n;
  int span = m, off = 0;
  for (int s = 0; s < n; ++s) {
    const int blocks = m / span;
    span /= p->radix[s];
    p->span[s] = span;
    p->tw_off[s] = off;
    p->nb_magic[s] = blocks > 1 ? div_magic(blocks) : 0u;
    p->radix_magic[s] = div_magic(p->radix[s]);
    p->span_magic[s] = span > 1 ? div_magic(span) : 0u;
    off += (p->radix[s] - 1) * span;
  }
  p->split_off = off;
  p->n_tw = off + m / 2 + 1;
  const int pad_every = n > 1 ? 2 * p->span[0] : m;
  p->pad_magic = div_magic(pad_every);
  p->frame_elems = (m - 1) + 2 * ((m - 1) / pad_every) + 1;
  return true;
}

// Dynamic shared memory of a block with `frames` frame buffers: the twiddles,
// the frames, then the bin positions (unsigned short each).
inline size_t smem_bytes(const Plan& p, int frames) {
  return (static_cast<size_t>(p.n_tw) + static_cast<size_t>(frames) * p.frame_elems) *
             sizeof(float2) +
         static_cast<size_t>(p.m) * sizeof(unsigned short);
}

__device__ __forceinline__ int udiv(int i, unsigned magic) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(i), magic));
}

__device__ __forceinline__ int pad_index(int i, const Plan& p) {
  return i + 2 * udiv(i, p.pad_magic);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a * conj(w)
__device__ __forceinline__ float2 cmulc(float2 a, float2 w) {
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}
// -i * a
__device__ __forceinline__ float2 mul_negi(float2 a) { return make_float2(a.y, -a.x); }

constexpr float kSqrtHalf = 0.70710678118654752440f;  // cos(pi/4)
constexpr float kSin60 = 0.86602540378443864676f;     // sin(2pi/3)
constexpr float kCos72 = 0.30901699437494742410f;     // cos(2pi/5)
constexpr float kCos144 = -0.80901699437494742410f;   // cos(4pi/5)
constexpr float kSin72 = 0.95105651629515357212f;     // sin(2pi/5)
constexpr float kSin144 = 0.58778525229247312917f;    // sin(4pi/5)

// Forward DFTs (W_r = exp(-2 pi i / r)) in registers, in place.
__device__ __forceinline__ void dft2(float2* a) {
  const float2 t = a[1];
  a[1] = csub(a[0], t);
  a[0] = cadd(a[0], t);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = mul_negi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

__device__ __forceinline__ void dft3(float2& a0, float2& a1, float2& a2) {
  const float2 s = cadd(a1, a2), d = csub(a1, a2);
  const float2 t = make_float2(a0.x - 0.5f * s.x, a0.y - 0.5f * s.y);
  a0 = cadd(a0, s);
  a1 = make_float2(t.x + kSin60 * d.y, t.y - kSin60 * d.x);
  a2 = make_float2(t.x - kSin60 * d.y, t.y + kSin60 * d.x);
}

__device__ __forceinline__ void dft5(float2& a0, float2& a1, float2& a2, float2& a3,
                                     float2& a4) {
  const float2 t1 = cadd(a1, a4), t2 = cadd(a2, a3), t3 = csub(a1, a4), t4 = csub(a2, a3);
  const float2 m1 = make_float2(a0.x + kCos72 * t1.x + kCos144 * t2.x,
                                a0.y + kCos72 * t1.y + kCos144 * t2.y);
  const float2 m2 = make_float2(a0.x + kCos144 * t1.x + kCos72 * t2.x,
                                a0.y + kCos144 * t1.y + kCos72 * t2.y);
  const float2 n1 = make_float2(kSin72 * t3.x + kSin144 * t4.x, kSin72 * t3.y + kSin144 * t4.y);
  const float2 n2 = make_float2(kSin144 * t3.x - kSin72 * t4.x, kSin144 * t3.y - kSin72 * t4.y);
  a0 = cadd(a0, cadd(t1, t2));
  a1 = cadd(m1, mul_negi(n1));  // m1 - i n1
  a4 = csub(m1, mul_negi(n1));
  a2 = cadd(m2, mul_negi(n2));
  a3 = csub(m2, mul_negi(n2));
}

__device__ __forceinline__ void dft8(float2* a) {
  float2 b[4], c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b[k] = cadd(a[k], a[k + 4]);
    c[k] = csub(a[k], a[k + 4]);
  }
  c[1] = make_float2((c[1].x + c[1].y) * kSqrtHalf, (c[1].y - c[1].x) * kSqrtHalf);  // * W_8
  c[2] = mul_negi(c[2]);                                                             // * W_8^2
  c[3] = make_float2((c[3].y - c[3].x) * kSqrtHalf, -(c[3].x + c[3].y) * kSqrtHalf);  // * W_8^3
  dft4(b[0], b[1], b[2], b[3]);
  dft4(c[0], c[1], c[2], c[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[2 * k] = b[k];
    a[2 * k + 1] = c[k];
  }
}

// Good-Thomas: input (5*n1 + 3*n2) mod 15, DFT-3 over n1, DFT-5 over n2,
// output (10*k1 + 6*k2) mod 15.
__device__ __forceinline__ void dft15(float2* a) {
  float2 t[3][5];
#pragma unroll
  for (int n2 = 0; n2 < 5; ++n2) {
    t[0][n2] = a[(3 * n2) % 15];
    t[1][n2] = a[(5 + 3 * n2) % 15];
    t[2][n2] = a[(10 + 3 * n2) % 15];
    dft3(t[0][n2], t[1][n2], t[2][n2]);
  }
#pragma unroll
  for (int k1 = 0; k1 < 3; ++k1) {
    dft5(t[k1][0], t[k1][1], t[k1][2], t[k1][3], t[k1][4]);
#pragma unroll
    for (int k2 = 0; k2 < 5; ++k2) a[(10 * k1 + 6 * k2) % 15] = t[k1][k2];
  }
}

template <int R>
__device__ __forceinline__ void dft(float2* a) {
  if constexpr (R == 2) {
    dft2(a);
  } else if constexpr (R == 3) {
    dft3(a[0], a[1], a[2]);
  } else if constexpr (R == 4) {
    dft4(a[0], a[1], a[2], a[3]);
  } else if constexpr (R == 5) {
    dft5(a[0], a[1], a[2], a[3], a[4]);
  } else if constexpr (R == 8) {
    dft8(a);
  } else {
    static_assert(R == 15, "radix 2, 3, 4, 5, 8 or 15");
    dft15(a);
  }
}

// The conjugate DFT, sum_m a_m W_r^(-q*m): conj(DFT(conj a)).
template <int R>
__device__ __forceinline__ void idft(float2* a) {
#pragma unroll
  for (int q = 0; q < R; ++q) a[q].y = -a[q].y;
  dft<R>(a);
#pragma unroll
  for (int q = 0; q < R; ++q) a[q].y = -a[q].y;
}

// Butterfly b of pass s -> (block c, offset j). The first pass has one
// block, the last span 1; in between, consecutive lanes take consecutive
// blocks (the c-fast order that keeps the padded frame free of conflicts).
__device__ __forceinline__ void butterfly_at(const Plan& p, int s, int b, int blocks, int& c,
                                             int& j) {
  const int span = p.span[s];
  if (blocks == 1) {
    c = 0;
    j = b;
  } else if (span == 1) {
    c = b;
    j = 0;
  } else {
    j = udiv(b, p.nb_magic[s]);
    c = b - j * blocks;
  }
}

template <int R>
__device__ void forward_pass(float2* buf, const float2* tw, const Plan& p, int s, int lane) {
  const int span = p.span[s], len = R * span, blocks = p.m / len;
  for (int b = lane; b < p.m / R; b += 32) {
    int c, j;
    butterfly_at(p, s, b, blocks, c, j);
    const int base = c * len + j;
    float2 a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = buf[pad_index(base + q * span, p)];
    dft<R>(a);
    if (span > 1) {
      const float2* t = tw + p.tw_off[s] + j;
#pragma unroll
      for (int q = 1; q < R; ++q) a[q] = cmul(a[q], t[(q - 1) * span]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) buf[pad_index(base + q * span, p)] = a[q];
  }
}

template <int R>
__device__ void inverse_pass(float2* buf, const float2* tw, const Plan& p, int s, int lane) {
  const int span = p.span[s], len = R * span, blocks = p.m / len;
  for (int b = lane; b < p.m / R; b += 32) {
    int c, j;
    butterfly_at(p, s, b, blocks, c, j);
    const int base = c * len + j;
    float2 a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = buf[pad_index(base + q * span, p)];
    if (span > 1) {
      const float2* t = tw + p.tw_off[s] + j;
#pragma unroll
      for (int q = 1; q < R; ++q) a[q] = cmulc(a[q], t[(q - 1) * span]);
    }
    idft<R>(a);
#pragma unroll
    for (int q = 0; q < R; ++q) buf[pad_index(base + q * span, p)] = a[q];
  }
}

// The warp's frame `buf` (natural order) -> its DFT at ptab positions.
__device__ void fft_forward(float2* buf, const float2* tw, const Plan& p, int lane) {
  for (int s = 0; s < p.n_pass; ++s) {
    switch (p.radix[s]) {
      case 2: forward_pass<2>(buf, tw, p, s, lane); break;
      case 3: forward_pass<3>(buf, tw, p, s, lane); break;
      case 4: forward_pass<4>(buf, tw, p, s, lane); break;
      case 5: forward_pass<5>(buf, tw, p, s, lane); break;
      case 8: forward_pass<8>(buf, tw, p, s, lane); break;
      default: forward_pass<15>(buf, tw, p, s, lane); break;
    }
    __syncwarp();
  }
}

// The warp's spectrum `buf` (at ptab positions) -> sum_k Z[k] W_M^(-n*k) in
// natural order.
__device__ void fft_inverse(float2* buf, const float2* tw, const Plan& p, int lane) {
  for (int s = p.n_pass - 1; s >= 0; --s) {
    switch (p.radix[s]) {
      case 2: inverse_pass<2>(buf, tw, p, s, lane); break;
      case 3: inverse_pass<3>(buf, tw, p, s, lane); break;
      case 4: inverse_pass<4>(buf, tw, p, s, lane); break;
      case 5: inverse_pass<5>(buf, tw, p, s, lane); break;
      case 8: inverse_pass<8>(buf, tw, p, s, lane); break;
      default: inverse_pass<15>(buf, tw, p, s, lane); break;
    }
    __syncwarp();
  }
}

// The block's shared tables, from the wrapper's cos and sin tables of n_fft
// entries: W^m = (cos_tab[m], sin_sign * sin_tab[m]) = exp(-2 pi i m / N)
// (sin_sign +1 for a table of -sin, -1 for one of sin). Pass p's entry
// (q-1)*S + j is W_L^(j*q) = W^(j*q*N/L) (j*q < L: no wrap); then W^k,
// k <= M/2; then ptab[k], the padded position of bin k.
__device__ void load_tables(float2* tw, unsigned short* ptab, const float* cos_tab,
                            const float* sin_tab, float sin_sign, const Plan& p, int tid,
                            int nthreads) {
  const int n = 2 * p.m;
  for (int s = 0; s < p.n_pass; ++s) {
    const int r = p.radix[s], span = p.span[s], step = n / (r * span);
    for (int e = tid; e < (r - 1) * span; e += nthreads) {
      const int q = (span > 1 ? udiv(e, p.span_magic[s]) : e) + 1, j = e - (q - 1) * span;
      const int idx = j * q * step;
      tw[p.tw_off[s] + e] = make_float2(cos_tab[idx], sin_sign * sin_tab[idx]);
    }
  }
  for (int k = tid; k <= p.m / 2; k += nthreads)
    tw[p.split_off + k] = make_float2(cos_tab[k], sin_sign * sin_tab[k]);
  for (int k = tid; k < p.m; k += nthreads) {
    int rest = k, pos = 0;
    for (int s = 0; s < p.n_pass; ++s) {
      const int next = udiv(rest, p.radix_magic[s]);
      pos += (rest - next * p.radix[s]) * p.span[s];
      rest = next;
    }
    ptab[k] = static_cast<unsigned short>(pad_index(pos, p));
  }
}

}  // namespace
}  // namespace tvc_fft
