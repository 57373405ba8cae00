// The pieces of kernels K and L (filter_stage_bwd.cu): the operand reader
// that both routes share, and the tiles of the bf16 route.
//
// The bf16 route works on position-major bf16 copies [B][E][cp] of every
// tensor a product reads (cp = C rounded up to 8, one 16-byte ldmatrix row
// a position; channels [C, cp) hold zeros), each holding the value the TPU
// rounds (after the leaky ReLU where the product applies one). The launch that produces a value writes
// its copy in its epilogue; a first launch of the call (`prep`) writes the
// copies of the chain's inputs and packs the weights. A copy is defined on
// its own range of positions [lo, hi): its other rows are never written,
// and every tile zero-fills what lies outside a range instead of reading it.
// In this layout tap k of a dilation-d conv is a row offset of k d.
//
// The products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 sums, mma.cuh) with K counted in units of one tap and 8 input
// channels (16 bytes of one row): a unit's ldmatrix rows are the staged
// positions shifted by its tap, at its 8 channels, so any tap count and
// any channel count feeds a k16 step of two units (the packed weights are
// zero at the copies' padded channels).
//   - The conv tile (`tc_conv`): M = output channels (32, 48 or 64 rows a
//     block: whichever covers the rows with the least padding), N =
//     positions of one batch row (256 or 128 a block), K = taps x cp. A
//     block stages its weight rows and the span of positions it reads once,
//     then runs every k16 step; the elementwise steps stay fp32 in its
//     epilogue: bias, leaky-ReLU mask from the fp32 pre-activation, residual
//     add, FiLM (keeping u), the FiLM's gradient (gu = gr s, gs = gr u, gt =
//     gr), the bf16 copy the next product reads, the per-block sums of the
//     bias gradients, and the input gradient's own rows written straight
//     into the output with the pad's columns set aside for the fold.
//   - The weight-gradient tile (`tc_wgrad`): gw[o][k cin + i] = sum over the
//     product's positions of g[o][e] f(a)[i][e + (k - (K-1)/2) d], M = o, N =
//     units (ordered channel octet by octet, the taps of one octet side by
//     side, so a block stages few channels), K = positions. Both fragments
//     by ldmatrix.trans from the copies. A block sums one split of the
//     product's (batch row, 128-position chunk) list, the 4 warps taking a
//     quarter of each chunk's positions, two chunks in flight; the warps'
//     sums are added in warp order and each block writes its own partial.
//   - `finish` adds the partials (weights and biases) in a fixed order and
//     folds the pad's gradient onto the end samples; no float atomics, so
//     two calls give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "mma.cuh"

namespace {

// A [B, rows, rstride] operand read at extended column e (t = e - off):
// outside [0, len) the edge value (zero == 0, the chain input's edge
// replication) or 0 (zero != 0, a tensor defined only on a range).
struct Src {
  const void* p;
  long long bstride;
  int rstride;
  int off;
  int len;
  int zero;
  int bf16;
};

__device__ __forceinline__ float src_at(const Src& s, int b, int row, int col) {
  int t = col - s.off;
  if (t < 0 || t >= s.len) {
    if (s.zero) return 0.f;
    t = t < 0 ? 0 : s.len - 1;
  }
  const long long i = b * s.bstride + static_cast<long long>(row) * s.rstride + t;
  return s.bf16 ? to_f32(static_cast<const __nv_bfloat16*>(s.p)[i])
                : static_cast<const float*>(s.p)[i];
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

// ===========================================================================
// The bf16 route
// ===========================================================================
constexpr int TC_THREADS = 128;  // 4 warps a block
constexpr int TC_CHUNK = 128;    // positions a weight-gradient stage
                                 // (kernels/filter_stage.py::TC_CHUNK)
constexpr int TC_POS = 128;      // positions a prep block; bias partials are
                                 // sized for blocks of at least this many
constexpr int TC_STAGES = 3;     // weight-gradient chunks in flight (3 beat 2 on the H100)

__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// halves of a staged row of `halves` (a multiple of 8): an odd number of
// 16-byte pieces, so that ldmatrix's eight rows fall on distinct banks
__host__ __device__ constexpr int row_stride(int halves) {
  return (halves / 8) % 2 ? halves : halves + 8;
}

// m16 tiles of a block's rows: 2, 3 or 4 (32, 48 or 64 rows), the fewest
// padded rows, then the most rows a block (kernels/filter_stage.py::_tc_mt)
inline int tc_mt(int rows) {
  int best = 4, padded = cdiv(rows, 64) * 64;
  for (int mt = 3; mt >= 2; --mt) {
    const int p = cdiv(rows, 16 * mt) * 16 * mt;
    if (p < padded) {
      padded = p;
      best = mt;
    }
  }
  return best;
}

// n8 tiles a warp of a weight-gradient block, whose warps share its whole
// tile
__host__ __device__ constexpr int wgrad_nt(int mt) { return mt == 2 ? 10 : 6; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// The conv tile
// ---------------------------------------------------------------------------
enum TcEpilogue { TC_STORE = 0, TC_FILM = 1, TC_FILMGRAD = 2, TC_GX = 3 };

// out[o][e] = sum_(k, i) w[o][k cp + i] in[e + (k - (taps-1)/2) d][i] over e
// in [lo, hi) of each batch row, then the epilogue; v below is that sum.
struct TcConv {
  const __nv_bfloat16* in;  // [B][E][cin_p], defined on [in_lo, in_hi)
  int cin_p, in_lo, in_hi;
  const __nv_bfloat16* w;   // [co][kp], kp = taps cin_p rounded up to 16
  int kp, taps, d, co;
  int E, lo, hi;
  const float* bias;        // [co] or null: v += bias
  int ep;
  Src m, add;               // v *= (m > 0 ? 1 : 0.1) (has_m); v += add (has_add)
  int has_m, has_add;
  Src s, t, res, u;         // TC_FILM: r = v s + t + res; TC_FILMGRAD: s, u
  float* out;               // fp32 [B][co][E]: v, or null
  float* out2;              // TC_FILM: r, or null
  // the copy [B][E][pad8(co)] of v (TC_STORE), of r (TC_FILM), of gu = v s
  // (TC_FILMGRAD); its leaky ReLU with act; or null. Rows [co, pad8(co))
  // get zeros.
  __nv_bfloat16* cp0;
  int act;
  // TC_FILMGRAD: gs = v u and gt = v into rows cp1_row + o and cp1_row +
  // pad8(co) + o of [B][E][cp1_c], zeros likewise
  __nv_bfloat16* cp1;
  int cp1_c, cp1_row;
  float* bp0;               // [B tiles][co]: each block's sums of cp0's value
  float* bp1;               // TC_FILMGRAD: [B tiles][2 co], of gs, then gt
  // TC_GX: v into gx [B][co][gx_stride] at t = e - R for t in [0, T), the
  // pad's columns into edges [B][co][2R] (e, or e - T right of the input)
  float* gx;
  float* edges;
  int gx_stride, R, T;
};

// n8 tiles a warp of a conv block, whose 4 warps sit side by side along
// the positions (BN = 32 NT). On the H100 the FiLM, FiLM-gradient and
// input-gradient convs ran faster at 128 positions a block (more blocks an
// SM in their shared memory and registers), the plain ones at 256 with 32
// rows.
__host__ __device__ constexpr int conv_nt(int mt, int ep) {
  return mt == 2 && ep == TC_STORE ? 8 : 4;
}

// shared memory of a conv block: the weight rows, the staged positions and
// the units' offsets; then the epilogue's sums and copies
inline int conv_smem(int mt, const TcConv& c) {
  const int bm = 16 * mt, bn = 32 * conv_nt(mt, c.ep);
  const int span = bn + (c.taps - 1) / 2 * c.d * 2;
  const int operands =
      2 * (bm * row_stride(c.kp) + span * row_stride(c.cin_p)) + 4 * (c.kp / 8);
  const int ncp = (c.cp0 ? 1 : 0) + (c.ep == TC_FILMGRAD ? 2 : 0);
  const int epilogue = 4 * bm * (bn + 4) + 2 * ncp * bn * (bm + 8);
  return operands > epilogue ? operands : epilogue;
}

template <int MT, int NT>
__device__ __forceinline__ void tc_conv(const TcConv& c) {
  constexpr int BM = 16 * MT, BN = 32 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, m0 = blockIdx.y * BM, p0 = c.lo + blockIdx.x * BN;
  const int half = (c.taps - 1) / 2 * c.d, span = BN + 2 * half;
  const int ws = row_stride(c.kp), xs = row_stride(c.cin_p);
  const int kp8 = c.kp / 8, cp8 = c.cin_p / 8;
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][ws]
  __nv_bfloat16* sx = sw + BM * ws;                             // [span][xs]
  int* uoff = reinterpret_cast<int*>(sx + span * xs);           // [kp8]

  for (int e = tid; e < BM * kp8; e += TC_THREADS) {
    const int r = e / kp8, k8 = e - r * kp8;
    const bool ok = m0 + r < c.co;
    cp_async16(sw + r * ws + 8 * k8,
               ok ? c.w + static_cast<long long>(m0 + r) * c.kp + 8 * k8 : c.w, ok);
  }
  const __nv_bfloat16* in = c.in + static_cast<long long>(b) * c.E * c.cin_p;
  for (int e = tid; e < span * cp8; e += TC_THREADS) {
    const int r = e / cp8, k8 = e - r * cp8;
    const int p = p0 - half + r;
    const bool ok = p >= c.in_lo && p < c.in_hi;
    cp_async16(sx + r * xs + 8 * k8, ok ? in + static_cast<long long>(p) * c.cin_p + 8 * k8 : c.in,
               ok);
  }
  cp_async_commit();
  for (int u = tid; u < kp8; u += TC_THREADS) {  // unit u: tap u / cp8, channels 8 (u % cp8)
    const int k = u / cp8;
    uoff[u] = k < c.taps ? k * c.d * xs + 8 * (u - k * cp8) : 0;  // past the units: weight 0
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  // ldmatrix x4, matrix sel = lane / 8: A (row-major weights) matrices (m,
  // k), (m + 8, k), (m, k + 8), (m + 8, k + 8); B (positions x channels)
  // matrices (n, unit 2ks), (n, unit 2ks + 1), (n + 8, 2ks), (n + 8, 2ks + 1)
  const int r8 = lane & 7, sel = lane >> 3;
  const __nv_bfloat16* arow = sw + (r8 + 8 * (sel & 1)) * ws + 8 * (sel >> 1);
  const __nv_bfloat16* brow = sx + (warp * NT * 8 + r8 + 8 * (sel >> 1)) * xs;
  for (int ks = 0; ks < kp8 / 2; ++ks) {
    uint32_t a[MT][4], bf[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], arow + mt * 16 * ws + 16 * ks);
    const __nv_bfloat16* bk = brow + uoff[2 * ks + (sel & 1)];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, bk + np * 16 * xs);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[nt]);
  }

  // The epilogue, through shared memory: the sums to so [BM][BN + 4] fp32;
  // pass 1, a warp RB rows at a time, lanes along the positions (coalesced
  // fp32 loads and stores, each operand's loads issued together), the bias
  // sums by a fixed xor tree, the copies' values to sc [copy][BN][BM + 8]
  // bf16; pass 2, the copies out in 16-byte rows.
  constexpr int OS = BN + 4, CS = BM + 8, PL = BN / 32;
  constexpr int RB = 2;  // rows a batch (4 measured slower on the H100)
  static_assert(BM % (RB * TC_THREADS / 32) == 0, "the warps take the rows in batches");
  const int ncp = (c.cp0 ? 1 : 0) + (c.ep == TC_FILMGRAD ? 2 : 0);
  float* so = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(so + BM * OS);
  __syncthreads();  // every warp is done with the staged operands
  {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = mt * 16 + g, col = warp * NT * 8 + nt * 8 + 2 * t4;
        so[r * OS + col] = acc[mt][nt][0];
        so[r * OS + col + 1] = acc[mt][nt][1];
        so[(r + 8) * OS + col] = acc[mt][nt][2];
        so[(r + 8) * OS + col + 1] = acc[mt][nt][3];
      }
  }
  __syncthreads();
  const long long tile = static_cast<long long>(b) * gridDim.x + blockIdx.x;
  for (int r0 = RB * warp; r0 < BM; r0 += RB * (TC_THREADS / 32)) {
    float v[RB][PL], x[RB][PL], y[RB][PL], z[RB][PL];
    bool ok[RB][PL];
    int e[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) e[i] = p0 + lane + 32 * i;
#pragma unroll
    for (int h = 0; h < RB; ++h) {
      const int r = r0 + h, o = m0 + r;
      const float bias = c.bias && o < c.co ? c.bias[o] : 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        ok[h][i] = o < c.co && e[i] < c.hi;
        v[h][i] = so[r * OS + lane + 32 * i] + bias;
      }
    }
    auto load = [&](const Src& src, float (&dst)[RB][PL]) {
#pragma unroll
      for (int h = 0; h < RB; ++h)
#pragma unroll
        for (int i = 0; i < PL; ++i) dst[h][i] = ok[h][i] ? src_at(src, b, m0 + r0 + h, e[i]) : 0.f;
    };
    if (c.has_m || c.has_add) {
      if (c.has_m) load(c.m, x);
      if (c.has_add) load(c.add, y);
#pragma unroll
      for (int h = 0; h < RB; ++h)
#pragma unroll
        for (int i = 0; i < PL; ++i) {
          if (c.has_m) v[h][i] *= x[h][i] > 0.f ? 1.f : 0.1f;
          if (c.has_add) v[h][i] += y[h][i];
        }
    }
    if (c.ep == TC_FILM) {
      load(c.s, x);
      load(c.t, y);
      load(c.res, z);
    } else if (c.ep == TC_FILMGRAD) {
      load(c.s, x);
      load(c.u, y);
    }
#pragma unroll
    for (int h = 0; h < RB; ++h) {
      const int r = r0 + h, o = m0 + r;
      const long long row = static_cast<long long>(b) * c.co + o;
      float bs[3] = {0.f, 0.f, 0.f};  // bias sums: cp0's value; TC_FILMGRAD gs, gt
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int col = lane + 32 * i;
        float cv = v[h][i], gs = 0.f;
        if (c.ep == TC_FILM) cv = v[h][i] * x[h][i] + y[h][i] + z[h][i];
        if (c.ep == TC_FILMGRAD) {
          gs = v[h][i] * y[h][i];
          cv = v[h][i] * x[h][i];
        }
        if (ok[h][i]) {
          if (c.out) c.out[row * c.E + e[i]] = v[h][i];
          if (c.out2) c.out2[row * c.E + e[i]] = cv;
          if (c.ep == TC_GX) {
            const int t = e[i] - c.R;
            if (t >= 0 && t < c.T) c.gx[row * c.gx_stride + t] = v[h][i];
            else c.edges[row * 2 * c.R + (t < 0 ? e[i] : e[i] - c.T)] = v[h][i];
          }
          bs[0] += cv;
          bs[1] += gs;
          bs[2] += v[h][i];
        }
        if (c.cp0) sc[col * CS + r] = __float2bfloat16_rn(c.act ? lrelu(cv) : cv);
        if (c.ep == TC_FILMGRAD) {
          sc[(BN + col) * CS + r] = __float2bfloat16_rn(gs);
          sc[(2 * BN + col) * CS + r] = __float2bfloat16_rn(v[h][i]);
        }
      }
      if (c.bp0) {
        const float s0 = warp_sum(bs[0]);
        if (lane == 0 && o < c.co) c.bp0[tile * c.co + o] = s0;
      }
      if (c.bp1) {
        const float s1 = warp_sum(bs[1]), s2 = warp_sum(bs[2]);
        if (lane == 0 && o < c.co) {
          c.bp1[tile * 2 * c.co + o] = s1;
          c.bp1[tile * 2 * c.co + c.co + o] = s2;
        }
      }
    }
  }
  if (ncp == 0) return;
  __syncthreads();
  // pass 2: copy k's rows [m0, m0 + BM) of each position below pad8(co), 8
  // channels a thread (the rows from co on hold zeros: their weights are
  // zero-filled and their epilogue operands read as 0)
  const int cop = pad8(c.co);
  for (int i = tid; i < ncp * BN * (BM / 8); i += TC_THREADS) {
    const int k = i / (BN * (BM / 8)), rem = i - k * (BN * (BM / 8));
    const int col = rem / (BM / 8), q = rem - col * (BM / 8);
    const int o = m0 + 8 * q, e = p0 + col;
    if (o >= cop || e >= c.hi) continue;
    const int kk = c.cp0 ? k : k + 1;  // 0: cp0, 1: gs, 2: gt
    __nv_bfloat16* dst = kk == 0 ? c.cp0 + (static_cast<long long>(b) * c.E + e) * cop + o
                                 : c.cp1 + (static_cast<long long>(b) * c.E + e) * c.cp1_c +
                                       c.cp1_row + (kk - 1) * cop + o;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(sc + (k * BN + col) * CS + 8 * q);
  }
}

// ---------------------------------------------------------------------------
// The weight-gradient tile
// ---------------------------------------------------------------------------
// partial[split][o][k cin + i] = sum over the split's positions e of
// g[e][m(o)] a[e + (k - (taps-1)/2) d][i], m(o) = o, or for rows in groups
// of rg (the FiLM rows) (o / rg) rgp + o % rg: split `split` of the product's
// chunk list (batch row b, positions lo + [c, c + 1) TC_CHUNK cut at hi),
// chunks [split n / splits, (split + 1) n / splits) of its n, batch row by
// batch row (kernels/filter_stage.py::wgrad_split_chunks).
struct TcWgrad {
  const __nv_bfloat16* g;  // [B][E][gc], defined on [lo, hi)
  int gc, co;
  int gm, rg, rgp;         // M: g's channels [0, gm); rows rg of every rgp
  const __nv_bfloat16* a;  // [B][E][ac], defined on [a_lo, a_hi)
  int ac, a_lo, a_hi, cin, taps, d;
  int B, E, lo, hi, splits;
  float* partial;          // [splits][co][taps cin]
};

// the most channel octets a block of NT units stages
__host__ __device__ constexpr int wgrad_octets(int nt, int taps, int ac) {
  return (nt - 1) / taps + 2 < ac / 8 ? (nt - 1) / taps + 2 : ac / 8;
}

inline int wgrad_smem(int mt, const TcWgrad& w) {
  const int nt = wgrad_nt(mt);
  const int span = TC_CHUNK + (w.taps - 1) / 2 * w.d * 2;
  const int stage = TC_CHUNK * row_stride(16 * mt) + span * row_stride(8 * wgrad_octets(nt, w.taps, w.ac));
  const int pipe = 2 * TC_STAGES * stage, red = 4 * 16 * mt * 8 * nt;
  return pipe > red ? pipe : red;
}

template <int MT, int NT>
__device__ __forceinline__ void tc_wgrad(const TcWgrad& w) {
  constexpr int BM = 16 * MT, BN = 8 * NT;
  constexpr int GS = row_stride(BM);
  static_assert(NT % 2 == 0, "units come in ldmatrix pairs");
  static_assert(TC_CHUNK == 32 * 4, "a warp takes two k16 steps of a chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = w.taps * (w.ac / 8);
  const int nnb = cdiv(units, NT);
  const int mb = blockIdx.x / nnb, nb = blockIdx.x - mb * nnb;
  const int m0 = mb * BM, u0 = nb * NT;
  const int oct_lo = u0 / w.taps;
  const int nch8 = (min(u0 + NT, units) - 1) / w.taps - oct_lo + 1;  // octets staged
  const int half = (w.taps - 1) / 2 * w.d, span = TC_CHUNK + 2 * half;
  const int as = row_stride(8 * nch8);
  const int stage = TC_CHUNK * GS + span * as;  // halves
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int per_b = cdiv(w.hi - w.lo, TC_CHUNK);
  const long long total = static_cast<long long>(w.B) * per_b;
  const int first = static_cast<int>(blockIdx.y * total / w.splits);
  const int nchunk = static_cast<int>((blockIdx.y + 1) * total / w.splits) - first;

  // chunk `first + k` into buffer `buf`: g's rows (zero past the chunk's
  // end and past g's channels), a's span (zero outside its range). One
  // cp.async group.
  auto issue = [&](int k, int buf) {
    const int c = first + k, b = c / per_b;
    const int e0 = w.lo + (c - b * per_b) * TC_CHUNK, e1 = min(e0 + TC_CHUNK, w.hi);
    __nv_bfloat16* sg = stages + buf * stage;
    __nv_bfloat16* sa = sg + TC_CHUNK * GS;
    const __nv_bfloat16* grow = w.g + static_cast<long long>(b) * w.E * w.gc;
    for (int e = tid; e < TC_CHUNK * (BM / 8); e += TC_THREADS) {
      const int r = e / (BM / 8), ch = m0 + 8 * (e - r * (BM / 8));
      const bool ok = e0 + r < e1 && ch < w.gc;
      cp_async16(sg + r * GS + ch - m0, ok ? grow + static_cast<long long>(e0 + r) * w.gc + ch : w.g,
                 ok);
    }
    const __nv_bfloat16* arow = w.a + static_cast<long long>(b) * w.E * w.ac;
    for (int e = tid; e < span * nch8; e += TC_THREADS) {
      const int r = e / nch8, k8 = e - r * nch8;
      const int p = e0 - half + r;
      const bool ok = p >= w.a_lo && p < w.a_hi;
      cp_async16(sa + r * as + 8 * k8,
                 ok ? arow + static_cast<long long>(p) * w.ac + 8 * (oct_lo + k8) : w.a, ok);
    }
    cp_async_commit();
  };

  // ldmatrix.trans x4, matrix sel = lane / 8: A (g, positions x rows)
  // matrices (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8); B (a, positions
  // x channels) matrices (k, unit 2np), (k + 8, 2np), (k, 2np + 1), (k + 8,
  // 2np + 1), each unit its tap's row offset and its octet's column
  const int r8 = lane & 7, sel = lane >> 3;
  int boff[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    const int u = u0 + 2 * np + (sel >> 1);
    const int oct = u / w.taps, k = u - oct * w.taps;
    boff[np] = u < units ? k * w.d * as + 8 * (oct - oct_lo) : 0;  // past the units: discarded
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  auto compute = [&](int buf) {
    const __nv_bfloat16* sg = stages + buf * stage;
    const __nv_bfloat16* sa = sg + TC_CHUNK * GS;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k0 = 32 * warp + 16 * kk;
      uint32_t a[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(a[mt], sg + (k0 + r8 + 8 * (sel >> 1)) * GS + mt * 16 + 8 * (sel & 1));
      const __nv_bfloat16* bk = sa + (k0 + r8 + 8 * (sel & 1)) * as;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bk + boff[np]);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[nt]);
    }
  };

  // chunk k's copies were issued TC_STAGES - 1 chunks earlier (one group a
  // chunk, empty past the end)
#pragma unroll
  for (int k = 0; k < TC_STAGES - 1; ++k)
    if (k < nchunk) issue(k, k);
    else cp_async_commit();
  for (int k = 0; k < nchunk; ++k) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // chunk k is in; chunk k - 1's products are done
    const int ahead = k + TC_STAGES - 1;
    if (ahead < nchunk) issue(ahead, ahead % TC_STAGES);
    else cp_async_commit();
    compute(k % TC_STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums, added in warp order into [BM][BN]
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
  for (int w2 = 0; w2 < 4; ++w2) {
    if (warp == w2) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float& dst = red[(mt * 16 + g + 8 * (r >> 1)) * BN + nt * 8 + 2 * t4 + (r & 1)];
            dst = (w2 ? dst : 0.f) + acc[mt][nt][r];
          }
    }
    __syncthreads();
  }
  const int ncols = w.taps * w.cin;
  float* out = w.partial + static_cast<long long>(blockIdx.y) * w.co * ncols;
  for (int i = tid; i < BM * BN; i += TC_THREADS) {
    const int r = i / BN, col = i - r * BN;
    const int m = m0 + r, u = u0 + col / 8, grp = m / w.rgp;
    if (m >= w.gm || m - grp * w.rgp >= w.rg || u >= units) continue;
    const int o = m - grp * (w.rgp - w.rg);
    const int oct = u / w.taps, k = u - oct * w.taps, ch = 8 * oct + col % 8;
    if (ch < w.cin) out[static_cast<long long>(o) * ncols + k * w.cin + ch] = red[i];
  }
}

// ---------------------------------------------------------------------------
// prep: the chain inputs' copies and the packed weights, one launch
// ---------------------------------------------------------------------------
// dst[b][e][r] = f(src(b, r, e)) for e in [lo, hi), 0 for r in [rows, cp);
// f = leaky ReLU with act; bp[b tiles + tile][r] = the block's sum of the
// fp32 values, or null. A block: TC_POS positions of one batch row.
struct CopyJob {
  Src src;
  int rows, act;
  __nv_bfloat16* dst;
  int cp, E, lo, hi, tiles;
  float* bp;
};

// wp[o][k cin_p + i] = w[off + o so + k sk + i si] (i < cin), 0 elsewhere
// in [co][kp], rounded to nearest even: the strides read a transposed conv's
// weights (its taps reversed) from the forward's in place
struct PackJob {
  const float* w;
  __nv_bfloat16* wp;
  int co, taps, cin, cin_p, kp;
  long long off, so, sk, si;
};

constexpr int PREP_MAX_COPY = 3, PREP_MAX_PACK = 8;

struct Prep {
  CopyJob copy[PREP_MAX_COPY];
  PackJob pack[PREP_MAX_PACK];
  int first[PREP_MAX_COPY + PREP_MAX_PACK + 1];  // each job's first block
  int ncopy, npack;
  int ss;  // halves a staged position: the widest copy's channels + 8
};

constexpr int PREP_MAX_CP = 128;  // channels of a copy the prep stages

// a block: its TC_POS positions' rows into shared memory, [TC_POS][ss]
// halves (a thread a position, every channel; coalesced loads along the
// positions), then out in 16-byte pieces, consecutive threads on
// consecutive pieces
__device__ __forceinline__ void prep_copy(const CopyJob& j, int blk, int ss) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float red[TC_THREADS / 32][8];
  static_assert(TC_POS == TC_THREADS, "a thread a position");
  const int b = blk / j.tiles, tile = blk - b * j.tiles;
  const int e0 = j.lo + tile * TC_POS, e = e0 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = e < j.hi;
  for (int oc = 0; oc < j.cp / 8; ++oc) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = in && 8 * oc + i < j.rows ? src_at(j.src, b, 8 * oc + i, e) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      st[threadIdx.x * ss + 8 * oc + i] = __float2bfloat16_rn(j.act ? lrelu(v[i]) : v[i]);
    if (!j.bp) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(v[i]);
      if (lane == 0) red[warp][i] = s;
    }
    __syncthreads();
    const int r = 8 * oc + threadIdx.x;
    if (threadIdx.x < 8 && r < j.rows) {
      float s = 0.f;
      for (int w = 0; w < TC_THREADS / 32; ++w) s += red[w][threadIdx.x];
      j.bp[static_cast<long long>(blk) * j.rows + r] = s;
    }
    __syncthreads();
  }
  __syncthreads();
  const int pieces = j.cp / 8, n = min(TC_POS, j.hi - e0) * pieces;
  __nv_bfloat16* dst = j.dst + (static_cast<long long>(b) * j.E + e0) * j.cp;
  for (int i = threadIdx.x; i < n; i += TC_THREADS) {
    const int p = i / pieces, q = i - p * pieces;
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(p) * j.cp + 8 * q) =
        *reinterpret_cast<const uint4*>(st + p * ss + 8 * q);
  }
}

__device__ __forceinline__ void prep_pack(const PackJob& j, int blk) {
  const long long n = static_cast<long long>(blk) * TC_THREADS + threadIdx.x;
  if (n >= static_cast<long long>(j.co) * j.kp) return;
  const int o = static_cast<int>(n / j.kp), col = static_cast<int>(n - static_cast<long long>(o) * j.kp);
  const int k = col / j.cin_p, i = col - k * j.cin_p;
  const float v = k < j.taps && i < j.cin ? j.w[j.off + o * j.so + k * j.sk + i * j.si] : 0.f;
  j.wp[n] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void prep_body(const Prep& p) {
  int job = 0;
  while (static_cast<int>(blockIdx.x) >= p.first[job + 1]) ++job;
  const int blk = blockIdx.x - p.first[job];
  if (job < p.ncopy) prep_copy(p.copy[job], blk, p.ss);
  else prep_pack(p.pack[job - p.ncopy], blk);
}

// ---------------------------------------------------------------------------
// finish: the partials' sums and the folds, one launch
// ---------------------------------------------------------------------------
// out[k] = sum over p < parts of part[p n + k], k < n: a warp an element,
// lane l adding partials l, l + 32, ... in order, then a fixed xor tree
struct SumJob {
  const float* part;
  float* out;
  int parts, n;
};

// gx[r][0] += sum of edges[r][e] over e in [vlo, R), gx[r][T - 1] += sum of
// edges[r][e - T] over e in [R + T, vhi), gx[r][t] = 0 for t in [T,
// stride): the edge-replicated pad's gradient, for each of `rows` rows
struct FoldJob {
  float* gx;
  const float* edges;
  int rows, stride, T, R, vlo, vhi;
};

constexpr int FIN_MAX_SUM = 13, FIN_MAX_FOLD = 2;
constexpr int FIN_WARPS = TC_THREADS / 32;

struct Finish {
  SumJob sum[FIN_MAX_SUM];
  FoldJob fold[FIN_MAX_FOLD];
  int first[FIN_MAX_SUM + FIN_MAX_FOLD + 1];
  int nsum, nfold;
};

__device__ __forceinline__ void finish_sum(const SumJob& j, int blk) {
  const int lane = threadIdx.x & 31;
  const long long k = static_cast<long long>(blk) * FIN_WARPS + (threadIdx.x >> 5);
  if (k >= j.n) return;  // the whole warp
  const float* p = j.part + k;
  float s = 0.f;
  for (int q = lane; q < j.parts; q += 32 * 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = q + 32 * u < j.parts ? p[static_cast<long long>(q + 32 * u) * j.n] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) s += v[u];
  }
  s = warp_sum(s);
  if (lane == 0) j.out[k] = s;
}

__device__ __forceinline__ void finish_fold(const FoldJob& j, int blk) {
  const int r = blk * TC_THREADS + threadIdx.x;
  if (r >= j.rows) return;
  float* row = j.gx + static_cast<long long>(r) * j.stride;
  const float* edge = j.edges + static_cast<long long>(r) * 2 * j.R;
  float s = 0.f;
  for (int e = j.vlo; e < j.R; ++e) s += edge[e];
  row[0] += s;
  s = 0.f;
  for (int e = j.R + j.T; e < j.vhi; ++e) s += edge[e - j.T];
  row[j.T - 1] += s;
  for (int t = j.T; t < j.stride; ++t) row[t] = 0.f;
}

__device__ __forceinline__ void finish_body(const Finish& f) {
  int job = 0;
  while (static_cast<int>(blockIdx.x) >= f.first[job + 1]) ++job;
  const int blk = blockIdx.x - f.first[job];
  if (job < f.nsum) finish_sum(f.sum[job], blk);
  else finish_fold(f.fold[job - f.nsum], blk);
}

}  // namespace
