// The tiles that kernels M (mrd_fwd.cu) and N (mrd_dx.cu) share: the bf16
// tensor-core implicit GEMM of one (batch row, plane) tile, the one-output
// gather of the width-1 layers, and the weights' bf16 packing.
#pragma once

#include "mma.cuh"
#include "mrd.cuh"

namespace {

// ---------------------------------------------------------------------------
// Weights packed for the tensor cores: fp32 HWIO [kh*3][cin][cout] -> bf16
// [kh*3][pad32(cin)][pad32(cout)], rounded to nearest even, zero padded. A
// launch packs the weights of a later launch on its side (no launch of its
// own); every element has one writer.
// ---------------------------------------------------------------------------
struct Pack {
  const float* w;  // null: nothing to pack
  __nv_bfloat16* wp;
  int kh, cin, cout;
};

__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }

__device__ void pack_weights(const Pack& pk) {
  if (!pk.w) return;
  const int cp = pad32(pk.cin), op = pad32(pk.cout);
  const int n = pk.kh * KW * cp * op;  // launchers keep it below 2^31
  const int per_block = blockDim.x * blockDim.y * blockDim.z;
  const long long block =
      blockIdx.x + static_cast<long long>(gridDim.x) * (blockIdx.y + gridDim.y * blockIdx.z);
  const long long first = block * per_block + threadIdx.x +
                          blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  if (first >= n) return;
  const int threads = static_cast<int>(
      min(static_cast<long long>(gridDim.x) * gridDim.y * gridDim.z * per_block,
          static_cast<long long>(n)));
  for (int e = static_cast<int>(first); e < n; e += threads) {
    const int o = e % op, r = e / op, c = r % cp, t = r / cp;
    const float v = c < pk.cin && o < pk.cout ? pk.w[(t * pk.cin + c) * pk.cout + o] : 0.f;
    pk.wp[e] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core tile. Output rows m0 + [0, BM) (M: output channels; N: input
// channels) x positions pos0 + [0, 128) of one plane, summed over the plane's
// taps, the reduction channels (M: cin; N: cout) in stages of 32, and the
// three w-taps:
//   acc[m][n] = sum_(tap, c, j) A_j[m][c] * src[c][tap.start + pos0 + n + shift_j]
// with A_j = W[wi][j]^T (M: [cout][cin], read transposed from [c][o]) or
// W[wi][j] (N: [cin][cout]), shift_j = j (M) or 2 - j (N).
//
// The operand comes position-major, xt [B][positions][pad32(C)] (the layer
// that produced it writes this copy beside the plane-major map), so a
// stage's span of 130 positions x 32 channels is 130 aligned 64-byte rows:
// cp.async brings them whole, zero where the tap reads nothing, into
// [position][channel] rows of 80 bytes, where a w-tap's shift is a row
// offset and ldmatrix reads any row. The weights come by cp.async from the
// packed weights. A ring of MMA_STAGES stages keeps the next stages' copies
// in flight during the products. 4 warps, 2 along the rows (MT m16 tiles
// each) x 2 along the positions (64 each, eight n8 tiles): a warp's 6
// ldmatrix feed 16 mma.sync at MT = 2.
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;
constexpr int MMA_BN = 128;              // positions a block
constexpr int MMA_KC = 32;               // channels a stage
constexpr int MMA_SPAN = MMA_BN + 2;     // positions a stage reads
constexpr int SX_STRIDE = MMA_KC + 8;    // halves a staged position
constexpr int OUT_STRIDE = MMA_BN + 8;   // floats a staged output row
constexpr int MMA_STAGES = 3;           // stages in flight (2 measured slower, 4 no faster)

template <int MT, bool DX>
struct MmaTile {
  static constexpr int BM = 32 * MT;
  static constexpr int SW_ROWS = DX ? BM : MMA_KC;           // per w-tap
  static constexpr int SW_STRIDE = DX ? MMA_KC + 8 : BM + 8;  // halves
  static constexpr int SX_HALVES = MMA_SPAN * SX_STRIDE;
  static constexpr int STAGE = SX_HALVES + KW * SW_ROWS * SW_STRIDE;
  static constexpr int PIPE_BYTES = MMA_STAGES * STAGE * 2;
  static constexpr int OUT_BYTES = BM * OUT_STRIDE * 4;
  static constexpr int SMEM = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;
};

// xt: batch row b's operand, position-major, row stride cp = pad32(C) (16-
// byte aligned); wp: the packed weights; acc: zero on entry. Every thread of
// the block calls it; it ends with the block synchronised.
template <int MT, bool DX>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* __restrict__ xt, int cp,
                                         const __nv_bfloat16* __restrict__ wp, int cinp,
                                         int coutp, const Tap* taps, int ntaps, int pos0, int m0,
                                         unsigned char* smem, float (&acc)[MT][8][4]) {
  using S = MmaTile<MT, DX>;
  constexpr int BM = S::BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int nkc = cp / MMA_KC;
  const int nstage = ntaps * nkc;
  if (nstage == 0) return;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  // stage s = (tap s / nkc, channels k0 + [0, 32)) into buffer `buf`: one
  // cp.async group
  auto issue = [&](int s, int buf) {
    const Tap tp = taps[s / nkc];
    const int k0 = (s % nkc) * MMA_KC;
    __nv_bfloat16* sx = stages + buf * S::STAGE;
    for (int e = tid; e < MMA_SPAN * (MMA_KC / 8); e += MMA_THREADS) {
      const int r = e / (MMA_KC / 8), piece = e % (MMA_KC / 8);
      const int p = tp.start + pos0 + r;
      const bool ok = p >= tp.lo && p < tp.hi;
      cp_async16(sx + r * SX_STRIDE + 8 * piece,
                 ok ? xt + static_cast<long long>(p) * cp + k0 + 8 * piece : xt, ok);
    }
    __nv_bfloat16* sw = sx + S::SX_HALVES;
    if (!DX) {  // [j][c][o]: rows c of the stage, 16-byte pieces along o
      for (int e = tid; e < KW * MMA_KC * (BM / 8); e += MMA_THREADS) {
        const int p = e % (BM / 8), r = (e / (BM / 8)) % MMA_KC, j = e / (BM / 8 * MMA_KC);
        const int o = m0 + 8 * p;
        const bool ok = o < coutp;
        const __nv_bfloat16* g =
            wp + (static_cast<long long>(tp.wi * KW + j) * cinp + k0 + r) * coutp + (ok ? o : 0);
        cp_async16(sw + (j * MMA_KC + r) * S::SW_STRIDE + 8 * p, g, ok);
      }
    } else {  // [j][c][o]: rows c of the tile, 16-byte pieces along the stage's o
      for (int e = tid; e < KW * BM * (MMA_KC / 8); e += MMA_THREADS) {
        const int p = e % (MMA_KC / 8), m = (e / (MMA_KC / 8)) % BM, j = e / (MMA_KC / 8 * BM);
        const int c = m0 + m;
        const bool ok = c < cinp;
        const __nv_bfloat16* g = wp + (static_cast<long long>(tp.wi * KW + j) * cinp +
                                       (ok ? c : 0)) * coutp + k0 + 8 * p;
        cp_async16(sw + (j * BM + m) * S::SW_STRIDE + 8 * p, g, ok);
      }
    }
    cp_async_commit();
  };
  const int r8 = lane & 7, hi8 = (lane >> 4) << 3, mid8 = ((lane >> 3) & 1) << 3;
  auto compute = [&](int buf) {
    const __nv_bfloat16* sx = stages + buf * S::STAGE;
    const __nv_bfloat16* sw = sx + S::SX_HALVES;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int sh = DX ? 2 - j : j;
#pragma unroll
      for (int kk = 0; kk < MMA_KC; kk += 16) {
        uint32_t a[MT][4], b[8][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int mb = wm * MT * 16 + mt * 16;
          if (!DX)  // matrices (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8) of rows k
            ldmatrix_x4_trans(a[mt], sw + (j * MMA_KC + kk + r8 + hi8) * S::SW_STRIDE + mb + mid8);
          else  // the same matrices of rows m
            ldmatrix_x4(a[mt], sw + (j * BM + mb + r8 + mid8) * S::SW_STRIDE + kk + hi8);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // n8 tiles 2np, 2np + 1: (n, k), (n, k + 8) each
          uint32_t r[4];
          ldmatrix_x4(r, sx + (wn * 64 + np * 16 + r8 + hi8 + sh) * SX_STRIDE + kk + mid8);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    }
  };

  // stage s's copies were issued MMA_STAGES - 1 stages earlier (one group a
  // stage, empty past the end)
#pragma unroll
  for (int k = 0; k < MMA_STAGES - 1; ++k)
    if (k < nstage) issue(k, k);
    else cp_async_commit();
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // stage s is in; stage s - 1's products are done
    const int ahead = s + MMA_STAGES - 1;  // into the buffer stage s - 1 used
    if (ahead < nstage) issue(ahead, ahead % MMA_STAGES);
    else cp_async_commit();
    compute(s % MMA_STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();  // the caller reuses the shared memory
}

// the accumulators to shared memory, [BM][OUT_STRIDE] fp32, for coalesced
// stores of whole rows
template <int MT>
__device__ __forceinline__ void stage_acc(const float (&acc)[MT][8][4], unsigned char* smem) {
  float* so = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int m = (warp >> 1) * MT * 16 + mt * 16 + g, n = (warp & 1) * 64 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(so + m * OUT_STRIDE + n) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(so + (m + 8) * OUT_STRIDE + n) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
}

// the tile's m16 tiles a warp: 32 or 64 rows a block. On the H100 at the
// MRD's widths 64 rows beat 128 (three blocks an SM instead of two, smaller
// last waves) and 32 (more ldmatrix a product).
inline int mma_mt(int rows) { return rows <= 32 ? 1 : 2; }

// ---------------------------------------------------------------------------
// The one-output gather of the width-1 layers (M's post layer, cout = 1; N's
// layer 0, cin = 1): 8 warps; SPLIT of them share a group of positions,
// splitting the C source channels; PL consecutive positions a lane (PL + 2
// loads feed its 3 PL FMAs); fp32 FMAs (bf16 operands are exact in fp32),
// the SPLIT partial sums added in a fixed order. M's post layer has a few
// planes of 256 channels (PL = 1, SPLIT = 8: blocks enough to fill the card);
// N's layer 0 has thousands of planes of 32 (PL = 4, SPLIT = 1: each warp
// its own 128 positions, no reduction).
// ---------------------------------------------------------------------------
constexpr int NW_THREADS = 256;
constexpr int NW_WARPS = NW_THREADS / 32;

template <int PL, int SPLIT>
struct Narrow {
  static constexpr int WARP_POS = 32 * PL;                       // positions a group
  static constexpr int POS = WARP_POS * (NW_WARPS / SPLIT);      // positions a block
  static constexpr int RED = SPLIT > 1 ? NW_WARPS * WARP_POS : 1;  // floats of `red`
};

// out[pos] = sum_(tap, c, j) coef[tap.wi][j][c] * src[c][tap.start + pos + shift_j]
// coef: [kh*3][C] in shared memory; red: Narrow::RED floats. Returns the
// number of consecutive positions this thread holds from `pos` (0 or PL;
// with SPLIT > 1, PL = 1 and thread i < POS holds pos0 + i).
template <int PL, int SPLIT, bool DX, typename TI>
__device__ int narrow_sum(const TI* __restrict__ src, long long rowb, int src_len, int C,
                          const float* coef, const Tap* taps, int ntaps, int pos0, float* red,
                          float (&out)[PL], int& pos) {
  using N = Narrow<PL, SPLIT>;
  static_assert(SPLIT == 1 || PL == 1, "a split group reduces one position a lane");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / SPLIT, part = warp % SPLIT;
  const int first = pos0 + group * N::WARP_POS;  // the group's first position
#pragma unroll
  for (int k = 0; k < PL; ++k) out[k] = 0.f;
  for (int t = 0; t < ntaps; ++t) {
    const Tap tp = taps[t];
    const int base = tp.start + first + PL * lane;  // this lane's first source position
    // the group's whole span [start + first, + WARP_POS + 2) inside [lo, hi): no masks
    const bool inside = tp.start + first >= tp.lo && tp.start + first + N::WARP_POS + 2 <= tp.hi;
#pragma unroll 4
    for (int c = part; c < C; c += SPLIT) {
      const TI* row = src + (rowb + c) * src_len + base;
      float v[PL + 2];
#pragma unroll
      for (int u = 0; u < PL + 2; ++u)
        v[u] = inside || (base + u >= tp.lo && base + u < tp.hi) ? load(row, u) : 0.f;
      const float* cf = coef + tp.wi * KW * C + c;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const float w = cf[j * C];
        const int sh = DX ? 2 - j : j;
#pragma unroll
        for (int k = 0; k < PL; ++k) out[k] = fmaf(w, v[k + sh], out[k]);
      }
    }
  }
  if (SPLIT == 1) {
    pos = first + PL * lane;
    return PL;
  }
  red[warp * N::WARP_POS + lane] = out[0];
  __syncthreads();
  if (threadIdx.x >= N::POS) return 0;
  const int g = threadIdx.x / N::WARP_POS, i = threadIdx.x % N::WARP_POS;
  out[0] = 0.f;
  for (int w = 0; w < SPLIT; ++w) out[0] += red[(g * SPLIT + w) * N::WARP_POS + i];
  pos = pos0 + threadIdx.x;
  return 1;
}

}  // namespace
