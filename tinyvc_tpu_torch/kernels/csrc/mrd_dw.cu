// Kernel O: the fused MRD chain's weight-gradient sweep, for the decoder's
// post-join training step. Replaces the dW/db sweep of
// tinyvc_tpu/ops/pallas/mrd.py::_mrd_bwd (_bwd_kernel_dw, launched at :385):
// for each layer, h-tap i and w-tap j, in the phase-plane layout (mrd.cuh),
//   dW[i,j][c][o] = sum_(b, q, l < L) x_b[c][phi(q,i) blk_in + (2+delta) Wp - 1 + j + l]
//                                    * dy_b[o][q blk_out + 2 Wp + l]
//   db[o] = sum dy,
// both fp32. Kernels M and N are in mrd_fwd.cu and mrd_dx.cu.
//
// Bound on the H100: the step's crop (B=16, T=8000, four resolutions) is
// ~200 GFLOP of valid products per sweep, 0.20 ms at 989 TFLOP/s with bf16
// operands on the tensor cores (moving its maps, 0.23 ms, is the larger
// bound), 3.0 ms at 67 TFLOP/s in fp32 on the CUDA cores.
//
// Design, bf16 operands (6 launches a call: the two width-1 layers' gathers,
// one per tensor-core layer, the partials' sum):
//   layers with cin, cout > 1 (99.7% of the products): an implicit GEMM on
//     the tensor cores, M = cin, N = cout, K = positions (b, q, l). Its
//     operands are the position-major copies [B][position][pad32(C)] that
//     M (x, the layer below's output) and N (dy) already write for their own
//     tiles, so a stage is whole 16-byte rows for cp.async, a w-tap's shift
//     a row offset, and ldmatrix.trans gives both fragments. A block owns
//     one (cin tile, cout tile of 64, h-tap i, split): it stages one dy span
//     of 128 positions and the x span two longer, and feeds all three w-taps
//     from them (x rows at offsets 0, 1, 2), 3 x 64 x 64 fp32 sums over 4
//     warps, two stages in flight. Positions outside the tap's input plane
//     interior are zero-filled: the copies' halo rows are never written,
//     nor read. The split: the layer's (b, q, 128-position chunk) list,
//     each plane's valid rows only, cut into a fixed number of equal pieces
//     computed from the shape (kernels/mrd.py::dw_schedule), so that the
//     grid fills the 132 SMs about twice; blocks that read the same
//     positions are adjacent in the grid. The blocks of cin tile 0 and h-tap
//     0 also sum their staged dy columns for db. The mma sums run 8 k-steps
//     of 16 a stage into the block's accumulators for the whole split.
//   layer 0 (cin = 1) and the post layer (cout = 1): CUDA-core gathers in
//     one launch, a block per 256 positions of a plane's valid rows and 32
//     channels of the wide side (layer 0's dy, the post layer's x).
//   Every block writes its own partial; the last launch adds the partials
//     of every layer in a fixed order. No atomics: dW and db are
//     bit-reproducible.
// fp32 operands (exact; TF32 would break the tolerance): per layer, blocks
//   of 64 x 64 CUDA-core tiles sum fixed chunks of 1024 positions of one
//   (b, q) into partials, a second launch adds them in chunk order, a third
//   sums dy per channel for db; three launches a layer.

#include "mrd_tiles.cuh"
#include "launch_count.cuh"

namespace {

// ===========================================================================
// fp32: CUDA-core tiles, three launches a layer
// ===========================================================================
constexpr int THREADS = 256;
constexpr int TCH = 64;  // channels per block

// ---------------------------------------------------------------------------
// O, first launch: partial weight gradients. grid (chunks, tiles, kh); chunk
// = (b, q, 1024-position slice of [0, L)); ws[chunk][i*3+j][cin][cout]
// ---------------------------------------------------------------------------
constexpr int LS = 16;  // positions per shared-memory stage

__global__ void __launch_bounds__(THREADS) mrd_dw_partial_kernel(const float* __restrict__ x,
                                                                 const float* __restrict__ dy,
                                                                 float* __restrict__ ws,
                                                                 Layer ly, int wch) {
  __shared__ float sx[TCH][LS + 2];
  __shared__ float sd[LS][TCH + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = ly.L(), blk_in = ly.blk_in(), blk_out = ly.blk_out();
  const long long in_len = ly.in_len(), out_len = ly.out_len();
  const int nlc = (L + wch - 1) / wch;
  const int chunk = blockIdx.x;
  const int bq = chunk / nlc, lc = chunk - bq * nlc;
  const int b = bq / ly.s_out, q = bq - b * ly.s_out;
  const int n_ot = (ly.cout + TCH - 1) / TCH;
  const int c0 = (blockIdx.y / n_ot) * TCH, o0 = (blockIdx.y % n_ot) * TCH;
  const int i = blockIdx.z;
  int phi, delta;
  ly.tap(q, i, phi, delta);
  const long long xstart = static_cast<long long>(phi) * blk_in + (2 + delta) * ly.Wp - 1;
  const long long dstart = static_cast<long long>(q) * blk_out + 2 * ly.Wp;
  const int lbeg = lc * wch, lend = min(L, lbeg + wch);

  float acc[KW][4][4];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][a][k] = 0.f;

  for (int l0 = lbeg; l0 < lend; l0 += LS) {
    for (int e = tid; e < TCH * (LS + 2); e += THREADS) {
      const int r = e / (LS + 2), k = e - r * (LS + 2);
      const long long idx = xstart + l0 + k;
      float v = 0.f;
      if (c0 + r < ly.cin && idx >= 0 && idx < in_len)
        v = load(x, (static_cast<long long>(b) * ly.cin + c0 + r) * in_len + idx);
      sx[r][k] = v;
    }
    for (int e = tid; e < LS * TCH; e += THREADS) {
      const int o = e % TCH, k = e / TCH;
      float v = 0.f;
      if (o0 + o < ly.cout && l0 + k < lend)
        v = load(dy, (static_cast<long long>(b) * ly.cout + o0 + o) * out_len + dstart + l0 + k);
      sd[k][o] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < LS; ++k) {
      float dv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = sd[k][tx + 16 * a];
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float xv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sx[ty + 16 * c][k + j];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[j][c][a] = fmaf(xv[c], dv[a], acc[j][c][a]);
      }
    }
    __syncthreads();
  }

  const long long per_chunk = static_cast<long long>(ly.kh) * KW * ly.cin * ly.cout;
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ci = c0 + ty + 16 * c;
      if (ci >= ly.cin) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int o = o0 + tx + 16 * a;
        if (o >= ly.cout) continue;
        ws[chunk * per_chunk + (static_cast<long long>(i * KW + j) * ly.cin + ci) * ly.cout + o] =
            acc[j][c][a];
      }
    }
}

// O, second launch: dw = the partials summed in chunk order
__global__ void mrd_dw_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                  long long n, int chunks) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += ws[c * n + e];
  dw[e] = s;
}

// O, third launch: db[o] = the sum of dy over the batch and every position
// (dy is zero off the valid positions), one block per channel, a fixed tree
__global__ void __launch_bounds__(THREADS) mrd_db_kernel(const float* __restrict__ dy,
                                                         float* __restrict__ db, int B, int cout,
                                                         long long len) {
  __shared__ float red[THREADS];
  const int o = blockIdx.x;
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* row = dy + (static_cast<long long>(b) * cout + o) * len;
    for (long long p = threadIdx.x; p < len; p += THREADS) s += load(row, p);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) db[o] = red[0];
}


// ===========================================================================
// bf16: tensor-core tiles (cin, cout > 1), gathers (cin = 1 or cout = 1), and
// one launch that adds every layer's partials
// ===========================================================================
constexpr int DW_THREADS = 128;
constexpr int DW_BK = 128;    // positions a stage: one chunk of the split schedule
constexpr int DW_BN = 64;     // output channels a block
constexpr int DW_STAGES = 2;  // stages in flight; on the H100 128 x 2 beat 64 x 2-4, 96 x 2-3,
                              // 128 x 3 and 192 x 2
constexpr int DW_MAXQ = 64;   // output planes of a layer, at most

// a block: BM = 32 MT input channels x 64 output channels x 3 w-taps; warps
// 2 x 2, each MT m16 tiles x 4 n8 tiles a w-tap
template <int MT>
struct DwTile {
  static constexpr int BM = 32 * MT;
  static constexpr int SX_STRIDE = BM + 8;     // halves a staged x position
  static constexpr int SD_STRIDE = DW_BN + 8;  // halves a staged dy position
  static constexpr int SX_HALVES = (DW_BK + 2) * SX_STRIDE;
  static constexpr int STAGE = SX_HALVES + DW_BK * SD_STRIDE;
  static constexpr int SMEM = DW_STAGES * STAGE * 2;
};

// A layer's output planes' valid rows cut into pieces of `size` positions,
// batch row by batch row, plane by plane (kernels/mrd.py::dw_plane_chunks):
// first[q] = a batch row's first piece of plane q; made on the host, so
// that a block finds its plane without a division a plane.
struct Walk {
  int first[DW_MAXQ + 1];
  int per_b, size;
  // batch row b, plane q and first position l0 of piece c
  __device__ void piece(int c, int& b, int& q, int& l0) const {
    b = c / per_b;
    const int w = c - b * per_b;
    for (q = 0; w >= first[q + 1]; ++q) {
    }
    l0 = (w - first[q]) * size;
  }
};

Walk make_walk(const Layer& ly, int size) {
  Walk wk{};
  wk.size = size;
  for (int q = 0; q < ly.s_out; ++q) {
    wk.first[q] = wk.per_b;
    wk.per_b += (ly.valid_rows(q) * ly.Wp + size - 1) / size;
  }
  for (int q = ly.s_out; q <= DW_MAXQ; ++q) wk.first[q] = wk.per_b;
  return wk;
}

// grid (kh * cin tiles * cout tiles, splits); partial blockIdx.y of
// ws[split][kh*3*cin*cout + cout]: dW [i*3+j][c][o], then db
template <int MT>
__global__ void __launch_bounds__(DW_THREADS) mrd_dw_mma_kernel(
    const __nv_bfloat16* __restrict__ xt, const __nv_bfloat16* __restrict__ dyt,
    float* __restrict__ ws, Layer ly, Walk wk, int splits) {
  using S = DwTile<MT>;
  constexpr int BM = S::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n_ct = (ly.cin + BM - 1) / BM, n_ot = (ly.cout + DW_BN - 1) / DW_BN;
  const int i = blockIdx.x / (n_ct * n_ot), ct = blockIdx.x / n_ot % n_ct;
  const int c0 = ct * BM, o0 = blockIdx.x % n_ot * DW_BN;
  const int cpx = pad32(ly.cin), cpd = pad32(ly.cout);
  const long long total = static_cast<long long>(ly.B) * wk.per_b;
  const int first = static_cast<int>(blockIdx.y * total / splits);
  const int nchunk = static_cast<int>((blockIdx.y + 1) * total / splits) - first;

  // chunk `first + k` (batch row b, plane q, positions l0 + [0, DW_BK)) into
  // buffer `buf`: x rows l0 + [0, DW_BK + 2) of the tap's slice, zero outside its
  // input plane's interior; dy rows, zero past the plane's valid rows. One
  // cp.async group.
  auto issue = [&](int k, int buf) {
    int b, q, l0, phi, delta;
    wk.piece(first + k, b, q, l0);
    ly.tap(q, i, phi, delta);
    const long long xb = static_cast<long long>(phi) * ly.blk_in();
    const long long xs = xb + (2 + delta) * ly.Wp - 1 + l0, lo = xb + 2 * ly.Wp,
                    hi = xb + (2 + ly.g_in) * ly.Wp;
    const __nv_bfloat16* xrow = xt + static_cast<long long>(b) * ly.in_len() * cpx;
    __nv_bfloat16* sx = stages + buf * S::STAGE;
    for (int e = tid; e < (DW_BK + 2) * (BM / 8); e += DW_THREADS) {
      const int r = e / (BM / 8), ch = c0 + 8 * (e % (BM / 8));
      const long long p = xs + r;
      const bool ok = p >= lo && p < hi && ch < cpx;
      cp_async16(sx + r * S::SX_STRIDE + ch - c0, ok ? xrow + p * cpx + ch : xt, ok);
    }
    const long long ds = static_cast<long long>(q) * ly.blk_out() + 2 * ly.Wp;
    const long long dend = ds + static_cast<long long>(ly.valid_rows(q)) * ly.Wp;
    const __nv_bfloat16* drow = dyt + static_cast<long long>(b) * ly.out_len() * cpd;
    __nv_bfloat16* sd = sx + S::SX_HALVES;
    for (int e = tid; e < DW_BK * (DW_BN / 8); e += DW_THREADS) {
      const int r = e / (DW_BN / 8), ch = o0 + 8 * (e % (DW_BN / 8));
      const long long p = ds + l0 + r;
      const bool ok = p < dend && ch < cpd;
      cp_async16(sd + r * S::SD_STRIDE + ch - o0, ok ? drow + p * cpd + ch : dyt, ok);
    }
    cp_async_commit();
  };

  float acc[KW][MT][4][4] = {};
  float dbs = 0.f;  // with_db: column tid % 64's sum over rows tid / 64 + 2 k
  const bool with_db = ct == 0 && i == 0;
  const int r8 = lane & 7, hi8 = (lane >> 4) << 3, mid8 = ((lane >> 3) & 1) << 3;
  auto compute = [&](int buf) {
    const __nv_bfloat16* sx = stages + buf * S::STAGE;
    const __nv_bfloat16* sd = sx + S::SX_HALVES;
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      // B (k = positions x n = output channels) from rows of dy: matrices
      // (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8), transposed
      uint32_t bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sd + (kk + r8 + mid8) * S::SD_STRIDE + wn * 32 + np * 16 + hi8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        // A (m = input channels x k) from rows of x shifted by j: matrices
        // (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8), transposed
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4_trans(a[mt], sx + (kk + j + r8 + hi8) * S::SX_STRIDE + wm * MT * 16 +
                                       mt * 16 + mid8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[j][mt][nt], a[mt], bf[nt]);
      }
    }
    if (with_db)
      for (int k = tid / DW_BN; k < DW_BK; k += DW_THREADS / DW_BN)
        dbs += __bfloat162float(sd[k * S::SD_STRIDE + tid % DW_BN]);
  };

  // chunk k's copies were issued DW_STAGES - 1 chunks earlier (one group a
  // chunk, empty past the end)
#pragma unroll
  for (int k = 0; k < DW_STAGES - 1; ++k)
    if (k < nchunk) issue(k, k);
    else cp_async_commit();
  for (int k = 0; k < nchunk; ++k) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // chunk k is in; chunk k - 1's products are done
    const int ahead = k + DW_STAGES - 1;  // into the buffer chunk k - 1 used
    if (ahead < nchunk) issue(ahead, ahead % DW_STAGES);
    else cp_async_commit();
    compute(k % DW_STAGES);
  }
  cp_async_wait<0>();

  const int ndw = ly.kh * KW * ly.cin * ly.cout;
  float* out = ws + static_cast<long long>(blockIdx.y) * (ndw + ly.cout);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * MT * 16 + mt * 16 + g + 8 * h;
        if (c >= ly.cin) continue;
        float* row = out + ((i * KW + j) * ly.cin + c) * ly.cout;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = o0 + wn * 32 + nt * 8 + 2 * t4 + e;
            if (o < ly.cout) row[o] = acc[j][mt][nt][2 * h + e];
          }
      }
  if (with_db) {
    __syncthreads();  // the stages are free
    float* red = reinterpret_cast<float*>(smem);
    red[tid] = dbs;
    __syncthreads();
    if (tid < DW_BN && o0 + tid < ly.cout) out[ndw + o0 + tid] = red[tid] + red[tid + DW_BN];
  }
}

// ---------------------------------------------------------------------------
// The width-1 layers, on the CUDA cores, in one launch: one block per pass
// of GW_POS positions of an output plane's valid rows (its own partial) and
// 32 channels of the wide side (layer 0's dy, the post layer's x); every
// sum in a fixed order. The blocks are latency-bound (most of a block's
// life waits on its loads), so a thread issues its loads before it stores
// any.
// ---------------------------------------------------------------------------
constexpr int GW_THREADS = 256;
constexpr int GW_WARPS = GW_THREADS / 32;
constexpr int GW_RUN = 32;                 // positions a warp of layer 0's gather
constexpr int GW_POS = GW_WARPS * GW_RUN;  // positions a block
constexpr int GW_ROW = 33;                 // floats a staged position (32 channels)
constexpr int C1_MAXKH = 8;                // layer 0's h-taps, at most
constexpr int NW_MAXKH = 3;                // the post layer's, at most
static_assert(GW_POS == GW_THREADS, "a thread stages a position");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One width-1 layer's gather: its maps, its walk in passes of GW_POS, its
// partials (one a pass) and its blocks, pieces x channel groups of 32.
struct GatherJob {
  Layer ly;
  Walk wk;
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  float* ws;
  int pieces, groups;
};

// layer 0 (cin = 1): the spectrogram's kh tap slices and dy, transposed to
// [position][channel], staged; a lane a channel, each warp sliding a window
// of three along its run of GW_RUN positions; the warps' sums added in
// order. Partial `piece` of ws[][kh*3*cout + cout], channels 32 group +
// [0, 32)
__device__ void dw_c1(const GatherJob& jb, int piece, int group) {
  const Layer& ly = jb.ly;
  const __nv_bfloat16* __restrict__ x = jb.x;
  const __nv_bfloat16* __restrict__ dy = jb.dy;
  constexpr int NT = C1_MAXKH * KW;
  static_assert(GW_WARPS * (NT + 1) * 32 <= GW_POS * GW_ROW, "the warps' sums fit in sdy");
  __shared__ float sx[C1_MAXKH][GW_POS + 2];
  __shared__ float sdy[GW_POS * GW_ROW];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  int b, q, l0;
  jb.wk.piece(piece, b, q, l0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, o0 = group * 32;
  block_taps(ly, false, q, taps, &ntaps);  // every h-tap, in order
  const int n = ly.valid_rows(q) * ly.Wp, kh = ly.kh;
  const long long in_len = ly.in_len(), out_len = ly.out_len();
  // thread tid stages position tid of every slice and channel (threads 0
  // and 1 also the slices' last two), all its loads issued before its stores
  {
    const __nv_bfloat16* drow = dy + (static_cast<long long>(b) * ly.cout + o0) * out_len +
                                q * ly.blk_out() + 2 * ly.Wp + l0 + tid;
    const int olen = static_cast<int>(out_len);  // 32 rows below 2^31 (the launcher's check)
    const bool in = l0 + tid < n;
    float xv[C1_MAXKH][2], v[32];
#pragma unroll
    for (int t = 0; t < C1_MAXKH; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = static_cast<long long>(taps[t].start) + l0 + tid + h * GW_POS;
        xv[t][h] = t < kh && (h == 0 || tid < 2) && p >= taps[t].lo && p < taps[t].hi
                       ? to_f32(x[b * in_len + p])
                       : 0.f;
      }
#pragma unroll
    for (int o = 0; o < 32; ++o)
      v[o] = in && o0 + o < ly.cout ? to_f32(drow[o * olen]) : 0.f;
#pragma unroll
    for (int t = 0; t < C1_MAXKH; ++t) {
      sx[t][tid] = xv[t][0];
      if (tid < 2) sx[t][GW_POS + tid] = xv[t][1];
    }
#pragma unroll
    for (int o = 0; o < 32; ++o) sdy[tid * GW_ROW + o] = v[o];
  }
  __syncthreads();
  float acc[NT + 1] = {};  // dW taps, then db
  const int k0 = warp * GW_RUN;
  float win[C1_MAXKH][2];
#pragma unroll
  for (int i = 0; i < C1_MAXKH; ++i) {
    win[i][0] = sx[i][k0];
    win[i][1] = sx[i][k0 + 1];
  }
#pragma unroll
  for (int k = k0; k < k0 + GW_RUN; ++k) {
    const float d = sdy[k * GW_ROW + lane];
#pragma unroll
    for (int i = 0; i < C1_MAXKH; ++i)
      if (i < kh) {
        const float x2 = sx[i][k + 2];
        acc[i * KW] = fmaf(win[i][0], d, acc[i * KW]);
        acc[i * KW + 1] = fmaf(win[i][1], d, acc[i * KW + 1]);
        acc[i * KW + 2] = fmaf(x2, d, acc[i * KW + 2]);
        win[i][0] = win[i][1];
        win[i][1] = x2;
      }
    acc[NT] += d;
  }
  __syncthreads();  // sdy becomes the warps' sums
#pragma unroll
  for (int t = 0; t <= NT; ++t) sdy[(warp * (NT + 1) + t) * 32 + lane] = acc[t];
  __syncthreads();
  // dW tap t (and db, t = nt) of channel o0 + o: the warps' sums in order
  float* out = jb.ws + static_cast<long long>(piece) * (kh * KW * ly.cout + ly.cout);
  for (int e = tid; e < (kh * KW + 1) * 32; e += GW_THREADS) {
    const int t = e / 32, o = e - t * 32, slot = t < kh * KW ? t : NT;
    if (o0 + o >= ly.cout) continue;
    float v = 0.f;
    for (int w = 0; w < GW_WARPS; ++w) v += sdy[(w * (NT + 1) + slot) * 32 + o];
    out[t * ly.cout + o0 + o] = v;
  }
}

// the post layer (cout = 1): dy staged in shared memory; x read along
// positions, each lane GW_POS / 32 of them, its three w-taps from L1. Each
// warp takes GW_WARPS of the group's 32 channels one after the other, its
// lanes' sums added by a fixed xor tree. Partial `piece` of
// ws[][kh*3*cin + 1]
__device__ void dw_narrow(const GatherJob& jb, int piece, int group) {
  const Layer& ly = jb.ly;
  const __nv_bfloat16* __restrict__ x = jb.x;
  const __nv_bfloat16* __restrict__ dy = jb.dy;
  constexpr int NT = NW_MAXKH * KW;
  __shared__ float sd[GW_POS];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  int b, q, l0;
  jb.wk.piece(piece, b, q, l0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  block_taps(ly, false, q, taps, &ntaps);
  const int n = ly.valid_rows(q) * ly.Wp, kh = ly.kh, nt = kh * KW;
  const int ilen = static_cast<int>(ly.in_len());  // below 2^31 (the launcher's check)
  sd[tid] = l0 + tid < n ? to_f32(dy[static_cast<long long>(b) * ly.out_len() +
                                     static_cast<long long>(q) * ly.blk_out() + 2 * ly.Wp + l0 +
                                     tid])
                         : 0.f;
  __syncthreads();
  float* out = jb.ws + static_cast<long long>(piece) * (nt * ly.cin + 1);
  if (group == 0 && warp == 0) {  // db: the pass's dy, a fixed tree
    float v = 0.f;
#pragma unroll
    for (int u = 0; u < GW_POS / 32; ++u) v += sd[lane + 32 * u];
    v = warp_sum(v);
    if (lane == 0) out[nt * ly.cin] = v;
  }
  for (int cc = 0; cc < 32 / GW_WARPS; ++cc) {
    const int c = group * 32 + warp * (32 / GW_WARPS) + cc;
    if (c >= ly.cin) break;
    const __nv_bfloat16* row = x + (static_cast<long long>(b) * ly.cin + c) * ilen;
    float acc[NT] = {};
#pragma unroll
    for (int i = 0; i < NW_MAXKH; ++i) {
      if (i >= kh) break;
      const Tap tp = taps[i];
#pragma unroll
      for (int u = 0; u < GW_POS / 32; ++u) {
        const int k = lane + 32 * u, p = tp.start + l0 + k;
        const float d = sd[k];
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const float v = p + j >= tp.lo && p + j < tp.hi ? to_f32(row[p + j]) : 0.f;
          acc[i * KW + j] = fmaf(v, d, acc[i * KW + j]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float v = warp_sum(acc[t]);
      if (lane == 0 && t < nt) out[t * ly.cin + c] = v;
    }
  }
}

// Both width-1 layers' gathers in one launch: block r of job j is piece
// r % pieces, channel group r / pieces
constexpr int DW_MAXG = 2;  // gathers a call, at most

struct Gathers {
  GatherJob job[DW_MAXG];
  int jobs;
};

__device__ __forceinline__ void dw_gather(const GatherJob& jb, int r) {
  if (jb.ly.cin == 1) dw_c1(jb, r % jb.pieces, r / jb.pieces);
  else dw_narrow(jb, r % jb.pieces, r / jb.pieces);
}

__global__ void __launch_bounds__(GW_THREADS) mrd_dw_gather_kernel(Gathers g) {
  static_assert(DW_MAXG == 2, "a constant index a job");
  const int n0 = g.job[0].pieces * g.job[0].groups;
  if (static_cast<int>(blockIdx.x) < n0) dw_gather(g.job[0], blockIdx.x);
  else dw_gather(g.job[1], blockIdx.x - n0);
}

// ---------------------------------------------------------------------------
// The sum: each output element of a layer is its partials added in a fixed
// order. A block of 256 threads takes 256 elements of a layer with few
// partials, or 32 elements of one with RED_SPLIT or more, its 8 warps then
// taking every 8th partial and adding their sums in warp order.
// ---------------------------------------------------------------------------
constexpr int DW_MAXL = 8;  // layers a call, at most
constexpr int RED_THREADS = 256;
constexpr int RED_SPLIT = 16;
constexpr int RED_BATCH = 8;

struct DwSum {
  float* dw[DW_MAXL];
  float* db[DW_MAXL];
  long long woff[DW_MAXL];    // the layer's first partial in ws
  int bfirst[DW_MAXL + 1];    // its first block of the sum
  int n[DW_MAXL];             // elements a partial: kh*3*cin*cout + cout
  int ndw[DW_MAXL];           // of them dW
  int parts[DW_MAXL];
  int layers;
};

__global__ void __launch_bounds__(RED_THREADS) mrd_dw_reduce_kernel(const float* __restrict__ ws,
                                                                    DwSum s) {
  __shared__ float red[RED_THREADS];
  int li = 0;
  while (static_cast<int>(blockIdx.x) >= s.bfirst[li + 1]) ++li;
  const int blk = blockIdx.x - s.bfirst[li], parts = s.parts[li], n = s.n[li];
  const bool split = parts >= RED_SPLIT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = split ? blk * 32 + lane : blk * RED_THREADS + threadIdx.x;
  const int r0 = split ? warp : 0, step = split ? RED_THREADS / 32 : 1;
  float acc = 0.f;
  if (k < n) {  // loads in batches of RED_BATCH, added in order
    const float* p = ws + s.woff[li] + k;
    for (int r = r0; r < parts; r += RED_BATCH * step) {
      float v[RED_BATCH];
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        v[u] = r + u * step < parts ? p[static_cast<long long>(r + u * step) * n] : 0.f;
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u) acc += v[u];
    }
  }
  if (split) {
    red[threadIdx.x] = acc;
    __syncthreads();
    if (warp) return;
    acc = 0.f;
    for (int w = 0; w < RED_THREADS / 32; ++w) acc += red[w * 32 + lane];
  }
  if (k >= n) return;
  if (k < s.ndw[li]) s.dw[li][k] = acc;
  else s.db[li][k - s.ndw[li]] = acc;
}

template <int MT>
int launch_dw_mma(const void* xt, const void* dyt, float* ws, const Layer& ly, int splits,
                  cudaStream_t st) {
  constexpr int smem = DwTile<MT>::SMEM;
  if (cudaFuncSetAttribute(mrd_dw_mma_kernel<MT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(ly.cin, DwTile<MT>::BM) * cdiv(ly.cout, DW_BN) * ly.kh, splits);
  mrd_dw_mma_kernel<MT><<<grid, DW_THREADS, smem, tvc::counted(st)>>>(
      static_cast<const __nv_bfloat16*>(xt), static_cast<const __nv_bfloat16*>(dyt), ws, ly,
      make_walk(ly, DW_BK), splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// O in fp32 for one layer: x (the layer's input) and dy -> dw [kh*3, cin,
// cout] and db [cout]; ws holds the partials, chunks * kh*3*cin*cout floats,
// chunks = B * s_out * ceil(L / wch).
extern "C" int tvc_mrd_dw(const float* x, const float* dy, float* ws, long long ws_len, float* dw,
                          float* db, MRD_LAYER_ARGS, int wch, void* stream) {
  const Layer ly = MRD_LAYER;
  if (bad(ly) || wch <= 0 || wch % LS) return static_cast<int>(cudaErrorInvalidValue);
  const int L = g_out * Wp;
  const long long chunks = static_cast<long long>(B) * s_out * ((L + wch - 1) / wch);
  const long long n = static_cast<long long>(kh) * KW * cin * cout;
  if (chunks > 0x7fffffffLL || chunks * n > ws_len) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks), cdiv(cin, TCH) * cdiv(cout, TCH), kh);
  const long long len = static_cast<long long>(s_out) * (g_out + 4) * Wp;
  mrd_dw_partial_kernel<<<grid, THREADS, 0, tvc::counted(st)>>>(x, dy, ws, ly, wch);
  mrd_db_kernel<<<cout, THREADS, 0, tvc::counted(st)>>>(dy, db, B, cout, len);
  mrd_dw_sum_kernel<<<cdiv(n, 256), 256, 0, tvc::counted(st)>>>(ws, dw, n,
                                                                 static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

// O with bf16 operands for a chain of `layers` layers: one launch a layer
// and one that adds the partials. ptrs, 6 a layer: x (the layer's input [B,
// cin, in_len]), xt (its position-major copy [B, in_len, pad32(cin)]), dy
// ([B, cout, out_len]), dyt (its copy [B, out_len, pad32(cout)]), dw ([kh*3,
// cin, cout] fp32), db ([cout] fp32); the copies only where cin, cout > 1,
// x and dy only where not. dims, 15 a layer: MRD_LAYER_ARGS, then the
// layer's partials (kernels/mrd.py::dw_schedule): its splits, in [1, its
// chunks], where cin, cout > 1, else B * s_out. ws: every layer's partials,
// parts * (kh*3*cin*cout + cout) floats each, ws_len in all.
extern "C" int tvc_mrd_dw_bf16(void* const* ptrs, const int* dims, int layers, float* ws,
                               long long ws_len, void* stream) {
  constexpr int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (layers <= 0 || layers > DW_MAXL) return invalid;
  DwSum sum{};
  Gathers gat{};
  Layer lys[DW_MAXL];
  long long need = 0, blocks = 0;
  for (int li = 0; li < layers; ++li) {
    const int* d = dims + 15 * li;
    void* const* p = ptrs + 6 * li;
    const Layer ly =
        make_layer(d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9], d[10], d[11],
                   d[12], d[13]);
    const int parts = d[14];
    lys[li] = ly;
    if (bad(ly) || !p[4] || !p[5] || parts <= 0) return invalid;
    if (ly.s_out > DW_MAXQ) return invalid;
    if (ly.cin > 1 && ly.cout > 1) {
      const long long chunks = static_cast<long long>(ly.B) * make_walk(ly, DW_BK).per_b;
      if (!p[1] || !p[3] || reinterpret_cast<uintptr_t>(p[1]) % 16 ||
          reinterpret_cast<uintptr_t>(p[3]) % 16 || parts > 65535 ||
          chunks > 0x7fffffffLL || parts > (chunks > 1 ? chunks : 1))
        return invalid;
    } else {
      const Walk wk = make_walk(ly, GW_POS);
      if (!p[0] || !p[2] || gat.jobs == DW_MAXG || 32LL * ly.in_len() > 0x7fffffffLL ||
          32LL * ly.out_len() > 0x7fffffffLL || parts != static_cast<long long>(ly.B) * wk.per_b ||
          ly.kh > (ly.cin == 1 ? C1_MAXKH : NW_MAXKH))
        return invalid;
      gat.job[gat.jobs++] = GatherJob{ly, wk, static_cast<const __nv_bfloat16*>(p[0]),
                                      static_cast<const __nv_bfloat16*>(p[2]),
                                      ws + need, parts,
                                      ((ly.cin == 1 ? ly.cout : ly.cin) + 31) / 32};
    }
    const long long n = static_cast<long long>(ly.kh) * KW * ly.cin * ly.cout + ly.cout;
    if (n > 0x7fffffffLL) return invalid;
    sum.dw[li] = static_cast<float*>(p[4]);
    sum.db[li] = static_cast<float*>(p[5]);
    sum.woff[li] = need;
    sum.bfirst[li] = static_cast<int>(blocks);
    sum.n[li] = static_cast<int>(n);
    sum.ndw[li] = static_cast<int>(n) - ly.cout;
    sum.parts[li] = parts;
    need += parts * n;
    blocks += cdiv(n, parts >= RED_SPLIT ? 32 : RED_THREADS);
  }
  if (blocks > 0x7fffffffLL) return invalid;
  sum.bfirst[layers] = static_cast<int>(blocks);
  sum.layers = layers;
  if (need != ws_len) return invalid;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gat.jobs) {
    long long blocks = 0;
    for (int j = 0; j < gat.jobs; ++j)
      blocks += static_cast<long long>(gat.job[j].pieces) * gat.job[j].groups;
    mrd_dw_gather_kernel<<<static_cast<unsigned>(blocks), GW_THREADS, 0, tvc::counted(st)>>>(gat);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
  }
  for (int li = 0; li < layers; ++li) {
    const Layer& ly = lys[li];
    if (ly.cin == 1 || ly.cout == 1) continue;
    void* const* p = ptrs + 6 * li;
    const int rc = ly.cin <= 32
                       ? launch_dw_mma<1>(p[1], p[3], ws + sum.woff[li], ly, sum.parts[li], st)
                       : launch_dw_mma<2>(p[1], p[3], ws + sum.woff[li], ly, sum.parts[li], st);
    if (rc) return rc;
  }
  mrd_dw_reduce_kernel<<<static_cast<unsigned>(blocks), RED_THREADS, 0, tvc::counted(st)>>>(ws,
                                                                                            sum);
  return static_cast<int>(cudaGetLastError());
}
