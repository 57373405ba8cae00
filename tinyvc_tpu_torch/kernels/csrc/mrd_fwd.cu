// Kernel M: one layer of the fused MRD chain forward, for the decoder's
// post-join training step. Replaces tinyvc_tpu/ops/pallas/mrd.py::_fwd_pallas
// (_fwd_kernel, mrd.py:75, launched at :178): every layer of one MRD
// resolution's conv stack in the phase-plane layout (mrd.cuh). One launch a
// layer; the TPU keeps a batch row's whole chain in VMEM, but a layer's output
// for one row (up to 3.5 MiB fp32) is far beyond a block's shared memory.
//
// Bound on the H100: operations. One forward of the step's crop (B=16,
// T=8000, four resolutions) is ~200 GFLOP of valid products, 0.20 ms at 989
// TFLOP/s with bf16 operands on the tensor cores, 3.0 ms at 67 TFLOP/s in fp32
// on the CUDA cores.
//
// Design, by layer shape and precision (per crop, the bf16 time is 8% of
// its bound: 2.1 ms, against 14.1 ms for CUDA-core products):
//   layers 1-4, bf16: an implicit GEMM on the tensor cores per (batch row,
//     output plane q): out[o][l] = sum_(i, c, j) W[i][j][c][o] *
//     x[c][tap_i + j + l] (mrd_tiles.cuh::mma_tile): 64 (or 32) channels x
//     128 positions a block, mma.sync m16n8k16 with fp32 accumulators, three
//     cp.async stages of 32 channels. The w-taps' one-element shifts defeat
//     aligned copies of a [channel][position] map, so the kernel reads its
//     input position-major ([B][position][pad32(cin)], written beside the
//     plane-major map by the launch of the layer below; a w-tap is then a
//     row offset) and writes such a copy of its own output for the layer
//     above. Its weights come packed to bf16 by the previous layer's launch.
//     Tiles past the plane's valid rows skip their products (about 10% of
//     the layout's positions).
//   layers 1-4, fp32: 64 x 64 register tiles of fp32 FMAs, exact (TF32 would
//     break the fp32 tolerance), with the same skip.
//   layer 0 (cin = 1): 21 taps a position over all 32 channels, one thread a
//     position (no empty channel lanes); it writes the position-major copy
//     and packs layer 1's weights.
//   post layer (cout = 1): a one-output gather, 8 warps splitting cin.
// Every kernel adds the fp32 bias, applies the validity mask, writes the
// plane's zero halo rows and stores the operand type.
//
// Left for later: wgmma (its shared-memory descriptors take no one-element
// row shift either, but the position-major copy would let TMA feed it), a
// persistent schedule over the planes' ragged last tiles and waves (three
// blocks an SM leave the last wave of a layer part empty).

#include "mrd_tiles.cuh"
#include "launch_count.cuh"

namespace {

// the plane's zero halo rows: the first block along x writes the head, the
// last the tail, for output channels o0 .. o0 + n - 1. (The position-major
// copy needs none: the next layer reads only interior rows.)
template <typename T>
__device__ void write_halos(T* out, const Layer& ly, int b, int q, int o0, int n) {
  const bool head = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (!head && !last) return;
  const int halo = 2 * ly.Wp, tail = ly.blk_out() - halo - ly.L();
  const int warps = blockDim.x / 32, lane = threadIdx.x & 31;
  for (int o = o0 + static_cast<int>(threadIdx.x >> 5); o < o0 + n; o += warps) {
    T* row = out + (static_cast<long long>(b) * ly.cout + o) * ly.out_len() +
             static_cast<long long>(q) * ly.blk_out();
    if (head)
      for (int p = lane; p < halo; p += 32) row[p] = from_f32<T>(0.f);
    if (last)
      for (int p = lane; p < tail; p += 32) row[halo + ly.L() + p] = from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// layers 1-4, bf16: grid (ceil(L/128), ceil(cout/BM), B*s_out)
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(MMA_THREADS) mrd_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ xt, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* __restrict__ outt, Layer ly, Pack next) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  constexpr int BM = MmaTile<MT, false>::BM;
  pack_weights(next);
  const int b = blockIdx.z / ly.s_out, q = blockIdx.z - b * ly.s_out;
  const int L = ly.L(), l0 = blockIdx.x * MMA_BN, m0 = blockIdx.y * BM;
  block_taps(ly, false, q, taps, &ntaps);
  float acc[MT][8][4] = {};
  if (l0 < ly.valid_rows(q) * ly.Wp)  // else every position of the tile is masked
    mma_tile<MT, false>(xt + static_cast<long long>(b) * ly.in_len() * pad32(ly.cin),
                        pad32(ly.cin), wp, pad32(ly.cin), pad32(ly.cout), taps, ntaps, l0, m0,
                        smem, acc);
  stage_acc<MT>(acc, smem);
  const float* so = reinterpret_cast<const float*>(smem);
  // thread n stores position l0 + n of every row (coalesced rows) and keeps
  // the values position-major in shared memory, [n][m] bf16 beside the fp32
  // tile; then the block writes them out as whole rows of channels for the
  // next layer (outt), 16 bytes a lane
  static_assert(MMA_THREADS == MMA_BN, "a thread a position");
  constexpr int TS = BM + 8;  // halves a staged row of channels
  static_assert(BM * OUT_STRIDE * 4 + MMA_BN * TS * 2 <= MmaTile<MT, false>::SMEM, "smem");
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + BM * OUT_STRIDE * 4);
  const int n = threadIdx.x, l = l0 + n;
  const bool valid = l < L && ly.valid(q, l);
  const long long pos = static_cast<long long>(q) * ly.blk_out() + 2 * ly.Wp + l0;
  __nv_bfloat16* col = out + static_cast<long long>(b) * ly.cout * ly.out_len() + pos + n;
  const int cp = pad32(ly.cout), nt = min(BM, cp - m0);
  for (int m = 0; m < nt; ++m) {
    const int o = m0 + m;
    const __nv_bfloat16 h =
        __float2bfloat16_rn(valid && o < ly.cout ? so[m * OUT_STRIDE + n] + bias[o] : 0.f);
    if (o < ly.cout && l < L) col[static_cast<long long>(o) * ly.out_len()] = h;
    st[n * TS + m] = h;
  }
  if (outt) {
    __syncthreads();
    const int pieces = nt / 8, shift = __ffs(pieces) - 1;
    uint4* rows = reinterpret_cast<uint4*>(outt + (static_cast<long long>(b) * ly.out_len() + pos) *
                                                      cp + m0);
    for (int e = threadIdx.x; e < MMA_BN * pieces; e += MMA_THREADS) {
      const int nn = e >> shift, g = e & (pieces - 1);
      if (l0 + nn < L)
        rows[static_cast<long long>(nn) * (cp / 8) + g] =
            *reinterpret_cast<const uint4*>(st + nn * TS + 8 * g);
    }
  }
  write_halos(out, ly, b, q, m0, min(BM, ly.cout - m0));
}

// ---------------------------------------------------------------------------
// layers 1-4, fp32: grid (ceil(L/TP), ceil(cout/TCH), B*s_out)
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int TP = 64;   // positions per block
constexpr int TCH = 64;  // channels per block
constexpr int CI = 16;   // reduction rows per shared-memory stage

__global__ void __launch_bounds__(THREADS) mrd_fwd_kernel(const float* __restrict__ x,
                                                          const float* __restrict__ w,
                                                          const float* __restrict__ bias,
                                                          float* __restrict__ out, Layer ly) {
  __shared__ float sx[CI][TP + 2];
  __shared__ float sw[KW][CI][TCH + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = ly.L(), blk_in = ly.blk_in(), blk_out = ly.blk_out();
  const long long in_len = ly.in_len();
  const int l0 = blockIdx.x * TP, o0 = blockIdx.y * TCH;
  const int b = blockIdx.z / ly.s_out, q = blockIdx.z - b * ly.s_out;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  const int kh = l0 < ly.valid_rows(q) * ly.Wp ? ly.kh : 0;  // past the valid rows: no products
  for (int i = 0; i < kh; ++i) {
    int phi, delta;
    ly.tap(q, i, phi, delta);
    const long long start = static_cast<long long>(phi) * blk_in + (2 + delta) * ly.Wp - 1 + l0;
    for (int c0 = 0; c0 < ly.cin; c0 += CI) {
      const int nci = min(CI, ly.cin - c0);
      for (int e = tid; e < CI * (TP + 2); e += THREADS) {
        const int r = e / (TP + 2), k = e - r * (TP + 2);
        const long long idx = start + k;
        float v = 0.f;
        if (r < nci && idx >= 0 && idx < in_len)
          v = x[(static_cast<long long>(b) * ly.cin + c0 + r) * in_len + idx];
        sx[r][k] = v;
      }
      for (int e = tid; e < KW * CI * TCH; e += THREADS) {
        const int o = e % TCH, rem = e / TCH, r = rem % CI, j = rem / CI;
        float v = 0.f;
        if (r < nci && o0 + o < ly.cout)
          v = w[(static_cast<long long>(i * KW + j) * ly.cin + c0 + r) * ly.cout + o0 + o];
        sw[j][r][o] = v;
      }
      __syncthreads();
      for (int r = 0; r < nci; ++r) {
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          float wv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) wv[a] = sw[j][r][ty + 16 * a];
#pragma unroll
          for (int k = 0; k < 4; ++k) xv[k] = sx[r][tx + 16 * k + j];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(wv[a], xv[k], acc[a][k]);
        }
      }
      __syncthreads();
    }
  }

  const long long plane0 = static_cast<long long>(q) * blk_out;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty + 16 * a;
    if (o >= ly.cout) continue;
    float* row = out + (static_cast<long long>(b) * ly.cout + o) * ly.out_len() + plane0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l0 + tx + 16 * k;
      if (l >= L) continue;
      row[2 * ly.Wp + l] = ly.valid(q, l) ? acc[a][k] + bias[o] : 0.f;
    }
  }
  write_halos(out, ly, b, q, o0, min(TCH, ly.cout - o0));
}

// ---------------------------------------------------------------------------
// layer 0 (cin = 1): grid (ceil(L/C1_THREADS), B*s_out); dynamic shared
// memory: the weights [kh*3][cout] fp32
// ---------------------------------------------------------------------------
constexpr int C1_THREADS = 128;
constexpr int C1_MAXKH = 8;

template <typename T>
__global__ void __launch_bounds__(C1_THREADS) mrd_fwd_c1_kernel(const T* __restrict__ x,
                                                                const float* __restrict__ w,
                                                                const float* __restrict__ bias,
                                                                T* __restrict__ out,
                                                                __nv_bfloat16* __restrict__ outt,
                                                                Layer ly, int round, Pack next) {
  extern __shared__ float sw1[];
  __shared__ float sx[C1_MAXKH][C1_THREADS + 2];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  pack_weights(next);
  const int tid = threadIdx.x, b = blockIdx.y / ly.s_out, q = blockIdx.y - b * ly.s_out;
  const int L = ly.L(), l0 = blockIdx.x * C1_THREADS, cout = ly.cout;
  const long long in_len = ly.in_len();
  for (int e = tid; e < ly.kh * KW * cout; e += C1_THREADS)
    sw1[e] = round ? round_bf16(w[e]) : w[e];
  block_taps(ly, false, q, taps, &ntaps);
  for (int i = 0; i < ly.kh; ++i)
    for (int k = tid; k < C1_THREADS + 2; k += C1_THREADS) {
      const long long idx = static_cast<long long>(taps[i].start) + l0 + k;
      sx[i][k] = idx >= 0 && idx < in_len ? load(x, b * in_len + idx) : 0.f;
    }
  __syncthreads();
  const int l = l0 + tid;
  const bool in = l < L, valid = in && ly.valid(q, l);
  T* base = out + static_cast<long long>(b) * cout * ly.out_len() +
            static_cast<long long>(q) * ly.blk_out() + 2 * ly.Wp + l;
  const int cp = pad32(cout);  // the position-major copy's row: 16-byte pieces of 8 channels
  __nv_bfloat16* trow = outt ? outt + (static_cast<long long>(b) * ly.out_len() +
                                       static_cast<long long>(q) * ly.blk_out() + 2 * ly.Wp + l) *
                                          cp
                             : nullptr;
  for (int o0 = 0; o0 < (outt ? cp : cout); o0 += 8) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    if (valid)
      for (int t = 0; t < ly.kh * KW; ++t) {
        const float xv = sx[t / KW][tid + t % KW];
        const float* wr = sw1 + t * cout + o0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (o0 + e < cout) acc[e] = fmaf(wr[e], xv, acc[e]);
      }
    if (!in) continue;
    uint4 piece;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&piece);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = o0 + e < cout && valid ? acc[e] + bias[o0 + e] : 0.f;
      if (o0 + e < cout) base[static_cast<long long>(o0 + e) * ly.out_len()] = from_f32<T>(v);
      h[e] = __float2bfloat16_rn(v);
    }
    if (trow) *reinterpret_cast<uint4*>(trow + o0) = piece;
  }
  write_halos(out, ly, b, q, 0, cout);
}

// ---------------------------------------------------------------------------
// the post layer (cout = 1): grid (ceil(L/32), B*s_out); dynamic shared
// memory: the weights [kh*3][cin] fp32
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NW_THREADS) mrd_fwd_narrow_kernel(const T* __restrict__ x,
                                                                    const float* __restrict__ w,
                                                                    const float* __restrict__ bias,
                                                                    T* __restrict__ out, Layer ly,
                                                                    int round) {
  extern __shared__ float swn[];
  using NP = Narrow<1, NW_WARPS>;
  __shared__ float red[NP::RED];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  const int b = blockIdx.y / ly.s_out, q = blockIdx.y - b * ly.s_out;
  const int L = ly.L(), l0 = blockIdx.x * NP::POS;
  for (int e = threadIdx.x; e < ly.kh * KW * ly.cin; e += NW_THREADS)
    swn[e] = round ? round_bf16(w[e]) : w[e];
  block_taps(ly, false, q, taps, &ntaps);
  float s[1] = {0.f};
  int l = l0 + static_cast<int>(threadIdx.x), n = threadIdx.x < NP::POS;
  if (l0 < ly.valid_rows(q) * ly.Wp)  // else the block's positions are all masked
    n = narrow_sum<1, NW_WARPS, false>(x, static_cast<long long>(b) * ly.cin, ly.in_len(), ly.cin,
                                       swn, taps, ntaps, l0, red, s, l);
  if (n && l < L)
    out[static_cast<long long>(b) * ly.out_len() + static_cast<long long>(q) * ly.blk_out() +
        2 * ly.Wp + l] = from_f32<T>(ly.valid(q, l) ? s[0] + bias[0] : 0.f);
  write_halos(out, ly, b, q, 0, 1);
}

template <typename K>
bool allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
         cudaSuccess;
}

template <int MT>
int launch_mma(const void* xt, const void* wp, const float* bias, void* out, void* outt,
               const Layer& ly, const Pack& next, cudaStream_t st) {
  constexpr int smem = MmaTile<MT, false>::SMEM;
  if (!allow_smem(mrd_fwd_mma_kernel<MT>, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(ly.L(), MMA_BN), cdiv(ly.cout, MmaTile<MT, false>::BM), ly.B * ly.s_out);
  mrd_fwd_mma_kernel<MT><<<grid, MMA_THREADS, smem, tvc::counted(st)>>>(
      static_cast<const __nv_bfloat16*>(xt), static_cast<const __nv_bfloat16*>(wp), bias,
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(outt), ly, next);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// M: x [B, cin, s_in*(g_in+4)*Wp] in the operand type, w [kh*3, cin, cout]
// fp32 (rounded to bf16 under bf16), bias [cout] fp32 -> out
// [B, cout, s_out*(g_out+4)*Wp] in the operand type. Under bf16 a layer with
// cin, cout > 1 reads xt, its input position-major [B, s_in*(g_in+4)*Wp,
// pad32(cin)], and its weights packed (wp, mrd_tiles.cuh::Pack); outt, if
// given, receives the output position-major for the next layer; wnext, if
// given, is the next layer's w (kh_n, cin_n, cout_n), which this launch
// packs into wpnext.
extern "C" int tvc_mrd_fwd(const void* x, const void* xt, const float* w, const float* bias,
                           void* out, void* outt, const void* wp, const float* wnext,
                           void* wpnext, int kh_n, int cin_n, int cout_n, MRD_LAYER_ARGS,
                           int bf16, void* stream) {
  const Layer ly = MRD_LAYER;
  const Pack next{wnext, static_cast<__nv_bfloat16*>(wpnext), kh_n, cin_n, cout_n};
  const bool mma = bf16 && cin > 1 && cout > 1;
  if (bad(ly) || (wnext && (!wpnext || !bf16)) || (outt && (!bf16 || cout == 1)) ||
      (mma && (!xt || !wp)) || reinterpret_cast<uintptr_t>(wpnext) % 16 ||
      reinterpret_cast<uintptr_t>(xt) % 16 || reinterpret_cast<uintptr_t>(wp) % 16 ||
      reinterpret_cast<uintptr_t>(outt) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ot = static_cast<__nv_bfloat16*>(outt);
  if (cin == 1) {
    const int smem = kh * KW * cout * 4;
    if (kh > C1_MAXKH || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(cdiv(ly.L(), C1_THREADS), B * s_out);
    if (bf16)
      mrd_fwd_c1_kernel<<<grid, C1_THREADS, smem, tvc::counted(st)>>>(
          static_cast<const __nv_bfloat16*>(x), w, bias, static_cast<__nv_bfloat16*>(out), ot, ly,
          1, next);
    else
      mrd_fwd_c1_kernel<<<grid, C1_THREADS, smem, tvc::counted(st)>>>(
          static_cast<const float*>(x), w, bias, static_cast<float*>(out), ot, ly, 0, next);
    return static_cast<int>(cudaGetLastError());
  }
  if (cout == 1) {
    const int smem = kh * KW * cin * 4;
    if (wnext || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(cdiv(ly.L(), Narrow<1, NW_WARPS>::POS), B * s_out);
    if (bf16)
      mrd_fwd_narrow_kernel<<<grid, NW_THREADS, smem, tvc::counted(st)>>>(
          static_cast<const __nv_bfloat16*>(x), w, bias, static_cast<__nv_bfloat16*>(out), ly,
          1);
    else
      mrd_fwd_narrow_kernel<<<grid, NW_THREADS, smem, tvc::counted(st)>>>(
          static_cast<const float*>(x), w, bias, static_cast<float*>(out), ly, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (mma) {
    switch (mma_mt(cout)) {
      case 1: return launch_mma<1>(xt, wp, bias, out, outt, ly, next, st);
      case 2: return launch_mma<2>(xt, wp, bias, out, outt, ly, next, st);
      default: return launch_mma<4>(xt, wp, bias, out, outt, ly, next, st);
    }
  }
  if (wnext) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(ly.L(), TP), cdiv(cout, TCH), B * s_out);
  mrd_fwd_kernel<<<grid, THREADS, 0, tvc::counted(st)>>>(static_cast<const float*>(x), w, bias,
                                           static_cast<float*>(out), ly);
  return static_cast<int>(cudaGetLastError());
}

