// Kernel N: the fused MRD chain's input-gradient sweep, for the decoder's
// post-join training step. Replaces the dx sweep of
// tinyvc_tpu/ops/pallas/mrd.py::_mrd_bwd (_bwd_kernel_dx, mrd.py:210,
// launched at :356): top-down, each layer's masked cotangent
// dy = mask(cot + dx from the layer above) and the gradient of its input, at
// layer 0 dspec.
//
// Bound on the H100: operations, as kernel M's (mrd_fwd.cu): the transposed
// products of every layer, 0.20 ms per crop (B=16, T=8000, four resolutions)
// at 989 TFLOP/s with bf16 operands; dspec's pass over dy0 is a bandwidth
// pass (11-28 MiB in bf16 per resolution).
//
// Design. dx is a gather, not a scatter, so no float atomics: per (batch
// row, input plane phi), dx[c][p] = sum over the (q, i) taps that land on
// phi, the channels o and the w-taps j of W[i][j][c][o] *
// dy_q[o][p - (2 + delta) * Wp + 1 - j], computed only on the rows the
// layer below reads, [2, 2 + its valid rows) of each plane.
//   bf16 (the tensor cores; per crop 2.2 ms of device time, against 34.1 ms
//     for CUDA-core products over every row): one launch a layer and one
//     more. The top layer's dy is a select (cot where valid, else 0), with a
//     position-major copy [B][position][pad32(cout)] (a shared-memory
//     transpose) and its weights packed to bf16. Each layer's products then
//     run on the tile of mrd_tiles.cuh (rows = input channels) from that copy,
//     and the epilogue forms the layer below's dy from the fp32 sums,
//     select(valid, cot_below + dx, 0), both ways, and packs the layer below's
//     weights: the fp32 dx never goes to device memory, and every dy element
//     has one writer (the first and last blocks along a plane write its halo
//     rows). Layer 0 (cin = 1): dspec over each plane's whole block (its
//     halos are part of the result), a one-output gather of the 32 channels'
//     taps, 128 positions a warp.
//   fp32 (exact: TF32 would break the tolerance): two launches a layer, the
//     select dy = (cot + above where valid, else 0) and the dx, 64 x 64
//     register tiles of fp32 FMAs, carried down in fp32 as the next layer's
//     `above` (its halo rows never written nor read), or dspec's gather.
// fp32 accumulation throughout; dspec leaves in the operand type
// (mrd.py:355).
//
// Left for later: wgmma, a persistent schedule; dspec's gather reads each
// dy0 element once per tap that lands on it (3-4), through L2.

#include "mrd_tiles.cuh"
#include "launch_count.cuh"

namespace {

// ---------------------------------------------------------------------------
// dy = select(valid, cot + above, 0) over one layer's flat output; packs own
// ---------------------------------------------------------------------------
constexpr int DY_TILE = 32;  // a block: 32 positions x 32 channels, threads (32, 8)

// grid (ceil(out_len/32), ceil(cout/32), B); dyt, if given, receives dy
// position-major [B][out_len][pad32(cout)] through a shared-memory tile
template <typename T>
__global__ void __launch_bounds__(DY_TILE * 8) mrd_dy_kernel(const T* __restrict__ cot,
                                                             const float* __restrict__ above,
                                                             T* __restrict__ dy,
                                                             __nv_bfloat16* __restrict__ dyt,
                                                             Layer ly, Pack own) {
  __shared__ float tile[DY_TILE][DY_TILE + 1];
  pack_weights(own);
  const int b = blockIdx.z, c0 = blockIdx.y * DY_TILE, p0 = blockIdx.x * DY_TILE;
  const int len = ly.out_len(), p = p0 + threadIdx.x;
  bool valid = false;  // p is a valid output position
  if (p < len) {
    const int q = p / ly.blk_out(), within = p - q * ly.blk_out() - 2 * ly.Wp;
    valid = within >= 0 && within < ly.L() && ly.valid(q, within);
  }
  for (int r = threadIdx.y; r < DY_TILE; r += 8) {
    const int c = c0 + r;
    float v = 0.f;
    if (c < ly.cout && p < len) {
      const long long n = (static_cast<long long>(b) * ly.cout + c) * len + p;
      if (valid) {
        v = load(cot, n);
        if (above) v += above[n];
      }
      dy[n] = from_f32<T>(v);
    }
    tile[r][threadIdx.x] = v;
  }
  if (!dyt) return;
  __syncthreads();
  const int cp = pad32(ly.cout), c = c0 + threadIdx.x;
  for (int r = threadIdx.y; r < DY_TILE; r += 8)
    if (p0 + r < len && c < cp)
      dyt[(static_cast<long long>(b) * len + p0 + r) * cp + c] =
          __float2bfloat16_rn(tile[threadIdx.x][r]);
}

// ---------------------------------------------------------------------------
// dx, cin > 1, bf16, with the layer below's dy formed in the epilogue:
// dy_below = select(valid below, cot_below + dx, 0), in bf16, and its
// position-major copy dyt_below (if the layer below runs on the tensor
// cores, else null); the fp32 dx never leaves the block. Packs `next`.
// grid (ceil(g_in*Wp/128), ceil(cin/BM), B*s_in)
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(MMA_THREADS) mrd_dx_mma_kernel(
    const __nv_bfloat16* __restrict__ dyt, const __nv_bfloat16* __restrict__ wp,
    const __nv_bfloat16* __restrict__ cot_below, __nv_bfloat16* __restrict__ dy_below,
    __nv_bfloat16* __restrict__ dyt_below, Layer ly, Pack next) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  constexpr int BM = MmaTile<MT, true>::BM;
  pack_weights(next);
  const int b = blockIdx.z / ly.s_in, phi = blockIdx.z - b * ly.s_in;
  const int p0 = 2 * ly.Wp + blockIdx.x * MMA_BN, m0 = blockIdx.y * BM;
  const int rows = ly.rows_in(phi), p_int = (2 + ly.g_in) * ly.Wp;  // interior rows end
  block_taps(ly, true, phi, taps, &ntaps);
  float acc[MT][8][4] = {};
  if (p0 < (2 + rows) * ly.Wp)  // else the tile holds no valid position of the layer below
    mma_tile<MT, true>(dyt + static_cast<long long>(b) * ly.out_len() * pad32(ly.cout),
                       pad32(ly.cout), wp, pad32(ly.cin), pad32(ly.cout), taps, ntaps, p0, m0,
                       smem, acc);
  stage_acc<MT>(acc, smem);
  // thread n forms position p0 + n of every channel (coalesced rows) and
  // keeps it position-major in shared memory for dyt_below's whole rows
  static_assert(MMA_THREADS == MMA_BN, "a thread a position");
  constexpr int TS = BM + 8;  // halves a staged row of channels
  static_assert(BM * OUT_STRIDE * 4 + MMA_BN * TS * 2 <= MmaTile<MT, true>::SMEM, "smem");
  const float* so = reinterpret_cast<const float*>(smem);
  __nv_bfloat16* stt = reinterpret_cast<__nv_bfloat16*>(smem + BM * OUT_STRIDE * 4);
  const int n = threadIdx.x, p = p0 + n, row = p / ly.Wp - 2, col = p - (row + 2) * ly.Wp;
  const bool valid = row < rows && col >= 1 && col <= ly.W;
  const long long base = static_cast<long long>(b) * ly.cin * ly.in_len() +
                         static_cast<long long>(phi) * ly.blk_in() + p;
  const int cp = pad32(ly.cin), nt = min(BM, cp - m0);
  for (int m = 0; m < nt; ++m) {
    const int c = m0 + m;
    const long long at = base + static_cast<long long>(c) * ly.in_len();
    const float v = valid && c < ly.cin ? to_f32(cot_below[at]) + so[m * OUT_STRIDE + n] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    if (c < ly.cin && p < p_int) dy_below[at] = h;
    stt[n * TS + m] = h;
  }
  if (dyt_below) {
    __syncthreads();
    const int pieces = nt / 8, shift = __ffs(pieces) - 1;
    uint4* rowst = reinterpret_cast<uint4*>(
        dyt_below + (static_cast<long long>(b) * ly.in_len() +
                     static_cast<long long>(phi) * ly.blk_in() + p0) * cp + m0);
    for (int e = threadIdx.x; e < MMA_BN * pieces; e += MMA_THREADS) {
      const int nn = e >> shift, g = e & (pieces - 1);
      if (p0 + nn < p_int)
        rowst[static_cast<long long>(nn) * (cp / 8) + g] =
            *reinterpret_cast<const uint4*>(stt + nn * TS + 8 * g);
    }
  }
  // the plane's halo rows of dy_below: the first block along x the head, the last the tail
  const bool head = blockIdx.x == 0, last = blockIdx.x == gridDim.x - 1;
  if (head || last) {
    const int halo = 2 * ly.Wp, tail = ly.blk_in() - p_int;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int c = m0 + static_cast<int>(threadIdx.x >> 5); c < min(m0 + BM, ly.cin);
         c += MMA_THREADS / 32) {
      __nv_bfloat16* plane = dy_below + (static_cast<long long>(b) * ly.cin + c) * ly.in_len() +
                             static_cast<long long>(phi) * ly.blk_in();
      if (head)
        for (int q = threadIdx.x & 31; q < halo; q += 32) plane[q] = zero;
      if (last)
        for (int q = threadIdx.x & 31; q < tail; q += 32) plane[p_int + q] = zero;
    }
  }
}

// ---------------------------------------------------------------------------
// dx, cin > 1, fp32: grid (ceil(g_in*Wp/TP), ceil(cin/TCH), B*s_in)
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int TP = 64;   // positions per block
constexpr int TCH = 64;  // channels per block
constexpr int CI = 16;   // reduction rows per shared-memory stage

__global__ void __launch_bounds__(THREADS) mrd_dx_kernel(const float* __restrict__ dy,
                                                         const float* __restrict__ w,
                                                         float* __restrict__ dx, Layer ly) {
  __shared__ float sd[CI][TP + 2];
  __shared__ float sw[KW][CI][TCH + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int L = ly.L(), blk_out = ly.blk_out();
  const long long out_len = ly.out_len();
  const int p0 = 2 * ly.Wp + blockIdx.x * TP, c0 = blockIdx.y * TCH;
  const int b = blockIdx.z / ly.s_in, phi = blockIdx.z - b * ly.s_in;
  const int p_hi = (2 + ly.rows_in(phi)) * ly.Wp;
  if (p0 >= p_hi) return;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  for (int q = 0; q < ly.s_out; ++q) {
    for (int i = 0; i < ly.kh; ++i) {
      int tphi, delta;
      ly.tap(q, i, tphi, delta);
      if (tphi != phi) continue;
      // input position p reads dy_q at l = p - (2 + delta) * Wp + 1 - j
      const int lstart = p0 - (2 + delta) * ly.Wp - 1;
      for (int o0 = 0; o0 < ly.cout; o0 += CI) {
        const int nco = min(CI, ly.cout - o0);
        for (int e = tid; e < CI * (TP + 2); e += THREADS) {
          const int r = e / (TP + 2), k = e - r * (TP + 2);
          const int l = lstart + k;
          float v = 0.f;
          if (r < nco && l >= 0 && l < L)
            v = dy[(static_cast<long long>(b) * ly.cout + o0 + r) * out_len +
                   static_cast<long long>(q) * blk_out + 2 * ly.Wp + l];
          sd[r][k] = v;
        }
        // W[i][j][c][o] as sw[j][o][c]: consecutive threads read consecutive o
        for (int e = tid; e < KW * CI * TCH; e += THREADS) {
          const int r = e % CI, rem = e / CI, c = rem % TCH, j = rem / TCH;
          float v = 0.f;
          if (r < nco && c0 + c < ly.cin)
            v = w[(static_cast<long long>(i * KW + j) * ly.cin + c0 + c) * ly.cout + o0 + r];
          sw[j][r][c] = v;
        }
        __syncthreads();
        for (int r = 0; r < nco; ++r) {
#pragma unroll
          for (int j = 0; j < KW; ++j) {
            float wv[4], dv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) wv[a] = sw[j][r][ty + 16 * a];
#pragma unroll
            for (int k = 0; k < 4; ++k) dv[k] = sd[r][tx + 16 * k + 2 - j];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[a][k] = fmaf(wv[a], dv[k], acc[a][k]);
          }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = c0 + ty + 16 * a;
    if (c >= ly.cin) continue;
    float* row = dx + (static_cast<long long>(b) * ly.cin + c) * ly.in_len() +
                 static_cast<long long>(phi) * ly.blk_in();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + tx + 16 * k;
      if (p < p_hi) row[p] = acc[a][k];
    }
  }
}

// ---------------------------------------------------------------------------
// dx, cin = 1 (dspec): grid (ceil(blk_in/1024), B*s_in); dynamic shared
// memory: the weights [kh*3][cout] fp32
// ---------------------------------------------------------------------------
template <typename TI, typename TO>
__global__ void __launch_bounds__(NW_THREADS) mrd_dx_narrow_kernel(const TI* __restrict__ dy,
                                                                   const float* __restrict__ w,
                                                                   TO* __restrict__ dx, Layer ly,
                                                                   int round) {
  extern __shared__ float swn[];
  using NP = Narrow<4, 1>;
  __shared__ float red[NP::RED];
  __shared__ Tap taps[MAXT];
  __shared__ int ntaps;
  const int b = blockIdx.y / ly.s_in, phi = blockIdx.y - b * ly.s_in;
  const int p0 = blockIdx.x * NP::POS;
  for (int e = threadIdx.x; e < ly.kh * KW * ly.cout; e += NW_THREADS)
    swn[e] = round ? round_bf16(w[e]) : w[e];
  block_taps(ly, true, phi, taps, &ntaps);
  float s[4];
  int p;
  narrow_sum<4, 1, true>(dy, static_cast<long long>(b) * ly.cout, ly.out_len(), ly.cout, swn,
                         taps, ntaps, p0, red, s, p);
  TO* row = dx + static_cast<long long>(b) * ly.in_len() + static_cast<long long>(phi) * ly.blk_in();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (p + k < ly.blk_in()) row[p + k] = from_f32<TO>(s[k]);
}

template <int MT>
int launch_mma(const void* dyt, const void* wp, const void* cot_below, void* dy_below,
               void* dyt_below, const Layer& ly, const Pack& next, cudaStream_t st) {
  constexpr int smem = MmaTile<MT, true>::SMEM;
  if (cudaFuncSetAttribute(mrd_dx_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(ly.g_in * ly.Wp, MMA_BN), cdiv(ly.cin, MmaTile<MT, true>::BM),
                  ly.B * ly.s_in);
  mrd_dx_mma_kernel<MT><<<grid, MMA_THREADS, smem, tvc::counted(st)>>>(
      static_cast<const __nv_bfloat16*>(dyt), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(cot_below), static_cast<__nv_bfloat16*>(dy_below),
      static_cast<__nv_bfloat16*>(dyt_below), ly, next);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N for one layer li, in the operand type of cot / dy (bf16 or fp32).
//  fp32: dy = select(valid, cot + above, 0) (above fp32, or null at the
//    top), then dx [B, cin, s_in*(g_in+4)*Wp] from dy and w [kh*3, cin, cout]
//    fp32: every position at cin = 1 (layer 0), else the rows the layer below
//    reads, in fp32, carried down as the next call's `above`.
//  bf16, cin > 1: if cot is given (the top layer), first dy = select(valid,
//    cot, 0) with its position-major copy dyt [B, s_out*(g_out+4)*Wp,
//    pad32(cout)] and w packed into wp; then the products from dyt and wp,
//    whose epilogue forms the layer below's dy_below = select(valid,
//    cot_below + dx, 0) [B, cin, in_len] and, if dyt_below is given, its
//    position-major copy; wnext (the layer below's w, kh_n, cin_n, cout_n),
//    if given, is packed into wpnext. dx is not written.
//  bf16, cin = 1 (layer 0): dspec into dx (bf16 under dx_bf16) from dy,
//    formed by the layer above's call (or here from cot, if given).
// One launch a layer, two where dy is formed here.
extern "C" int tvc_mrd_dx(const void* cot, const float* above, void* dy, void* dyt, void* dx,
                          const float* w, void* wp, const void* cot_below, void* dy_below,
                          void* dyt_below, const float* wnext, void* wpnext, int kh_n, int cin_n,
                          int cout_n, MRD_LAYER_ARGS, int bf16, int dx_bf16, void* stream) {
  const Layer ly = MRD_LAYER;
  const bool mma = bf16 && cin > 1;
  const Pack own{mma && cot ? w : nullptr, static_cast<__nv_bfloat16*>(wp), kh, cin, cout};
  const Pack next{wnext, static_cast<__nv_bfloat16*>(wpnext), kh_n, cin_n, cout_n};
  if (bad(ly) || (dx_bf16 && (!bf16 || cin != 1)) ||
      (mma && (!wp || !dyt || !cot_below || !dy_below || above || dx)) ||
      (!mma && (dyt || cot_below || dy_below || dyt_below || wnext || !dx)) ||
      (!bf16 && !cot) || (wnext && !wpnext) || reinterpret_cast<uintptr_t>(dyt) % 16 ||
      reinterpret_cast<uintptr_t>(wp) % 16 || reinterpret_cast<uintptr_t>(dyt_below) % 16 ||
      reinterpret_cast<uintptr_t>(wpnext) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin == 1 && kh * KW * cout * 4 > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 dy_grid(cdiv(ly.out_len(), DY_TILE), cdiv(cout, DY_TILE), B), dy_block(DY_TILE, 8);
  const dim3 narrow_grid(cdiv(ly.blk_in(), Narrow<4, 1>::POS), B * s_in);
  const int narrow_smem = kh * KW * cout * 4;
  auto* t = static_cast<__nv_bfloat16*>(dyt);
  if (bf16) {
    auto* d = static_cast<__nv_bfloat16*>(dy);
    if (cot) {
      mrd_dy_kernel<<<dy_grid, dy_block, 0, tvc::counted(st)>>>(
          static_cast<const __nv_bfloat16*>(cot), above, d, t, ly, own);
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc) return rc;
    }
    if (mma) {
      switch (mma_mt(cin)) {
        case 1: return launch_mma<1>(dyt, wp, cot_below, dy_below, dyt_below, ly, next, st);
        default: return launch_mma<2>(dyt, wp, cot_below, dy_below, dyt_below, ly, next, st);
      }
    }
    if (dx_bf16)
      mrd_dx_narrow_kernel<<<narrow_grid, NW_THREADS, narrow_smem, tvc::counted(st)>>>(
          static_cast<const __nv_bfloat16*>(d), w, static_cast<__nv_bfloat16*>(dx), ly, 1);
    else
      mrd_dx_narrow_kernel<<<narrow_grid, NW_THREADS, narrow_smem, tvc::counted(st)>>>(
          static_cast<const __nv_bfloat16*>(d), w, static_cast<float*>(dx), ly, 1);
  } else {
    auto* d = static_cast<float*>(dy);
    mrd_dy_kernel<<<dy_grid, dy_block, 0, tvc::counted(st)>>>(static_cast<const float*>(cot),
                                                              above, d, t, ly, own);
    if (cin == 1)
      mrd_dx_narrow_kernel<<<narrow_grid, NW_THREADS, narrow_smem, tvc::counted(st)>>>(
          static_cast<const float*>(d), w, static_cast<float*>(dx), ly, 0);
    else
      mrd_dx_kernel<<<dim3(cdiv(g_in * Wp, TP), cdiv(cin, TCH), B * s_in), THREADS, 0,
                      tvc::counted(st)>>>(d, w, static_cast<float*>(dx), ly);
  }
  return static_cast<int>(cudaGetLastError());
}
