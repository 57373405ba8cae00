// Kernel H: kNN feature matching against one shared dictionary.
//
// Replaces tinyvc_tpu/ops/pallas/knn.py::pallas_match_features (_knn_kernel),
// which the bf16 serving profile runs when the dictionary is 2-D and at most
// 12 MiB in fp32 (tinyvc_tpu/infer/generator.py::serving_match_features):
// source rows x [R, C] (R = B*T), dictionary [N, C] -> [R, C] fp32.
//
// Function, per source row:
//   - cos normalises the row, x / (|x| + 1e-6); the dictionary rows come
//     normalised from the wrapper (JAX normalises them outside its kernel);
//   - similarity s.r against every dictionary row, ranked by s.r (cos, IP)
//     or by 2 s.r - |r|^2 (L2, the wrapper's rank-bias row);
//   - the k best by k argmax passes: by value, ties to the lowest index;
//   - the mean of those k dictionary rows rounded to bf16 (the TPU's
//     ref_mean = ref.astype(bfloat16)), summed in fp32 in index order (the
//     one-hot product's order), divided by k;
//   - mean * (1 - alpha) + x * alpha with the raw row x.
//
// Bound on the H100: operations, 2 * R * N * C fp32 flops for the similarity
// product (1.0 GFLOP at R=320, N=2048, C=768: 15 us at the 67 TFLOP/s fp32
// peak; 8.1 GFLOP, 120 us, at R=2560); the bytes (source, dictionary,
// output) are some 15 MB. The products stay fp32 FMAs on the CUDA cores: a
// neighbour flips where two similarities agree to ~1e-6, and TF32 or bf16
// splits are coarser than that. At R=320 the product is too small to fill
// the card with whole tiles (10 x 32 tiles of 32 x 64 similarities), so
// latency, not the FMA rate, bounds it.
//
// Design. The TPU keeps the whole [t, N] similarity tile in VMEM and runs k
// masked argmax passes over it. Here no similarity is stored; three
// launches:
//   1. knn_prep writes the source transposed, xT [C, Rp] (Rp = R padded to
//      64 with zero columns), each row normalised once under cos with
//      __fdiv_rn, as the plain version rounds it. The dictionary comes
//      transposed the same way, refT [C, Np], from the wrapper, which
//      prepares it once per dictionary.
//   2. knn_topk: a block holds WM warps of 16 source rows x one 64-row tile
//      of the dictionary at a time, over its slice of the dictionary; a
//      thread holds a 4 x 8 register tile of fp32 FMA sums, channel after
//      channel. Both operands are K-major, so a 3-stage ring of 32-channel
//      chunks fills shared memory by 16-byte cp.async copies, the next
//      chunks in flight while the current one is multiplied, and each
//      thread reads its operands as float4. With KS = 2 (the 32-row tiles of
//      small R) two warps share each 16 x 64 tile, each summing 16 of every
//      32 channels, and the second's sums are added to the first's once the
//      tile is done: twice the warps where the card has too few. Each
//      finished tile is folded into per-thread top-KL lists in registers
//      (KL = 4 or 8 >= k); the 8 lanes that share rows merge theirs by
//      shuffles at the end, and the block writes its slice's k best per row
//      to the [nsplit, R, k] workspace.
//   3. knn_mean: a warp per row merges the slices' lists by shuffles, writes
//      the neighbours best first, and gathers the k bf16 rows with 16-byte
//      loads (8 channels a lane) for the mean and the blend.
// Ranking by (value desc, index asc) at every merge gives the argmax passes'
// order. The schedule (tile height, slice, nsplit) is `schedule` below,
// mirrored by kernels/knn.py::knn_schedule: 32-row blocks of 2 x 2 warps
// until 64-row blocks of 4 warps fill the 132 SMs twice, one 64-row
// dictionary tile a slice up to N = 2048; 10 x 32 = 320 blocks at R=320,
// N=2048, 40 x 32 at R=2560.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "mma.cuh"
#include "launch_count.cuh"

namespace {

constexpr int BN = 64;            // dictionary rows per tile: one warp's columns
constexpr int BK = 32;            // channels per stage of the ring
constexpr int STAGES = 3;
constexpr int PAD = 64;           // xT's and refT's columns padded to this
constexpr int FILL = 2 * 132;     // blocks: at least two an SM
constexpr int MAX_SPLIT = 32;     // candidate lists a row, at most
constexpr int KMAX = 8;
constexpr int EMPTY = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

enum Metric { COS = 0, IP = 1, L2 = 2 };

struct Schedule {
  int rows;    // source rows a block: 32 or 64
  int slice;   // dictionary rows a block (a multiple of BN)
  int nsplit;  // slices, the workspace's first dimension
};

// The 4-warp tile (64 rows) when its blocks fill the card twice, else the
// 2-warp tile (32 rows); slices of one 64-row dictionary tile, or of as
// many as keep a row's candidate lists at MAX_SPLIT. Many small blocks: the
// hardware's block scheduler balances them over the SMs.
Schedule schedule(int R, int N) {
  const int nt = (N + BN - 1) / BN;
  const int per = (nt + MAX_SPLIT - 1) / MAX_SPLIT;
  const int nsplit = (nt + per - 1) / per;
  const int rows = static_cast<long long>((R + 63) / 64) * nsplit >= FILL ? 64 : 32;
  return {rows, per * BN, nsplit};
}

int padded(int n) { return (n + PAD - 1) / PAD * PAD; }

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Bubble (v, i) into the sorted list (vals, idxs); the worst falls out.
// Unrolled with static indices, so the list stays in registers.
template <int KL>
__device__ __forceinline__ void insert(float (&vals)[KL], int (&idxs)[KL], float v, int i) {
  if (!better(v, i, vals[KL - 1], idxs[KL - 1])) return;
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    if (better(v, i, vals[j], idxs[j])) {
      const float tv = vals[j];
      const int ti = idxs[j];
      vals[j] = v;
      idxs[j] = i;
      v = tv;
      i = ti;
    }
  }
}

// merge the list of lane ^ o into this lane's
template <int KL>
__device__ __forceinline__ void merge_lane(float (&vals)[KL], int (&idxs)[KL], int o) {
  float pv[KL];
  int pi[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    pv[j] = __shfl_xor_sync(FULL, vals[j], o);
    pi[j] = __shfl_xor_sync(FULL, idxs[j], o);
  }
#pragma unroll
  for (int j = 0; j < KL; ++j) insert(vals, idxs, pv[j], pi[j]);
}

// Launch 1. Block: 32 source rows x 128 channels, 256 threads; the tile is
// loaded in one batch, then written transposed.
__global__ void __launch_bounds__(256)
knn_prep(const float* __restrict__ x, float* __restrict__ xT, int R, int Rp, int C, int metric) {
  __shared__ float tile[32][129];
  __shared__ float sinv[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * 32, c_lo = blockIdx.y * 128;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int m = warp + 8 * (u & 3), cc = 32 * (u >> 2) + lane;
    tile[m][cc] = r0 + m < R && c_lo + cc < C ? x[static_cast<long long>(r0 + m) * C + c_lo + cc]
                                              : 0.f;
  }
  if (metric == COS) {
    // |x| + 1e-6 of rows warp + 8 u, the four at once, each channel by channel
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r0 + warp + 8 * u < R) {
          const float v = x[static_cast<long long>(r0 + warp + 8 * u) * C + c];
          acc[u] = fmaf(v, v, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(FULL, acc[u], o);
      if (lane == 0) sinv[warp + 8 * u] = sqrtf(acc[u]) + 1e-6f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int cc = warp + 8 * u;
    if (c_lo + cc < C) {
      float v = tile[lane][cc];
      if (metric == COS && r0 + lane < R) v = __fdiv_rn(v, sinv[lane]);
      xT[static_cast<long long>(c_lo + cc) * Rp + r0 + lane] = v;
    }
  }
}

// Launch 2. WM x KS warps: warp (w, p) takes rows r0 + 16 w .. + 15 of the
// block's tile and channel part p (channels kk of each BK-chunk with
// kk / (BK / KS) == p); lane (gi, gj) = (lane / 8, lane % 8) rows 4 gi ..
// 4 gi + 3 and columns 4 gj .. 4 gj + 3, 32 + 4 gj .. 32 + 4 gj + 3 of the
// warp's 16 x 64. With KS = 2 a tile's similarity is part 0's FMA chain plus
// part 1's, added in that order once the tile is summed; part 0 holds the
// lists.
template <int WM, int KS, int KL>
__global__ void __launch_bounds__(WM * KS * 32, 4)
knn_topk(const float* __restrict__ xT, const float* __restrict__ refT,
         const float* __restrict__ rowb, float* __restrict__ cand_v, int* __restrict__ cand_i,
         int R, int Rp, int N, int Np, int C, int k, int metric, int slice) {
  constexpr int BM = 16 * WM, THREADS = 32 * WM * KS, KK = BK / KS;
  static_assert(BK * BM / 4 % THREADS == 0 && BK * BN / 4 % THREADS == 0, "copies a thread");
  __shared__ __align__(16) float sa[STAGES][BK][BM];
  __shared__ __align__(16) float sb[STAGES][BK][BN];

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % WM, part = (tid >> 5) / WM;
  const int gi = lane >> 3, gj = lane & 7;
  const int r0 = blockIdx.x * BM;
  const int n_lo = blockIdx.y * slice;
  const int n_hi = min(N, n_lo + slice);
  const int nchunks = (C + BK - 1) / BK;
  const int steps = (n_hi - n_lo + BN - 1) / BN * nchunks;

  // stage s of the flat (tile, chunk) sequence into its ring slot; channels
  // past C are zero-filled
  auto load = [&](int s) {
    const int t = s / nchunks;
    const int c0 = (s - t * nchunks) * BK;
    const int n0 = n_lo + t * BN;
    float(*a)[BM] = sa[s % STAGES];
    float(*b)[BN] = sb[s % STAGES];
#pragma unroll
    for (int u = 0; u < BK * BM / 4 / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int kk = e / (BM / 4), q = e % (BM / 4);
      const bool ok = c0 + kk < C;
      cp_async16(&a[kk][4 * q], xT + static_cast<long long>(ok ? c0 + kk : 0) * Rp + r0 + 4 * q,
                 ok);
    }
#pragma unroll
    for (int u = 0; u < BK * BN / 4 / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int kk = e / (BN / 4), q = e % (BN / 4);
      const bool ok = c0 + kk < C && n0 + 4 * q < Np;
      cp_async16(&b[kk][4 * q],
                 ok ? refT + static_cast<long long>(c0 + kk) * Np + n0 + 4 * q : refT, ok);
    }
  };

  float acc[4][8];
  float vals[4][KL];
  int idxs[4][KL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      vals[i][j] = -INFINITY;
      idxs[i][j] = EMPTY;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  int chunk = 0, n0 = n_lo;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s has landed; slot (s - 1) % STAGES is free
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    cp_async_commit();
    const float(*a)[BM] = sa[s % STAGES];
    const float(*b)[BN] = sb[s % STAGES];
#pragma unroll
    for (int u = 0; u < KK; ++u) {
      const int kk = part * KK + u;
      const float4 av = *reinterpret_cast<const float4*>(&a[kk][16 * warp + 4 * gi]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][4 * gj]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][32 + 4 * gj]);
      const float xa[4] = {av.x, av.y, av.z, av.w};
      const float db[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xa[i], db[j], acc[i][j]);
    }
    if (++chunk == nchunks) {
      // the tile is summed: part 0 adds the other parts' sums, folds the
      // tile into its lists, and every part starts the next tile
      if constexpr (KS > 1) {
        __shared__ float red[KS - 1][WM][32][32];
        if (part > 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) red[part - 1][warp][e][lane] = acc[e / 8][e % 8];
        }
        __syncthreads();  // the next write to red is a tile, and a barrier, away
        if (part == 0) {
#pragma unroll
          for (int p = 0; p < KS - 1; ++p)
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[e / 8][e % 8] += red[p][warp][e][lane];
        }
      }
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + (j < 4 ? 4 * gj + j : 32 + 4 * gj + j - 4);
          if (n < n_hi) {
            const float bias = metric == L2 ? rowb[n] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              insert(vals[i], idxs[i], metric == L2 ? fmaf(2.f, acc[i][j], bias) : acc[i][j],
                     n);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      chunk = 0;
      n0 += BN;
    }
  }
  cp_async_wait<0>();
  if (part > 0) return;

  // the 8 lanes of a row group (lanes 8 gi .. 8 gi + 7) merge their lists
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) merge_lane(vals[i], idxs[i], o);
  if (gj == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 16 * warp + 4 * gi + i;
      if (r >= R) continue;
      const long long base = (static_cast<long long>(blockIdx.y) * R + r) * k;
#pragma unroll
      for (int j = 0; j < KL; ++j)
        if (j < k) {
          cand_v[base + j] = vals[i][j];
          cand_i[base + j] = idxs[i][j];
        }
    }
  }
}

// Launch 3. A warp per source row, 8 rows a block.
template <int KL>
__global__ void __launch_bounds__(256)
knn_mean(const float* __restrict__ x, const __nv_bfloat16* __restrict__ refm,
         const float* __restrict__ cand_v, const int* __restrict__ cand_i,
         float* __restrict__ out, int* __restrict__ idx_out, int R, int C, int k, int nsplit,
         float alpha, float one_minus_alpha, int vec) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp
  float vals[KL];
  int idxs[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    vals[j] = -INFINITY;
    idxs[j] = EMPTY;
  }
#pragma unroll 4
  for (int t = lane; t < nsplit * k; t += 32) {
    const int s = t / k;
    const long long e = (static_cast<long long>(s) * R + r) * k + (t - s * k);
    insert(vals, idxs, cand_v[e], cand_i[e]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge_lane(vals, idxs, o);
  // every lane holds the row's best KL, the neighbours first
  int sel[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) {
    if (j < k && lane == j) idx_out[static_cast<long long>(r) * k + j] = idxs[j];
    sel[j] = j < k ? idxs[j] : EMPTY;
  }
  // the mean sums in increasing index order
#pragma unroll
  for (int i = 0; i < KL - 1; ++i)
#pragma unroll
    for (int j = 0; j < KL - 1 - i; ++j)
      if (sel[j] > sel[j + 1]) {
        const int t = sel[j];
        sel[j] = sel[j + 1];
        sel[j + 1] = t;
      }
  const float kf = static_cast<float>(k);
  const long long row = static_cast<long long>(r) * C;
  if (vec) {
    // 8 channels a lane: one 16-byte load of each neighbour's bf16 row
#pragma unroll 3
    for (int c = 8 * lane; c < C; c += 256) {
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.f;
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        if (j < k) {
          const uint4 u =
              *reinterpret_cast<const uint4*>(refm + static_cast<long long>(sel[j]) * C + c);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[2 * e] += __uint_as_float(w[e] << 16);
            sum[2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
          }
        }
      }
      float m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = __fdiv_rn(sum[e], kf);
      if (alpha != 0.f) {
        const float4 x0 = *reinterpret_cast<const float4*>(x + row + c);
        const float4 x1 = *reinterpret_cast<const float4*>(x + row + c + 4);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          m[e] = __fadd_rn(__fmul_rn(m[e], one_minus_alpha), __fmul_rn(xv[e], alpha));
      }
      *reinterpret_cast<float4*>(out + row + c) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(out + row + c + 4) = make_float4(m[4], m[5], m[6], m[7]);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KL; ++j)
        if (j < k) sum += to_f32(refm[static_cast<long long>(sel[j]) * C + c]);
      float m = __fdiv_rn(sum, kf);
      if (alpha != 0.f) m = __fadd_rn(__fmul_rn(m, one_minus_alpha), __fmul_rn(x[row + c], alpha));
      out[row + c] = m;
    }
  }
}

template <int KL>
int launch_knn(const float* x, float* xT, const float* refT, const float* rowb,
               const __nv_bfloat16* refm, float* cand_v, int* cand_i, float* out, int* idx_out,
               int R, int N, int C, int k, int metric, const Schedule& sc, float alpha,
               float one_minus_alpha, cudaStream_t st) {
  const int Rp = padded(R), Np = padded(N);
  knn_prep<<<dim3(Rp / 32, (C + 127) / 128), 256, 0, tvc::counted(st)>>>(x, xT, R, Rp, C, metric);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const dim3 grid((R + sc.rows - 1) / sc.rows, sc.nsplit);
  if (sc.rows == 64)
    knn_topk<4, 1, KL><<<grid, 128, 0, tvc::counted(st)>>>(xT, refT, rowb, cand_v, cand_i, R, Rp,
                                                           N, Np, C, k, metric, sc.slice);
  else
    knn_topk<2, 2, KL><<<grid, 128, 0, tvc::counted(st)>>>(xT, refT, rowb, cand_v, cand_i, R, Rp,
                                                           N, Np, C, k, metric, sc.slice);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const int vec = C % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                    reinterpret_cast<uintptr_t>(refm)) & 15) == 0;
  knn_mean<KL><<<(R + 7) / 8, 256, 0, tvc::counted(st)>>>(x, refm, cand_v, cand_i, out, idx_out, R,
                                                         C, k, sc.nsplit, alpha, one_minus_alpha,
                                                         vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [R, C]; xT [C, pad64(R)] workspace; refT [C, pad64(N)] (the similarity
// rows, transposed, zero columns past N); rowb [N] (L2 rank bias); refm
// [N, C] bf16 (mean rows); cand_v/cand_i [nsplit, R, k] workspace, nsplit
// as `schedule` (kernels/knn.py::knn_schedule) gives it; out [R, C] fp32;
// idx_out [R, k] int32, the neighbours best first. metric: 0 cos, 1 IP, 2 L2.
extern "C" int tvc_knn(const float* x, float* xT, const float* refT, const float* rowb,
                       const void* refm, float* cand_v, int* cand_i, float* out, int* idx_out,
                       int R, int N, int C, int k, int metric, int nsplit, float alpha,
                       float one_minus_alpha, void* stream) {
  if (R <= 0 || C <= 0 || k < 1 || k > KMAX || N < k || metric < 0 || metric > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Schedule sc = schedule(R, N);
  if (nsplit != sc.nsplit || sc.nsplit > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const __nv_bfloat16*>(refm);
  if (k <= 4)
    return launch_knn<4>(x, xT, refT, rowb, m, cand_v, cand_i, out, idx_out, R, N, C, k, metric,
                         sc, alpha, one_minus_alpha, st);
  return launch_knn<8>(x, xT, refT, rowb, m, cand_v, cand_i, out, idx_out, R, N, C, k, metric, sc,
                       alpha, one_minus_alpha, st);
}
