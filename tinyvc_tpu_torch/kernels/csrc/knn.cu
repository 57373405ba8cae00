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
// Design. The TPU keeps the whole [t, N] similarity tile in VMEM and runs k
// masked argmax passes over it. Here no similarity is stored: launch 1
// computes a [64 rows x 64 dictionary rows] tile of similarities at a time in
// registers (an fp32 FMA product over C in chunks of 32 staged in shared
// memory; 256 threads, each 4 x 4) and folds each into a running top-k kept
// in registers per (thread, row); the 16 threads that share a row merge their
// lists by warp shuffles. A block covers one 128-row slice of the dictionary,
// so small batches still fill the card; its top-k per row goes to a
// workspace. Launch 2 merges the slices' lists per row, orders the k indices,
// and forms the mean and the blend. Ranking by (value desc, index asc) at
// every merge gives the argmax passes' order.
//
// Bound on the H100: operations, 2 * R * N * C fp32 flops for the similarity
// product (1.0 GFLOP at R=320, N=2048, C=768: 15 us at the fp32 peak), the
// bytes (source, dictionary twice, output) some 15 MB. The sums are fp32 on
// the CUDA cores: a neighbour flips where two similarities agree to ~1e-6.

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

constexpr int TM = 64;       // source rows per block
constexpr int TN = 64;       // dictionary rows per inner tile
constexpr int SPLIT = 128;   // dictionary rows per block
constexpr int CC = 32;       // channels per reduction chunk
constexpr int THREADS = 256; // 16 dictionary lanes x 16 row lanes
constexpr int KMAX = 8;
constexpr int EMPTY = 0x7fffffff;

enum Metric { COS = 0, IP = 1, L2 = 2 };

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Bubble (v, i) into the sorted list (vals, idxs) of length k; the worst
// falls out. Unrolled over KMAX with static indices, so the list stays in
// registers.
__device__ __forceinline__ void insert(float (&vals)[KMAX], int (&idxs)[KMAX], float v, int i,
                                       int k) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k && better(v, i, vals[j], idxs[j])) {
      const float tv = vals[j];
      const int ti = idxs[j];
      vals[j] = v;
      idxs[j] = i;
      v = tv;
      i = ti;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
knn_topk(const float* __restrict__ x, const float* __restrict__ refn,
         const float* __restrict__ rowb, float* __restrict__ cand_v, int* __restrict__ cand_i,
         int R, int N, int C, int k, int metric) {
  __shared__ float sx[CC][TM + 1];
  __shared__ float sd[CC][TN + 1];
  __shared__ float sinv[TM];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = blockIdx.x * TM;
  const int n_lo = blockIdx.y * SPLIT;
  const int n_hi = min(N, n_lo + SPLIT);

  // cos: |x| + 1e-6 of each of the block's rows, one warp per row at a time
  if (metric == COS) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int m = warp; m < TM; m += THREADS / 32) {
      float acc = 0.f;
      if (r0 + m < R)
        for (int c = lane; c < C; c += 32) {
          const float v = x[static_cast<long long>(r0 + m) * C + c];
          acc = fmaf(v, v, acc);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) sinv[m] = sqrtf(acc) + 1e-6f;
    }
  }

  float vals[4][KMAX];
  int idxs[4][KMAX];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      vals[a][j] = -INFINITY;
      idxs[a][j] = EMPTY;
    }

  for (int nt = n_lo; nt < n_hi; nt += TN) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += CC) {
      __syncthreads();
      for (int e = tid; e < TM * CC; e += THREADS) {
        const int c = e % CC, m = e / CC;
        float v = 0.f;
        if (r0 + m < R && c0 + c < C) {
          v = x[static_cast<long long>(r0 + m) * C + c0 + c];
          if (metric == COS) v = __fdiv_rn(v, sinv[m]);
        }
        sx[c][m] = v;
      }
      for (int e = tid; e < TN * CC; e += THREADS) {
        const int c = e % CC, n = e / CC;
        sd[c][n] = nt + n < n_hi && c0 + c < C
                       ? refn[static_cast<long long>(nt + n) * C + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < CC; ++c) {
        float xv[4], dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = sx[c][ty + 16 * a];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = sd[c][tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(xv[a], dv[j], acc[a][j]);
      }
    }
    // fold the tile into the running lists, in increasing dictionary index
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nt + tx + 16 * j;
      if (n >= n_hi) continue;
      const float bias = metric == L2 ? rowb[n] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float v = metric == L2 ? fmaf(2.f, acc[a][j], bias) : acc[a][j];
        insert(vals[a], idxs[a], v, n, k);
      }
    }
  }

  // merge the 16 lists of each row (16 consecutive lanes of one warp)
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float pv[KMAX];
      int pi[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        pv[j] = __shfl_xor_sync(0xffffffffu, vals[a][j], o);
        pi[j] = __shfl_xor_sync(0xffffffffu, idxs[a][j], o);
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) insert(vals[a], idxs[a], pv[j], pi[j], k);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + ty + 16 * a;
      if (r >= R) continue;
      const long long base = (static_cast<long long>(blockIdx.y) * R + r) * k;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) {
          cand_v[base + j] = vals[a][j];
          cand_i[base + j] = idxs[a][j];
        }
    }
  }
}

// One block per source row: merge the slices' lists, then mean and blend.
__global__ void __launch_bounds__(128)
knn_mean(const float* __restrict__ x, const __nv_bfloat16* __restrict__ refm,
         const float* __restrict__ cand_v, const int* __restrict__ cand_i,
         float* __restrict__ out, int* __restrict__ idx_out, int R, int C, int k, int nsplit,
         float alpha, float one_minus_alpha) {
  __shared__ int sel[KMAX];
  const int r = blockIdx.x;
  if (threadIdx.x == 0) {
    float vals[KMAX];
    int idxs[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      vals[j] = -INFINITY;
      idxs[j] = EMPTY;
    }
    for (int s = 0; s < nsplit; ++s) {
      const long long base = (static_cast<long long>(s) * R + r) * k;
      for (int j = 0; j < k; ++j) insert(vals, idxs, cand_v[base + j], cand_i[base + j], k);
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) {
        idx_out[static_cast<long long>(r) * k + j] = idxs[j];
        sel[j] = idxs[j];
      }
    // the mean sums in increasing index order
    for (int i = 1; i < k; ++i)
      for (int j = i; j > 0 && sel[j - 1] > sel[j]; --j) {
        const int t = sel[j - 1];
        sel[j - 1] = sel[j];
        sel[j] = t;
      }
  }
  __syncthreads();
  const float kf = static_cast<float>(k);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int j = 0; j < k; ++j) sum += to_f32(refm[static_cast<long long>(sel[j]) * C + c]);
    float m = __fdiv_rn(sum, kf);
    const long long o = static_cast<long long>(r) * C + c;
    if (alpha != 0.f) m = __fadd_rn(__fmul_rn(m, one_minus_alpha), __fmul_rn(x[o], alpha));
    out[o] = m;
  }
}

}  // namespace

// x [R, C]; refn [N, C] (similarity rows); rowb [N] (L2 rank bias);
// refm [N, C] bf16 (mean rows); cand_v/cand_i [ceil(N/128), R, k] workspace;
// out [R, C] fp32; idx_out [R, k] int32, the neighbours best first.
// metric: 0 cos, 1 IP, 2 L2.
extern "C" int tvc_knn(const float* x, const float* refn, const float* rowb, const void* refm,
                       float* cand_v, int* cand_i, float* out, int* idx_out, int R, int N, int C,
                       int k, int metric, int nsplit, float alpha, float one_minus_alpha,
                       void* stream) {
  if (R <= 0 || C <= 0 || k < 1 || k > KMAX || N < k || metric < 0 || metric > 2 ||
      nsplit != (N + SPLIT - 1) / SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + TM - 1) / TM, nsplit);
  knn_topk<<<grid, THREADS, 0, st>>>(x, refn, rowb, cand_v, cand_i, R, N, C, k, metric);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  knn_mean<<<R, 128, 0, st>>>(x, static_cast<const __nv_bfloat16*>(refm), cand_v, cand_i, out,
                              idx_out, R, C, k, nsplit, alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}
