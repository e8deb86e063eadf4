// k nearest neighbours of 3-D points for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:knn_pallas
// (_knn_kernel), which keeps the whole target cloud on chip for M <= 4096 and
// runs k passes of (min, argmin, mask) over a (tile, M) distance block.
//
// Here the target cloud sits in shared memory (coordinates and |t|^2, 64 KB
// at M = 4096) and one warp owns one query at a time; lane l takes the
// candidates l, l + 32, ... . For each query:
//
//  1. every lane finds its smallest distance; the k-th smallest of the 32
//     lane minima is a threshold T that at least k candidates reach, so T is
//     at least the k-th distance of the row;
//  2. every candidate with d <= T goes into the warp's list in shared memory
//     (ballot compaction, 256 entries);
//  3. k rounds of warp argmin over (distance, index) in the list, the winner
//     taken out each round: the k nearest in ascending distance, ties to the
//     lowest index, the order of k passes of argmin-and-mask over the whole
//     row (ops/common.py:select_smallest). Where more than 256 candidates
//     reach T (many coincident points), k rounds of "the next (distance,
//     index) after the last winner" over the whole row instead.
//
// Distances are the fixed-order float32 form of knn_select.cuh, clamped at
// 1e-12, recomputed the same way in every pass, so the kernel and its plain
// version (ops/cuda_knn.py:knn_reference) pick the same neighbours in the
// same order. N and M may differ (a cross kNN).
//
// Bound: operations. Each (query, target) pair costs 8 flops of distance and
// a compare, twice (passes 1 and 2); the selection costs k rounds over a
// list of about k to 2k entries. Bytes are 12 per point read and 8 k per
// query written.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"  // sq_norm3, sq_dist3

#define WPB 8      // warps (= queries in flight) per block
#define QPW 4      // queries per warp
#define CAP 256    // candidates a warp's list holds
#define MAXM 4096  // the TPU kernel's envelope
#define MAXK 32    // T is one of the 32 lane minima
#define FULL 0xffffffffu
#define NO_INDEX 0x7fffffff

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// the smallest (d, i) over the warp, with its list position p, in every lane
__device__ __forceinline__ void warp_lexmin(float& d, int& i, int& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(FULL, d, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    const int op = __shfl_xor_sync(FULL, p, o);
    if (lex_less(od, oi, d, i)) { d = od; i = oi; p = op; }
  }
}

__global__ void __launch_bounds__(WPB * 32)
knn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           long long* __restrict__ idx_out, int N, int M, int k) {
  extern __shared__ __align__(16) float smem[];
  float* tx = smem;
  float* ty = tx + M;
  float* tz = ty + M;
  float* tt = tz + M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ld = tt + M + warp * CAP;                          // list distances
  int* li = reinterpret_cast<int*>(tt + M + WPB * CAP) + warp * CAP;
  const int b = blockIdx.y;
  const float* tb = tgt + (size_t)b * M * 3;
  for (int m = tid; m < M; m += WPB * 32) {
    const float px = tb[3 * m], py = tb[3 * m + 1], pz = tb[3 * m + 2];
    tx[m] = px; ty[m] = py; tz[m] = pz;
    tt[m] = sq_norm3(px, py, pz);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;

  for (int j = 0; j < QPW; ++j) {
    const int n = (blockIdx.x * QPW + j) * WPB + warp;
    if (n >= N) break;                       // uniform over the warp
    const float* q = src + ((size_t)b * N + n) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    const float qq = sq_norm3(qx, qy, qz);

    // 1. the threshold
    float lmin = CUDART_INF_F;
    for (int m = lane; m < M; m += 32)
      lmin = fminf(lmin, sq_dist3(qx, qy, qz, qq, tx[m], ty[m], tz[m], tt[m]));
    int rank = 0;                            // in (value, lane) order
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      const float v = __shfl_sync(FULL, lmin, o);
      rank += (v < lmin || (v == lmin && o < lane)) ? 1 : 0;
    }
    const unsigned at_k = __ballot_sync(FULL, rank == k - 1);
    const float T = __shfl_sync(FULL, lmin, __ffs(at_k) - 1);

    // 2. the candidates at or below it
    int cnt = 0;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      const float d = m < M ? sq_dist3(qx, qy, qz, qq, tx[m], ty[m], tz[m], tt[m])
                            : CUDART_INF_F;
      const bool take = d <= T;
      const unsigned mask = __ballot_sync(FULL, take);
      const int pos = cnt + __popc(mask & below);
      if (take && pos < CAP) { ld[pos] = d; li[pos] = m; }
      cnt += __popc(mask);
    }
    __syncwarp();

    // 3. k rounds of warp argmin
    long long* out = idx_out + ((size_t)b * N + n) * k;
    if (cnt <= CAP) {
      for (int r = 0; r < k; ++r) {
        float d = CUDART_INF_F;
        int i = NO_INDEX, p = 0;
        for (int e = lane; e < cnt; e += 32)
          if (lex_less(ld[e], li[e], d, i)) { d = ld[e]; i = li[e]; p = e; }
        warp_lexmin(d, i, p);
        if (lane == 0) {
          out[r] = i;
          ld[p] = CUDART_INF_F;              // taken: k finite entries remain
        }
        __syncwarp();
      }
    } else {
      float pd = -CUDART_INF_F;              // the last winner
      int pi = -1;
      for (int r = 0; r < k; ++r) {
        float d = CUDART_INF_F;
        int i = NO_INDEX, p = 0;
        for (int m = lane; m < M; m += 32) {
          const float dm = sq_dist3(qx, qy, qz, qq, tx[m], ty[m], tz[m], tt[m]);
          if (lex_less(pd, pi, dm, m) && lex_less(dm, m, d, i)) { d = dm; i = m; }
        }
        warp_lexmin(d, i, p);
        if (lane == 0) out[r] = i;
        pd = d;
        pi = i;
      }
    }
    __syncwarp();                            // the list serves the next query
  }
}

extern "C" int knn_launch(const float* src, const float* tgt, long long* idx,
                          int B, int N, int M, int k, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M < 1 || M > MAXM || N < 1 || k < 1 || k > MAXK || k > M)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)4 * M + 2 * WPB * CAP);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + WPB * QPW - 1) / (WPB * QPW), B);
  knn_kernel<<<grid, WPB * 32, smem, stream>>>(src, tgt, idx, N, M, k);
  return (int)cudaGetLastError();
}
