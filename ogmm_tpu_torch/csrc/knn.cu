// k nearest neighbours of 3-D points for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:knn_pallas
// (_knn_kernel), which keeps the whole target cloud on chip for M <= 4096 and
// runs k passes of (min, argmin, mask) over a (tile, M) distance block.
//
// Here a block loads the target cloud of its batch entry into shared memory
// once, as (x, y, z, |t|^2) (64 KB at M = 4096), for KQ = 64 queries. Each
// query has NL = 4 lanes; lane l takes the points l, l + 4, ... of each
// 64-point sub-tile. Two passes over the target:
//  1. each lane forms the minimum of its 16 points of each sub-tile and
//     keeps the Q = ceil(K/4) smallest of these minima (a min/max network in
//     registers); T, the largest of the four lanes' Q-th, has at least K
//     points at or below it (Q distinct ones in each lane), so T bounds the
//     query's K-th distance, and it lies close to it (a lane's Q-th smallest
//     minimum is its Q-th smallest distance unless two of its nearest points
//     share a sub-tile);
//  2. each lane keeps a sorted top-K of its own points in registers, and the
//     lanes of a query share a threshold (T, then tighter) and merge their
//     lists by rank at the end (knn_lanes.cuh, the selection of the streamed
//     kNN). A lane appends the index of each of its points at or below the
//     threshold to its own buffer in shared memory (CL entries); the warp
//     inserts the buffered points (one compare-and-swap chain for each point
//     of its busiest lane, the distance formed again) only where a lane's
//     buffer could overflow in the next sub-tile and at the end. With T from
//     the start, a lane buffers a few of its points (about 7 at k = 20),
//     not the whole first sub-tile and the long tail of a threshold that
//     starts at inf, and the warp waits for its busiest lane once, not once
//     a sub-tile.
// Both passes compare the distance before its clamp at 1e-12: T and every
// threshold are at or above 1e-12, where the clamp changes no comparison.
//
// K is a template parameter, compiled for the k the paths and the checks use
// (KNN_KS: 1, 5, 20, 32); any other k <= 32 takes the next compiled K and
// writes the first k of its K pairs, which are the k smallest in order
// (ops/cuda_knn.py:knn_plan mirrors the choice and the launch). The output
// is int64 (B, N, k), ascending distance, ties to the lowest index: the
// order of k passes of argmin-and-mask over the whole row
// (ops/common.py:select_smallest). Distances are the fixed-order float32 form
// of knn_select.cuh, clamped at 1e-12, so the kernel and its plain version
// (ops/cuda_knn.py:knn_reference) pick the same neighbours in the same
// order. N and M may differ (a cross kNN).
//
// Bound: operations. Each (query, target) pair costs 8 flops of distance and
// a compare; bytes are 12 per point read and 8 k per query written. What
// holds it from the bound: the second pass over the distances, the insertion
// chains (K compare-and-swap steps a candidate, the warp waiting for its
// busiest lane) and the merge.
#include <cuda_runtime.h>

#include "knn_lanes.cuh"   // NL, SUBT, the lists, threshold and merge
#include "knn_select.cuh"  // sq_norm3

#define KQ 64              // queries a block
#define KNT (KQ * NL)      // threads of a block
#define CL 32              // entries of a lane's candidate buffer
#define MAXM 4096          // the TPU kernel's envelope
#define MAXK 32
// the compiled K (ascending); X is a macro of one K
#define KNN_KS(X) X(1) X(5) X(20) X(32)

// dynamic shared memory: the target and the lanes' buffers, then (the same
// bytes) the lists
__host__ __device__ constexpr int knn_smem(int M, int K) {
  return M * 16 + CL * KNT * 4 > KNT * K * 8 ? M * 16 + CL * KNT * 4 : KNT * K * 8;
}

// sq_dist3 before its clamp at 1e-12 (dist_fma's other steps)
__device__ __forceinline__ float dist_raw(float qx, float qy, float qz, float qq, float4 p) {
  const float inner = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                __fmul_rn(qz, p.z));
  return fmaf(-2.0f, inner, __fadd_rn(qq, p.w));
}

// The buffered points into the lane's list (the warp runs one chain for each
// point of its busiest lane); the tighter threshold
template <int K>
__device__ __forceinline__ float drain(float (&kd)[K], int (&ki)[K], const int* buf,
                                       int& cnt, const float4* tp, float qx, float qy,
                                       float qz, float qq, float thr) {
  while (__any_sync(FULL, cnt > 0)) {
    if (cnt > 0) {
      const int m = buf[--cnt * KNT];
      insert<K>(kd, ki, dist_fma(qx, qy, qz, qq, tp[m]), m);
    }
  }
  return fminf(thr, lanes_threshold<K>(kd));
}

// grid (query blocks, B), KNT threads
template <int K>
__global__ void __launch_bounds__(KNT)
knn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           long long* __restrict__ idx_out, int N, int M, int k) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float4* tp = reinterpret_cast<float4*>(dsm);   // [M]
  const int b = blockIdx.y, tid = threadIdx.x, sub = tid % NL;
  const int n = blockIdx.x * KQ + tid / NL;
  const bool valid = n < N;
  const float* tb = tgt + (size_t)b * M * 3;
  for (int m = tid; m < M; m += KNT) {
    const float x = tb[3 * m], y = tb[3 * m + 1], z = tb[3 * m + 2];
    tp[m] = make_float4(x, y, z, sq_norm3(x, y, z));
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  __syncthreads();
  // 1. the Q smallest of the lane's sub-tile minima, ascending
  constexpr int Q = (K + NL - 1) / NL;
  float g[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) g[s] = CUDART_INF_F;
  for (int s0 = 0; s0 < M; s0 += SUBT) {
    const float4* ts = tp + s0 + sub;
    const int hi = valid ? min(SUBT, M - s0) : 0;
    float gm = CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < SUBT / NL; ++jj)
      if (sub + NL * jj < hi) gm = fminf(gm, dist_raw(qx, qy, qz, qq, ts[NL * jj]));
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const float lo = fminf(gm, g[s]);
      gm = fmaxf(gm, g[s]);
      g[s] = lo;
    }
  }
  // the query's shared threshold: T, then tighter
  float thr = fmaxf(g[Q - 1], 1e-12f);
#pragma unroll
  for (int o = 1; o < NL; o <<= 1) thr = fmaxf(thr, __shfl_xor_sync(FULL, thr, o));
  // 2. the lanes' lists, fed from their buffers
  float kd[K];
  int ki[K];
  lanes_init<K>(kd, ki);
  int* buf = reinterpret_cast<int*>(tp + M) + tid;   // [CL][KNT], the lane's column
  int cnt = 0;
  for (int s0 = 0; s0 < M; s0 += SUBT) {
    if (__any_sync(FULL, cnt > CL - SUBT / NL))
      thr = drain<K>(kd, ki, buf, cnt, tp, qx, qy, qz, qq, thr);
    const float4* ts = tp + s0 + sub;
    const int hi = valid ? min(SUBT, M - s0) : 0;
#pragma unroll
    for (int jj = 0; jj < SUBT / NL; ++jj) {
      if (sub + NL * jj < hi && dist_raw(qx, qy, qz, qq, ts[NL * jj]) <= thr)
        buf[cnt++ * KNT] = s0 + sub + NL * jj;
    }
  }
  drain<K>(kd, ki, buf, cnt, tp, qx, qy, qz, qq, thr);
  __syncthreads();   // every thread is done with the target: the lists go there
  float* ld = reinterpret_cast<float*>(dsm);      // [K][KNT]
  int* li = reinterpret_cast<int*>(ld + K * KNT);  // [K][KNT]
  lanes_store<K>(kd, ki, ld, li, KNT, tid);
  __syncthreads();
  if (!valid) return;
  lanes_merge<K>(kd, ki, ld, li, KNT, tid, sub, idx_out + ((size_t)b * N + n) * k, k);
}

template <int K>
static cudaError_t launch(const float* src, const float* tgt, long long* idx, int B,
                          int N, int M, int k, cudaStream_t stream) {
  const int smem = knn_smem(M, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  knn_kernel<K><<<dim3((N + KQ - 1) / KQ, B), KNT, smem, stream>>>(src, tgt, idx, N, M, k);
  return cudaGetLastError();
}

// K: the compiled list length the wrapper chose (ops/cuda_knn.py:knn_plan),
// the smallest of KNN_KS at or above k
extern "C" int knn_launch(const float* src, const float* tgt, long long* idx,
                          int B, int N, int M, int k, int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M < 1 || M > MAXM || N < 1 || B < 1 || B > 65535 || k < 1 || k > MAXK ||
      k > M || K < k)
    return (int)cudaErrorInvalidValue;
#define CASE(KK) \
  if (K == KK) return (int)launch<KK>(src, tgt, idx, B, N, M, k, stream);
  KNN_KS(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
