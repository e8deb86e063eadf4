// kNN and 1-NN of 3-D points with the target streamed through shared memory,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels ogmm_tpu/ops/pallas_stream.py:knn_stream
// (_knn_stream_kernel) and nn1_stream (_nn1_stream_kernel); nn1_stream_t
// computes the same function and is served by the 1-NN entry point. They
// exist for clouds too large to hold the target on chip (the indoor request,
// N = M = 35,000).
//
// One block owns a query tile of STN = 64 points, one thread a query. The
// target streams through shared memory in tiles of STM = 512 points
// (coordinates and |t|^2 as one float4 a point); each thread keeps its
// running top-k as a list sorted by (distance, index) in registers and
// inserts a candidate with an unrolled compare-and-swap chain. Every
// comparison is on the pair (distance, index), so the result is the k
// lexicographically smallest pairs whatever order the tiles are visited in:
// ascending distance, ties to the lowest index, the order of the plain
// PyTorch version (k passes of argmin and mask). Distances are the
// fixed-order float32 form of knn_select.cuh, clamped at 1e-12, as in
// ogmm_tpu_torch/ops/common.py:square_distance3, so the indices agree bit for
// bit.
//
// Options, as the TPU kernel's:
//  - diag: visit target tiles from the one holding column tile*STN*stretch
//    outwards (start, start+1, start-1, ...); on Morton-sorted clouds the
//    true neighbours come first.
//  - lb (B, T_n, T_m): a lower bound of every squared distance between query
//    tile i and target tile j (ops/stream.py:pair_tile_bounds). A tile is
//    skipped only where its bound is above worst (1 + 1e-6) + 1e-6, worst
//    being the largest running k-th distance of the tile's valid rows; a
//    skipped tile holds no candidate that could enter any list.
//  - gate (1-NN): worst is clamped to max_dist_sq, so tiles beyond the ICP
//    inlier gate are skipped at once; a row whose true nearest point lies at
//    or beyond the gate may then return any index and d >= gate (inf and 0
//    where no tile was visited), the TPU kernel's contract.
//
// Bound: operations. 8 flops of distance and one compare for every
// (query, target) pair the search needs, against 12 bytes read for each
// point and 8 bytes written for each index. The cull and the diagonal order
// cut the pairs visited to the tiles near each query tile.
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

#include "knn_select.cuh"  // sq_norm3, sq_dist3

#define STN 64     // queries (= threads) of a block
#define STM 512    // target points of a shared-memory tile
#define MAXK 32

__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

template <int K>
__global__ void __launch_bounds__(STN)
stream_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const float* __restrict__ lb, long long* __restrict__ idx_out,
              float* __restrict__ d_out, int N, int M, int diag, int stretch,
              float gate) {
  __shared__ float4 tp[STM];
  __shared__ float red[STN / 32];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int n = tile * STN + tid;
  const int n_t = gridDim.x, n_m = (M + STM - 1) / STM;
  const bool valid = n < N;
  const float* tb = tgt + (size_t)b * M * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  float kd[K];
  int ki[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { kd[s] = CUDART_INF_F; ki[s] = 0; }
  const int start = diag ? (int)(((long long)tile * STN * stretch / STM) % n_m) : 0;
  float worst = gate;  // every running k-th distance is inf at first
  for (int t = 0; t < n_m; ++t) {
    int phys = t;
    if (diag) {
      const int off = ((t + 1) / 2) * (1 - 2 * (t % 2));
      phys = ((start + off) % n_m + n_m) % n_m;
    }
    if (lb != nullptr &&
        lb[((size_t)b * n_t + tile) * n_m + phys] > worst * (1.0f + 1e-6f) + 1e-6f)
      continue;  // the same decision in every thread of the block
    const int m0 = phys * STM, len = min(STM, M - m0);
    __syncthreads();
    for (int m = tid; m < len; m += STN) {
      const float* p = tb + 3 * (size_t)(m0 + m);
      tp[m] = make_float4(p[0], p[1], p[2], sq_norm3(p[0], p[1], p[2]));
    }
    __syncthreads();
    if (valid) {
      for (int m = 0; m < len; ++m) {
        const float4 p = tp[m];
        float cd = sq_dist3(qx, qy, qz, qq, p.x, p.y, p.z, p.w);
        int ci = m0 + m;
        if (before(cd, ci, kd[K - 1], ki[K - 1])) {
#pragma unroll
          for (int s = 0; s < K; ++s) {
            if (before(cd, ci, kd[s], ki[s])) {
              const float td = kd[s]; const int ti = ki[s];
              kd[s] = cd; ki[s] = ci; cd = td; ci = ti;
            }
          }
        }
      }
    }
    if (lb != nullptr) {  // worst over the tile's valid rows, for the cull
      float w = valid ? kd[K - 1] : -CUDART_INF_F;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
      if ((tid & 31) == 0) red[tid >> 5] = w;
      __syncthreads();
      w = red[0];
#pragma unroll
      for (int i = 1; i < STN / 32; ++i) w = fmaxf(w, red[i]);
      worst = fminf(w, gate);
    }
  }
  if (!valid) return;
  const size_t row = (size_t)b * N + n;
  if (d_out != nullptr) {
    d_out[row] = kd[0];
    idx_out[row] = ki[0];
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) idx_out[row * K + s] = ki[s];
  }
}

static cudaError_t check_args(int B, int N, int M, int k) {
  if (B < 1 || N < 1 || M < k || k < 1 || k > MAXK) return cudaErrorInvalidValue;
  return cudaSuccess;
}

extern "C" int knn_stream_launch(const float* src, const float* tgt,
                                 const float* lb, long long* idx, int B, int N,
                                 int M, int k, int diag, int stretch,
                                 void* stream_ptr) {
  if (check_args(B, N, M, k) != cudaSuccess) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + STN - 1) / STN, B);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (k) {
#define CASE(K)                                                                \
  case K:                                                                      \
    stream_kernel<K><<<grid, STN, 0, stream>>>(src, tgt, lb, idx, nullptr, N, \
                                               M, diag, stretch, INFINITY);     \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    CASE(17) CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24)
    CASE(25) CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// gate: max_dist_sq, or +inf for none (then the 1-NN is exact on every row)
extern "C" int nn1_stream_launch(const float* src, const float* tgt,
                                 const float* lb, float* d, long long* idx,
                                 int B, int N, int M, float gate, int diag,
                                 int stretch, void* stream_ptr) {
  if (check_args(B, N, M, 1) != cudaSuccess) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + STN - 1) / STN, B);
  stream_kernel<1><<<grid, STN, 0, (cudaStream_t)stream_ptr>>>(
      src, tgt, lb, idx, d, N, M, diag, stretch, gate);
  return (int)cudaGetLastError();
}
