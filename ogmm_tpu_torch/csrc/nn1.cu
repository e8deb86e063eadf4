// Nearest neighbour (1-NN) of 3-D points for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:nn1_pallas
// (_nn1_kernel), which keeps the whole target cloud on chip for M <= 4096.
// Here one thread owns one query point and scans the target in order,
// staged through shared memory in tiles of 1024 points (coordinates and
// |t|^2, 16 KB), keeping the running minimum with a strict comparison: the
// first index among equal minima wins, as with an argmin. Distances are the
// fixed-order float32 form of knn_select.cuh, clamped at 1e-12, so that the
// plain PyTorch version (ops/cuda_knn.py:nn1_reference) picks the same
// index bit for bit.
//
// Bound: operations. Each (query, target) pair costs 8 flops of distance and
// one compare against 12 bytes read per point and 12 written per query.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"  // sq_norm3, sq_dist3

#define QTB 128    // queries (= threads) per block
#define TILE 1024  // target points per shared-memory tile
#define MAXM 4096  // the TPU kernel's envelope

__global__ void __launch_bounds__(QTB)
nn1_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           float* __restrict__ dmin, long long* __restrict__ imin, int N,
           int M) {
  __shared__ float tx[TILE], ty[TILE], tz[TILE], tt[TILE];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int n = blockIdx.x * QTB + tid;
  const float* tb = tgt + (size_t)b * M * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (n < N) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  float best = CUDART_INF_F;
  int best_i = 0;
  for (int m0 = 0; m0 < M; m0 += TILE) {
    const int len = min(TILE, M - m0);
    __syncthreads();
    for (int m = tid; m < len; m += QTB) {
      const float px = tb[3 * (m0 + m)], py = tb[3 * (m0 + m) + 1],
                  pz = tb[3 * (m0 + m) + 2];
      tx[m] = px; ty[m] = py; tz[m] = pz;
      tt[m] = sq_norm3(px, py, pz);
    }
    __syncthreads();
    for (int m = 0; m < len; ++m) {
      const float d = sq_dist3(qx, qy, qz, qq, tx[m], ty[m], tz[m], tt[m]);
      if (d < best) { best = d; best_i = m0 + m; }
    }
  }
  if (n < N) {
    dmin[(size_t)b * N + n] = best;
    imin[(size_t)b * N + n] = best_i;
  }
}

extern "C" int nn1_launch(const float* src, const float* tgt, float* dmin,
                          long long* imin, int B, int N, int M,
                          void* stream_ptr) {
  if (M < 1 || M > MAXM || N < 1) return (int)cudaErrorInvalidValue;
  nn1_kernel<<<dim3((N + QTB - 1) / QTB, B), QTB, 0, (cudaStream_t)stream_ptr>>>(
      src, tgt, dmin, imin, N, M);
  return (int)cudaGetLastError();
}
