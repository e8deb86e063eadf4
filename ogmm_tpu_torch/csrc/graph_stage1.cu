// kNN graph + edge features + stage-1 product of the DGCNN training forward,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_dgcnn_train.py:
// graph_stage1_pallas (_stage1_kernel). Compiled for the neighbour counts k
// of DGCNN_KS (knn_select.cuh); k = 20 below. Two launches:
//
//  1. knn_alpha_kernel (knn_select.cuh, the selection of dgcnn_eval.cu): one
//     warp per query, the distance row in registers, k rounds of warp
//     argmin-and-mask (ascending, ties to the lowest index), the first pk
//     neighbours' position-encoding angles against the centroid sum / N.
//     Writes idx (B, N, k) int32 and alpha (B, N, pk) float32.
//  2. edge_stage1_kernel: one warp per edge row (b, j, n). The offset
//     nbr - q is formed in float32 and then cast to the compute type (the
//     training contract: the TPU kernel gathers in float32 too), the row
//     [nbr - q, q] (6 values) is written to e, and z = e . w1 (6 x 64, float32
//     accumulation, rounded once to the compute type) to z1, two columns a
//     lane. Both outputs are (B, k, N, C): the layout the custom VJP of
//     ops/dgcnn_train.py reads, neighbour axis outermost, so a warp writes
//     one contiguous 64-wide row.
//
// Bound: bytes. Per point it reads 12 bytes and writes 20 * (64 + 6) values
// in the compute type plus 20 indices and pk angles (about 3 KB in bf16),
// against about 20 * 2 * 6 * 64 flops of the product and the 8 * N + 20 * N
// flops of the distance row and the selection.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_select.cuh"  // knn_alpha_kernel, DGCNN_KS, MAXN, QPB, to_f, from_f

#define C1 64     // stage-1 width
#define EW 6      // edge row: [nbr - q, q]
#define RPB 8     // edge rows (= warps) per block

template <typename T, int KNN>
__global__ void __launch_bounds__(RPB * 32)
edge_stage1_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const T* __restrict__ w1, T* __restrict__ z1,
                   T* __restrict__ e_out, int N) {
  __shared__ float sw[EW * C1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < EW * C1; i += RPB * 32) sw[i] = to_f(w1[i]);
  __syncthreads();

  const int n = blockIdx.x * RPB + warp, j = blockIdx.y, b = blockIdx.z;
  if (n >= N) return;
  const size_t row = (size_t)b * N + n;
  const int nb = idx[row * KNN + j];
  const float* pq = x + row * 3;
  const float* pn = x + ((size_t)b * N + nb) * 3;
  float e[EW];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e[i] = to_f(from_f<T>(__fsub_rn(pn[i], pq[i])));
    e[3 + i] = to_f(from_f<T>(pq[i]));
  }
  const size_t out_row = ((size_t)b * KNN + j) * N + n;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = lane + 32 * c;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < EW; ++i) acc = fmaf(e[i], sw[i * C1 + col], acc);
    z1[out_row * C1 + col] = from_f<T>(acc);
  }
  if (lane < EW) {
    float v = e[0];
#pragma unroll
    for (int i = 1; i < EW; ++i)
      if (lane == i) v = e[i];
    e_out[out_row * EW + lane] = from_f<T>(v);
  }
}

template <int KNN>
static cudaError_t launch_k(const float* x, const void* w1, int* idx,
                           float* alpha, void* z1, void* e, int B, int N,
                           int pk, int is_bf16, cudaStream_t stream) {
  if (N < KNN || pk > KNN) return cudaErrorInvalidValue;
  knn_alpha_kernel<KNN><<<dim3((N + QPB - 1) / QPB, B), 256, 0, stream>>>(
      x, nullptr, idx, alpha, N, pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + RPB - 1) / RPB, KNN, B);
  if (is_bf16)
    edge_stage1_kernel<__nv_bfloat16, KNN><<<grid, RPB * 32, 0, stream>>>(
        x, idx, (const __nv_bfloat16*)w1, (__nv_bfloat16*)z1,
        (__nv_bfloat16*)e, N);
  else
    edge_stage1_kernel<float, KNN><<<grid, RPB * 32, 0, stream>>>(
        x, idx, (const float*)w1, (float*)z1, (float*)e, N);
  return cudaGetLastError();
}

extern "C" int graph_stage1_launch(const float* x, const void* w1, int* idx,
                                   float* alpha, void* z1, void* e, int B,
                                   int N, int k, int pk, int is_bf16,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN) return (int)cudaErrorInvalidValue;
  switch (k) {
#define CASE(K)                                                              \
  case K:                                                                    \
    return (int)launch_k<K>(x, w1, idx, alpha, z1, e, B, N, pk, is_bf16,     \
                            stream);
    DGCNN_KS(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
