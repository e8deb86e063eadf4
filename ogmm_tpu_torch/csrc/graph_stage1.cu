// kNN graph + edge features + stage-1 product of the DGCNN training forward,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_dgcnn_train.py:
// graph_stage1_pallas (_stage1_kernel). Takes any k from 1 to N <= 1024,
// the TPU kernel's envelope, and writes exactly k edge rows a point (the
// trainer's BatchNorm moments sum over them): up to k = 32 the selection's
// list is dgcnn_rows(k) long (knn_select.cuh), above it the selection is
// knn_wide_kernel (knn_wide.cuh: a bisection of the distance bits, the k
// pairs sorted in shared memory); the edge pass is compiled for k = 20, the
// ModelNet graph, and takes any other k at run time; k = 20 below. Two
// launches:
//
//  1. knn_kernel<k, GraphOut> (knn_lanes.cuh, the dense selection shared
//     with dgcnn_eval.cu, knn.cu and posenc_angles.cu): the cloud in shared
//     memory, 64 queries a block, four lanes a query with sorted register
//     lists, a threshold from a first pass over sub-tile minima, buffered
//     insertion and a merge by rank (ascending, ties to the lowest index);
//     the first pk neighbours' position-encoding angles against the
//     centroid sum / N. Writes idx (B, N, k) int32 and alpha (B, N, pk)
//     float32.
//  2. edge_stage1_kernel: eight threads an edge row (b, j, n), eight
//     columns each, over the B k N rows by a grid-stride loop of a grid
//     sized to the card (ops/cuda_dgcnn_train.py:edge_plan), two rows a
//     thread a step with the loads of both issued first. The offset
//     nbr - q is formed in float32 and then cast to the compute type (the
//     training contract: the TPU kernel gathers in float32 too), the row
//     [nbr - q, q] (6 values) goes to e, and z = e . w1 (6 x 64, float32
//     fmaf over i = 0..5, rounded once to the compute type) to z1. A thread
//     holds its 6 x 8 weights in registers, loaded once, and writes its
//     eight values with one 16-byte store in bf16 (two in float32), so a
//     warp writes four rows, 512 contiguous bytes in bf16; three of the
//     eight threads write the row of e as three pairs. Both outputs are
//     (B, k, N, C): the layout the custom VJP of ops/dgcnn_train.py reads,
//     neighbour axis outermost.
//
// Bound: bytes. Per point it reads 12 bytes and writes 20 * (64 + 6) values
// in the compute type plus 20 indices and pk angles (about 3 KB in bf16),
// against about 20 * 2 * 6 * 64 flops of the product and the 8 * N + 20
// flops a query of the distances and the selection. The edge pass is the
// writes (44 MB of z1 and 4 MB of e at (24, 717, k = 20) in bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "knn_lanes.cuh"   // GraphOut
#include "knn_select.cuh"  // MAXN, to_f, from_f
#include "knn_wide.cuh"    // graph_select_launch

#define C1 64     // stage-1 width
#define EW 6      // edge row: [nbr - q, q]
#define CT 8      // columns a thread (threads a row: C1 / CT)
#define ET 256    // threads of an edge block
#define ERB (ET / (C1 / CT))   // edge rows a block takes at a time
#define EU 2      // rows a thread takes a step of the grid-stride loop

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// a thread's CT values of a z1 row (16-byte aligned)
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float (&v)[CT]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[CT]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// two values of an e row
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// grid: edge_plan's blocks, ET threads; rows = B * k * N < 2^31. A
// thread takes EU rows a step, stride apart (the loads of all of them in
// flight before the first product). KNN: k where it is compiled in, 0 for
// the k given at run time
template <typename T, int KNN>
__global__ void __launch_bounds__(ET, 3)
edge_stage1_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const T* __restrict__ w1, T* __restrict__ z1,
                   T* __restrict__ e_out, int N, int rows, int k_rt) {
  const int k = KNN > 0 ? KNN : k_rt;
  const int part = threadIdx.x % (C1 / CT), c0 = part * CT;
  float w[EW][CT];
#pragma unroll
  for (int i = 0; i < EW; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) w[i][c] = to_f(w1[i * C1 + c0 + c]);
  const int stride = gridDim.x * ERB;
  const int first = blockIdx.x * ERB + threadIdx.x / (C1 / CT);
  for (int r0 = first; r0 < rows; r0 += EU * stride) {
    float pq[EU][3], pn[EU][3];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int r = min(r0 + u * stride, rows - 1);
      const int n = r % N, bj = r / N, j = bj % k, b = bj / k;
      const size_t q = (size_t)b * N + n;
      const float* pp = x + q * 3;
      const float* np = x + ((size_t)b * N + idx[q * k + j]) * 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) { pq[u][i] = pp[i]; pn[u][i] = np[i]; }
    }
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int r = r0 + u * stride;
      if (r >= rows) break;
      float e[EW];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        e[i] = to_f(from_f<T>(__fsub_rn(pn[u][i], pq[u][i])));
        e[3 + i] = to_f(from_f<T>(pq[u][i]));
      }
      float acc[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        acc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < EW; ++i) acc[c] = fmaf(e[i], w[i][c], acc[c]);
      }
      store_cols(z1 + (size_t)r * C1 + c0, acc);
#pragma unroll
      for (int p = 0; p < EW / 2; ++p)
        if (part == p) store_pair(e_out + (size_t)r * EW + 2 * p, e[2 * p], e[2 * p + 1]);
    }
  }
}

// the edge pass: compiled for k = 20, any other k at run time
template <typename T>
static void launch_edges(const float* x, const int* idx, const void* w1, void* z1,
                         void* e, int N, int rows, int k, int blocks,
                         cudaStream_t stream) {
  if (k == 20)
    edge_stage1_kernel<T, 20><<<blocks, ET, 0, stream>>>(x, idx, (const T*)w1, (T*)z1,
                                                         (T*)e, N, rows, k);
  else
    edge_stage1_kernel<T, 0><<<blocks, ET, 0, stream>>>(x, idx, (const T*)w1, (T*)z1,
                                                        (T*)e, N, rows, k);
}

// the edge pass over exactly k rows a point, after the selection wrote idx
static cudaError_t launch_edge_pass(const float* x, const int* idx, const void* w1,
                                    void* z1, void* e, int N, int rows, int k,
                                    int is_bf16, int blocks, cudaStream_t stream) {
  if (is_bf16)
    launch_edges<__nv_bfloat16>(x, idx, w1, z1, e, N, rows, k, blocks, stream);
  else
    launch_edges<float>(x, idx, w1, z1, e, N, rows, k, blocks, stream);
  return cudaGetLastError();
}

// blocks: the edge pass's grid (ops/cuda_dgcnn_train.py:edge_plan). The
// selection is graph_select_launch's (knn_wide.cuh)
extern "C" int graph_stage1_launch(const float* x, const void* w1, int* idx,
                                   float* alpha, void* z1, void* e, int B,
                                   int N, int k, int pk, int is_bf16, int blocks,
                                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || B < 1 || B > 65535 || blocks < 1 || k < 1 || N < k || pk > k ||
      (long long)B * k * N > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const GraphOut graph{idx, alpha, nullptr, pk};
  const cudaError_t err = graph_select_launch(x, graph, B, N, k, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_edge_pass(x, idx, w1, z1, e, N, B * k * N, k, is_bf16, blocks,
                               stream);
}
