// Fused eval DGCNN encoder for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_dgcnn.py:dgcnn_eval_pallas
// (_dgcnn_kernel + _run_stages). Compiled for the neighbour counts k of
// DGCNN_KS (knn_select.cuh); k = 20 below. Two launches, nothing but the
// neighbour indices (B*N*k ints) passes through device memory between them:
//
//  1. knn_alpha_kernel (knn_select.cuh, shared with graph_stage1.cu): one
//     warp per query point. The cloud (N <= 1024) sits
//     in shared memory, the query's float32 distance row sits in the warp's
//     registers (32 values a lane), and k rounds of warp argmin-and-mask
//     pick the neighbours in ascending order, ties to the lowest index. The
//     first posenc_k rounds also give the position-encoding angle
//     cos(angle(p -> nbr, p -> centroid)) from float32 coordinates.
//     Distances are formed without fused multiply-adds in a fixed order,
//     (|q|^2 + |t|^2) - 2 (q0 t0 + q1 t1 + q2 t2), so that the plain PyTorch
//     version selects the same neighbours bit for bit.
//  2. dgcnn_stage_kernel: one block per 8 query points, one warp per query.
//     The 8k edge rows [nbr - q (float32, then cast), q], the stage
//     activations and the 512-wide concat stay in shared memory. Each stage
//     is Dense (BN scale folded into the weight) + bias + ReLU in the
//     compute type with float32 accumulation; a thread holds all k
//     neighbour rows of its query for two output columns, so the max over k
//     is taken in registers. The final Dense(512 -> emb) + bias + ReLU
//     writes the only large output.
//
// A second entry point, dgcnn_edges_launch, replaces
// ogmm_tpu/ops/pallas_dgcnn.py:dgcnn_edges_pallas (_dgcnn_edges_kernel): the
// same stage kernel over pre-gathered float32 neighbour coordinates
// (B, N, k, 3) instead of indices, at any N (the indoor clouds, N = 35,000,
// whose graph comes from knn_stream.cu). Eval only, BN folded, as kernel 1.
//
// Bound: operations. The stage products are 2*45,440 flops for each of the
// B*N*k edge rows plus 2*512*emb for each point, against 12 bytes in and
// 2*emb bytes out for each point. This first version does the products with
// float32 FMAs on the CUDA cores (bf16 operands are widened, which is exact);
// moving them to the tensor cores is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_select.cuh"  // knn_alpha_kernel, DGCNN_KS, MAXN, QPB, to_f, from_f

#define TQ 8       // queries (= warps) per block of the stage kernel
#define CATW 512   // 64 + 64 + 128 + 256

// ------------------------------------------------------------------- stages

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int W = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the upper half of a float32
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// round the float32 sum to the compute type, add the bias there, ReLU
__device__ __forceinline__ float bias_relu(float acc, float bias) {
  return fmaxf(acc + bias, 0.f);
}
__device__ __forceinline__ __nv_bfloat16 bias_relu(float acc, __nv_bfloat16 bias) {
  const float z = __bfloat162float(__float2bfloat16(acc));
  const float s = __bfloat162float(__float2bfloat16(z + __bfloat162float(bias)));
  return __float2bfloat16(fmaxf(s, 0.f));
}

// acc[r][c] = sum_kk in[r][kk] * w[kk][col0 + lane + 32 c] for RT rows held
// in shared memory (all lanes read the same address: a broadcast) and CT
// columns a lane (neighbouring lanes read neighbouring weights).
template <typename T, int RT, int CT>
__device__ __forceinline__ void dense_tile(const T* __restrict__ in, int cin,
                                           const T* __restrict__ w, int cout,
                                           int col0, float (&acc)[RT][CT]) {
  constexpr int V = Vec<T>::W;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  for (int kk = 0; kk < cin; kk += V) {
    float wv[V][CT];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int c = 0; c < CT; ++c)
        wv[v][c] = to_f(w[(size_t)(kk + v) * cout + col0 + lane + 32 * c]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float a[V];
      Vec<T>::load(in + r * cin + kk, a);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[r][c] = fmaf(a[v], wv[v][c], acc[r][c]);
    }
  }
}

// one edge-conv stage for this warp's query: rows [warp*KNN, +KNN) of `in`
// (row length cin) -> the same rows of `outbuf` (row length cout, may be
// null) and the max over the rows -> cat[warp][cat_off + col]
template <typename T, int KNN>
__device__ __forceinline__ void edge_stage(const T* in, int cin,
                                           const T* __restrict__ w,
                                           const T* __restrict__ bias, int cout,
                                           T* outbuf, T* cat, int cat_off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int col0 = 0; col0 < cout; col0 += 64) {
    float acc[KNN][2];
    dense_tile<T, KNN, 2>(in + (size_t)warp * KNN * cin, cin, w, cout, col0, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + lane + 32 * c;
      const T bv = bias[col];
      float mx = 0.f;                        // ReLU outputs are >= 0
#pragma unroll
      for (int r = 0; r < KNN; ++r) {
        const T v = bias_relu(acc[r][c], bv);
        if (outbuf) outbuf[(size_t)(warp * KNN + r) * cout + col] = v;
        mx = fmaxf(mx, to_f(v));
      }
      cat[warp * CATW + cat_off + col] = from_f<T>(mx);
    }
  }
}

template <typename T, int KNN>
__global__ void __launch_bounds__(TQ * 32)
dgcnn_stage_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const float* __restrict__ nbr,
                   const T* w1, const T* w2, const T* w3, const T* w4, const T* w5,
                   const T* b1, const T* b2, const T* b3, const T* b4, const T* b5,
                   T* __restrict__ out, int N, int emb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = TQ * KNN;
  T* bufA = reinterpret_cast<T*>(smem_raw);  // R x 64
  T* bufB = bufA + R * 64;                   // R x 128
  T* cat = bufB + R * 128;                   // TQ x 512
  const int b = blockIdx.y, n0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // edge rows, 8 wide: [nbr - q, q, 0, 0]; the offset in float32, then cast.
  // The neighbour's coordinates come from nbr (B, N, KNN, 3) where it is
  // given, else from x through idx
  for (int r = tid; r < R; r += TQ * 32) {
    const int n = min(n0 + r / KNN, N - 1);
    const size_t row = (size_t)b * N + n;
    const float* pq = x + row * 3;
    const float* pn = nbr != nullptr
                          ? nbr + (row * KNN + r % KNN) * 3
                          : x + ((size_t)b * N + idx[row * KNN + r % KNN]) * 3;
    T* e = bufA + r * 8;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      e[i] = from_f<T>(pn[i] - pq[i]);
      e[3 + i] = from_f<T>(pq[i]);
    }
    e[6] = from_f<T>(0.f);
    e[7] = from_f<T>(0.f);
  }
  __syncthreads();
  edge_stage<T, KNN>(bufA, 8, w1, b1, 64, bufB, cat, 0);
  __syncthreads();
  edge_stage<T, KNN>(bufB, 64, w2, b2, 64, bufA, cat, 64);
  __syncthreads();
  edge_stage<T, KNN>(bufA, 64, w3, b3, 128, bufB, cat, 128);
  __syncthreads();
  edge_stage<T, KNN>(bufB, 128, w4, b4, 256, nullptr, cat, 256);
  __syncthreads();

  // head: (TQ, 512) x (512, emb), 64 columns a warp at a time
  for (int col0 = warp * 64; col0 < emb; col0 += TQ * 64) {
    float acc[TQ][2];
    dense_tile<T, TQ, 2>(cat, CATW, w5, emb, col0, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + lane + 32 * c;
      const T bv = b5[col];
#pragma unroll
      for (int r = 0; r < TQ; ++r)
        if (n0 + r < N)
          out[((size_t)b * N + n0 + r) * emb + col] = bias_relu(acc[r][c], bv);
    }
  }
}

template <typename T, int KNN>
static cudaError_t launch_stages(const float* x, const int* idx,
                                 const float* nbr, const void* const* w,
                                 const void* const* bs, void* out, int B, int N, int emb,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)(TQ * KNN * (64 + 128) + TQ * CATW);
  cudaError_t err = cudaFuncSetAttribute(
      dgcnn_stage_kernel<T, KNN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  dgcnn_stage_kernel<T, KNN><<<grid, TQ * 32, smem, stream>>>(
      x, idx, nbr, (const T*)w[0], (const T*)w[1], (const T*)w[2],
      (const T*)w[3], (const T*)w[4], (const T*)bs[0], (const T*)bs[1], (const T*)bs[2],
      (const T*)bs[3], (const T*)bs[4], (T*)out, N, emb);
  return cudaGetLastError();
}

template <int KNN>
static cudaError_t launch_k(const float* x, const void* const* w,
                           const void* const* bs, int* idx, float* alpha,
                           void* out, int B, int N, int emb, int pk,
                           int is_bf16, cudaStream_t stream) {
  if (N < KNN || pk > KNN) return cudaErrorInvalidValue;
  const dim3 grid((N + QPB - 1) / QPB, B);
  knn_alpha_kernel<KNN><<<grid, 256, 0, stream>>>(x, nullptr, idx, alpha, N, pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (is_bf16)
    return launch_stages<__nv_bfloat16, KNN>(x, idx, nullptr, w, bs, out, B, N,
                                             emb, stream);
  return launch_stages<float, KNN>(x, idx, nullptr, w, bs, out, B, N, emb, stream);
}

extern "C" int dgcnn_eval_launch(
    const float* x, const void* w1, const void* w2, const void* w3,
    const void* w4, const void* w5, const void* b1, const void* b2,
    const void* b3, const void* b4, const void* b5, int* idx, float* alpha,
    void* out, int B, int N, int emb, int k, int pk, int is_bf16,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || emb % 64 != 0) return (int)cudaErrorInvalidValue;
  const void* w[5] = {w1, w2, w3, w4, w5};
  const void* bs[5] = {b1, b2, b3, b4, b5};
  switch (k) {
#define CASE(K)                                                              \
  case K:                                                                    \
    return (int)launch_k<K>(x, w, bs, idx, alpha, out, B, N, emb, pk,        \
                            is_bf16, stream);
    DGCNN_KS(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (B, N, 3) and nbr (B, N, k, 3) float32 -> out (B, N, emb): the stage
// chain alone, over the given neighbours, at any N >= 1
extern "C" int dgcnn_edges_launch(
    const float* x, const float* nbr, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* b1,
    const void* b2, const void* b3, const void* b4, const void* b5, void* out,
    int B, int N, int emb, int k, int is_bf16, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N < 1 || emb % 64 != 0) return (int)cudaErrorInvalidValue;
  const void* w[5] = {w1, w2, w3, w4, w5};
  const void* bs[5] = {b1, b2, b3, b4, b5};
  switch (k) {
#define CASE(K)                                                               \
  case K:                                                                     \
    return is_bf16 ? (int)launch_stages<__nv_bfloat16, K>(x, nullptr, nbr, w, \
                                                          bs, out, B, N, emb, \
                                                          stream)             \
                   : (int)launch_stages<float, K>(x, nullptr, nbr, w, bs, out, \
                                                  B, N, emb, stream);
    DGCNN_KS(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
