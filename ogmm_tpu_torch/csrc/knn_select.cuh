// The fixed-order distance of every kernel that picks neighbours (the
// selections of knn_lanes.cuh, nn1.cu, knn_stream.cu and icp.cu), the
// neighbour counts and cloud sizes of the DGCNN kernels, and their
// compute-type conversions.
//
// Distances are formed without fused multiply-adds in one fixed order,
//   (|q|^2 + |t|^2) - 2 (q0 t0 + q1 t1 + q2 t2), clamped at 1e-12,
// the order of ogmm_tpu_torch/ops/common.py:square_distance3, so that a
// kernel and its plain PyTorch version select the same points bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define MAXN 1024  // points of a cloud the DGCNN kernels take

// The fused DGCNN kernels take any k from 1 to N <= MAXN. Up to DGCNN_MAX_K
// the shared selection keeps register lists (knn_lanes.cuh, as knn.cu's),
// above it the selection is knn_wide.cuh's. Their stage chains are compiled
// for the row counts of DGCNN_KS, multiples of 4 from 8 (an 8-row tensor-core
// tile spans at most two points): a point of k neighbours takes
// dgcnn_rows(k) rows, the rows past k repeating its nearest neighbour, which
// changes no max over the rows (eval: BN folded from running statistics);
// above DGCNN_MAX_K a point's neighbours go through them in chunks of at
// most DGCNN_MAX_K (dgcnn_eval.cu:launch_stages). The register-list
// selection's list is dgcnn_rows(k) long, and both write exactly k
// neighbours; graph_stage1.cu writes exactly k edge rows a point (its
// BatchNorm moments sum over them). X is a macro of one row count
#define DGCNN_MAX_K 32
#define DGCNN_KS(X) X(8) X(12) X(16) X(20) X(24) X(28) X(32)

__host__ __device__ constexpr int dgcnn_rows(int k) { return k <= 8 ? 8 : (k + 3) & ~3; }

// compute type (float32 or bf16) <-> float32
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sq_norm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// squared distance of q (norm qq) to a point p = (x, y, z, |t|^2) before
// its clamp: (qq + tt) - 2 inner in float32, the last two steps as one fma
// (2 inner is exact, so fma(-2, inner, qq + tt) rounds once as the
// subtraction does, and the bits are those of square_distance3)
__device__ __forceinline__ float dist_raw(float qx, float qy, float qz, float qq,
                                          float4 p) {
  const float inner = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                __fmul_rn(qz, p.z));
  return fmaf(-2.0f, inner, __fadd_rn(qq, p.w));
}

// the same, clamped at 1e-12
__device__ __forceinline__ float dist_fma(float qx, float qy, float qz, float qq,
                                          float4 p) {
  return fmaxf(dist_raw(qx, qy, qz, qq, p), 1e-12f);
}
