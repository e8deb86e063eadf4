// Neighbour selection shared by the DGCNN kernels (dgcnn_eval.cu,
// graph_stage1.cu) and the position-encoding angles (posenc_angles.cu), the
// fixed-order distance of every kernel that picks neighbours (nn1.cu,
// knn.cu), and the compute-type conversions of the DGCNN kernels.
//
// Distances are formed without fused multiply-adds in one fixed order,
//   (|q|^2 + |t|^2) - 2 (q0 t0 + q1 t1 + q2 t2), clamped at 1e-12,
// the order of ogmm_tpu_torch/ops/common.py:square_distance3, so that a
// kernel and its plain PyTorch version select the same points bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define QPB 32     // queries per block of the selection kernel
#define MAXN 1024  // 32 lanes x 32 registers hold one distance row

// the neighbour counts the fused DGCNN kernels are compiled for: k = 20 is
// the ModelNet graph, 16 and 8 the narrower graphs the port's checks and
// small configurations drive; any other k takes the unfused route. X is a
// macro of one count
#define DGCNN_KS(X) X(8) X(16) X(20)

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

// squared distance of q (norm qq) to t (norm tt), clamped at 1e-12
__device__ __forceinline__ float sq_dist3(float qx, float qy, float qz, float qq,
                                          float tx, float ty, float tz, float tt) {
  const float inner = __fadd_rn(__fadd_rn(__fmul_rn(qx, tx), __fmul_rn(qy, ty)),
                                __fmul_rn(qz, tz));
  return fmaxf(__fsub_rn(__fadd_rn(qq, tt), __fmul_rn(2.0f, inner)), 1e-12f);
}

// sq_dist3 of a point p = (x, y, z, |t|^2) with its last two steps as one
// fma: 2 inner is exact, so fma(-2, inner, qq + tt) rounds once as
// (qq + tt) - 2 inner does, and the bits are the same
__device__ __forceinline__ float dist_fma(float qx, float qy, float qz, float qq,
                                          float4 p) {
  const float inner = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                __fmul_rn(qz, p.z));
  return fmaxf(fmaf(-2.0f, inner, __fadd_rn(qq, p.w)), 1e-12f);
}

// One warp per query point. The cloud (N <= 1024) sits in shared memory, the
// query's float32 distance row sits in the warp's registers (32 values a
// lane), and KNN (<= 32, one index a lane) rounds of warp argmin-and-mask
// pick the neighbours in ascending order, ties to the lowest index. The
// first pk rounds also give the position-encoding angle
// cos(angle(p -> nbr, p -> centroid)) from float32 coordinates, the centroid
// being the given one (B, 3) or, where that is null, the cloud's sum / N.
// Needs KNN <= N.
// Writes idx_out (B, N, KNN) unless it is null, and alpha_out (B, N, pk).
template <int KNN>
__global__ void __launch_bounds__(256)
knn_alpha_kernel(const float* __restrict__ x, const float* __restrict__ centroid,
                 int* __restrict__ idx_out, float* __restrict__ alpha_out,
                 int N, int pk) {
  __shared__ float sx[MAXN], sy[MAXN], sz[MAXN], st[MAXN];
  __shared__ float red[3][8];
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xb = x + (size_t)b * N * 3;

  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int j = tid; j < N; j += 256) {
    const float px = xb[3 * j], py = xb[3 * j + 1], pz = xb[3 * j + 2];
    sx[j] = px; sy[j] = py; sz[j] = pz;
    st[j] = sq_norm3(px, py, pz);
    ax += px; ay += py; az += pz;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, o);
    ay += __shfl_xor_sync(0xffffffffu, ay, o);
    az += __shfl_xor_sync(0xffffffffu, az, o);
  }
  if (lane == 0) { red[0][warp] = ax; red[1][warp] = ay; red[2][warp] = az; }
  __syncthreads();
  float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) { cx += red[0][w]; cy += red[1][w]; cz += red[2][w]; }
  cx /= (float)N; cy /= (float)N; cz /= (float)N;
  if (centroid != nullptr) {
    cx = centroid[3 * b]; cy = centroid[3 * b + 1]; cz = centroid[3 * b + 2];
  }

  for (int qi = warp; qi < QPB; qi += 8) {
    const int n = blockIdx.x * QPB + qi;
    if (n >= N) break;                       // uniform over the warp
    const float qx = sx[n], qy = sy[n], qz = sz[n], qq = st[n];

    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i * 32 + lane;
      d[i] = j < N ? sq_dist3(qx, qy, qz, qq, sx[j], sy[j], sz[j], st[j])
                   : CUDART_INF_F;
    }

    // direction to the centroid, for the angles
    float gx = qx - cx, gy = qy - cy, gz = qz - cz;
    const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
    gx /= gn; gy /= gn; gz /= gn;

    int my_idx = 0;
    float my_alpha = 0.f;
    for (int jj = 0; jj < KNN; ++jj) {
      float bv = d[0];
      int bi = 0;
#pragma unroll
      for (int i = 1; i < 32; ++i)
        if (d[i] < bv) { bv = d[i]; bi = i; }
      int bj = bi * 32 + lane;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (ov < bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (bj == i * 32 + lane) d[i] = CUDART_INF_F;
      if (lane == jj) my_idx = bj;
      if (jj < pk) {
        float lx = sx[bj] - qx, ly = sy[bj] - qy, lz = sz[bj] - qz;
        const float ln = fmaxf(sqrtf(lx * lx + ly * ly + lz * lz), 1e-12f);
        lx /= ln; ly /= ln; lz /= ln;
        const float a = lx * gx + ly * gy + lz * gz;
        if (lane == jj) my_alpha = a;
      }
    }
    const size_t row = (size_t)b * N + n;
    if (idx_out != nullptr && lane < KNN) idx_out[row * KNN + lane] = my_idx;
    if (lane < pk) alpha_out[row * pk + lane] = my_alpha;
  }
}
