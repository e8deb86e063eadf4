// Whole-loop point-to-point ICP for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_icp.py:icp_pallas
// (_icp_kernel, _horn_pi): all trips of the refinement of one cloud in one
// block, one launch for the batch. Each trip:
//  1. moved = src R^T + t, each coordinate ((s0 R[i][0] + s1 R[i][1]) +
//     s2 R[i][2]) + t[i] without fused multiply-adds;
//  2. the 1-NN of every moved point among tgt over the fixed-order float32
//     distance of knn_select.cuh (clamped at 1e-12), first index on ties;
//  3. the gate d < threshold^2; a cloud with no inlier keeps its pose;
//  4. the inliers' means and covariance on the ORIGINAL src against their
//     correspondences, + 1e-5 I, the identity on a non-finite covariance;
//  5. R from Horn's 4x4 matrix by PI_ITERS shifted power iterations from
//     q = (1, 1e-3, 2e-3, 3e-3), t = mean(corr) - R mean(src).
// Steps 1-2 are the arithmetic of the plain version
// (ops/cuda_icp.py:icp_fused_reference), so the first trip's
// correspondences are identical bit for bit; the sums of step 4 are taken
// in another (fixed) order, so later trips agree to float32 round-off.
//
// tgt (M <= 4096 points, with |t|^2) sits in shared memory for the whole
// loop; src (any N) is read from L2 each trip. Four threads share a query
// row in the search (each a quarter of tgt, then a shuffle over (distance,
// index) pairs), 1024 threads a block; the moments go through a fixed-order
// block reduction, and thread 0 solves the 4x4 problem.
//
// Bound: operations. 30 trips of N M distances (8 flops and a compare each)
// are 3.3 GFLOP a request of 24 clouds of 717 points, 0.05 ms at the
// float32 rate; one block a cloud leaves most SMs idle at B = 24, and the
// block barriers and the serial 4x4 solve of every trip add to it. What the
// kernel removes is the eager loop's ~270 launches a trip.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"  // sq_norm3, sq_dist3

#define ICP_NT 1024  // threads a block
#define ROW_THREADS 4  // threads a query row in the search
#define MAXM 4096    // tgt in shared memory: 16 bytes a point, 64 KB
#define NWARPS (ICP_NT / 32)
#define PI_ITERS 30  // core/procrustes.py:_horn_quaternion_pi

// sums of K values over the block, fixed order: a shuffle tree in each warp,
// then thread 0 adds the warps' sums in order into out[0..K); all threads
// see out after the call
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*part)[16],
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += part[w][k];
      out[k] = s;
    }
  __syncthreads();
}

// R maximising tr(R cov^T) (cov row-major 3x3): Horn's symmetric 4x4
// matrix, shifted by its Gershgorin bound, power iteration
__device__ void horn_pi(const float* c, float* R) {
  const float sxx = c[0], sxy = c[1], sxz = c[2];
  const float syx = c[3], syy = c[4], syz = c[5];
  const float szx = c[6], szy = c[7], szz = c[8];
  float K[4][4];
  K[0][0] = sxx + syy + szz;
  K[0][1] = K[1][0] = syz - szy;
  K[0][2] = K[2][0] = szx - sxz;
  K[0][3] = K[3][0] = sxy - syx;
  K[1][1] = sxx - syy - szz;
  K[1][2] = K[2][1] = sxy + syx;
  K[1][3] = K[3][1] = szx + sxz;
  K[2][2] = -sxx + syy - szz;
  K[2][3] = K[3][2] = syz + szy;
  K[3][3] = -sxx - syy + szz;
  float sigma = 0.f;
  for (int i = 0; i < 4; ++i) {
    const float s = fabsf(K[i][0]) + fabsf(K[i][1]) + fabsf(K[i][2]) + fabsf(K[i][3]);
    sigma = fmaxf(sigma, s);
  }
  for (int i = 0; i < 4; ++i) K[i][i] += sigma + 1e-6f;
  float q[4] = {1.f, 1e-3f, 2e-3f, 3e-3f};
  for (int it = 0; it < PI_ITERS; ++it) {
    float p[4];
    for (int i = 0; i < 4; ++i)
      p[i] = K[i][0] * q[0] + K[i][1] * q[1] + K[i][2] * q[2] + K[i][3] * q[3];
    const float nrm = fmaxf(sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + p[3] * p[3]),
                            1e-30f);
    for (int i = 0; i < 4; ++i) q[i] = p[i] / nrm;
  }
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = w * w + x * x - y * y - z * z; R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = w * w - x * x + y * y - z * z; R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = w * w - x * x - y * y + z * z;
}

__global__ void __launch_bounds__(ICP_NT, 1)
icp_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           const float* __restrict__ pose, float* __restrict__ out,
           int* __restrict__ code, int* __restrict__ first, int N, int M,
           float thr2, int iters) {
  extern __shared__ float sm[];  // tx, ty, tz, |t|^2: (4, M)
  __shared__ float part[NWARPS][16];
  __shared__ float sR[9], st[3], mom[16];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* sb = src + (size_t)b * N * 3;
  const float* tb = tgt + (size_t)b * M * 3;
  int* cb = code + (size_t)b * N;
  int* fb = first + (size_t)b * N;
  float *tx = sm, *ty = sm + M, *tz = sm + 2 * M, *tt = sm + 3 * M;
  for (int m = tid; m < M; m += ICP_NT) {
    tx[m] = tb[3 * m]; ty[m] = tb[3 * m + 1]; tz[m] = tb[3 * m + 2];
    tt[m] = sq_norm3(tx[m], ty[m], tz[m]);
  }
  if (tid < 12) {            // pose (3, 4): [R | t]
    const float v = pose[(size_t)b * 12 + tid];
    if (tid % 4 < 3) sR[(tid / 4) * 3 + tid % 4] = v; else st[tid / 4] = v;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = sR[k];
    t[0] = st[0]; t[1] = st[1]; t[2] = st[2];

    // search and the inliers' first moments: count, sum src, sum corr
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n0 = 0; n0 < N; n0 += ICP_NT / ROW_THREADS) {
      const int n = n0 + tid / ROW_THREADS, sub = tid % ROW_THREADS;
      float best = CUDART_INF_F, s0 = 0.f, s1 = 0.f, s2 = 0.f;
      int bi = 0;
      if (n < N) {
        s0 = sb[3 * n]; s1 = sb[3 * n + 1]; s2 = sb[3 * n + 2];
        float mv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          mv[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(s0, R[3 * i]),
                                                __fmul_rn(s1, R[3 * i + 1])),
                                      __fmul_rn(s2, R[3 * i + 2])), t[i]);
        const float mm = sq_norm3(mv[0], mv[1], mv[2]);
        for (int m = sub; m < M; m += ROW_THREADS) {
          const float d = sq_dist3(mv[0], mv[1], mv[2], mm, tx[m], ty[m], tz[m], tt[m]);
          if (d < best) { best = d; bi = m; }   // m ascending: first index
        }
      }
#pragma unroll
      for (int off = 1; off < ROW_THREADS; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (n < N && sub == 0) {
        const bool inlier = best < thr2;
        cb[n] = inlier ? bi : ~bi;
        if (it == 0) fb[n] = bi;
        if (inlier) {
          acc[0] += 1.f;
          acc[1] += s0; acc[2] += s1; acc[3] += s2;
          acc[4] += tx[bi]; acc[5] += ty[bi]; acc[6] += tz[bi];
        }
      }
    }
    block_sum<7>(acc, part, mom);
    if (mom[0] == 0.f) continue;   // no inlier: the pose stays (block-uniform)
    const float wsum = fmaxf(mom[0], 1e-12f);
    const float sm0 = mom[1] / wsum, sm1 = mom[2] / wsum, sm2 = mom[3] / wsum;
    const float cm0 = mom[4] / wsum, cm1 = mom[5] / wsum, cm2 = mom[6] / wsum;

    // covariance of the centred inliers, sum w (s - mean s)(c - mean c)^T
    float cv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n = tid; n < N; n += ICP_NT) {
      const int c = cb[n];
      if (c < 0) continue;
      const float ds[3] = {sb[3 * n] - sm0, sb[3 * n + 1] - sm1, sb[3 * n + 2] - sm2};
      const float dc[3] = {tx[c] - cm0, ty[c] - cm1, tz[c] - cm2};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) cv[3 * i + j] += ds[i] * dc[j];
    }
    block_sum<9>(cv, part, mom + 7);
    if (tid == 0) {
      float cov[9], Rn[9];
      bool finite = true;
      for (int k = 0; k < 9; ++k) {
        cov[k] = mom[7 + k];
        finite = finite && isfinite(cov[k]);
      }
      for (int k = 0; k < 9; ++k) cov[k] = (finite ? cov[k] : 0.f) + (k % 4 == 0 ? 1e-5f : 0.f);
      horn_pi(cov, Rn);
      if (!finite)
        for (int k = 0; k < 9; ++k) Rn[k] = k % 4 == 0 ? 1.f : 0.f;
      for (int k = 0; k < 9; ++k) sR[k] = Rn[k];
      st[0] = cm0 - (Rn[0] * sm0 + Rn[1] * sm1 + Rn[2] * sm2);
      st[1] = cm1 - (Rn[3] * sm0 + Rn[4] * sm1 + Rn[5] * sm2);
      st[2] = cm2 - (Rn[6] * sm0 + Rn[7] * sm1 + Rn[8] * sm2);
    }
    __syncthreads();
  }
  if (tid < 12)
    out[(size_t)b * 12 + tid] = tid % 4 < 3 ? sR[(tid / 4) * 3 + tid % 4] : st[tid / 4];
}

// src (B, N, 3), tgt (B, M, 3), pose (B, 3, 4) float32 -> out (B, 3, 4);
// code (B, N) int32 scratch, first (B, N) int32: the first trip's 1-NN.
extern "C" int icp_launch(const float* src, const float* tgt, const float* pose,
                          float* out, int* code, int* first, int B, int N,
                          int M, float thr2, int iters, void* stream_ptr) {
  if (B < 1 || N < 1 || M < 1 || M > MAXM || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 16 * M;
  cudaError_t err = cudaFuncSetAttribute(
      icp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  icp_kernel<<<B, ICP_NT, smem, (cudaStream_t)stream_ptr>>>(
      src, tgt, pose, out, code, first, N, M, thr2, iters);
  return (int)cudaGetLastError();
}
