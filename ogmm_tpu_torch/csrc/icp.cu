// Whole-loop point-to-point ICP for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_icp.py:icp_pallas
// (_icp_kernel, _horn_pi): all trips of the refinement of a batch in one
// launch. Each trip:
//  1. moved = src R^T + t, each coordinate ((s0 R[i][0] + s1 R[i][1]) +
//     s2 R[i][2]) + t[i] without fused multiply-adds;
//  2. the 1-NN of every moved point among tgt over the fixed-order float32
//     distance of knn_select.cuh (clamped at 1e-12), first index on ties;
//  3. the gate d < threshold^2; a cloud with no inlier keeps its pose;
//  4. the inliers' means and then their centred covariance on the ORIGINAL
//     src against their correspondences (two passes), + 1e-5 I, the
//     identity on a non-finite covariance;
//  5. R from Horn's 4x4 matrix by PI_ITERS shifted power iterations from
//     q = (1, 1e-3, 2e-3, 3e-3), t = mean(corr) - R mean(src).
// Steps 1-2 are the arithmetic of the plain version
// (ops/cuda_icp.py:icp_fused_reference), so the first trip's
// correspondences are identical bit for bit; the sums of step 4 are taken
// in another (fixed) order, so later trips agree to float32 round-off.
//
// A thread block cluster of C blocks owns a cloud (ops/cuda_icp.py:icp_plan:
// C = 4 at the refined request's 24 clouds, 96 blocks in one wave: the card
// holds 30 clusters of 4 at once but only 22 of 5). Every block keeps the
// whole target in shared memory as float4 (x, y, z, |t|^2), 16 bytes a
// point (M <= 4096), and owns a fixed slice of `rows` src rows, held in
// shared memory with their inlier codes for all trips. `lanes` threads
// share a row in the search, each taking every lanes-th target point
// (strict <, ascending), then a shuffle over (distance, index) pairs. Sums
// are taken in a fixed order: a shuffle tree in each warp, the block's warps
// in order, then the cluster's blocks in rank order through distributed
// shared memory; so every block holds the same sums and solves the 4x4
// problem itself from them (one thread, then a block barrier), with no
// broadcast across the cluster. The block's partial sums have two slots by
// trip parity, so a fast block never overwrites a slot a slow one still
// reads: two cluster barriers a trip (after the first moments, after the
// covariance), one more before the blocks leave.
//
// Bound: operations. 30 trips of N M distances (8 flops and a compare each)
// are 3.3 GFLOP a request of 24 clouds of 717 points, 0.05 ms at the
// float32 rate. What stays serial a trip: the two cluster barriers, the
// block sums and the power iteration's 30 dependent steps (IEEE square root
// and division each step). Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): 0.62 ms at (24, 717, 717) (0.597 on the device), 1.51 at (24,
// 1433, 1433); of the first, the search about 0.31 ms, the solve 0.15 and
// the barriers and sums 0.14 (scripts/torch_port_profile.py --probe icp).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_select.cuh"  // sq_norm3, dist_fma

namespace cg = cooperative_groups;

#define MAXM 4096         // tgt in shared memory: 16 bytes a point, 64 KB
#define MAX_CLUSTER 8     // the portable cluster size
#define MAX_THREADS 1024
#define PI_ITERS 30       // core/procrustes.py:_horn_quaternion_pi
#define NSUM 16           // 7 first moments, then 9 covariance sums
#define SMEM_LIMIT (223 * 1024)  // dynamic: 227 KB less 4 KB for the static arrays
#define FULL 0xffffffffu

// this block's sums of v[0..K) into part[0..K): a shuffle tree in each warp,
// then thread k adds the warps' sums in warp order
template <int K>
__device__ __forceinline__ void block_part(float (&v)[K], float (*wpart)[NSUM],
                                           float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(FULL, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) wpart[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += wpart[w][threadIdx.x];
    part[threadIdx.x] = s;
  }
}

// the cluster's sums of slot `slot` entries [k0, k0 + K) in rank order into
// sums, after the cluster barrier that published them
template <int K>
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster,
                                             float* slot, int k0, float* sums) {
  if (threadIdx.x < K) {
    const int k = k0 + threadIdx.x;
    float v[MAX_CLUSTER];
    const int C = (int)cluster.num_blocks();
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) v[r] = cluster.map_shared_rank(slot, r)[k];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) s += v[r];
    sums[k] = s;
  }
  __syncthreads();
}

// R maximising tr(R cov^T) (cov row-major 3x3): Horn's symmetric 4x4
// matrix, shifted by its Gershgorin bound, power iteration
__device__ __forceinline__ void horn_pi(const float* c, float* R) {
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = fabsf(K[i][0]) + fabsf(K[i][1]) + fabsf(K[i][2]) + fabsf(K[i][3]);
    sigma = fmaxf(sigma, s);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) K[i][i] += sigma + 1e-6f;
  float q[4] = {1.f, 1e-3f, 2e-3f, 3e-3f};
#pragma unroll 1
  for (int it = 0; it < PI_ITERS; ++it) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = K[i][0] * q[0] + K[i][1] * q[1] + K[i][2] * q[2] + K[i][3] * q[3];
    const float nrm = fmaxf(sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + p[3] * p[3]),
                            1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = p[i] / nrm;
  }
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = w * w + x * x - y * y - z * z; R[1] = 2 * (x * y - w * z); R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z); R[4] = w * w - x * x + y * y - z * z; R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y); R[7] = 2 * (y * z + w * x); R[8] = w * w - x * x - y * y + z * z;
}

// grid B * C blocks in clusters of C (the cluster's rank r holds src rows
// [r rows, min(N, (r + 1) rows))); dynamic shared memory: tgt (M float4),
// the rows (float4), their codes (int)
__global__ void __launch_bounds__(MAX_THREADS, 1)
icp_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           const float* __restrict__ pose, float* __restrict__ out,
           int* __restrict__ first, int N, int M, float thr2, int iters,
           int rows, int lanes) {
  extern __shared__ float4 sm4[];
  __shared__ float wpart[MAX_THREADS / 32][NSUM];
  __shared__ float part[2][NSUM];   // this block's sums by trip parity
  __shared__ float sums[NSUM];      // the cluster's
  __shared__ float spose[12];       // R (row-major) and t after a solve
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x, nt = blockDim.x;
  const int r0 = rank * rows, nr = max(0, min(rows, N - r0));
  float4* tq = sm4;
  float4* sq = sm4 + M;
  int* code = reinterpret_cast<int*>(sq + rows);
  const float* tb = tgt + (size_t)b * M * 3;
  const float* sb = src + ((size_t)b * N + r0) * 3;
  for (int m = tid; m < M; m += nt) {
    const float x = tb[3 * m], y = tb[3 * m + 1], z = tb[3 * m + 2];
    tq[m] = make_float4(x, y, z, sq_norm3(x, y, z));
  }
  for (int r = tid; r < nr; r += nt)
    sq[r] = make_float4(sb[3 * r], sb[3 * r + 1], sb[3 * r + 2], 0.f);
  float R[9], t[3];   // pose (3, 4): [R | t], the same in every thread
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[3 * i + j] = pose[(size_t)b * 12 + 4 * i + j];
    t[i] = pose[(size_t)b * 12 + 4 * i + 3];
  }
  __syncthreads();
  const int sub = tid % lanes, per_pass = nt / lanes;

  for (int it = 0; it < iters; ++it) {
    float* slot = part[it & 1];
    // search and the inliers' first moments: count, sum src, sum corr
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < nr; p0 += per_pass) {
      const int r = p0 + tid / lanes;
      float best = CUDART_INF_F;
      int bi = 0;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        s = sq[r];
        float mv[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          mv[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(s.x, R[3 * i]),
                                                __fmul_rn(s.y, R[3 * i + 1])),
                                      __fmul_rn(s.z, R[3 * i + 2])), t[i]);
        const float mm = sq_norm3(mv[0], mv[1], mv[2]);
#pragma unroll 4
        for (int m = sub; m < M; m += lanes) {
          const float d = dist_fma(mv[0], mv[1], mv[2], mm, tq[m]);
          if (d < best) { best = d; bi = m; }   // m ascending: first index
        }
      }
      for (int off = 1; off < lanes; off <<= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (r < nr && sub == 0) {
        const bool inlier = best < thr2;
        code[r] = inlier ? bi : ~bi;
        if (it == 0) first[(size_t)b * N + r0 + r] = bi;
        if (inlier) {
          const float4 c = tq[bi];
          acc[0] += 1.f;
          acc[1] += s.x; acc[2] += s.y; acc[3] += s.z;
          acc[4] += c.x; acc[5] += c.y; acc[6] += c.z;
        }
      }
    }
    block_part<7>(acc, wpart, slot);
    cluster.sync();
    cluster_sums<7>(cluster, slot, 0, sums);
    if (sums[0] == 0.f) continue;   // no inlier: the pose stays (cluster-uniform)
    const float wsum = fmaxf(sums[0], 1e-12f);
    const float sm0 = sums[1] / wsum, sm1 = sums[2] / wsum, sm2 = sums[3] / wsum;
    const float cm0 = sums[4] / wsum, cm1 = sums[5] / wsum, cm2 = sums[6] / wsum;

    // covariance of the centred inliers, sum w (s - mean s)(c - mean c)^T
    float cv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = tid; r < nr; r += nt) {
      const int c = code[r];
      if (c < 0) continue;
      const float4 s = sq[r], p = tq[c];
      const float ds[3] = {s.x - sm0, s.y - sm1, s.z - sm2};
      const float dc[3] = {p.x - cm0, p.y - cm1, p.z - cm2};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) cv[3 * i + j] += ds[i] * dc[j];
    }
    block_part<9>(cv, wpart, slot + 7);
    cluster.sync();
    cluster_sums<9>(cluster, slot, 7, sums);
    if (tid == 0) {   // every block solves from the same sums
      float cov[9], Rn[9];
      bool finite = true;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        cov[k] = sums[7 + k];
        finite = finite && isfinite(cov[k]);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) cov[k] = (finite ? cov[k] : 0.f) + (k % 4 == 0 ? 1e-5f : 0.f);
      horn_pi(cov, Rn);
      if (!finite)
#pragma unroll
        for (int k = 0; k < 9; ++k) Rn[k] = k % 4 == 0 ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) spose[k] = Rn[k];
      spose[9] = cm0 - (Rn[0] * sm0 + Rn[1] * sm1 + Rn[2] * sm2);
      spose[10] = cm1 - (Rn[3] * sm0 + Rn[4] * sm1 + Rn[5] * sm2);
      spose[11] = cm2 - (Rn[6] * sm0 + Rn[7] * sm1 + Rn[8] * sm2);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = spose[k];
    t[0] = spose[9]; t[1] = spose[10]; t[2] = spose[11];
  }
  cluster.sync();   // no block leaves while another may read its sums
  if (rank == 0 && tid == 0)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) out[(size_t)b * 12 + 4 * i + j] = R[3 * i + j];
      out[(size_t)b * 12 + 4 * i + 3] = t[i];
    }
}

// src (B, N, 3), tgt (B, M, 3), pose (B, 3, 4) float32 -> out (B, 3, 4);
// first (B, N) int32: the first trip's 1-NN. cluster, rows, lanes, threads
// and smem: ops/cuda_icp.py:icp_plan, checked here.
extern "C" int icp_launch(const float* src, const float* tgt, const float* pose,
                          float* out, int* first, int B, int N, int M,
                          float thr2, int iters, int cluster, int rows,
                          int lanes, int threads, int smem, void* stream_ptr) {
  if (B < 1 || N < 1 || M < 1 || M > MAXM || iters < 0 || cluster < 2 ||
      cluster > MAX_CLUSTER || rows < 1 || (long long)rows * cluster < N ||
      (lanes != 1 && lanes != 2 && lanes != 4) || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 ||
      smem < 16 * M + 20 * rows || smem > SMEM_LIMIT ||
      (long long)B * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      icp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream_ptr;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, icp_kernel, src, tgt, pose, out, first, N, M,
                           thr2, iters, rows, lanes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// how many clusters of the kernel with this shape the card holds at once, by
// the occupancy calculator: ops/cuda_icp.py:icp_plan picks the cluster size
// so that a launch's clusters run in one wave (an H100: 30 clusters of 4 at
// 736 threads, 22 of 5 at 576)
extern "C" int icp_max_clusters(int cluster, int threads, int smem, int* out) {
  if (cluster < 1 || cluster > MAX_CLUSTER || threads < 32 || threads > MAX_THREADS ||
      smem < 0 || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      icp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)icp_kernel, &cfg);
}
