// Farthest-point sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_fps.py:fps_pallas
// (_fps_kernel), which keeps the batch's points and running distances on
// chip for the whole chain. Here one block owns one row (cloud) and runs the
// whole npoint-step chain in one launch: the row's start index and initial
// distance row come from the caller (the random start with distance 1e10,
// or the centre start with the distances to the centroid), so that one
// launch serves fps_combined's anchor and centre rows together. Each step
// reads the chosen point, updates every point's running minimum distance
// min(dist, (x - c)^2) with the three squares summed x, y, z in that order
// without fused multiply-adds (the order of the plain loop,
// ops/cuda_fps.py:fps_reference), and takes the
// block's argmax, ties to the lowest index (a warp shuffle tree over
// (distance, index) pairs, then one warp over the warps' winners).
//
// The points (structure of arrays) and distances of a row sit in shared
// memory up to SMEM_MAX_N points; beyond that the block reads the points from
// the caller's (N, 3) array and keeps the distances in the caller's scratch
// row, both served from L2 (the indoor request's rows hold 35,000 points).
//
// Bound: neither bytes nor operations. A step does ~10 flops a point, and
// the 128 steps depend on each other: two block barriers and the argmax
// tree a step bound it, about a microsecond each, against the microseconds
// of host launches a step the plain loop pays.
#include <cuda_runtime.h>
#include <math_constants.h>

#define SMEM_MAX_N 10240  // 16 bytes a point: 160 KB of shared memory

template <bool SMEM>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ dist,
           const long long* __restrict__ start, long long* __restrict__ ids,
           int N, int npoint) {
  extern __shared__ float sm[];
  __shared__ float wbest[32];
  __shared__ int widx[32], s_far;
  const int row = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthr + 31) >> 5;
  const float* pts = xyz + (size_t)row * N * 3;
  float* drow = dist + (size_t)row * N;
  long long* out = ids + (size_t)row * npoint;
  float *sx = sm, *sy = sm + N, *sz = sm + 2 * N, *sd = sm + 3 * N;
  if (SMEM) {
    for (int n = tid; n < N; n += nthr) {
      sx[n] = pts[3 * n]; sy[n] = pts[3 * n + 1]; sz[n] = pts[3 * n + 2];
      sd[n] = drow[n];
    }
    __syncthreads();
  }
  int far = (int)start[row];
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[i] = far;
    const float cx = SMEM ? sx[far] : pts[3 * far];
    const float cy = SMEM ? sy[far] : pts[3 * far + 1];
    const float cz = SMEM ? sz[far] : pts[3 * far + 2];
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += nthr) {
      const float dx = __fsub_rn(SMEM ? sx[n] : pts[3 * n], cx);
      const float dy = __fsub_rn(SMEM ? sy[n] : pts[3 * n + 1], cy);
      const float dz = __fsub_rn(SMEM ? sz[n] : pts[3 * n + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float dn = fminf(SMEM ? sd[n] : drow[n], d);
      if (SMEM) sd[n] = dn; else drow[n] = dn;
      if (dn > best) { best = dn; bi = n; }   // n ascending: first index
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (lane == 0) { wbest[warp] = best; widx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? wbest[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? widx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) s_far = bi;
    }
    __syncthreads();
    far = s_far;
  }
}

// xyz (R, N, 3) float32, dist (R, N) float32 (the initial distances,
// overwritten), start (R,) int64 -> ids (R, npoint) int64.
extern "C" int fps_launch(const float* xyz, float* dist, const long long* start,
                          long long* ids, int R, int N, int npoint,
                          void* stream_ptr) {
  if (R < 1 || N < 1 || npoint < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // about four points a thread, whole warps, at most 1024 threads
  int threads = ((N + 3) / 4 + 31) / 32 * 32;
  threads = threads < 64 ? 64 : threads > 1024 ? 1024 : threads;
  if (N <= SMEM_MAX_N) {
    const int smem = 16 * N;
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fps_kernel<true><<<R, threads, smem, stream>>>(xyz, dist, start, ids, N, npoint);
  } else {
    fps_kernel<false><<<R, threads, 0, stream>>>(xyz, dist, start, ids, N, npoint);
  }
  return (int)cudaGetLastError();
}
