// Farthest-point sampling for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_fps.py:fps_pallas
// (_fps_kernel), which keeps the batch's points and running distances on
// chip for the whole chain. Here one block, or one thread block cluster,
// owns one row (cloud) and runs the whole npoint-step chain in one launch:
// the row's start index and initial distance row come from the caller (the
// random start with distance 1e10, or the centre start with the distances to
// the centroid), so that one launch serves fps_combined's anchor and centre
// rows together. Each step reads the chosen point, updates every point's
// running minimum distance min(dist, (x - c)^2) with the three squares
// summed x, y, z in that order without fused multiply-adds (the order of
// the plain loop, ops/cuda_fps.py:fps_reference), and takes the row's
// argmax, ties to the lowest index.
//
// The register routes (fps_reg_kernel<P, CL>; ops/cuda_fps.py:fps_plan
// picks the launch): block r of a row's B blocks owns its contiguous share
// [r S, r S + S), S = ceil(N / B), and its thread t the P contiguous points
// from r S + t P, and keeps their x, y, z and running distance in
// registers for the whole chain; the initial distance row is only read.
// Contiguous ownership makes "lowest lane, then lowest warp, then lowest
// block" the lowest index, so no index is compared:
//  - thread: the first maximum of its P distances;
//  - warp: __reduce_max_sync over the distances' bits (non-negative floats
//    order as integers), __ballot_sync and __ffs for the first lane holding
//    it; that lane holds the winner's index and coordinates;
//  - row: each warp publishes (bits, index, x, y, z) in a slot of a
//    double-buffered table, slot rank * warps + warp; one barrier a step
//    (__syncthreads for a block a row; one barrier.cluster arrive/wait for
//    a cluster of CL blocks a row, each warp writing its record into every
//    block's table through distributed shared memory); then every warp
//    reduces the table itself (the lowest slot of the largest bits) and
//    reads the new centre from its record.
// A block holds at most FpsThreads<P> x P points; a row takes a cluster of up
// to 16 blocks (above 8 with cudaFuncAttributeNonPortableClusterSizeAllowed)
// where one block cannot hold it (the indoor request's rows of 35,000
// points). Beyond what the largest cluster holds the L2 route
// (fps_l2_kernel) keeps the old design: one block of 1024 threads a row,
// the points read from the caller's (N, 3) array and the running distances
// in a scratch copy of the distance row, both served from L2.
//
// Bound: neither bytes nor operations. A step does ~10 flops a point, and
// the steps depend on each other: the barrier and the reductions a step
// bound it (a block barrier and two warp reductions for a block a row, the
// cluster barrier for a cluster), against the microseconds of host launches
// a step the plain loop pays.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace cg = cooperative_groups;

#define FULL_MASK 0xffffffffu
#define MAX_WARPS 32                          // 1024 threads
#define MAX_CLUSTER 16                        // non-portable above 8
#define SLOTS (MAX_WARPS * MAX_CLUSTER)       // a row's warps

// the most threads a block of P points a thread takes (its launch bounds:
// the registers of P points beside the step's work); ops/cuda_fps.py:
// FPS_POINTS mirrors it
template <int P>
struct FpsThreads {
  static constexpr int value = P <= 4 ? 1024 : P <= 8 ? 768 : 512;
};

template <int P, bool CL>
__global__ void __launch_bounds__(FpsThreads<P>::value, 1)
fps_reg_kernel(const float* __restrict__ xyz, const float* __restrict__ dist,
               const long long* __restrict__ start, long long* __restrict__ ids,
               int N, int npoint) {
  __shared__ int skey[2][SLOTS];
  __shared__ float4 srec[2][SLOTS];      // (index bits, x, y, z)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  int rank = 0, nblocks = 1, row = blockIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (CL) {
    rank = (int)cluster.block_rank();
    nblocks = (int)cluster.num_blocks();
    row = blockIdx.x / nblocks;
  }
  const float* pts = xyz + (size_t)row * N * 3;
  const float* drow = dist + (size_t)row * N;
  long long* out = ids + (size_t)row * npoint;
  // block r owns [r S, r S + S) of the row (S = ceil(N / blocks)), thread t
  // of it P points from r S + t P
  const int share = (N + nblocks - 1) / nblocks;
  const int hi = min(N, (rank + 1) * share), base = rank * share + tid * P;
  float px[P], py[P], pz[P], pd[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = base + p;
    const bool in = n < hi;
    px[p] = in ? pts[3 * n] : 0.f;
    py[p] = in ? pts[3 * n + 1] : 0.f;
    pz[p] = in ? pts[3 * n + 2] : 0.f;
    // + 0 turns a -0 into +0, so that the bits of every distance order as
    // integers; padding (-1) lies below every distance
    pd[p] = in ? __fadd_rn(drow[n], 0.f) : -1.f;
  }
  int far = (int)start[row];
  float cx = pts[3 * far], cy = pts[3 * far + 1], cz = pts[3 * far + 2];
  if constexpr (CL) cluster.sync();   // every block runs before a peer writes its table
  const int slot = rank * warps + warp, nslots = nblocks * warps;
  for (int i = 0;; ++i) {
    if (rank == 0 && tid == 0) out[i] = far;
    if (i + 1 == npoint) break;
    // the running distances and this thread's first maximum
    int bk = INT_MIN, bp = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float dx = __fsub_rn(px[p], cx);
      const float dy = __fsub_rn(py[p], cy);
      const float dz = __fsub_rn(pz[p], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      pd[p] = fminf(pd[p], d);
      const int k = __float_as_int(pd[p]);
      if (k > bk) { bk = k; bp = p; }
    }
    float wx = px[0], wy = py[0], wz = pz[0];
#pragma unroll
    for (int p = 1; p < P; ++p)
      if (bp == p) { wx = px[p]; wy = py[p]; wz = pz[p]; }
    // the warp's winner: the first lane holding the largest bits
    const int wk = __reduce_max_sync(FULL_MASK, bk);
    const int wl = __ffs(__ballot_sync(FULL_MASK, bk == wk)) - 1;
    const int buf = i & 1;
    if constexpr (!CL) {
      if (lane == wl) {
        skey[buf][slot] = wk;
        srec[buf][slot] = make_float4(__int_as_float(base + bp), wx, wy, wz);
      }
      __syncthreads();
    } else {
      const int wn = __shfl_sync(FULL_MASK, base + bp, wl);
      const float4 rec = make_float4(__int_as_float(wn), __shfl_sync(FULL_MASK, wx, wl),
                                     __shfl_sync(FULL_MASK, wy, wl),
                                     __shfl_sync(FULL_MASK, wz, wl));
      if (lane < nblocks) {   // lane r writes the record into block r's table
        *cluster.map_shared_rank(&skey[buf][slot], lane) = wk;
        *cluster.map_shared_rank(&srec[buf][slot], lane) = rec;
      }
      cluster.sync();
    }
    // the row's winner: the lowest slot of the largest bits
    int rs;
    if (nslots <= 32) {   // a slot a lane: the first lane holding the maximum
      const int k = lane < nslots ? skey[buf][lane] : INT_MIN;
      const int rk = __reduce_max_sync(FULL_MASK, k);
      rs = __ffs(__ballot_sync(FULL_MASK, lane < nslots && k == rk)) - 1;
    } else {
      int best = INT_MIN, bs = INT_MAX;
      for (int s = lane; s < nslots; s += 32) {
        const int k = skey[buf][s];
        if (bs == INT_MAX || k > best) { best = k; bs = s; }
      }
      const int rk = __reduce_max_sync(FULL_MASK, best);
      rs = __reduce_min_sync(FULL_MASK, best == rk ? bs : INT_MAX);
    }
    const float4 r = srec[buf][rs];
    far = __float_as_int(r.x);
    cx = r.y; cy = r.z; cz = r.w;
  }
}

// The L2 route for rows no cluster holds in registers: one block of 1024
// threads a row, the points read from xyz, the running distances kept in
// dist (the caller's scratch copy), a warp shuffle tree over (distance,
// index) pairs, then one warp over the warps' winners.
__global__ void __launch_bounds__(1024)
fps_l2_kernel(const float* __restrict__ xyz, float* __restrict__ dist,
              const long long* __restrict__ start, long long* __restrict__ ids,
              int N, int npoint) {
  __shared__ float wbest[32];
  __shared__ int widx[32], s_far;
  const int row = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nthr + 31) >> 5;
  const float* pts = xyz + (size_t)row * N * 3;
  float* drow = dist + (size_t)row * N;
  long long* out = ids + (size_t)row * npoint;
  int far = (int)start[row];
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) out[i] = far;
    const float cx = pts[3 * far], cy = pts[3 * far + 1], cz = pts[3 * far + 2];
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += nthr) {
      const float dx = __fsub_rn(pts[3 * n], cx);
      const float dy = __fsub_rn(pts[3 * n + 1], cy);
      const float dz = __fsub_rn(pts[3 * n + 2], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float dn = fminf(drow[n], d);
      drow[n] = dn;
      if (dn > best) { best = dn; bi = n; }   // n ascending: first index
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL_MASK, best, off);
      const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (lane == 0) { wbest[warp] = best; widx[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? wbest[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? widx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL_MASK, best, off);
        const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) s_far = bi;
    }
    __syncthreads();
    far = s_far;
  }
}

template <int P>
static cudaError_t launch_reg(const float* xyz, const float* dist,
                              const long long* start, long long* ids, int R, int N,
                              int npoint, int cluster, int threads,
                              cudaStream_t stream) {
  if (threads > FpsThreads<P>::value) return cudaErrorInvalidValue;
  if (cluster == 1) {
    fps_reg_kernel<P, false><<<R, threads, 0, stream>>>(xyz, dist, start, ids, N,
                                                        npoint);
    return cudaGetLastError();
  }
  if (cluster > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_reg_kernel<P, true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fps_reg_kernel<P, true>, xyz, dist, start,
                                       ids, N, npoint);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// xyz (R, N, 3) float32, dist (R, N) float32 (the initial distances), start
// (R,) int64 -> ids (R, npoint) int64. The launch (ops/cuda_fps.py:fps_plan,
// checked here): route 0 the registers, `cluster` blocks a row of `threads`
// threads of `points` points each (dist only read); route 1 the L2 route,
// one block of `threads` threads a row (dist overwritten: the caller's
// scratch copy).
extern "C" int fps_launch(const float* xyz, float* dist, const long long* start,
                          long long* ids, int R, int N, int npoint, int cluster,
                          int threads, int points, int route, void* stream_ptr) {
  if (R < 1 || N < 1 || npoint < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (route == 1) {
    if (cluster != 1 || R > 0x7fffffff) return (int)cudaErrorInvalidValue;
    fps_l2_kernel<<<R, threads, 0, stream>>>(xyz, dist, start, ids, N, npoint);
    return (int)cudaGetLastError();
  }
  if (route != 0 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 &&
                     cluster != MAX_CLUSTER) ||
      (long long)threads * points < (N + cluster - 1) / cluster ||
      (long long)R * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  switch (points) {
    case 2: return (int)launch_reg<2>(xyz, dist, start, ids, R, N, npoint, cluster, threads, stream);
    case 4: return (int)launch_reg<4>(xyz, dist, start, ids, R, N, npoint, cluster, threads, stream);
    case 8: return (int)launch_reg<8>(xyz, dist, start, ids, R, N, npoint, cluster, threads, stream);
    case 16: return (int)launch_reg<16>(xyz, dist, start, ids, R, N, npoint, cluster, threads, stream);
  }
  return (int)cudaErrorInvalidValue;
}
