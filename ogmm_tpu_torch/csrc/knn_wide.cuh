// The dense selection above k = 32: knn_wide_kernel<Out>, the k nearest
// points of a whole target cloud (M <= 4096) for each query at any
// 1 <= k <= M, for the callers of knn_kernel<K, Out> (knn_lanes.cuh) past
// its register lists: the dense kNN (knn.cu, IndexOut) and the DGCNN graphs
// (dgcnn_eval.cu, graph_stage1.cu, GraphOut). Those lists stop at 32: a
// lane's sorted list of K pairs takes 2 K registers and a K-step chain per
// insertion. Here nothing a query keeps grows with k in registers.
//
// A block loads its cloud into shared memory as (x, y, z, |t|^2), as
// knn_kernel does, and takes WIDE_QUERIES queries, one warp a query at a
// time. Each warp has two buffers of its own in shared memory: the keys,
// one a point, and the list, wide_list(k) = the power of two at or above k
// (at least 32). For a query the warp
//  1. writes each point's key, the bits of its clamped fixed-order float32
//     distance (dist_fma): the distances are positive, so the bits order as
//     the numbers do;
//  2. finds T, the k-th smallest key, bit by bit from bit 30 down: T takes
//     a bit where fewer than k keys lie below T with it (a count over the
//     keys and a warp sum a bit), so T ends as the largest value with fewer
//     than k keys below it;
//  3. takes, in index order (32 points a step, ballots for the positions),
//     every point below T and the first k - (points below T) at T: exactly
//     the k smallest (distance, index) pairs, ties to the lowest index. They
//     are compacted in place into the keys' buffer (a point's position never
//     passes its index) beside their indices in the list;
//  4. sorts the k pairs, padded to the list's length with (inf, INT_MAX), by
//     a bitonic network on (key, index), and writes the first k through Out:
//     ascending distance, ties to the lowest index, the order of k passes of
//     argmin and mask (ops/common.py:select_smallest), so the kernel and the
//     plain version pick the same neighbours in the same order.
// GraphOut's angles take the centroid of the cloud summed as knn_kernel
// sums it (256 threads, the same order), or the one given.
//
// Bound: operations. Each (query, point) pair costs 8 flops of distance and
// a compare; the design reads its keys 33 times (31 bits, the count below T
// and the gather) and sorts k log^2 k / 4 pairs a query: the shared-memory
// reads of the bisection are what hold it from that bound.
#pragma once

#include <limits.h>

#include "knn_lanes.cuh"   // IndexOut, GraphOut, knn_launch_k, smem_cap_once, FULL
#include "knn_select.cuh"  // dist_fma, sq_norm3, DGCNN_KS, DGCNN_MAX_K

#define WIDE_QUERIES 32    // queries a block
#define WIDE_WARPS 8       // warps a block where their buffers fit (wide_warps)
#define WIDE_MIN_LIST 32   // the least length of a warp's list
#define WIDE_MAX_M 4096    // the TPU kernel's envelope
// dynamic shared memory a block may use: an H100's 227 KB (232,448 bytes)
// less the centroid's warp sums (static, 3 WIDE_WARPS floats)
#define WIDE_SMEM (232448 - 3 * WIDE_WARPS * 4)

// a warp's list: the power of two at or above k, at least WIDE_MIN_LIST
__host__ __device__ constexpr int wide_list(int k) {
  int p = WIDE_MIN_LIST;
  while (p < k) p <<= 1;
  return p;
}

// 32-bit words of a warp's buffers: the keys (M of them, or the list's
// length where that is more: the padded list sorts there) and the list
__host__ __device__ constexpr int wide_words(int M, int k) {
  return (M > wide_list(k) ? M : wide_list(k)) + wide_list(k);
}

// dynamic shared memory of a block of `warps` warps: the cloud, then each
// warp's buffers
__host__ __device__ constexpr int wide_smem(int M, int k, int warps) {
  return 16 * M + 4 * warps * wide_words(M, k);
}

// warps a block: WIDE_WARPS, halved until their buffers fit (4 at M = 4096
// and k above 2048); 0 where not even one fits
__host__ __device__ constexpr int wide_warps(int M, int k) {
  int w = WIDE_WARPS;
  while (w > 0 && wide_smem(M, k, w) > WIDE_SMEM) w >>= 1;
  return w;
}

// grid (query blocks of WIDE_QUERIES, B), 32 warps threads (GraphOut: always
// WIDE_WARPS), wide_smem(M, k, warps) bytes of dynamic shared memory
template <class Out>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
knn_wide_kernel(const float* __restrict__ src, const float* __restrict__ tgt, Out out,
                int N, int M, int k) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ float red[3][WIDE_WARPS];           // the centroid's warp sums
  float4* tp = reinterpret_cast<float4*>(dsm);   // [M]
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int list = wide_list(k), nkeys = M > list ? M : list;
  unsigned* keys = reinterpret_cast<unsigned*>(tp + M) + warp * (nkeys + list);
  int* sel = reinterpret_cast<int*>(keys + nkeys);
  const float* tb = tgt + (size_t)b * M * 3;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int m = tid; m < M; m += blockDim.x) {
    const float x = tb[3 * m], y = tb[3 * m + 1], z = tb[3 * m + 2];
    tp[m] = make_float4(x, y, z, sq_norm3(x, y, z));
    ax += x; ay += y; az += z;
  }
  if constexpr (Out::kAngles) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ax += __shfl_xor_sync(FULL, ax, o);
      ay += __shfl_xor_sync(FULL, ay, o);
      az += __shfl_xor_sync(FULL, az, o);
    }
    if (lane == 0) {
      red[0][warp] = ax; red[1][warp] = ay; red[2][warp] = az;
    }
  }
  __syncthreads();
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if constexpr (Out::kAngles) {
    for (int w = 0; w < warps; ++w) {
      cx += red[0][w]; cy += red[1][w]; cz += red[2][w];
    }
    cx /= (float)M; cy /= (float)M; cz /= (float)M;
    if (out.centroid != nullptr) {
      cx = out.centroid[3 * b];
      cy = out.centroid[3 * b + 1];
      cz = out.centroid[3 * b + 2];
    }
  }
  const unsigned below = (1u << lane) - 1u;      // the lanes before this one
  for (int qi = warp; qi < WIDE_QUERIES; qi += warps) {
    const int n = blockIdx.x * WIDE_QUERIES + qi;
    if (n >= N) break;
    const float* q = src + ((size_t)b * N + n) * 3;
    const float qx = q[0], qy = q[1], qz = q[2];
    const float qq = sq_norm3(qx, qy, qz);
    // 1. the keys
    for (int i = lane; i < M; i += 32)
      keys[i] = __float_as_uint(dist_fma(qx, qy, qz, qq, tp[i]));
    __syncwarp();
    // 2. T, the k-th smallest key (every key is below 2^31)
    unsigned T = 0u;
    for (int bit = 30; bit >= 0; --bit) {
      const unsigned cand = T | (1u << bit);
      int c = 0;
      for (int i = lane; i < M; i += 32) c += keys[i] < cand;
      if (__reduce_add_sync(FULL, c) < k) T = cand;
    }
    int less = 0;
    for (int i = lane; i < M; i += 32) less += keys[i] < T;
    const int need = k - __reduce_add_sync(FULL, less);   // taken at T, >= 1
    // 3. the k pairs in index order, compacted in place
    int taken = 0, ties = 0;
    for (int base = 0; base < M; base += 32) {
      const int i = base + lane;
      const unsigned key = i < M ? keys[i] : 0xffffffffu;
      const bool at = i < M && key == T;
      const unsigned atm = __ballot_sync(FULL, at);
      const bool take = key < T || (at && ties + __popc(atm & below) < need);
      const unsigned tm = __ballot_sync(FULL, take);
      const int pos = taken + __popc(tm & below);
      ties += __popc(atm);
      taken += __popc(tm);
      __syncwarp();                  // this step's keys are read: pos <= i
      if (take) {
        keys[pos] = key;
        sel[pos] = i;
      }
    }
    for (int r = k + lane; r < list; r += 32) {
      keys[r] = 0xffffffffu;
      sel[r] = INT_MAX;
    }
    __syncwarp();
    // 4. the bitonic network over the list, ascending (key, index)
    for (int size = 2; size <= list; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < list / 2; t += 32) {
          const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
          const unsigned ka = keys[lo], kb = keys[hi];
          const int ia = sel[lo], ib = sel[hi];
          if ((ka > kb || (ka == kb && ia > ib)) == ((lo & size) == 0)) {
            keys[lo] = kb; keys[hi] = ka;
            sel[lo] = ib; sel[hi] = ia;
          }
        }
        __syncwarp();
      }
    }
    // the unit direction to the centroid, for the angles
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if constexpr (Out::kAngles) {
      gx = qx - cx; gy = qy - cy; gz = qz - cz;
      const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
      gx /= gn; gy /= gn; gz /= gn;
    }
    const size_t row = (size_t)b * N + n;
    for (int r = lane; r < k; r += 32)
      out.put(row, k, r, sel[r], tb, qx, qy, qz, gx, gy, gz);
    __syncwarp();                    // the buffers are the next query's
  }
}

// the launch of knn_wide_kernel<Out> for B clouds; 1 <= k <= M <= 4096
template <class Out>
static cudaError_t knn_wide_launch(const float* src, const float* tgt, Out out, int B,
                                   int N, int M, int k, cudaStream_t stream) {
  if (M < 1 || M > WIDE_MAX_M || k < 1 || k > M || N < 1 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  // the angles' centroid is summed by WIDE_WARPS warps, as knn_kernel's
  const int warps = Out::kAngles ? WIDE_WARPS : wide_warps(M, k);
  if (warps < 1 || wide_smem(M, k, warps) > WIDE_SMEM) return cudaErrorInvalidValue;
  static bool wide[MAX_DEVICES] = {};
  const cudaError_t err =
      smem_cap_once(wide, (const void*)knn_wide_kernel<Out>, WIDE_SMEM);
  if (err != cudaSuccess) return err;
  knn_wide_kernel<Out><<<dim3((N + WIDE_QUERIES - 1) / WIDE_QUERIES, B), warps * 32,
                         wide_smem(M, k, warps), stream>>>(src, tgt, out, N, M, k);
  return cudaGetLastError();
}

// the DGCNN graph of B clouds of N points (dgcnn_eval.cu, graph_stage1.cu):
// up to DGCNN_MAX_K knn_kernel with a list of dgcnn_rows(k), above it
// knn_wide_kernel; either writes exactly k neighbours
static cudaError_t graph_select_launch(const float* x, GraphOut graph, int B, int N,
                                       int k, cudaStream_t stream) {
  if (k > DGCNN_MAX_K) return knn_wide_launch(x, x, graph, B, N, N, k, stream);
  switch (dgcnn_rows(k)) {
#define CASE(K) \
  case K:       \
    return knn_launch_k<K>(x, x, graph, B, N, N, k, stream);
    DGCNN_KS(CASE)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}
