// The selection shared by the four-lane kNN kernels (knn.cu:knn_kernel<K>,
// the dense kNN; knn_stream.cu:knn_stream_kernel<K>, the streamed one).
//
// NL = 4 lanes (adjacent threads of a warp) share a query. Each lane keeps a
// sorted top-K of its own points, (distance, index) pairs in registers,
// placeholders (inf, INT_MAX). The points come in sub-tiles of SUBT; lane
// `sub` takes the points sub, sub + 4, ... of each. A candidate enters only
// at or below the threshold the query's four lanes share, set after each
// round of insertions to the smaller of the least of their K-th distances
// and the largest of their ceil(K/4)-th (four lists that each hold ceil(K/4)
// pairs at or below a value hold K pairs there): an upper bound of the
// query's running K-th distance. A candidate above it has K pairs before it
// and can never be among the K, so the four lists together always hold the
// query's K smallest pairs. A lane first marks its points that pass (in the
// streamed kernel those of a sub-tile, in the dense one those of many
// sub-tiles, kept in a buffer), then the warp runs one compare-and-swap
// chain for each marked point of its busiest lane (the distance formed
// again), not one for each position where any of its 32 lanes inserts. At
// the end the four lists of a query merge by rank in shared memory: the rank
// of a lane's s-th pair is s plus the pairs before it in the other three
// lists (binary searches), exact because the lanes hold disjoint indices; a
// lane stops at its first pair of rank k or more, and placeholders never
// rank below k.
//
// Every comparison is on the pair (distance, index), so the K pairs are the
// K lexicographically smallest whatever order the points come in: ascending
// distance, ties to the lowest index, the order of the plain version's k
// passes of argmin and mask. Where a kernel is compiled for a K above the k
// asked, the first k of its K pairs are the k smallest.
#pragma once

#include <limits.h>
#include <math_constants.h>

#include "knn_select.cuh"  // dist_fma

#define NL 4              // lanes a query
#define SUBT 64           // points of a sub-tile
#define FULL 0xffffffffu

__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

template <int K>
__device__ __forceinline__ void lanes_init(float (&kd)[K], int (&ki)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) { kd[s] = CUDART_INF_F; ki[s] = INT_MAX; }
}

// (cd, ci) into a lane's sorted list, if it comes before the list's last
template <int K>
__device__ __forceinline__ void insert(float (&kd)[K], int (&ki)[K], float cd, int ci) {
  if (!before(cd, ci, kd[K - 1], ki[K - 1])) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (before(cd, ci, kd[s], ki[s])) {
      const float td = kd[s]; const int ti = ki[s];
      kd[s] = cd; ki[s] = ci; cd = td; ci = ti;
    }
  }
}

// One sub-tile for a lane: its points ts[0], ts[NL], ... (ts = the
// sub-tile's first point + sub), index idx0 + NL jj, the first `hi` points
// of the sub-tile valid (0 for a lane without a query). Every lane of the
// warp calls it together.
template <int K>
__device__ __forceinline__ void lanes_subtile(float (&kd)[K], int (&ki)[K], float thr,
                                              float qx, float qy, float qz, float qq,
                                              const float4* ts, int sub, int hi, int idx0) {
  const float lim = fminf(thr, kd[K - 1]);
  unsigned pending = 0;
#pragma unroll
  for (int jj = 0; jj < SUBT / NL; ++jj) {
    if (sub + NL * jj < hi && dist_fma(qx, qy, qz, qq, ts[NL * jj]) <= lim)
      pending |= 1u << jj;
  }
  while (__any_sync(FULL, pending != 0)) {
    if (pending != 0) {
      const int jj = __ffs(pending) - 1;
      pending &= pending - 1;
      insert<K>(kd, ki, dist_fma(qx, qy, qz, qq, ts[NL * jj]), idx0 + NL * jj);
    }
  }
}

// the threshold the query's four lanes share: the least K-th, the largest
// ceil(K/4)-th, whichever is smaller
template <int K>
__device__ __forceinline__ float lanes_threshold(const float (&kd)[K]) {
  constexpr int Q = (K + NL - 1) / NL;
  float lo = kd[K - 1], up = kd[Q - 1];
#pragma unroll
  for (int o = 1; o < NL; o <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
    up = fmaxf(up, __shfl_xor_sync(FULL, up, o));
  }
  return fminf(lo, up);
}

// a lane's list into the columns `tid` of ld, li ([K][nt] each)
template <int K>
__device__ __forceinline__ void lanes_store(const float (&kd)[K], const int (&ki)[K],
                                            float* ld, int* li, int nt, int tid) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ld[s * nt + tid] = kd[s];
    li[s * nt + tid] = ki[s];
  }
}

// after lanes_store and a barrier: the lane's pairs of rank below kout to
// out[rank]
template <int K>
__device__ __forceinline__ void lanes_merge(const float (&kd)[K], const int (&ki)[K],
                                            const float* ld, const int* li, int nt,
                                            int tid, int sub, long long* out, int kout) {
  const int first_lane = tid - sub;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (ki[s] == INT_MAX) break;      // placeholders: never among the k
    int rank = s;
#pragma unroll
    for (int o = 0; o < NL; ++o) {
      if (o == sub) continue;
      const int col = first_lane + o;
      int lo = 0, hi = K;             // the pairs of lane o before (kd[s], ki[s])
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(ld[mid * nt + col], li[mid * nt + col], kd[s], ki[s])) lo = mid + 1;
        else hi = mid;
      }
      rank += lo;
    }
    if (rank >= kout) break;          // the lane's later pairs rank after
    out[rank] = ki[s];
  }
}
