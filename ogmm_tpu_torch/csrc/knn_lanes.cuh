// The selection shared by the four-lane kNN kernels: knn_kernel<K, Out>
// below, the dense one (the kNN of knn.cu, the DGCNN graphs of
// graph_stage1.cu and dgcnn_eval.cu, the angles of posenc_angles.cu), and
// knn_stream.cu:knn_stream_kernel<K>, the streamed one.
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

#include "knn_select.cuh"  // dist_fma, dist_raw, sq_norm3

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

// after lanes_store and a barrier: put(rank, index) for each of the lane's
// pairs of rank below kout
template <int K, class Put>
__device__ __forceinline__ void lanes_merge(const float (&kd)[K], const int (&ki)[K],
                                            const float* ld, const int* li, int nt,
                                            int tid, int sub, int kout, Put put) {
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
    put(rank, ki[s]);
  }
}

// ---------------------------------------------------------------------------
// The dense selection (knn_kernel<K, Out>): the k nearest points of a whole
// target cloud (M <= 4096) for each query, one function with four callers:
// the dense kNN (knn.cu, int64 indices), the DGCNN training graph
// (graph_stage1.cu) and eval graph (dgcnn_eval.cu), both int32 indices and
// the angles of the first pk neighbours against the cloud's centroid, and
// the position-encoding angles (posenc_angles.cu, angles only, against the
// centroid it is given).
//
// A block loads the target cloud of its batch entry into shared memory
// once, as (x, y, z, |t|^2) (64 KB at M = 4096), for KQ = 64 queries. Each
// query has NL = 4 lanes; lane l takes the points l, l + 4, ... of each
// 64-point sub-tile. Two passes over the target:
//  1. each lane forms the minimum of its 16 points of each sub-tile and
//     keeps the Q = ceil(K/4) smallest of these minima (a min/max network in
//     registers); T, the largest of the four lanes' Q-th, has at least K
//     points at or below it (Q distinct ones in each lane), so T bounds the
//     query's K-th distance, and it lies close to it (a lane's Q-th smallest
//     minimum is its Q-th smallest distance unless two of its nearest points
//     share a sub-tile);
//  2. each lane keeps a sorted top-K of its own points in registers, and the
//     lanes of a query share a threshold (T, then tighter) and merge their
//     lists by rank at the end. A lane appends the index of each of its
//     points at or below the threshold to its own buffer in shared memory
//     (CL entries); the warp inserts the buffered points (one
//     compare-and-swap chain for each point of its busiest lane, the
//     distance formed again) only where a lane's buffer could overflow in
//     the next sub-tile and at the end. With T from the start, a lane
//     buffers a few of its points (about 7 at k = 20), not the whole first
//     sub-tile and the long tail of a threshold that starts at inf, and the
//     warp waits for its busiest lane once, not once a sub-tile.
// Both passes compare the distance before its clamp at 1e-12: T and every
// threshold are at or above 1e-12, where the clamp changes no comparison.
// Any N and M >= 1: a sub-tile past the end of the target is cut short, a
// query past the end of the block's rows runs with the block and writes
// nothing. Where the compiled K is above the k asked (kout), the first kout
// of the K pairs are written: they are the kout smallest in order.

// a kernel's dynamic shared-memory attribute belongs to a device: `done`
// holds one flag a device of the caller's kernel, and the attribute is
// raised to `bytes` once on each (always on a device past the flags)
#define MAX_DEVICES 64
static inline cudaError_t smem_cap_once(bool (&done)[MAX_DEVICES], const void* fn,
                                        int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

#define KQ 64              // queries a block
#define KNT (KQ * NL)      // threads of a block
#define CL 32              // entries of a lane's candidate buffer

// dynamic shared memory: the target and the lanes' buffers, then (the same
// bytes) the lists
__host__ __device__ constexpr int knn_smem(int M, int K) {
  return M * 16 + CL * KNT * 4 > KNT * K * 8 ? M * 16 + CL * KNT * 4 : KNT * K * 8;
}

// The buffered points into the lane's list (the warp runs one chain for each
// point of its busiest lane); the tighter threshold
template <int K>
__device__ __forceinline__ float drain(float (&kd)[K], int (&ki)[K], const int* buf,
                                       int& cnt, const float4* tp, float qx, float qy,
                                       float qz, float qq, float thr) {
  while (__any_sync(FULL, cnt > 0)) {
    if (cnt > 0) {
      const int m = buf[--cnt * KNT];
      insert<K>(kd, ki, dist_fma(qx, qy, qz, qq, tp[m]), m);
    }
  }
  return fminf(thr, lanes_threshold<K>(kd));
}

// What the dense kNN writes: int64 (B, N, kout)
struct IndexOut {
  long long* idx;
  static constexpr bool kAngles = false;
  __device__ __forceinline__ void put(size_t row, int kout, int rank, int m,
                                      const float*, float, float, float, float,
                                      float, float) const {
    idx[row * kout + rank] = m;
  }
};

// What the graph selections write: int32 indices (B, N, kout) unless idx is
// null, and alpha (B, N, pk), cos(angle(q -> nbr, q -> centroid)) of the
// first pk neighbours from float32 coordinates (a coincident neighbour
// gives 0), the centroid being the given one (B, 3) or, where that is null,
// the cloud's sum / M
struct GraphOut {
  int* idx;
  float* alpha;
  const float* centroid;
  int pk;
  static constexpr bool kAngles = true;
  // tb: the cloud; (gx, gy, gz): the unit direction from q to the centroid
  __device__ __forceinline__ void put(size_t row, int kout, int rank, int m,
                                      const float* tb, float qx, float qy, float qz,
                                      float gx, float gy, float gz) const {
    if (idx != nullptr) idx[row * kout + rank] = m;
    if (rank >= pk) return;
    float lx = tb[3 * m] - qx, ly = tb[3 * m + 1] - qy, lz = tb[3 * m + 2] - qz;
    const float ln = fmaxf(sqrtf(lx * lx + ly * ly + lz * lz), 1e-12f);
    lx /= ln; ly /= ln; lz /= ln;
    alpha[row * pk + rank] = lx * gx + ly * gy + lz * gz;
  }
};

// grid (query blocks of KQ, B), KNT threads, knn_smem(M, K) bytes of
// dynamic shared memory
template <int K, class Out>
__global__ void __launch_bounds__(KNT)
knn_kernel(const float* __restrict__ src, const float* __restrict__ tgt, Out out,
           int N, int M, int kout) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ float red[3][KNT / 32];             // the centroid's warp sums
  float4* tp = reinterpret_cast<float4*>(dsm);   // [M]
  const int b = blockIdx.y, tid = threadIdx.x, sub = tid % NL;
  const int n = blockIdx.x * KQ + tid / NL;
  const bool valid = n < N;
  const float* tb = tgt + (size_t)b * M * 3;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int m = tid; m < M; m += KNT) {
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
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = ax; red[1][tid >> 5] = ay; red[2][tid >> 5] = az;
    }
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  __syncthreads();
  // the unit direction to the centroid, for the angles
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if constexpr (Out::kAngles) {
    float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll
    for (int w = 0; w < KNT / 32; ++w) {
      cx += red[0][w]; cy += red[1][w]; cz += red[2][w];
    }
    cx /= (float)M; cy /= (float)M; cz /= (float)M;
    if (out.centroid != nullptr) {
      cx = out.centroid[3 * b];
      cy = out.centroid[3 * b + 1];
      cz = out.centroid[3 * b + 2];
    }
    gx = qx - cx; gy = qy - cy; gz = qz - cz;
    const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
    gx /= gn; gy /= gn; gz /= gn;
  }
  // 1. the Q smallest of the lane's sub-tile minima, ascending
  constexpr int Q = (K + NL - 1) / NL;
  float g[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) g[s] = CUDART_INF_F;
  for (int s0 = 0; s0 < M; s0 += SUBT) {
    const float4* ts = tp + s0 + sub;
    const int hi = valid ? min(SUBT, M - s0) : 0;
    float gm = CUDART_INF_F;
#pragma unroll
    for (int jj = 0; jj < SUBT / NL; ++jj)
      if (sub + NL * jj < hi) gm = fminf(gm, dist_raw(qx, qy, qz, qq, ts[NL * jj]));
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const float lo = fminf(gm, g[s]);
      gm = fmaxf(gm, g[s]);
      g[s] = lo;
    }
  }
  // the query's shared threshold: T, then tighter
  float thr = fmaxf(g[Q - 1], 1e-12f);
#pragma unroll
  for (int o = 1; o < NL; o <<= 1) thr = fmaxf(thr, __shfl_xor_sync(FULL, thr, o));
  // 2. the lanes' lists, fed from their buffers
  float kd[K];
  int ki[K];
  lanes_init<K>(kd, ki);
  int* buf = reinterpret_cast<int*>(tp + M) + tid;   // [CL][KNT], the lane's column
  int cnt = 0;
  for (int s0 = 0; s0 < M; s0 += SUBT) {
    if (__any_sync(FULL, cnt > CL - SUBT / NL))
      thr = drain<K>(kd, ki, buf, cnt, tp, qx, qy, qz, qq, thr);
    const float4* ts = tp + s0 + sub;
    const int hi = valid ? min(SUBT, M - s0) : 0;
#pragma unroll
    for (int jj = 0; jj < SUBT / NL; ++jj) {
      if (sub + NL * jj < hi && dist_raw(qx, qy, qz, qq, ts[NL * jj]) <= thr)
        buf[cnt++ * KNT] = s0 + sub + NL * jj;
    }
  }
  drain<K>(kd, ki, buf, cnt, tp, qx, qy, qz, qq, thr);
  __syncthreads();   // every thread is done with the target: the lists go there
  float* ld = reinterpret_cast<float*>(dsm);      // [K][KNT]
  int* li = reinterpret_cast<int*>(ld + K * KNT);  // [K][KNT]
  lanes_store<K>(kd, ki, ld, li, KNT, tid);
  __syncthreads();
  if (!valid) return;
  const size_t row = (size_t)b * N + n;
  lanes_merge<K>(kd, ki, ld, li, KNT, tid, sub, kout, [&](int rank, int m) {
    out.put(row, kout, rank, m, tb, qx, qy, qz, gx, gy, gz);
  });
}

// the launch of knn_kernel<K, Out> for B clouds; kout <= K, kout <= M <= 4096
template <int K, class Out>
static cudaError_t knn_launch_k(const float* src, const float* tgt, Out out, int B,
                                int N, int M, int kout, cudaStream_t stream) {
  static bool wide[MAX_DEVICES] = {};   // the attribute, for M <= 4096
  const cudaError_t err =
      smem_cap_once(wide, (const void*)knn_kernel<K, Out>, knn_smem(4096, K));
  if (err != cudaSuccess) return err;
  knn_kernel<K, Out><<<dim3((N + KQ - 1) / KQ, B), KNT, knn_smem(M, K), stream>>>(
      src, tgt, out, N, M, kout);
  return cudaGetLastError();
}
