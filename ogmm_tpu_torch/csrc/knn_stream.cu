// kNN and 1-NN of 3-D points with the target streamed through shared memory,
// for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels ogmm_tpu/ops/pallas_stream.py:knn_stream
// (_knn_stream_kernel) and nn1_stream (_nn1_stream_kernel); nn1_stream_t
// computes the same function and is served by the 1-NN entry point. They
// exist for clouds too large to hold the target on chip (the indoor request,
// N = M = 35,000).
//
// Distances are the fixed-order float32 form of knn_select.cuh, clamped at
// 1e-12, as in ogmm_tpu_torch/ops/common.py:square_distance3, and every
// comparison is on the pair (distance, index), so the result is the k
// lexicographically smallest pairs whatever order the tiles are visited in:
// ascending distance, ties to the lowest index, the order of the plain
// PyTorch version (k passes of argmin and mask); the indices agree bit for
// bit.
//
// Options, as the TPU kernels':
//  - diag: visit target tiles from the one holding column tile*STN*stretch
//    outwards (start, start+1, start-1, ...); on Morton-sorted clouds the
//    true neighbours come first.
//  - lb (B, T_n, T_m): a lower bound of every squared distance between query
//    tile i and target tile j (ops/stream.py:pair_tile_bounds). A tile is
//    skipped only where its bound is above worst (1 + 1e-6) + 1e-6, worst
//    being the largest running k-th distance (or an upper bound of it) of
//    the tile's valid rows; a skipped tile holds no candidate that could
//    enter any list.
//  - gate (1-NN): worst is clamped to max_dist_sq, so tiles beyond the ICP
//    inlier gate are skipped at once; a row whose true nearest point lies at
//    or beyond the gate may then return any index and d >= gate (inf and 0
//    where no tile was visited), the TPU kernel's contract.
//
// Bound: operations. 8 flops of distance and one compare for every
// (query, target) pair the search needs, against 12 bytes read for each
// point and 8 bytes written for each index. The cull and the diagonal order
// cut the pairs visited to the tiles near each query tile.
//
// Both kernels share one frame. A block is one row of the cull table (64
// queries; the table's grid is the contract), NL = 4 lanes a query, each
// taking every fourth point of a tile (a warp: 8 Morton-adjacent queries).
// The raw coordinates of the next candidate tile are in flight (cp.async into
// the other half of a double buffer) while the current one is searched; one
// pass turns a tile into (x, y, z, |t|^2) and the box of each 64-point
// sub-tile (a warp each). The block reads its row of the table into shared
// memory once, and fetches the next tile that the block's current worst
// leaves. A warp skips a sub-tile where every lane's lower bound of the
// distances it would compute there (the squared gap to the box less
// pair_tile_bounds' rounding margin) is above the lane's threshold.
//
// kNN (knn_stream_kernel<K>): the four lanes' sorted top-k lists, their
// shared threshold (set after each sub-tile), the batched insertion and the
// merge by rank of knn_lanes.cuh (shared with the dense kNN, knn.cu); the
// threshold, not each lane's own k-th, also bounds the sub-tile and tile
// culls, and the lists merge in the shared memory the tiles used. An
// optional counter takes the tiles each block searched, their largest count
// and the (warp, sub-tile) pairs searched (null on the main path).
//
// 1-NN (nn1_kernel): each lane keeps its best (d, i) over its points (strict
// < inside a tile, whose points it visits in ascending order, the pair order
// across tiles); the four lanes merge by shuffles at the end; its threshold
// is the lane's best so far, clamped to the gate. The ICP trip's 547 blocks
// of 256 threads (48 registers, 32 bytes spilled: five an SM) fill 132 SMs
// in one wave (four an SM, without the spill, measured the same). Where the
// query tiles alone cannot fill the card (the clustering's 2 x 16 queries
// against 35,000 points), the grid also splits the target tiles into chunks
// (ops/cuda_stream.py:nn1_stream_plan); each chunk writes its rows' partial
// (d, i), and a second launch takes the pair minimum over the chunks, a warp
// a row (exact: the pair order makes it independent of the order of the
// reduction and of the blocks). An optional counter adds up the target
// tiles the blocks searched (null on the main path).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): the kNN graph
// at (2, 35000, 35000, k=20) with cull and diagonal order 0.600 ms a call
// (0.585-0.595 on the device), searching 16.9% of the tile pairs where the
// search needs 16.2% and forming 3.4% of all distances; what bounds it is
// the insertion chains and the merge, about 0.35 ms of it (a build without
// them: scripts/torch_port_profile.py --probe knn_stream). The 1-NN ICP
// trip at (1, 35000, 35000) with cull and gate 0.195 ms a call (0.192 on
// the device), searching 19.8% of the tile pairs where the search needs
// 15.6%; the clustering's (2, 16, 35000) 0.0075 ms on the device,
// 0.044-0.053 ms between back-to-back calls (the wrapper's host work).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include "knn_lanes.cuh"   // NL, SUBT, before, the lists, threshold and merge
#include "knn_select.cuh"  // sq_norm3, dist_fma

#define STN 64            // queries of a block: one row of the cull table
#define STM 512           // target points of a shared-memory tile
#define MAXK 32
#define NT (STN * NL)     // threads of a block (a warp makes a sub-tile's box)
// the kNN block's tile buffers: raw coordinates twice, (x, y, z, |t|^2) and
// the boxes; the same bytes hold the lists for the merge
#define KNN_TILE_BYTES ((2 * STM * 3 + 4 * STM + (STM / SUBT) * 8) * 4)
#define KNN_MAX_SMEM (200 * 1024)

// the t-th target tile of the diagonal-first order from `start`
__device__ __forceinline__ int diag_tile(int t, int start, int n_m) {
  const int off = ((t + 1) / 2) * (1 - 2 * (t % 2));
  return ((start + off) % n_m + n_m) % n_m;
}

// a tile whose bound is above this may be skipped: worst with a margin
__device__ __forceinline__ float cull_at(float worst) {
  return worst * (1.0f + 1e-6f) + 1e-6f;
}

// 16 (or 4) bytes global -> shared without registers, the first `bytes`
// copied and the rest zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

// the raw coordinates of target points [m0, m0 + len) into buf, in flight;
// a word is always copied by the same thread, so a thread's wait covers
// every copy to the words it ever copies
__device__ __forceinline__ void fetch_tile(float* buf, const float* __restrict__ tb,
                                           int m0, int len) {
  const float* g = tb + (size_t)m0 * 3;
  const int words = len * 3;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    for (int c = threadIdx.x; 4 * c < words; c += NT)
      cp_async_16(buf + 4 * c, g + 4 * c, 4 * min(4, words - 4 * c));
  } else {
    for (int w = threadIdx.x; w < words; w += NT) cp_async_4(buf + w, g + w);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// warp w: the raw points 64 w .. 64 w + 63 of a tile of len to
// (x, y, z, |t|^2), and their box (lo xyz, hi xyz, max |t|^2)
__device__ __forceinline__ void tile_boxes(const float* raw, float4* tp,
                                           float (*box)[8], int len) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F}, tt = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = w * SUBT + h * 32 + lane;
    if (m < len) {
      const float x = raw[3 * m], y = raw[3 * m + 1], z = raw[3 * m + 2];
      const float nn = sq_norm3(x, y, z);
      tp[m] = make_float4(x, y, z, nn);
      lo[0] = fminf(lo[0], x); lo[1] = fminf(lo[1], y); lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x); hi[1] = fmaxf(hi[1], y); hi[2] = fmaxf(hi[2], z);
      tt = fmaxf(tt, nn);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(FULL, lo[c], o));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(FULL, hi[c], o));
    }
    tt = fmaxf(tt, __shfl_xor_sync(FULL, tt, o));
  }
  if (lane == 0) {
    box[w][0] = lo[0]; box[w][1] = lo[1]; box[w][2] = lo[2];
    box[w][3] = hi[0]; box[w][4] = hi[1]; box[w][5] = hi[2]; box[w][6] = tt;
  }
}

// a lower bound of the distances from q to the points of a box, less the
// rounding margin of pair_tile_bounds
__device__ __forceinline__ float box_low(const float* bx, float qx, float qy,
                                         float qz, float qq) {
  const float gx = fmaxf(fmaxf(bx[0] - qx, qx - bx[3]), 0.f);
  const float gy = fmaxf(fmaxf(bx[1] - qy, qy - bx[4]), 0.f);
  const float gz = fmaxf(fmaxf(bx[2] - qz, qz - bx[5]), 0.f);
  return (gx * gx + gy * gy + gz * gz) * (1.0f - 1e-6f) - 1e-5f * (1.0f + qq + bx[6]);
}

// the largest value of the block's valid rows (every lane of a row holds
// it): all threads get it
__device__ __forceinline__ float block_worst(float v, bool valid, float* red) {
  float w = valid ? v : -CUDART_INF_F;
#pragma unroll
  for (int o = 16; o >= NL; o >>= 1) w = fmaxf(w, __shfl_xor_sync(FULL, w, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = w;
  __syncthreads();
  w = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) w = fmaxf(w, red[i]);
  return w;
}

// ------------------------------------------------------------------- kNN

__host__ __device__ constexpr int knn_lists_bytes(int k) { return NT * k * 8; }
__host__ __device__ constexpr int knn_union_bytes(int k) {
  return knn_lists_bytes(k) > KNN_TILE_BYTES ? knn_lists_bytes(k) : KNN_TILE_BYTES;
}

// grid (query tiles, B), NT threads; dynamic shared memory: the tile
// buffers (or the lists) and, where table_in_smem, the block's table row
template <int K>
__global__ void __launch_bounds__(NT)
knn_stream_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           const float* __restrict__ lb, long long* __restrict__ idx_out,
           int* __restrict__ visits, int N, int M, int diag, int stretch,
           int table_in_smem) {
  extern __shared__ __align__(16) unsigned char dsm[];
  float* raw = reinterpret_cast<float*>(dsm);                   // [2][STM * 3]
  float4* tp = reinterpret_cast<float4*>(raw + 2 * STM * 3);    // [STM]
  float (*box)[8] = reinterpret_cast<float (*)[8]>(tp + STM);   // [STM / SUBT][8]
  __shared__ float red[NT / 32];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int n_t = gridDim.x, n_m = (M + STM - 1) / STM;
  const int tid = threadIdx.x, sub = tid % NL, n = tile * STN + tid / NL;
  const bool valid = n < N;
  const float* tb = tgt + (size_t)b * M * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  const bool culled = lb != nullptr;
  const float* lbs = culled ? lb + ((size_t)b * n_t + tile) * n_m : nullptr;
  if (culled && table_in_smem) {   // the block's row of the table, read once
    float* row = reinterpret_cast<float*>(dsm + knn_union_bytes(K));
    for (int t = tid; t < n_m; t += NT) row[t] = lbs[t];
    __syncthreads();
    lbs = row;
  }
  const int start = diag ? (int)(((long long)tile * STN * stretch / STM) % n_m) : 0;
  auto phys = [&](int t) { return diag ? diag_tile(t, start, n_m) : t; };
  float worst = CUDART_INF_F;   // the largest threshold of the block's rows
  auto next = [&](int t) {      // the first position >= t worst leaves
    while (t < n_m && culled && lbs[phys(t)] > cull_at(worst)) ++t;
    return t;
  };
  float kd[K];
  int ki[K];
  lanes_init<K>(kd, ki);
  float thr = CUDART_INF_F;     // the row's shared threshold
  int searched = 0, scans = 0, buf = 0;
  int pend = next(0);           // the position whose tile is in flight
  if (pend < n_m) {
    const int m0 = phys(pend) * STM;
    fetch_tile(raw + buf * STM * 3, tb, m0, min(STM, M - m0));
  }
  while (pend < n_m) {
    const int cur = pend, cb = buf, m0 = phys(cur) * STM, len = min(STM, M - m0);
    if (culled && lbs[phys(cur)] > cull_at(worst)) {
      // culled by a worst that fell since it was fetched: drop it
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      pend = next(cur + 1);
      if (pend < n_m) {
        const int n0 = phys(pend) * STM;
        fetch_tile(raw + buf * STM * 3, tb, n0, min(STM, M - n0));
      }
      continue;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the tile is in; every thread is done with tp
    pend = next(cur + 1);
    buf ^= 1;
    if (pend < n_m) {
      const int n0 = phys(pend) * STM;
      fetch_tile(raw + buf * STM * 3, tb, n0, min(STM, M - n0));
    }
    tile_boxes(raw + cb * STM * 3, tp, box, len);
    __syncthreads();
    for (int s = 0; s * SUBT < len; ++s) {
      if (__all_sync(FULL, !valid || box_low(box[s], qx, qy, qz, qq) > cull_at(thr)))
        continue;
      ++scans;
      lanes_subtile<K>(kd, ki, thr, qx, qy, qz, qq, tp + s * SUBT + sub, sub,
                       valid ? min(SUBT, len - s * SUBT) : 0, m0 + s * SUBT + sub);
      thr = lanes_threshold<K>(kd);
    }
    ++searched;
    if (culled) worst = block_worst(thr, valid, red);
  }
  if (visits != nullptr) {
    if ((tid & 31) == 0) atomicAdd(visits + 2, scans);
    if (tid == 0) {
      atomicAdd(visits, searched);
      atomicMax(visits + 1, searched);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();   // every thread is done with the tiles: the lists go there
  float* ld = reinterpret_cast<float*>(dsm);    // [K][NT]
  int* li = reinterpret_cast<int*>(ld + K * NT);  // [K][NT]
  lanes_store<K>(kd, ki, ld, li, NT, tid);
  __syncthreads();
  if (!valid) return;
  long long* out = idx_out + ((size_t)b * N + n) * K;
  lanes_merge<K>(kd, ki, ld, li, NT, tid, sub, K, [&](int rank, int m) { out[rank] = m; });
}

static cudaError_t check_args(int B, int N, int M, int k) {
  if (B < 1 || N < 1 || M < k || k < 1 || k > MAXK || B > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int K>
static cudaError_t knn_launch(const float* src, const float* tgt, const float* lb,
                              long long* idx, int* visits, int B, int N, int M,
                              int diag, int stretch, cudaStream_t stream) {
  const int n_m = (M + STM - 1) / STM;
  size_t smem = knn_union_bytes(K);
  int table_in_smem = 0;   // the table row beside the tiles where it fits
  if (lb != nullptr && smem + (size_t)n_m * 4 <= KNN_MAX_SMEM) {
    smem += (size_t)n_m * 4;
    table_in_smem = 1;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_stream_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  knn_stream_kernel<K><<<dim3((N + STN - 1) / STN, B), NT, smem, stream>>>(
      src, tgt, lb, idx, visits, N, M, diag, stretch, table_in_smem);
  return cudaGetLastError();
}

// visits: null, or three counters: the (query tile, target tile) pairs the
// blocks searched, the most one block searched, and the (warp, 64-point
// sub-tile) pairs the warps searched
extern "C" int knn_stream_launch(const float* src, const float* tgt,
                                 const float* lb, long long* idx, int* visits,
                                 int B, int N, int M, int k, int diag,
                                 int stretch, void* stream_ptr) {
  if (check_args(B, N, M, k) != cudaSuccess) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (k) {
#define CASE(K)                                                                \
  case K:                                                                      \
    return (int)knn_launch<K>(src, tgt, lb, idx, visits, B, N, M, diag,        \
                              stretch, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    CASE(17) CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24)
    CASE(25) CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ 1-NN

// grid (query tiles, chunks, B). chunk c searches target tiles
// [c * per_chunk, min((c + 1) * per_chunk, n_m)); with one chunk the tiles
// of the whole target, in the diagonal order if asked. One chunk writes
// d_out and i_out; several write their partials to pd, pi (B, chunks, N).
__global__ void __launch_bounds__(NT, 5)
nn1_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
           const float* __restrict__ lb, float* __restrict__ d_out,
           long long* __restrict__ i_out, float* __restrict__ pd,
           int* __restrict__ pi, int* __restrict__ visits, int N, int M,
           int diag, int stretch, float gate, int per_chunk) {
  __shared__ __align__(16) float raw[2][STM * 3];
  __shared__ float4 tp[STM];
  __shared__ float box[STM / SUBT][8];   // lo xyz, hi xyz, max |t|^2
  __shared__ float red[NT / 32];
  extern __shared__ float lbs[];          // the chunk's tiles of the table row
  const int tile = blockIdx.x, chunk = blockIdx.y, b = blockIdx.z;
  const int n_t = gridDim.x, chunks = gridDim.y, n_m = (M + STM - 1) / STM;
  const int tid = threadIdx.x, sub = tid % NL, n = tile * STN + tid / NL;
  const bool valid = n < N;
  const float* tb = tgt + (size_t)b * M * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  const int lo = chunk * per_chunk, cnt = min(n_m, lo + per_chunk) - lo;
  const bool diagonal = diag && chunks == 1;
  const int start = diagonal ? (int)(((long long)tile * STN * stretch / STM) % n_m) : 0;
  const bool culled = lb != nullptr;
  if (culled) {   // the block's row of the table, read once
    const float* lrow = lb + ((size_t)b * n_t + tile) * n_m + lo;
    for (int t = tid; t < cnt; t += NT) lbs[t] = lrow[t];
    __syncthreads();
  }
  // a tile whose bound is above the gate's cull is skipped at every step
  const float gate_cull = cull_at(gate);
  auto phys = [&](int t) { return diagonal ? diag_tile(t, start, n_m) : lo + t; };
  auto next = [&](int t) {   // the first position >= t the gate leaves
    while (t < cnt && culled && lbs[phys(t) - lo] > gate_cull) ++t;
    return t;
  };
  float bd = CUDART_INF_F, worst = gate;
  int bi = 0, searched = 0, buf = 0;
  int pend = next(0);          // the position whose tile is in flight
  if (pend < cnt) {
    const int m0 = phys(pend) * STM;
    fetch_tile(raw[buf], tb, m0, min(STM, M - m0));
  }
  while (pend < cnt) {
    const int cur = pend, cb = buf, m0 = phys(cur) * STM, len = min(STM, M - m0);
    if (culled && lbs[phys(cur) - lo] > cull_at(worst)) {
      // culled by a worst that fell since it was fetched: drop it
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      pend = next(cur + 1);
      if (pend < cnt) {
        const int n0 = phys(pend) * STM;
        fetch_tile(raw[buf], tb, n0, min(STM, M - n0));
      }
      continue;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the tile is in; every thread is done with tp
    pend = next(cur + 1);
    buf ^= 1;
    if (pend < cnt) {
      const int n0 = phys(pend) * STM;
      fetch_tile(raw[buf], tb, n0, min(STM, M - n0));
    }
    tile_boxes(raw[cb], tp, box, len);
    __syncthreads();
    // this lane's points sub, sub + 4, ... in ascending order: the first
    // of equal distances stays. A warp skips a sub-tile where, for each of
    // its lanes, a lower bound of every distance the lane would compute
    // there (the squared gap to the box, less the rounding margin of
    // pair_tile_bounds) is above its best so far (clamped to the gate)
    float td = CUDART_INF_F;
    int tj = 0;
    for (int s = 0; s * SUBT < len; ++s) {
      const float low = box_low(box[s], qx, qy, qz, qq);
      if (__all_sync(FULL, !valid || low > cull_at(fminf(fminf(bd, td), gate))))
        continue;
      if ((s + 1) * SUBT <= len) {
#pragma unroll
        for (int jj = 0; jj < SUBT / NL; ++jj) {
          const int j = s * SUBT + sub + NL * jj;
          const float dd = dist_fma(qx, qy, qz, qq, tp[j]);
          if (dd < td) { td = dd; tj = j; }
        }
      } else {
        for (int j = s * SUBT + sub; j < len; j += NL) {
          const float dd = dist_fma(qx, qy, qz, qq, tp[j]);
          if (dd < td) { td = dd; tj = j; }
        }
      }
    }
    if (before(td, m0 + tj, bd, bi)) { bd = td; bi = m0 + tj; }
    ++searched;
    if (culled) {  // worst over the block's valid rows, for the cull
      float w = fminf(bd, __shfl_xor_sync(FULL, bd, 1));
      w = fminf(w, __shfl_xor_sync(FULL, w, 2));   // the row's best
      worst = fminf(block_worst(w, valid, red), gate);
    }
  }
  // the four lanes of a row: the pair minimum
#pragma unroll
  for (int o = 1; o < NL; o <<= 1) {
    const float od = __shfl_xor_sync(FULL, bd, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (before(od, oi, bd, bi)) { bd = od; bi = oi; }
  }
  if (visits != nullptr && tid == 0) atomicAdd(visits, searched);
  if (!valid || sub != 0) return;
  if (chunks == 1) {
    d_out[(size_t)b * N + n] = bd;
    i_out[(size_t)b * N + n] = bi;
  } else {
    pd[((size_t)b * chunks + chunk) * N + n] = bd;
    pi[((size_t)b * chunks + chunk) * N + n] = bi;
  }
}

// a warp a row: the pair minimum of its chunks' partials (the pair order
// makes it independent of the order of the reduction)
__global__ void __launch_bounds__(256)
nn1_merge_kernel(const float* __restrict__ pd, const int* __restrict__ pi,
                 float* __restrict__ d_out, long long* __restrict__ i_out,
                 int B, int N, int chunks) {
  const int idx = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= B * N) return;
  const int b = idx / N, n = idx % N;
  float bd = CUDART_INF_F;
  int bi = 0;
  for (int c = lane; c < chunks; c += 32) {
    const size_t at = ((size_t)b * chunks + c) * N + n;
    if (before(pd[at], pi[at], bd, bi)) { bd = pd[at]; bi = pi[at]; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(FULL, bd, o);
    const int oi = __shfl_xor_sync(FULL, bi, o);
    if (before(od, oi, bd, bi)) { bd = od; bi = oi; }
  }
  if (lane == 0) {
    d_out[idx] = bd;
    i_out[idx] = bi;
  }
}

// gate: max_dist_sq, or +inf for none (then the 1-NN is exact on every row).
// chunks and per_chunk: ops/cuda_stream.py:nn1_stream_plan; with more than
// one chunk pd and pi hold (B, chunks, N) partials. visits: null, or a
// counter the blocks add the tiles they searched to.
extern "C" int nn1_stream_launch(const float* src, const float* tgt,
                                 const float* lb, float* d, long long* idx,
                                 float* pd, int* pi, int* visits, int B, int N,
                                 int M, float gate, int diag, int stretch,
                                 int chunks, int per_chunk, void* stream_ptr) {
  if (check_args(B, N, M, 1) != cudaSuccess) return (int)cudaErrorInvalidValue;
  const int n_m = (M + STM - 1) / STM;
  if (chunks < 1 || per_chunk < 1 || (long long)chunks * per_chunk < n_m ||
      (chunks - 1) * per_chunk >= n_m || chunks > 65535 ||
      (chunks > 1 && (pd == nullptr || pi == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // the table row of a chunk in dynamic shared memory, beside 20.8 KB static
  const int lb_bytes = lb == nullptr ? 0 : per_chunk * (int)sizeof(float);
  cudaError_t err = cudaSuccess;
  if (lb_bytes > 16 * 1024) {
    err = cudaFuncSetAttribute(nn1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lb_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  nn1_kernel<<<dim3((N + STN - 1) / STN, chunks, B), NT, lb_bytes, stream>>>(
      src, tgt, lb, d, idx, pd, pi, visits, N, M, diag, stretch, gate, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  nn1_merge_kernel<<<(B * N + 7) / 8, 256, 0, stream>>>(pd, pi, d, idx, B, N,
                                                        chunks);
  return (int)cudaGetLastError();
}
