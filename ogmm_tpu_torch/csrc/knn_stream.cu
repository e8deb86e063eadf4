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
//    being the largest running k-th distance of the tile's valid rows; a
//    skipped tile holds no candidate that could enter any list.
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
// kNN (stream_kernel<K>): one block owns a query tile of STN = 64 points,
// one thread a query; the target streams through shared memory in tiles of
// STM = 512 points (coordinates and |t|^2 as one float4 a point); each
// thread keeps its running top-k as a list sorted by (distance, index) in
// registers and inserts a candidate with an unrolled compare-and-swap chain.
// It keeps the 1-NN output (d_out) and gate of its earlier form, which
// knn_stream_launch passes as null and +inf, so that its code, and its time,
// stay as they were measured.
//
// 1-NN (nn1_kernel): a design of its own that fills the card. The block is
// still one row of the cull table (64 queries; the table's grid is the
// contract), but NL = 4 lanes share a query, each taking every fourth point
// of a tile (a warp: 8 queries), so the ICP trip's 547 blocks of 256
// threads (48 registers, 32 bytes spilled: five an SM) fill 132 SMs in one
// wave (four an SM, without the spill, measured the same). Each lane
// keeps its best (d, i) over its points (strict < inside a tile, whose
// points it visits in ascending order, the pair order across tiles); the
// four lanes merge by shuffles at the end. The raw coordinates of the next
// candidate tile are in flight (cp.async into the other half of a double
// buffer) while the current one is searched; one pass turns a tile into
// (x, y, z, |t|^2) and the box of each 64-point sub-tile (a warp each). A
// warp skips a sub-tile where every lane's lower bound of the distances it
// would compute there (the squared gap to the box less pair_tile_bounds'
// rounding margin) is above the lane's best so far, clamped to the gate:
// the block-level table decides which 512-point tiles are fetched, the
// boxes which 64 points each warp of 8 Morton-adjacent queries searches.
// The block reads its row of the table into shared memory once: the scan
// for the next tile the gate leaves was a chain of dependent global loads.
// Where the query tiles alone cannot fill the card (the clustering's 2 x 16
// queries against 35,000 points), the grid also splits the target tiles
// into chunks (ops/cuda_stream.py:nn1_stream_plan); each chunk writes its
// rows' partial (d, i), and a second launch takes the pair minimum over the
// chunks, a warp a row (exact: the pair order makes it independent of the
// order of the reduction and of the blocks). An optional counter adds up
// the target tiles the blocks searched (null on the main path).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): the ICP trip at
// (1, 35000, 35000) with cull and gate 0.195 ms a call (0.192 on the
// device), searching 19.8% of the tile pairs where the search needs 15.6%;
// the clustering's (2, 16, 35000) 0.0075 ms on the device, 0.044-0.053 ms
// between back-to-back calls (the wrapper's host work).
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include "knn_select.cuh"  // sq_norm3, sq_dist3

#define STN 64     // queries (= threads) of a block
#define STM 512    // target points of a shared-memory tile
#define MAXK 32

__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// the t-th target tile of the diagonal-first order from `start`
__device__ __forceinline__ int diag_tile(int t, int start, int n_m) {
  const int off = ((t + 1) / 2) * (1 - 2 * (t % 2));
  return ((start + off) % n_m + n_m) % n_m;
}

// a tile whose bound is above this may be skipped: worst with a margin
__device__ __forceinline__ float cull_at(float worst) {
  return worst * (1.0f + 1e-6f) + 1e-6f;
}

template <int K>
__global__ void __launch_bounds__(STN)
stream_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const float* __restrict__ lb, long long* __restrict__ idx_out,
              float* __restrict__ d_out, int N, int M, int diag, int stretch,
              float gate) {
  __shared__ float4 tp[STM];
  __shared__ float red[STN / 32];
  const int b = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  const int n = tile * STN + tid;
  const int n_t = gridDim.x, n_m = (M + STM - 1) / STM;
  const bool valid = n < N;
  const float* tb = tgt + (size_t)b * M * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (valid) {
    const float* q = src + ((size_t)b * N + n) * 3;
    qx = q[0]; qy = q[1]; qz = q[2];
  }
  const float qq = sq_norm3(qx, qy, qz);
  float kd[K];
  int ki[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { kd[s] = CUDART_INF_F; ki[s] = 0; }
  const int start = diag ? (int)(((long long)tile * STN * stretch / STM) % n_m) : 0;
  float worst = gate;  // every running k-th distance is inf at first
  for (int t = 0; t < n_m; ++t) {
    int phys = t;
    if (diag) {
      const int off = ((t + 1) / 2) * (1 - 2 * (t % 2));
      phys = ((start + off) % n_m + n_m) % n_m;
    }
    if (lb != nullptr &&
        lb[((size_t)b * n_t + tile) * n_m + phys] > worst * (1.0f + 1e-6f) + 1e-6f)
      continue;  // the same decision in every thread of the block
    const int m0 = phys * STM, len = min(STM, M - m0);
    __syncthreads();
    for (int m = tid; m < len; m += STN) {
      const float* p = tb + 3 * (size_t)(m0 + m);
      tp[m] = make_float4(p[0], p[1], p[2], sq_norm3(p[0], p[1], p[2]));
    }
    __syncthreads();
    if (valid) {
      for (int m = 0; m < len; ++m) {
        const float4 p = tp[m];
        float cd = sq_dist3(qx, qy, qz, qq, p.x, p.y, p.z, p.w);
        int ci = m0 + m;
        if (before(cd, ci, kd[K - 1], ki[K - 1])) {
#pragma unroll
          for (int s = 0; s < K; ++s) {
            if (before(cd, ci, kd[s], ki[s])) {
              const float td = kd[s]; const int ti = ki[s];
              kd[s] = cd; ki[s] = ci; cd = td; ci = ti;
            }
          }
        }
      }
    }
    if (lb != nullptr) {  // worst over the tile's valid rows, for the cull
      float w = valid ? kd[K - 1] : -CUDART_INF_F;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
      if ((tid & 31) == 0) red[tid >> 5] = w;
      __syncthreads();
      w = red[0];
#pragma unroll
      for (int i = 1; i < STN / 32; ++i) w = fmaxf(w, red[i]);
      worst = fminf(w, gate);
    }
  }
  if (!valid) return;
  const size_t row = (size_t)b * N + n;
  if (d_out != nullptr) {
    d_out[row] = kd[0];
    idx_out[row] = ki[0];
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) idx_out[row * K + s] = ki[s];
  }
}

static cudaError_t check_args(int B, int N, int M, int k) {
  if (B < 1 || N < 1 || M < k || k < 1 || k > MAXK) return cudaErrorInvalidValue;
  return cudaSuccess;
}

extern "C" int knn_stream_launch(const float* src, const float* tgt,
                                 const float* lb, long long* idx, int B, int N,
                                 int M, int k, int diag, int stretch,
                                 void* stream_ptr) {
  if (check_args(B, N, M, k) != cudaSuccess) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + STN - 1) / STN, B);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (k) {
#define CASE(K)                                                                \
  case K:                                                                      \
    stream_kernel<K><<<grid, STN, 0, stream>>>(src, tgt, lb, idx, nullptr, N, \
                                               M, diag, stretch, INFINITY);     \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    CASE(17) CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24)
    CASE(25) CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ 1-NN

#define NL 4              // lanes a query
#define NT (STN * NL)     // threads of a 1-NN block
#define SUBT 64           // points of a sub-tile: one warp makes its box

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

// the raw coordinates of target points [m0, m0 + len) into buf, in flight
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

// sq_dist3 with its last two steps as one fma: 2 inner is exact, so
// fma(-2, inner, qq + tt) rounds once as (qq + tt) - 2 inner does
__device__ __forceinline__ float dist_fma(float qx, float qy, float qz, float qq,
                                          float4 p) {
  const float inner = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                __fmul_rn(qz, p.z));
  return fmaxf(fmaf(-2.0f, inner, __fadd_rn(qq, p.w)), 1e-12f);
}

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
    {  // warp w: points 64 w .. 64 w + 63 to (x, y, z, |t|^2), and their box
      const int w = tid / 32, lane = tid % 32;
      float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
      float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F}, tt = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = w * SUBT + h * 32 + lane;
        if (m < len) {
          const float x = raw[cb][3 * m], y = raw[cb][3 * m + 1], z = raw[cb][3 * m + 2];
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
          lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], o));
          hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], o));
        }
        tt = fmaxf(tt, __shfl_xor_sync(0xffffffffu, tt, o));
      }
      if (lane == 0) {
        box[w][0] = lo[0]; box[w][1] = lo[1]; box[w][2] = lo[2];
        box[w][3] = hi[0]; box[w][4] = hi[1]; box[w][5] = hi[2]; box[w][6] = tt;
      }
    }
    __syncthreads();
    // this lane's points sub, sub + 4, ... in ascending order: the first
    // of equal distances stays. A warp skips a sub-tile where, for each of
    // its lanes, a lower bound of every distance the lane would compute
    // there (the squared gap to the box, less the rounding margin of
    // pair_tile_bounds) is above its best so far (clamped to the gate)
    float td = CUDART_INF_F;
    int tj = 0;
    for (int s = 0; s * SUBT < len; ++s) {
      const float* bx = box[s];
      const float gx = fmaxf(fmaxf(bx[0] - qx, qx - bx[3]), 0.f);
      const float gy = fmaxf(fmaxf(bx[1] - qy, qy - bx[4]), 0.f);
      const float gz = fmaxf(fmaxf(bx[2] - qz, qz - bx[5]), 0.f);
      const float low = (gx * gx + gy * gy + gz * gz) * (1.0f - 1e-6f)
                        - 1e-5f * (1.0f + qq + bx[6]);
      if (__all_sync(0xffffffffu, !valid || low > cull_at(fminf(fminf(bd, td), gate))))
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
      float w = fminf(bd, __shfl_xor_sync(0xffffffffu, bd, 1));
      w = fminf(w, __shfl_xor_sync(0xffffffffu, w, 2));   // the row's best
      if (!valid) w = -CUDART_INF_F;
#pragma unroll
      for (int o = 16; o >= NL; o >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
      if ((tid & 31) == 0) red[tid >> 5] = w;
      __syncthreads();
      w = red[0];
#pragma unroll
      for (int i = 1; i < NT / 32; ++i) w = fmaxf(w, red[i]);
      worst = fminf(w, gate);
    }
  }
  // the four lanes of a row: the pair minimum
#pragma unroll
  for (int o = 1; o < NL; o <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
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
    const float od = __shfl_xor_sync(0xffffffffu, bd, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
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
