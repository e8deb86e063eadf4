// Nearest neighbour (1-NN) of 3-D points for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:nn1_pallas
// (_nn1_kernel), which keeps the whole target cloud on chip for M <= 4096.
//
// The launch is a plan of the wrapper's (ops/cuda_knn.py:nn1_plan, a pure
// function of the shape): LANES lanes a query (4, 8 or 16 adjacent threads
// of a warp), R queries a thread (1 or 2), NT / LANES x R queries a block.
// The grid is (query blocks, B). A block loads the target cloud once into
// shared memory as float4 (x, y, z, |t|^2) (64 KB at M = 4096). Lane l of a
// query takes the points l, l + LANES, ... in ascending order, in runs of BT:
// a run keeps only its least distance before the clamp (one min a pair,
// the work of a pair is the distance's seven operations and that min), and
// the first run whose least, clamped at 1e-12, is below the lane's best
// becomes the best; at the end the lane finds the first point of its best
// run at the best distance (the same arithmetic again). The LANES lanes
// merge by log2(LANES) shuffles on (distance, index) pairs. Every
// comparison is on the pair, so the first index among equal minima wins, as
// with an argmin, and a relaunch is bit-equal. Distances are dist_fma of
// knn_select.cuh (the fixed-order float32 form, clamped at 1e-12), so that
// the plain PyTorch version (ops/cuda_knn.py:nn1_reference) gives the same
// distance and index bit for bit. The target is never split across blocks:
// a split merged by a second launch measured slower between calls at every
// shape where the queries leave SMs idle.
//
// Bound: operations. Each (query, target) pair costs 8 flops of distance and
// one compare against 12 bytes read per point and 12 written per query.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_lanes.cuh"   // before, FULL, smem_cap_once
#include "knn_select.cuh"  // sq_norm3, dist_raw, dist_fma

#define NT 256     // threads a block
#define MAXM 4096  // the TPU kernel's envelope
#define BT 8       // points of a lane's run (one compare of the best a run)
// the (lanes a query, queries a thread) nn1_plan picks; X is a macro of one
// pair
#define NN1_PLANS(X) X(4, 2) X(8, 2) X(16, 2) X(16, 1)

// grid (query blocks of NT / LANES x R, B), NT threads, 16 bytes of dynamic
// shared memory a target point. A thread holds R queries, NT / LANES apart,
// so that each point it reads from shared memory serves R pairs.
template <int LANES, int R>
__global__ void __launch_bounds__(NT)
nn1_lanes_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 float* __restrict__ d_out, long long* __restrict__ i_out, int N,
                 int M) {
  extern __shared__ float4 tp[];   // the target's points
  constexpr int QG = NT / LANES;   // queries a block holds R of each
  const int b = blockIdx.y;
  const int tid = threadIdx.x, sub = tid % LANES;
  const int n0 = blockIdx.x * QG * R + tid / LANES;
  const float* tb = tgt + (size_t)b * M * 3;
  for (int m = tid; m < M; m += NT) {
    const float x = tb[3 * m], y = tb[3 * m + 1], z = tb[3 * m + 2];
    tp[m] = make_float4(x, y, z, sq_norm3(x, y, z));
  }
  float qx[R], qy[R], qz[R], qq[R], bd[R];
  int bs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r * QG;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (n < N) {
      const float* q = src + ((size_t)b * N + n) * 3;
      qx[r] = q[0]; qy[r] = q[1]; qz[r] = q[2];
    }
    qq[r] = sq_norm3(qx[r], qy[r], qz[r]);
    bd[r] = CUDART_INF_F;
    bs[r] = -1;
  }
  __syncthreads();
  // the lane's points are sub + LANES s, s = 0 .. np - 1; a run of BT of
  // them keeps only the least distance before the clamp (one min a pair),
  // and the first run whose least, clamped, is below bd becomes the best
  const int np = M > sub ? (M - sub + LANES - 1) / LANES : 0;
  const float4* lp = tp + sub;
  int s = 0;
  for (; s + BT <= np; s += BT) {
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      const float4 p = lp[(s + t) * LANES];
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] = fminf(m[r], dist_raw(qx[r], qy[r], qz[r], qq[r], p));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float c = fmaxf(m[r], 1e-12f);
      if (c < bd[r]) { bd[r] = c; bs[r] = s; }
    }
  }
  if (s < np) {   // the last, short run
    float m[R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = CUDART_INF_F;
    for (int t = s; t < np; ++t) {
      const float4 p = lp[t * LANES];
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] = fminf(m[r], dist_raw(qx[r], qy[r], qz[r], qq[r], p));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float c = fmaxf(m[r], 1e-12f);
      if (c < bd[r]) { bd[r] = c; bs[r] = s; }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // the first point of the best run at the best distance (the same
    // arithmetic again, so the same bits); a lane without a point keeps an
    // index past every point
    int j = sub;
    if (bs[r] >= 0) {
      for (int t = bs[r]; t < min(bs[r] + BT, np); ++t) {
        if (dist_fma(qx[r], qy[r], qz[r], qq[r], lp[t * LANES]) == bd[r]) {
          j = sub + t * LANES;
          break;
        }
      }
    }
    float d = bd[r];
    int i = j;
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) {
      const float od = __shfl_xor_sync(FULL, d, o);
      const int oi = __shfl_xor_sync(FULL, i, o);
      if (before(od, oi, d, i)) { d = od; i = oi; }
    }
    const int n = n0 + r * QG;
    if (n >= N || sub != 0) continue;
    d_out[(size_t)b * N + n] = d;
    i_out[(size_t)b * N + n] = i;
  }
}

template <int LANES, int R>
static cudaError_t launch(const float* src, const float* tgt, float* d, long long* idx,
                          int B, int N, int M, cudaStream_t stream) {
  static bool wide[MAX_DEVICES] = {};   // the attribute, for M <= MAXM
  const cudaError_t err = smem_cap_once(wide, (const void*)nn1_lanes_kernel<LANES, R>,
                                        MAXM * (int)sizeof(float4));
  if (err != cudaSuccess) return err;
  const int smem = M * (int)sizeof(float4);
  const int qb = NT / LANES * R;
  nn1_lanes_kernel<LANES, R><<<dim3((N + qb - 1) / qb, B), NT, smem, stream>>>(
      src, tgt, d, idx, N, M);
  return cudaGetLastError();
}

// lanes, rows (queries a thread): ops/cuda_knn.py:nn1_plan
extern "C" int nn1_launch(const float* src, const float* tgt, float* d, long long* idx,
                          int B, int N, int M, int lanes, int rows, void* stream_ptr) {
  if (M < 1 || M > MAXM || N < 1 || B < 1 || B > 65535 || (long long)B * N > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define CASE(L, RR) \
  if (lanes == L && rows == RR) return (int)launch<L, RR>(src, tgt, d, idx, B, N, M, stream);
  NN1_PLANS(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
