// Position-encoding angle features for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:posenc_angles_pallas
// (_angle_kernel): for every point p of a (B, N, 3) cloud, N <= 1024, and
// its k <= 32 nearest neighbours in ascending distance (ties to the lowest
// index, the point itself first), cos(angle(p -> neighbour, p -> centroid))
// from float32 coordinates, a coincident neighbour giving 0. Distances are
// the fixed-order float32 form of knn_select.cuh, so the plain version
// (ops/cuda_posenc.py:posenc_angles_reference) picks the same neighbours.
//
// Two selections, chosen by the wrapper's plan (ops/cuda_posenc.py:
// posenc_plan) before the launch:
//
//  * k <= 8 (pos_k is 5 in every preset): posenc_lanes_kernel<K, L>, sized
//    for a small k. L = 16 lanes (adjacent threads of a warp) share a
//    query, so that (24, 717) gives 1080 blocks of 256 threads where four
//    lanes and 64 queries a block gave 288. The block stages its cloud in
//    shared memory once, as (x, y, z, |t|^2), and sums the centroid there in
//    a fixed order (a thread's strided points, the warp tree, the warps in
//    order: the same in every block of a cloud), so no `mean` launch
//    precedes it. Lane l takes the points l, l + L, ... Two passes: (1)
//    each lane's nearest point; T, the k-th smallest of the L lanes' (k
//    distinct points lie at or below it), bounds the query's k-th distance;
//    (2) a lane appends its points at or below T to a buffer in shared
//    memory, and the warp then inserts the buffered points into the lanes'
//    sorted lists of K (distance, index) pairs in registers, one insertion
//    chain for each point of its busiest buffer; a warp one of whose
//    buffers overflowed scans again, draining before a buffer can fill
//    (inserting every point as it comes took 0.044 ms, every lane of a warp
//    waiting on the lane that inserted). The L lists merge in k rounds of a
//    shuffle butterfly over the L lanes, each round taking the least
//    (distance, index) head, which its lane pops; round r's winner stays
//    with lane r (K <= L), so lanes 0 .. k - 1 write the query's k angles
//    side by side.
//  * 8 < k <= 32: the dense selection the kNN and DGCNN kernels share
//    (knn_lanes.cuh:knn_kernel<K, GraphOut>, four lanes a query, a threshold
//    from sub-tile minima, buffered insertion, a merge by rank), with its
//    centroid summed in the kernel (GraphOut with no centroid given).
//
// Bound: operations. Per query N distances (8 flops each) and about one
// compare a candidate, against 12 bytes read and 4 k bytes written per
// point: 0.00166 ms at (24, 717, k = 5) on an H100. What bounds the lanes
// kernel: its two scans of the 45 points a lane (each about what the whole
// 1-NN kernel of nn1.cu takes), then the buffered insertions.
#include <cuda_runtime.h>

#include "knn_lanes.cuh"   // before, insert, lanes_init, knn_launch_k, GraphOut
#include "knn_select.cuh"  // dist_fma, sq_norm3, MAXN

// compiled list lengths of the lanes kernel and lanes a query (16 beat 8 on
// an H100: 0.0291 against 0.0341 ms at (24, 717, 5)); the wrapper takes the
// smallest K at or above k (ops/cuda_posenc.py mirrors both)
#define POSENC_LANES_KS(X) X(1) X(2) X(5) X(8)
#define POSENC_LANES 16
// compiled K of the shared selection for 8 < k <= 32 (the kNN kernel's)
#define POSENC_SHARED_KS(X) X(20) X(32)
#define PT 256             // threads a block of the lanes kernel

#define PCAP 12            // entries of a lane's candidate buffer
#define PSTEP 4            // a lane's points between two checks of its buffer

__host__ __device__ constexpr int lanes_smem(int N) { return N * 16 + PCAP * PT * 4; }

// grid (ceil(N / (PT / L)), B), PT threads, lanes_smem(N) bytes of dynamic
// shared memory
template <int K, int L>
__global__ void __launch_bounds__(PT)
posenc_lanes_kernel(const float* __restrict__ x, float* __restrict__ alpha,
                    int* __restrict__ idx, int N, int kout) {
  static_assert(K <= L && 32 % L == 0, "a round's winner stays with one lane");
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ float red[3][PT / 32];
  float4* tp = reinterpret_cast<float4*>(dsm);   // [N]
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % L;
  const int n = blockIdx.x * (PT / L) + tid / L;
  const bool valid = n < N;
  const float* xb = x + (size_t)b * N * 3;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int m = tid; m < N; m += PT) {
    const float px = xb[3 * m], py = xb[3 * m + 1], pz = xb[3 * m + 2];
    tp[m] = make_float4(px, py, pz, sq_norm3(px, py, pz));
    ax += px; ay += py; az += pz;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ax += __shfl_xor_sync(FULL, ax, o);
    ay += __shfl_xor_sync(FULL, ay, o);
    az += __shfl_xor_sync(FULL, az, o);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = ax; red[1][tid >> 5] = ay; red[2][tid >> 5] = az;
  }
  __syncthreads();
  const float4 qp = valid ? tp[n] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float qx = qp.x, qy = qp.y, qz = qp.z, qq = qp.w;
  // 1. each lane's nearest point; T, the kout-th smallest of the L lanes'
  //    (kout distinct points at or below it), bounds the query's kout-th
  //    distance
  float mn = CUDART_INF_F;
#pragma unroll 4
  for (int m = lane; m < N; m += L) mn = fminf(mn, dist_raw(qx, qy, qz, qq, tp[m]));
  const int first = (tid & 31) - lane;           // the query's first lane in the warp
  int rank = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float v = __shfl_sync(FULL, mn, first + j);
    rank += v < mn || (v == mn && j < lane);
  }
  const unsigned at = __ballot_sync(FULL, rank == kout - 1) >> first;
  const float t = __shfl_sync(FULL, mn, first + __ffs(at & ((1u << L) - 1u)) - 1);
  const float thr = valid ? fmaxf(t, 1e-12f) : -CUDART_INF_F;   // past N: none
  // 2. the points at or below T into the lane's buffer, and from there into
  //    its sorted list of K (the warp runs one insertion chain for each
  //    point of its busiest buffer). A buffer holds PCAP; where one
  //    overflowed (more than PCAP of a lane's points at or below T: many
  //    coincident points), its warp scans again and drains a buffer before
  //    it can fill.
  float kd[K];
  int ki[K];
  lanes_init<K>(kd, ki);
  int* buf = reinterpret_cast<int*>(tp + N) + tid;   // [PCAP][PT], the lane's column
  int cnt = 0;
  auto drain = [&]() {
    while (__any_sync(FULL, cnt > 0)) {
      if (cnt > 0) {
        const int m = buf[--cnt * PT];
        insert<K>(kd, ki, dist_fma(qx, qy, qz, qq, tp[m]), m);
      }
    }
  };
#pragma unroll 4
  for (int m = lane; m < N; m += L) {
    if (dist_raw(qx, qy, qz, qq, tp[m]) <= thr) {
      if (cnt < PCAP) buf[cnt * PT] = m;
      ++cnt;
    }
  }
  if (__any_sync(FULL, cnt > PCAP)) {
    cnt = 0;
    for (int m0 = 0; m0 < N; m0 += PSTEP * L) {    // the same trips in every lane
      if (__any_sync(FULL, cnt > PCAP - PSTEP)) drain();
#pragma unroll
      for (int s = 0; s < PSTEP; ++s) {
        const int m = m0 + s * L + lane;
        if (m < N && dist_raw(qx, qy, qz, qq, tp[m]) <= thr) buf[cnt++ * PT] = m;
      }
    }
  }
  drain();
  // 3. kout rounds: the least head of the query's L lists; lane r keeps
  //    round r's
  int mine = INT_MAX;
  for (int r = 0; r < kout; ++r) {
    float d = kd[0];
    int i = ki[0];
#pragma unroll
    for (int o = 1; o < L; o <<= 1) {
      const float od = __shfl_xor_sync(FULL, d, o);
      const int oi = __shfl_xor_sync(FULL, i, o);
      if (before(od, oi, d, i)) { d = od; i = oi; }
    }
    if (ki[0] == i) {                 // this lane's head won: pop it
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) { kd[s] = kd[s + 1]; ki[s] = ki[s + 1]; }
      kd[K - 1] = CUDART_INF_F;
      ki[K - 1] = INT_MAX;
    }
    if (lane == r) mine = i;
  }
  if (!valid || lane >= kout) return;
  // the unit direction to the centroid, then the angle of neighbour `mine`
  float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll
  for (int w = 0; w < PT / 32; ++w) {
    cx += red[0][w]; cy += red[1][w]; cz += red[2][w];
  }
  cx /= (float)N; cy /= (float)N; cz /= (float)N;
  float gx = qx - cx, gy = qy - cy, gz = qz - cz;
  const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
  gx /= gn; gy /= gn; gz /= gn;
  const float4 p = tp[mine];
  float lx = p.x - qx, ly = p.y - qy, lz = p.z - qz;
  const float ln = fmaxf(sqrtf(lx * lx + ly * ly + lz * lz), 1e-12f);
  lx /= ln; ly /= ln; lz /= ln;
  const size_t row = (size_t)b * N + n;
  alpha[row * kout + lane] = lx * gx + ly * gy + lz * gz;
  if (idx != nullptr) idx[row * kout + lane] = mine;
}

template <int K, int L>
static cudaError_t lanes_launch(const float* x, float* alpha, int* idx, int B, int N,
                                int k, cudaStream_t stream) {
  constexpr int Q = PT / L;
  posenc_lanes_kernel<K, L><<<dim3((N + Q - 1) / Q, B), PT, lanes_smem(N), stream>>>(
      x, alpha, idx, N, k);
  return cudaGetLastError();
}

// x (B, N, 3) float32 -> alpha (B, N, k); idx: null (the main path), or
// (B, N, k) int32 the neighbours are written to. lanes == NL (4): the shared
// selection at its compiled K; POSENC_LANES: the lanes kernel at K.
extern "C" int posenc_angles_launch(const float* x, float* alpha, int* idx, int B,
                                    int N, int k, int K, int lanes,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || k < 1 || k > N || K < k || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (lanes == NL) {
    const GraphOut out{idx, alpha, nullptr, k};
#define CASE(KK) \
    if (K == KK) return (int)knn_launch_k<KK>(x, x, out, B, N, N, k, stream);
    POSENC_SHARED_KS(CASE)
#undef CASE
    return (int)cudaErrorInvalidValue;
  }
#define CASE_K(KK) \
  if (K == KK && lanes == POSENC_LANES) \
    return (int)lanes_launch<KK, POSENC_LANES>(x, alpha, idx, B, N, k, stream);
  POSENC_LANES_KS(CASE_K)
#undef CASE_K
  return (int)cudaErrorInvalidValue;
}
