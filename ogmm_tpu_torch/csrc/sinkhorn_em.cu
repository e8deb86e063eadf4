// Overlap-weighted Sinkhorn-EM clustering for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_em.py:sinkhorn_em (_em_kernel,
// the mxu_lse schedule). One launch runs all EM trips of all clouds; the
// (N, K) transport plan never reaches device memory until the last trip's
// gamma is written. K is any cluster count up to 128, padded to KP = 32 KPL
// columns; the padding holds no mass (cost +inf, plan 0) and is never
// written out.
//
// One (717, 128) float32 plan is 367 KB, more than one SM's shared memory,
// so a thread block cluster of 8 blocks owns one cloud: each block keeps a
// slab of ceil(N/8) rows of the plan in its shared memory for the whole
// nested loop. A warp takes 4 rows at a time, 8 lanes a row; a lane holds
// KPL chunks of 4 columns of its row, at columns 4 (lane % 8 + 8 j), so the
// slab is read and written 16 bytes a lane without bank conflicts, and a row
// sum or maximum is the lane's own 4 KPL values and three shuffle steps.
// Column sums are taken per lane in registers, added over the warp's row
// groups by two shuffle steps, over the block's warps in warp order, and
// over the cluster through distributed shared memory in rank order, so
// every block of a cluster holds the same column sums and the same nodes,
// and the result does not change from run to run. The M-step's sums are
// taken by one thread a column over the gamma rows the pass leaves in the
// slab, in row order.
//
// Per EM trip (as the TPU kernel): cost = sqrt(max(d2, 1e-12)) / tau;
// Sinkhorn trip 1 in the log domain (stabilised row update u, column update
// v with a 1e-38 floor); trips 2..sk_iters in the direct domain (P scaled to
// the row marginal p = overlap + 1e-8, then to the column marginal
// q = 1/K + 1e-8, sums floored at 1e-38); gamma = P with non-finite -> 0,
// rows divided by max(row sum, 1e-3); M-step pi = sum gamma / N, nodes =
// gamma^T xyz / (pi N + 1e-5). A column scaling is applied when the next
// pass reads the plan, which gives the same values as scaling in place.
// Divisions by eps and tau, and by a gamma row's sum, are products with the
// reciprocal (about 1e-6 relative from the plain version's divisions).
//
// Bound: neither bytes nor operations but latency: sk_iters + 1 dependent
// passes per trip, each ended by a cluster barrier (~0.4-0.9 us on an H100)
// and a read of the other blocks' sums (~0.4 us). The design works on that
// latency:
//  - all clouds in one wave: a block has 4 warps and 55,920 B of shared
//    memory at N = 717, K = 128, so 4 blocks share an SM (3 of the earlier
//    8-warp, 73 KB blocks did), and the occupancy calculator
//    (sinkhorn_em_max_clusters) counts 62 clusters of 8 at once on an H100;
//  - few instructions a row: per 4 rows a lane issues its 4 KPL products
//    and sums, 3 shuffle steps and one division, and two row quads are in
//    flight a warp;
//  - no division by a row's sum in the gamma pass, whose entries may be
//    subnormal: the IEEE division's slow path for those cost ~70 us a trip;
//  - a block's column sums are added before the cluster barrier, so a
//    thread reads 8 remote values, not 32.
// The slab must fit in shared memory (launch below): N <= 3,352 at K = 128,
// N <= 12,128 at K <= 32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

#define CL 8          // blocks per cluster = per cloud
#define NW 4          // warps per block
#define NT (NW * 32)
#define QF 2          // row quads in flight a warp
#define RS 6          // floats a row keeps beside the slab: x, y, z, p, log p, u
#define FULL 0xffffffffu

// the shared memory of a block, in floats: the slab, RS floats a row, the
// nodes (x, y, z, |node|^2), the warps' column sums of a pass (NW column
// vectors), the block's column sums (two alternating vectors), its M-step
// sums (four vectors) and the column factors
__host__ __device__ constexpr size_t em_smem_floats(int rows_per, int kp) {
  return (size_t)rows_per * kp + ((RS * rows_per + 3) & ~3) +
         (4 + NW + 2 + 4 + 1) * (size_t)kp;
}

// the sum (or max) over the 8 lanes of a row
template <bool MAX>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// this lane's 4 KPL entries of slab row i, at columns 4 (lane % 8 + 8 j) + e
template <int KPL>
__device__ __forceinline__ void load_row(const float* P, int i, float (&v)[4 * KPL]) {
  constexpr int K = KPL * 32;
  const int cg = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(P + i * K + 4 * (cg + 8 * j));
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
  }
}

template <int KPL>
__device__ __forceinline__ void store_row(float* P, int i, const float (&v)[4 * KPL]) {
  constexpr int K = KPL * 32;
  const int cg = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    *reinterpret_cast<float4*>(P + i * K + 4 * (cg + 8 * j)) =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

// The end of a pass: this lane's column sums over its rows are added over
// the warp's 4 row groups (lanes 8 apart) into the warp's sums wsum[warp];
// a thread a column adds the NW warps' sums in warp order into the block's
// sum part[c]; after the cluster barrier it adds the parts of the cluster's
// blocks in rank order (all 8 remote loads issued first) and stores
// colf[c] = fn(cloud-wide sum of column c). Every block gets the same bits.
template <int KPL, class Fn>
__device__ __forceinline__ void reduce_cols(cg::cluster_group& cluster,
                                            float (&colacc)[4 * KPL], float* wsum,
                                            float* part, float* colf, Fn fn) {
  constexpr int K = KPL * 32;
  const int tid = threadIdx.x, warp = tid >> 5;
#pragma unroll
  for (int e = 0; e < 4 * KPL; ++e) {
    colacc[e] += __shfl_xor_sync(FULL, colacc[e], 8);
    colacc[e] += __shfl_xor_sync(FULL, colacc[e], 16);
  }
  if ((tid & 31) < 8) store_row<KPL>(wsum, warp, colacc);
  __syncthreads();
  for (int c = tid; c < K; c += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += wsum[w * K + c];
    part[c] = s;
  }
  cluster.sync();
  for (int c = tid; c < K; c += NT) {
    float v[CL];
#pragma unroll
    for (int r = 0; r < CL; ++r) v[r] = cluster.map_shared_rank(part, r)[c];
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) s += v[r];
    colf[c] = fn(s);
  }
  __syncthreads();
}

template <int KPL>
__device__ __forceinline__ void load_factors(const float* colf, float (&cs)[4 * KPL]) {
  const int cg = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(colf + 4 * (cg + 8 * j));
    cs[4 * j] = f.x; cs[4 * j + 1] = f.y; cs[4 * j + 2] = f.z; cs[4 * j + 3] = f.w;
  }
}

// the plan entries of a row from the slab and the column factors: in the
// first direct pass (and a gamma pass straight after the log-domain trip)
// exp(((u - cost) + v) / eps) from the cost and v, else the plan times the
// last pass's column scaling
template <int KPL>
__device__ __forceinline__ void plan_row(const float* P, const float* srow, int i,
                                         bool first, const float (&cs)[4 * KPL],
                                         float inv_eps, float (&v)[4 * KPL]) {
  load_row<KPL>(P, i, v);
  if (first) {
    const float u = srow[i * RS + 5];
#pragma unroll
    for (int e = 0; e < 4 * KPL; ++e) v[e] = expf(((-v[e] + u) + cs[e]) * inv_eps);
  } else {
#pragma unroll
    for (int e = 0; e < 4 * KPL; ++e) v[e] *= cs[e];
  }
}

template <int KPL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 4)
em_kernel(const float* __restrict__ xyz, const float* __restrict__ o,
          const float* __restrict__ nodes0, float* __restrict__ gamma_out,
          float* __restrict__ pi_out, float* __restrict__ nodes_out, int N,
          int nk, int iters, int sk_iters, float tau, float eps, float q_t,
          float log_q) {
  constexpr int K = KPL * 32;            // padded columns; nk of them real
  constexpr int V = 4 * KPL;             // entries of a row a lane holds
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, warp = tid >> 5, lr = (tid & 31) >> 3, cg8 = tid & 7;
  const int rows_per = (N + CL - 1) / CL;
  const int r0 = rank * rows_per;
  const int nrows = max(0, min(N, r0 + rows_per) - r0);
  const float inv_eps = 1.0f / eps, inv_tau = 1.0f / tau;

  extern __shared__ __align__(16) float smem[];
  float* P = smem;                       // slab: cost, then the plan, then gamma
  float* srow = P + (size_t)rows_per * K;   // rows_per x RS
  float4* snodes = reinterpret_cast<float4*>(srow + ((RS * rows_per + 3) & ~3));
  float* wsum = reinterpret_cast<float*>(snodes + K);   // NW x K
  float* part = wsum + NW * K;           // 2 x K, read by the cluster
  float* G = part + 2 * K;               // 4 x K, read by the cluster
  float* colf = G + 4 * K;               // the column factors of the last pass

  for (int i = tid; i < nrows; i += NT) {
    const size_t row = (size_t)b * N + r0 + i;
    float* s = srow + i * RS;
    s[0] = xyz[row * 3]; s[1] = xyz[row * 3 + 1]; s[2] = xyz[row * 3 + 2];
    const float pv = o[row] + 1e-8f;
    s[3] = pv;
    s[4] = logf(pv);
  }
  for (int k = tid; k < K; k += NT) {
    float x = 0.f, y = 0.f, z = 0.f;
    if (k < nk) {
      const float* p = nodes0 + ((size_t)b * nk + k) * 3;
      x = p[0]; y = p[1]; z = p[2];
    }
    snodes[k] = make_float4(x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                               __fmul_rn(z, z)));
  }
  __syncthreads();

  // this warp's row quads are warp + NW m; row i = 4 quad + lr. Rows past
  // the slab compute on row 0 and store nothing
  const int nq = (nrows + 3) / 4;
  const int nqw = nq > warp ? (nq - warp + NW - 1) / NW : 0;
  int npass = 0;
  float cs[V], colacc[V];
  for (int it = 0; it < iters; ++it) {
    const bool last = (it == iters - 1);

    // ---- cost, and Sinkhorn trip 1 in the log domain ----------------------
#pragma unroll
    for (int e = 0; e < V; ++e) colacc[e] = 0.f;
    for (int m0 = 0; m0 < nqw; m0 += QF) {
      float cst[QF][V], mx[QF], s[QF];
      int row[QF];
      bool ok[QF];
#pragma unroll
      for (int f = 0; f < QF; ++f) {
        row[f] = 4 * (warp + NW * (m0 + f)) + lr;
        ok[f] = m0 + f < nqw && row[f] < nrows;
        const int i = ok[f] ? row[f] : 0;
        const float x = srow[i * RS], y = srow[i * RS + 1], z = srow[i * RS + 2];
        const float xsq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                    __fmul_rn(z, z));
        mx[f] = -CUDART_INF_F;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int k = 4 * (cg8 + 8 * (e / 4)) + e % 4;
          const float4 nd = snodes[k];
          const float inner = __fadd_rn(__fadd_rn(__fmul_rn(x, nd.x), __fmul_rn(y, nd.y)),
                                        __fmul_rn(z, nd.z));
          const float d2 = fmaxf(__fsub_rn(__fadd_rn(xsq, nd.w), __fmul_rn(2.0f, inner)),
                                 1e-12f);
          cst[f][e] = k < nk ? sqrtf(d2) * inv_tau : CUDART_INF_F;   // padding: no mass
          mx[f] = fmaxf(mx[f], -cst[f][e] * inv_eps);
        }
      }
#pragma unroll
      for (int f = 0; f < QF; ++f) mx[f] = row_reduce<true>(mx[f]);
#pragma unroll
      for (int f = 0; f < QF; ++f) {
        s[f] = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) s[f] += expf(-cst[f][e] * inv_eps - mx[f]);
      }
#pragma unroll
      for (int f = 0; f < QF; ++f) s[f] = row_reduce<false>(s[f]);
#pragma unroll
      for (int f = 0; f < QF; ++f) {
        if (!ok[f]) continue;
        const float u = eps * (srow[row[f] * RS + 4] - (mx[f] + logf(s[f])));
        if (cg8 == 0) srow[row[f] * RS + 5] = u;
#pragma unroll
        for (int e = 0; e < V; ++e) colacc[e] += expf((-cst[f][e] + u) * inv_eps);
        store_row<KPL>(P, row[f], cst[f]);
      }
    }
    reduce_cols<KPL>(cluster, colacc, wsum, part + (npass++ & 1) * K, colf,
                     [&](float s) { return eps * (log_q - logf(s + 1e-38f)); });
    load_factors<KPL>(colf, cs);         // v: the first pass below reads cost

    // ---- Sinkhorn trips 2.. in the direct domain --------------------------
    for (int t = 1; t < sk_iters; ++t) {
#pragma unroll
      for (int e = 0; e < V; ++e) colacc[e] = 0.f;
      for (int m0 = 0; m0 < nqw; m0 += QF) {
        float val[QF][V], s[QF];
        int row[QF];
        bool ok[QF];
#pragma unroll
        for (int f = 0; f < QF; ++f) {
          row[f] = 4 * (warp + NW * (m0 + f)) + lr;
          ok[f] = m0 + f < nqw && row[f] < nrows;
          plan_row<KPL>(P, srow, ok[f] ? row[f] : 0, t == 1, cs, inv_eps, val[f]);
          s[f] = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) s[f] += val[f][e];
        }
#pragma unroll
        for (int f = 0; f < QF; ++f) s[f] = row_reduce<false>(s[f]);
#pragma unroll
        for (int f = 0; f < QF; ++f) {
          if (!ok[f]) continue;
          const float rs = srow[row[f] * RS + 3] / fmaxf(s[f], 1e-38f);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            val[f][e] *= rs;
            colacc[e] += val[f][e];
          }
          store_row<KPL>(P, row[f], val[f]);
        }
      }
      reduce_cols<KPL>(cluster, colacc, wsum, part + (npass++ & 1) * K, colf,
                       [&](float s) { return q_t / fmaxf(s, 1e-38f); });
      load_factors<KPL>(colf, cs);
    }

    // ---- gamma and the M-step sums ----------------------------------------
    for (int m0 = 0; m0 < nqw; m0 += QF) {
      float val[QF][V], s[QF];
      int row[QF];
      bool ok[QF];
#pragma unroll
      for (int f = 0; f < QF; ++f) {
        row[f] = 4 * (warp + NW * (m0 + f)) + lr;
        ok[f] = m0 + f < nqw && row[f] < nrows;
        plan_row<KPL>(P, srow, ok[f] ? row[f] : 0, sk_iters == 1, cs, inv_eps, val[f]);
        s[f] = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (!isfinite(val[f][e])) val[f][e] = 0.f;
          s[f] += val[f][e];
        }
      }
#pragma unroll
      for (int f = 0; f < QF; ++f) s[f] = row_reduce<false>(s[f]);
#pragma unroll
      for (int f = 0; f < QF; ++f) {
        if (!ok[f]) continue;
        const float rden = 1.0f / fmaxf(s[f], 1e-3f);
#pragma unroll
        for (int e = 0; e < V; ++e) val[f][e] *= rden;
        store_row<KPL>(P, row[f], val[f]);
      }
    }
    __syncthreads();
    // gamma is in the slab: a thread a column sums gamma, gamma x, gamma y,
    // gamma z over the block's rows in row order (and writes the last
    // trip's gamma, a row of threads on a row of gamma_out)
    for (int c = tid; c < K; c += NT) {
      float sg = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll 4
      for (int i = 0; i < nrows; ++i) {
        const float g = P[i * K + c];
        sg += g;
        sx += g * srow[i * RS];
        sy += g * srow[i * RS + 1];
        sz += g * srow[i * RS + 2];
        if (last && c < nk) gamma_out[((size_t)b * N + r0 + i) * nk + c] = g;
      }
      G[c] = sg; G[K + c] = sx; G[2 * K + c] = sy; G[3 * K + c] = sz;
    }
    cluster.sync();
    for (int k = tid; k < nk; k += NT) {
      float v[CL][4], sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < CL; ++r) {
        const float* g = cluster.map_shared_rank(G, r);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[r][q] = g[q * K + k];
      }
#pragma unroll
      for (int r = 0; r < CL; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[q] += v[r][q];
      const float pi = sum[0] / (float)N;
      const float npi = pi * (float)N + 1e-5f;
      const float x = sum[1] / npi, y = sum[2] / npi, z = sum[3] / npi;
      snodes[k] = make_float4(x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                                 __fmul_rn(z, z)));
      if (last && rank == 0) {
        pi_out[(size_t)b * nk + k] = pi;
        float* p = nodes_out + ((size_t)b * nk + k) * 3;
        p[0] = x; p[1] = y; p[2] = z;
      }
    }
    __syncthreads();
  }
  cluster.sync();   // no block leaves while another may read its sums
}

template <int KPL>
static size_t em_smem(int N) {
  return sizeof(float) * em_smem_floats((N + CL - 1) / CL, KPL * 32);
}

template <int KPL>
static cudaError_t launch(const float* xyz, const float* o, const float* nodes0,
                          float* gamma, float* pi, float* nodes, int B, int N,
                          int nk, int iters, int sk_iters, float tau,
                          float eps, float q_t, float log_q,
                          cudaStream_t stream) {
  const size_t smem = em_smem<KPL>(N);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      em_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  em_kernel<KPL><<<B * CL, NT, smem, stream>>>(xyz, o, nodes0, gamma, pi, nodes,
                                               N, nk, iters, sk_iters, tau,
                                               eps, q_t, log_q);
  return cudaGetLastError();
}

extern "C" int sinkhorn_em_launch(const float* xyz, const float* o,
                                  const float* nodes0, float* gamma, float* pi,
                                  float* nodes, int B, int N, int K, int iters,
                                  int sk_iters, float tau, float eps, float q_t,
                                  float log_q, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (iters < 1 || sk_iters < 1 || N < 1 || K < 1 || K > 128)
    return (int)cudaErrorInvalidValue;
  switch ((K + 31) / 32) {
#define CASE(KPL)                                                            \
  case KPL:                                                                  \
    return (int)launch<KPL>(xyz, o, nodes0, gamma, pi, nodes, B, N, K, iters, \
                            sk_iters, tau, eps, q_t, log_q, stream);
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// how many clusters (clouds) of the kernel for (N, K) the card holds at once,
// by the occupancy calculator; a launch of more clouds than that runs in
// more than one wave
extern "C" int sinkhorn_em_max_clusters(int N, int K, int* out) {
  if (N < 1 || K < 1 || K > 128) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  switch ((K + 31) / 32) {
#define CASE(KPL)                                    \
  case KPL:                                          \
    fn = (const void*)em_kernel<KPL>;                \
    smem = em_smem<KPL>(N);                          \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}
