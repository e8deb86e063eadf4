// Overlap-weighted Sinkhorn-EM clustering for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_em.py:sinkhorn_em (_em_kernel,
// the mxu_lse schedule). One launch runs all EM trips of all clouds; the
// (N, K) transport plan never reaches device memory until the last trip's
// gamma is written. K is any cluster count up to 128: a lane holds the
// columns lane + 32 c of a row, c < KPL = ceil(K / 32), and the columns from
// K up to 32 KPL are padding that holds no mass (cost +inf, plan 0) and is
// never written out.
//
// One (717, 128) float32 plan is 367 KB, more than one SM's shared memory,
// so a thread block cluster of 8 blocks owns one cloud: each block keeps a
// slab of ceil(N/8) rows of the plan in its shared memory for the whole
// nested loop. Row sums are warp reductions inside the slab (one warp per
// row, a lane holds K/32 columns); column sums are taken per warp in
// registers, summed over the block's warps in a fixed order, and summed over
// the cluster through distributed shared memory in rank order, so every
// block of a cluster holds the same column sums and the same nodes, and the
// result does not change from run to run.
//
// Per EM trip (as the TPU kernel): cost = sqrt(max(d2, 1e-12)) / tau; Sinkhorn
// trip 1 in the log domain (stabilised row update, column update with a
// 1e-38 floor); trips 2..sk_iters in the direct domain (P scaled to the row
// marginal p = overlap + 1e-8, then to the column marginal q = 1/K + 1e-8,
// sums floored at 1e-38); gamma = P with non-finite -> 0, rows divided by
// max(row sum, 1e-3); M-step pi = sum gamma / N, nodes = gamma^T xyz /
// (pi N + 1e-5). A column scaling is applied when the next pass reads the
// plan, which gives the same values as scaling in place.
//
// Bound: neither bytes nor operations but latency: about 11 dependent passes
// per trip, each ended by a cluster barrier, over a slab that a block sweeps
// in a few microseconds. More rows in flight per block is the next step.
// The slab of rows must fit in shared memory (launch below): N <= 3,072 at
// K = 128, N <= 11,600 at K <= 32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

#define CL 8          // blocks per cluster = per cloud
#define NW 8          // warps per block
#define NT (NW * 32)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum Q column vectors over the block's warps and then over the cluster.
// colacc[q][c] is this warp's partial for column lane + 32 c; on return
// colv[q*K + k] holds the cloud-wide sum in every block (K the padded count).
template <int KPL, int Q>
__device__ __forceinline__ void reduce_cols(cg::cluster_group& cluster,
                                            const float (&colacc)[4][KPL],
                                            float* warpacc, float* part,
                                            float* colv, int buf) {
  constexpr int K = KPL * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int c = 0; c < KPL; ++c)
      warpacc[(warp * 4 + q) * K + lane + 32 * c] = colacc[q][c];
  __syncthreads();
  float* mine = part + buf * 4 * K;
  for (int t = tid; t < Q * K; t += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += warpacc[(w * 4 + t / K) * K + t % K];
    mine[t] = s;
  }
  cluster.sync();
  for (int t = tid; t < Q * K; t += NT) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) s += cluster.map_shared_rank(mine, r)[t];
    colv[t] = s;
  }
  __syncthreads();
}

template <int KPL>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
em_kernel(const float* __restrict__ xyz, const float* __restrict__ o,
          const float* __restrict__ nodes0, float* __restrict__ gamma_out,
          float* __restrict__ pi_out, float* __restrict__ nodes_out, int N,
          int nk, int iters, int sk_iters, float tau, float eps, float q_t,
          float log_q) {
  constexpr int K = KPL * 32;            // padded columns; nk of them real
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_per = (N + CL - 1) / CL;
  const int r0 = rank * rows_per;
  const int nrows = max(0, min(N, r0 + rows_per) - r0);

  extern __shared__ __align__(16) float smem[];
  float* P = smem;                       // rows_per x K: cost, then the plan
  float* sxyz = P + rows_per * K;        // rows_per x 4: x, y, z, |x|^2
  float* sp = sxyz + rows_per * 4;       // rows_per x 2: p, log p
  float* su = sp + rows_per * 2;         // rows_per: u of Sinkhorn trip 1
  float* snodes = su + rows_per;         // K x 4: x, y, z, |node|^2
  float* warpacc = snodes + K * 4;       // NW x 4 x K
  float* part = warpacc + NW * 4 * K;    // 2 x 4 x K, read by the cluster
  float* colv = part + 2 * 4 * K;        // 4 x K reduced column sums

  for (int i = tid; i < nrows; i += NT) {
    const size_t row = (size_t)b * N + r0 + i;
    const float x = xyz[row * 3], y = xyz[row * 3 + 1], z = xyz[row * 3 + 2];
    sxyz[i * 4] = x; sxyz[i * 4 + 1] = y; sxyz[i * 4 + 2] = z;
    sxyz[i * 4 + 3] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z));
    const float pv = o[row] + 1e-8f;
    sp[i * 2] = pv;
    sp[i * 2 + 1] = logf(pv);
  }
  for (int k = tid; k < K; k += NT) {
    float x = 0.f, y = 0.f, z = 0.f;
    if (k < nk) {
      const float* p = nodes0 + ((size_t)b * nk + k) * 3;
      x = p[0]; y = p[1]; z = p[2];
    }
    snodes[k * 4] = x; snodes[k * 4 + 1] = y; snodes[k * 4 + 2] = z;
    snodes[k * 4 + 3] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                  __fmul_rn(z, z));
  }
  __syncthreads();

  int npass = 0;
  float colacc[4][KPL];
  for (int it = 0; it < iters; ++it) {
    const bool last = (it == iters - 1);

    // ---- cost, and Sinkhorn trip 1 in the log domain ----------------------
#pragma unroll
    for (int c = 0; c < KPL; ++c) colacc[0][c] = 0.f;
    for (int i = warp; i < nrows; i += NW) {
      const float x = sxyz[i * 4], y = sxyz[i * 4 + 1], z = sxyz[i * 4 + 2];
      const float xsq = sxyz[i * 4 + 3];
      float cst[KPL];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int k = lane + 32 * c;
        const float inner = __fadd_rn(
            __fadd_rn(__fmul_rn(x, snodes[k * 4]), __fmul_rn(y, snodes[k * 4 + 1])),
            __fmul_rn(z, snodes[k * 4 + 2]));
        const float d2 = fmaxf(
            __fsub_rn(__fadd_rn(xsq, snodes[k * 4 + 3]), __fmul_rn(2.0f, inner)),
            1e-12f);
        cst[c] = k < nk ? sqrtf(d2) / tau : CUDART_INF_F;   // padding: no mass
        m = fmaxf(m, (-cst[c]) / eps);
      }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) s += expf((-cst[c]) / eps - m);
      s = warp_sum(s);
      const float u = eps * (sp[i * 2 + 1] - (m + logf(s)));
      if (lane == 0) su[i] = u;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        P[i * K + lane + 32 * c] = cst[c];
        colacc[0][c] += expf((-cst[c] + u) / eps);
      }
    }
    reduce_cols<KPL, 1>(cluster, colacc, warpacc, part, colv, npass++ & 1);
    float vv[KPL], cs[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      vv[c] = eps * (log_q - logf(colv[lane + 32 * c] + 1e-38f));
      cs[c] = 1.f;
    }

    // ---- Sinkhorn trips 2.. in the direct domain --------------------------
    bool have_plan = false;   // the slab holds cost until the first pass
    for (int t = 1; t < sk_iters; ++t) {
#pragma unroll
      for (int c = 0; c < KPL; ++c) colacc[0][c] = 0.f;
      for (int i = warp; i < nrows; i += NW) {
        const float u = su[i];
        float val[KPL];
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const float pv = P[i * K + lane + 32 * c];
          val[c] = have_plan ? pv * cs[c] : expf(((-pv + u) + vv[c]) / eps);
          s += val[c];
        }
        s = warp_sum(s);
        const float rs = sp[i * 2] / fmaxf(s, 1e-38f);
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          val[c] *= rs;
          P[i * K + lane + 32 * c] = val[c];
          colacc[0][c] += val[c];
        }
      }
      reduce_cols<KPL, 1>(cluster, colacc, warpacc, part, colv, npass++ & 1);
#pragma unroll
      for (int c = 0; c < KPL; ++c)
        cs[c] = q_t / fmaxf(colv[lane + 32 * c], 1e-38f);
      have_plan = true;
    }

    // ---- gamma and the M-step sums ----------------------------------------
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < KPL; ++c) colacc[q][c] = 0.f;
    for (int i = warp; i < nrows; i += NW) {
      const float x = sxyz[i * 4], y = sxyz[i * 4 + 1], z = sxyz[i * 4 + 2];
      const float u = su[i];
      float val[KPL];
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float pv = P[i * K + lane + 32 * c];
        float g = have_plan ? pv * cs[c] : expf(((-pv + u) + vv[c]) / eps);
        if (!isfinite(g)) g = 0.f;
        val[c] = g;
        s += g;
      }
      s = warp_sum(s);
      const float den = fmaxf(s, 1e-3f);
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float g = val[c] / den;
        colacc[0][c] += g;
        colacc[1][c] += g * x;
        colacc[2][c] += g * y;
        colacc[3][c] += g * z;
        if (last && lane + 32 * c < nk)
          gamma_out[((size_t)b * N + r0 + i) * nk + lane + 32 * c] = g;
      }
    }
    reduce_cols<KPL, 4>(cluster, colacc, warpacc, part, colv, npass++ & 1);
    for (int k = tid; k < nk; k += NT) {
      const float pi = colv[k] / (float)N;
      const float npi = pi * (float)N + 1e-5f;
      const float x = colv[K + k] / npi, y = colv[2 * K + k] / npi;
      const float z = colv[3 * K + k] / npi;
      snodes[k * 4] = x; snodes[k * 4 + 1] = y; snodes[k * 4 + 2] = z;
      snodes[k * 4 + 3] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                    __fmul_rn(z, z));
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
static cudaError_t launch(const float* xyz, const float* o, const float* nodes0,
                          float* gamma, float* pi, float* nodes, int B, int N,
                          int nk, int iters, int sk_iters, float tau,
                          float eps, float q_t, float log_q,
                          cudaStream_t stream) {
  constexpr int K = KPL * 32;
  const int rows_per = (N + CL - 1) / CL;
  const size_t smem = sizeof(float) * ((size_t)rows_per * (K + 7) + K * 4 +
                                       NW * 4 * K + 2 * 4 * K + 4 * K);
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
