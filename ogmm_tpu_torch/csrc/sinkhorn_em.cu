// Overlap-weighted Sinkhorn-EM clustering for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_em.py:sinkhorn_em (_em_kernel,
// the mxu_lse schedule). One launch runs all EM trips of all clouds; the
// (N, K) transport plan never reaches device memory until the last trip's
// gamma is written. K is any cluster count up to 1024, padded to KP = 4 LPR
// KPL columns (below); the padding holds no mass (cost +inf, plan 0) and is
// never written out.
//
// One (717, 128) float32 plan is 367 KB, more than one SM's shared memory,
// so a thread block cluster of CL blocks owns one cloud (CL = 8, or 16 for
// the larger plans below): each block keeps a slab of ceil(N/CL) rows of
// the plan in its shared memory for the whole nested loop. A row is spread
// over LPR lanes of a warp, which takes 32 / LPR rows at a time; a lane
// holds KPL chunks of 4 columns of its row, at columns 4 (lane % LPR +
// LPR j), j < KPL <= 8, so the slab is read and written 16 bytes a lane
// without bank conflicts, and a row sum or maximum is the lane's own 4 KPL
// values and log2(LPR) shuffle steps. The lane layout by K:
//   K <= 256        LPR = 8,  KPL = ceil(K / 32),  KP = 32 KPL  (4 rows a warp)
//   256 < K <= 512  LPR = 16, KPL = ceil(K / 64),  KP = 64 KPL  (2 rows)
//   512 < K <= 1024 LPR = 32, KPL = ceil(K / 128), KP = 128 KPL (1 row)
// so a lane never holds more than 32 entries of a row (and their column
// factors and sums) in registers. Column sums are taken per lane in
// registers, added over the warp's row groups by 3 - log2(LPR) shuffle
// steps (none at LPR = 32, where a lane owns its columns outright), over the
// block's warps in warp order, and over the cluster through distributed
// shared memory in rank order, so every block of a cluster holds the same
// column sums and the same nodes, and the result does not change from run
// to run. The M-step's sums are taken by one thread a column over the gamma
// rows the pass leaves in the slab, in row order.
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
//    thread reads CL remote values, not 4 CL.
//
// Shared memory: the slab (rows ks floats apart), 6 floats a row, and
// column vectors of KP floats: the nodes (x, y, z, |node|^2: 4), the 4
// warps' sums of a pass (4), the block's sums (2, alternating by pass), the
// M-step sums (4) and the column factors (1), 15 in all to K = 256. Above
// K = 256 (LPR > 8) the M-step sums share the warps' sums' space, 11
// vectors; a cluster barrier ends each M-step there, so that no block
// writes its next pass's warp sums while another still reads its M-step
// sums. A cluster of CL = 8 blocks holds the slab to N = 3,352 at K = 128
// and N = 12,128 at K <= 32; past that the launch takes CL = 16 blocks a
// cloud (a non-portable cluster size, allowed by
// cudaFuncAttributeNonPortableClusterSizeAllowed). Between them they hold
// every (N, K) with K <= min(N, 1024) that the JAX package's rule sends to
// its kernel, N max(K, 128) 20 B <= 14 MiB (N <= 5,734 at K <= 128, 2,867 at
// K = 256, 1,433 at K = 512, 717 at K = 1023; ops/cuda_em.py:cluster_size
// chooses, the smallest that fits, 227 KB a block at most). The slab's rows
// are KP floats apart in a cluster of 8 blocks to K = 256 (a compile-time
// stride: the kernel of the N = 717 request), else 4 ceil(K / 4): a lane's
// last chunk past them is neither read nor written (a cost of +inf, a plan
// entry of 0 where it would be read), so K = 129 at N = 5,690 needs 356 rows
// of 132 floats a block, not of 160, and K = 257 rows of 260 floats, not of
// 320. KPL above 4 takes one row group in flight a warp (32 entries a row a
// lane, their column sums and factors in registers) and at most 2 blocks an
// SM; above K = 256 a block of the (48, 717, 512) request takes 209,008 B,
// one an SM.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

#define NW 4          // warps per block
#define NT (NW * 32)
#define QF 2          // row groups in flight a warp (one for KPL > 4)
#define RS 6          // floats a row keeps beside the slab: x, y, z, p, log p, u
#define FULL 0xffffffffu
#define EM_MAX_K 1024

// column vectors of KP floats a block keeps: the nodes (4), the warps' sums
// (NW), the block's sums (2), the M-step sums (4, in the warps' sums' space
// above K = 256) and the column factors (1)
__host__ __device__ constexpr int em_vectors(bool wide) {
  return 4 + NW + 2 + (wide ? 0 : 4) + 1;
}

// the shared memory of a block, in floats: the slab (rows ks floats apart),
// RS floats a row and `vectors` column vectors of kp
__host__ __device__ constexpr size_t em_smem_floats(int rows_per, int ks, int kp,
                                                    int vectors) {
  return (size_t)rows_per * ks + ((RS * rows_per + 3) & ~3) + (size_t)vectors * kp;
}

// the sum (or max) over the LPR lanes of a row
template <bool MAX, int LPR>
__device__ __forceinline__ float row_reduce(float v) {
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// this lane's 4 KPL entries of row i of a table whose rows are ld floats
// apart, at columns 4 (lane % LPR + LPR j) + e; a chunk at or past column ld
// (only the last, j = KPL - 1, can be) is not read and holds `fill`
template <int KPL, int LPR>
__device__ __forceinline__ void load_row(const float* P, int ld, int i, float (&v)[4 * KPL],
                                         float fill = 0.f) {
  const int cg = threadIdx.x & (LPR - 1);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int c = 4 * (cg + LPR * j);
    const float4 f = j < KPL - 1 || c < ld
                         ? *reinterpret_cast<const float4*>(P + i * ld + c)
                         : make_float4(fill, fill, fill, fill);
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
  }
}

// the same entries stored; a chunk at or past column ld is not written
template <int KPL, int LPR>
__device__ __forceinline__ void store_row(float* P, int ld, int i, const float (&v)[4 * KPL]) {
  const int cg = threadIdx.x & (LPR - 1);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int c = 4 * (cg + LPR * j);
    if (j < KPL - 1 || c < ld)
      *reinterpret_cast<float4*>(P + i * ld + c) =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// The end of a pass: this lane's column sums over its rows are added over
// the warp's 32 / LPR row groups (lanes LPR apart) into the warp's sums
// wsum[warp]; a thread a column adds the NW warps' sums in warp order into
// the block's sum part[c]; after the cluster barrier it adds the parts of
// the cluster's blocks in rank order (all CL remote loads issued first) and
// stores colf[c] = fn(cloud-wide sum of column c). Every block gets the
// same bits.
template <int KPL, int LPR, int CL, class Fn>
__device__ __forceinline__ void reduce_cols(cg::cluster_group& cluster,
                                            float (&colacc)[4 * KPL], float* wsum,
                                            float* part, float* colf, Fn fn) {
  constexpr int K = KPL * 4 * LPR;
  const int tid = threadIdx.x, warp = tid >> 5;
#pragma unroll
  for (int e = 0; e < 4 * KPL; ++e)
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) colacc[e] += __shfl_xor_sync(FULL, colacc[e], o);
  if ((tid & 31) < LPR) store_row<KPL, LPR>(wsum, K, warp, colacc);
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

template <int KPL, int LPR>
__device__ __forceinline__ void load_factors(const float* colf, float (&cs)[4 * KPL]) {
  const int cg = threadIdx.x & (LPR - 1);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(colf + 4 * (cg + LPR * j));
    cs[4 * j] = f.x; cs[4 * j + 1] = f.y; cs[4 * j + 2] = f.z; cs[4 * j + 3] = f.w;
  }
}

// the plan entries of a row from the slab (rows ks floats apart) and the
// column factors: in the first direct pass (and a gamma pass straight after
// the log-domain trip) exp(((u - cost) + v) / eps) from the cost and v, else
// the plan times the last pass's column scaling; columns past the slab's
// rows read as a cost of +inf or a plan entry of 0
template <int KPL, int LPR>
__device__ __forceinline__ void plan_row(const float* P, int ks, const float* srow, int i,
                                         bool first, const float (&cs)[4 * KPL],
                                         float inv_eps, float (&v)[4 * KPL]) {
  load_row<KPL, LPR>(P, ks, i, v, first ? CUDART_INF_F : 0.f);
  if (first) {
    const float u = srow[i * RS + 5];
#pragma unroll
    for (int e = 0; e < 4 * KPL; ++e) v[e] = expf(((-v[e] + u) + cs[e]) * inv_eps);
  } else {
#pragma unroll
    for (int e = 0; e < 4 * KPL; ++e) v[e] *= cs[e];
  }
}

// grid B CL blocks in clusters of CL (launch below)
template <int KPL, int LPR, int CL>
__global__ void __launch_bounds__(NT, KPL <= 4 ? 4 : 2)
em_kernel(const float* __restrict__ xyz, const float* __restrict__ o,
          const float* __restrict__ nodes0, float* __restrict__ gamma_out,
          float* __restrict__ pi_out, float* __restrict__ nodes_out, int N,
          int nk, int iters, int sk_iters, float tau, float eps, float q_t,
          float log_q) {
  constexpr int K = KPL * 4 * LPR;       // padded columns; nk of them real
  constexpr int V = 4 * KPL;             // entries of a row a lane holds
  constexpr int RG = 32 / LPR;           // rows a warp takes at a time
  constexpr bool WIDE = LPR > 8;         // K > 256: the M-step sums in wsum
  constexpr int QFK = KPL <= 4 ? QF : 1;   // row groups in flight a warp
  static_assert(NW >= 4, "the M-step's 4 sums share the warps' sums' space");
  const int ks = CL > 8 || WIDE ? 4 * ((nk + 3) / 4) : K;   // the slab's row stride
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, warp = tid >> 5, lr = (tid & 31) / LPR, cgl = tid & (LPR - 1);
  const int rows_per = (N + CL - 1) / CL;
  const int r0 = rank * rows_per;
  const int nrows = max(0, min(N, r0 + rows_per) - r0);
  const float inv_eps = 1.0f / eps, inv_tau = 1.0f / tau;

  extern __shared__ __align__(16) float smem[];
  float* P = smem;                       // slab: cost, then the plan, then gamma
  float* srow = P + (size_t)rows_per * ks;  // rows_per x RS
  float4* snodes = reinterpret_cast<float4*>(srow + ((RS * rows_per + 3) & ~3));
  float* wsum = reinterpret_cast<float*>(snodes + K);   // NW x K
  float* part = wsum + NW * K;           // 2 x K, read by the cluster
  float* G = WIDE ? wsum : part + 2 * K;   // 4 x K, read by the cluster
  float* colf = WIDE ? part + 2 * K : G + 4 * K;   // the last pass's column factors

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

  // this warp's row groups are warp + NW m; row i = RG group + lr. Rows past
  // the slab compute on row 0 and store nothing
  const int nq = (nrows + RG - 1) / RG;
  const int nqw = nq > warp ? (nq - warp + NW - 1) / NW : 0;
  int npass = 0;
  float cs[V], colacc[V];
  for (int it = 0; it < iters; ++it) {
    const bool last = (it == iters - 1);

    // ---- cost, and Sinkhorn trip 1 in the log domain ----------------------
#pragma unroll
    for (int e = 0; e < V; ++e) colacc[e] = 0.f;
    for (int m0 = 0; m0 < nqw; m0 += QFK) {
      float cst[QFK][V], mx[QFK], s[QFK];
      int row[QFK];
      bool ok[QFK];
#pragma unroll
      for (int f = 0; f < QFK; ++f) {
        row[f] = RG * (warp + NW * (m0 + f)) + lr;
        ok[f] = m0 + f < nqw && row[f] < nrows;
        const int i = ok[f] ? row[f] : 0;
        const float x = srow[i * RS], y = srow[i * RS + 1], z = srow[i * RS + 2];
        const float xsq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                    __fmul_rn(z, z));
        mx[f] = -CUDART_INF_F;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int k = 4 * (cgl + LPR * (e / 4)) + e % 4;
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
      for (int f = 0; f < QFK; ++f) mx[f] = row_reduce<true, LPR>(mx[f]);
#pragma unroll
      for (int f = 0; f < QFK; ++f) {
        s[f] = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) s[f] += expf(-cst[f][e] * inv_eps - mx[f]);
      }
#pragma unroll
      for (int f = 0; f < QFK; ++f) s[f] = row_reduce<false, LPR>(s[f]);
#pragma unroll
      for (int f = 0; f < QFK; ++f) {
        if (!ok[f]) continue;
        const float u = eps * (srow[row[f] * RS + 4] - (mx[f] + logf(s[f])));
        if (cgl == 0) srow[row[f] * RS + 5] = u;
#pragma unroll
        for (int e = 0; e < V; ++e) colacc[e] += expf((-cst[f][e] + u) * inv_eps);
        store_row<KPL, LPR>(P, ks, row[f], cst[f]);
      }
    }
    reduce_cols<KPL, LPR, CL>(cluster, colacc, wsum, part + (npass++ & 1) * K, colf,
                              [&](float s) { return eps * (log_q - logf(s + 1e-38f)); });
    load_factors<KPL, LPR>(colf, cs);    // v: the first pass below reads cost

    // ---- Sinkhorn trips 2.. in the direct domain --------------------------
    for (int t = 1; t < sk_iters; ++t) {
#pragma unroll
      for (int e = 0; e < V; ++e) colacc[e] = 0.f;
      for (int m0 = 0; m0 < nqw; m0 += QFK) {
        float val[QFK][V], s[QFK];
        int row[QFK];
        bool ok[QFK];
#pragma unroll
        for (int f = 0; f < QFK; ++f) {
          row[f] = RG * (warp + NW * (m0 + f)) + lr;
          ok[f] = m0 + f < nqw && row[f] < nrows;
          plan_row<KPL, LPR>(P, ks, srow, ok[f] ? row[f] : 0, t == 1, cs, inv_eps, val[f]);
          s[f] = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) s[f] += val[f][e];
        }
#pragma unroll
        for (int f = 0; f < QFK; ++f) s[f] = row_reduce<false, LPR>(s[f]);
#pragma unroll
        for (int f = 0; f < QFK; ++f) {
          if (!ok[f]) continue;
          const float rs = srow[row[f] * RS + 3] / fmaxf(s[f], 1e-38f);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            val[f][e] *= rs;
            colacc[e] += val[f][e];
          }
          store_row<KPL, LPR>(P, ks, row[f], val[f]);
        }
      }
      reduce_cols<KPL, LPR, CL>(cluster, colacc, wsum, part + (npass++ & 1) * K, colf,
                                [&](float s) { return q_t / fmaxf(s, 1e-38f); });
      load_factors<KPL, LPR>(colf, cs);
    }

    // ---- gamma and the M-step sums ----------------------------------------
    for (int m0 = 0; m0 < nqw; m0 += QFK) {
      float val[QFK][V], s[QFK];
      int row[QFK];
      bool ok[QFK];
#pragma unroll
      for (int f = 0; f < QFK; ++f) {
        row[f] = RG * (warp + NW * (m0 + f)) + lr;
        ok[f] = m0 + f < nqw && row[f] < nrows;
        plan_row<KPL, LPR>(P, ks, srow, ok[f] ? row[f] : 0, sk_iters == 1, cs, inv_eps,
                           val[f]);
        s[f] = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (!isfinite(val[f][e])) val[f][e] = 0.f;
          s[f] += val[f][e];
        }
      }
#pragma unroll
      for (int f = 0; f < QFK; ++f) s[f] = row_reduce<false, LPR>(s[f]);
#pragma unroll
      for (int f = 0; f < QFK; ++f) {
        if (!ok[f]) continue;
        const float rden = 1.0f / fmaxf(s[f], 1e-3f);
#pragma unroll
        for (int e = 0; e < V; ++e) val[f][e] *= rden;
        store_row<KPL, LPR>(P, ks, row[f], val[f]);
      }
    }
    __syncthreads();
    // gamma is in the slab: a thread a column sums gamma, gamma x, gamma y,
    // gamma z over the block's rows in row order (and writes the last
    // trip's gamma, a row of threads on a row of gamma_out); the columns
    // past ks are never read
    for (int c = tid; c < ks; c += NT) {
      float sg = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll 4
      for (int i = 0; i < nrows; ++i) {
        const float g = P[i * ks + c];
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
    // the M-step sums in the warps' sums' space (K > 256): no block writes
    // its next pass's warp sums before every block has read them
    if constexpr (WIDE)
      cluster.sync();
    else
      __syncthreads();
  }
  cluster.sync();   // no block leaves while another may read its sums
}

template <int KPL, int LPR>
static size_t em_smem(int N, int nk, int cl) {
  constexpr int K = KPL * 4 * LPR;
  constexpr bool WIDE = LPR > 8;
  return sizeof(float) * em_smem_floats((N + cl - 1) / cl,
                                        cl > 8 || WIDE ? 4 * ((nk + 3) / 4) : K, K,
                                        em_vectors(WIDE));
}

// the kernel for (K, CL) and its shared memory at N, the dynamic shared
// memory and (CL = 16) the non-portable cluster size allowed
template <int KPL, int LPR, int CL>
static cudaError_t prepare(int N, int nk, const void** fn, size_t* smem) {
  *fn = (const void*)em_kernel<KPL, LPR, CL>;
  *smem = em_smem<KPL, LPR>(N, nk, CL);
  if (*smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      em_kernel<KPL, LPR, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err == cudaSuccess && CL > 8)
    err = cudaFuncSetAttribute(em_kernel<KPL, LPR, CL>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

static cudaLaunchConfig_t cluster_config(int clouds, int cl, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clouds * cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KPL, int LPR, int CL>
static cudaError_t launch(const float* xyz, const float* o, const float* nodes0,
                          float* gamma, float* pi, float* nodes, int B, int N,
                          int nk, int iters, int sk_iters, float tau,
                          float eps, float q_t, float log_q,
                          cudaStream_t stream) {
  const void* fn;
  size_t smem;
  cudaError_t err = prepare<KPL, LPR, CL>(N, nk, &fn, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(B, CL, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, em_kernel<KPL, LPR, CL>, xyz, o, nodes0, gamma, pi,
                           nodes, N, nk, iters, sk_iters, tau, eps, q_t, log_q);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the form of a (KPL, LPR) instance, 1..16: KPL to K = 256, 4 + KPL to 512,
// 8 + KPL to 1024
__host__ constexpr int em_form(int kpl, int lpr) {
  return lpr == 8 ? kpl : lpr == 16 ? 4 + kpl : 8 + kpl;
}

// the form that takes K clusters (ops/cuda_em.py:lanes_per_row)
static int em_form_of(int K) {
  return K <= 256 ? (K + 31) / 32 : K <= 512 ? em_form((K + 63) / 64, 16)
                                             : em_form((K + 127) / 128, 32);
}

// the instance of (KPL, LPR, CL) for K clusters and a cluster of cl blocks
#define EM_DISPATCH(K, cl, CALL)                                              \
  switch ((cl) * 32 + em_form_of(K)) {                                        \
    CALL(1, 8, 8) CALL(2, 8, 8) CALL(3, 8, 8) CALL(4, 8, 8)                   \
    CALL(5, 8, 8) CALL(6, 8, 8) CALL(7, 8, 8) CALL(8, 8, 8)                   \
    CALL(1, 8, 16) CALL(2, 8, 16) CALL(3, 8, 16) CALL(4, 8, 16)               \
    CALL(5, 8, 16) CALL(6, 8, 16) CALL(7, 8, 16) CALL(8, 8, 16)               \
    CALL(5, 16, 8) CALL(6, 16, 8) CALL(7, 16, 8) CALL(8, 16, 8)               \
    CALL(5, 32, 8) CALL(6, 32, 8) CALL(7, 32, 8) CALL(8, 32, 8)               \
    CALL(5, 16, 16) CALL(6, 16, 16) CALL(7, 16, 16) CALL(8, 16, 16)           \
    CALL(5, 32, 16) CALL(6, 32, 16) CALL(7, 32, 16) CALL(8, 32, 16)           \
    default:                                                                  \
      return (int)cudaErrorInvalidValue;                                      \
  }

// cl: the blocks a cloud, 8 or 16 (ops/cuda_em.py:cluster_size)
extern "C" int sinkhorn_em_launch(const float* xyz, const float* o,
                                  const float* nodes0, float* gamma, float* pi,
                                  float* nodes, int B, int N, int K, int cl,
                                  int iters, int sk_iters, float tau, float eps,
                                  float q_t, float log_q, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (iters < 1 || sk_iters < 1 || N < 1 || K < 1 || K > EM_MAX_K || (cl != 8 && cl != 16))
    return (int)cudaErrorInvalidValue;
#define CASE(KPL, LPR, CL)                                                   \
  case CL * 32 + em_form(KPL, LPR):                                          \
    return (int)launch<KPL, LPR, CL>(xyz, o, nodes0, gamma, pi, nodes, B, N, \
                                     K, iters, sk_iters, tau, eps, q_t,      \
                                     log_q, stream);
  EM_DISPATCH(K, cl, CASE)
#undef CASE
}

// how many clusters (clouds) of the kernel for (N, K, cl) the card holds at
// once, by the occupancy calculator; a launch of more clouds than that runs
// in more than one wave, and 0 means the card cannot run it
extern "C" int sinkhorn_em_max_clusters(int N, int K, int cl, int* out) {
  if (N < 1 || K < 1 || K > EM_MAX_K || (cl != 8 && cl != 16))
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define CASE(KPL, LPR, CL)                                                   \
  case CL * 32 + em_form(KPL, LPR):                                          \
    err = prepare<KPL, LPR, CL>(N, K, &fn, &smem);                           \
    break;
  EM_DISPATCH(K, cl, CASE)
#undef CASE
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cl, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}
