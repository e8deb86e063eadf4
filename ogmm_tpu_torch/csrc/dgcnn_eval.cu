// Fused eval DGCNN encoder for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_dgcnn.py:dgcnn_eval_pallas
// (_dgcnn_kernel + _run_stages). Compiled for the neighbour counts k of
// DGCNN_KS (knn_select.cuh); k = 20 below. Nothing but the neighbour indices
// (B*N*k ints) and, for bf16, the 512-wide concat pass through device memory
// between the launches:
//
//  1. knn_alpha_kernel (knn_select.cuh, shared with graph_stage1.cu): one
//     warp per query point. The cloud (N <= 1024) sits
//     in shared memory, the query's float32 distance row sits in the warp's
//     registers (32 values a lane), and k rounds of warp argmin-and-mask
//     pick the neighbours in ascending order, ties to the lowest index. The
//     first posenc_k rounds also give the position-encoding angle
//     cos(angle(p -> nbr, p -> centroid)) from float32 coordinates.
//     Distances are formed without fused multiply-adds in a fixed order,
//     (|q|^2 + |t|^2) - 2 (q0 t0 + q1 t1 + q2 t2), so that the plain PyTorch
//     version selects the same neighbours bit for bit.
//  2. The stage chain. Each stage is Dense (BN scale folded into the weight)
//     + bias + ReLU in the compute type with float32 accumulation, over the
//     edge rows [nbr - q (float32, then cast), q], with the max over the k
//     rows of a point after each; then the 512-wide concat and the final
//     Dense(512 -> emb) + bias + ReLU.
//     bf16: two launches on the tensor cores (mma.sync m16n8k16, bf16
//     products, float32 sums). dgcnn_stage_mma_kernel: a block of 8 warps
//     owns 8 points, i.e. 8 k edge rows (160 at k = 20); the edge rows and
//     the stage activations stay in shared memory (75 KB at k = 20: two
//     blocks an SM). A stage is computed transposed, out^T = W^T h^T: a
//     warp holds the fragments of 16 output channels of W^T (32 in stage 4)
//     in registers, read once a block from L2 as the float32 weight and BN
//     scale and folded there, and walks
//     the edge rows 8 at a time, its B fragments read from the activation
//     rows with ldmatrix.
//     An accumulator holds 2 edge rows of 2 channels a lane, so the max
//     over a point's rows is taken in registers as the rows go by and
//     finished by a two-step shuffle over the 4 lanes of a channel pair;
//     the epilogue (round, add the bias in bf16, ReLU) runs on bf16 pairs.
//     The concat (B*N, 512) goes to device memory, and dgcnn_head_kernel
//     multiplies it by w5 in 128 x 64 tiles, both operands staged with
//     cp.async in double-buffered chunks of 64 and read with ldmatrix (w5's
//     with ldmatrix.trans), so a w5 tile serves 128 rows.
//     float32: dgcnn_stage_kernel on the CUDA cores in true float32 (TF32
//     would not hold the float32 route's 1e-4): one block per 8 query
//     points, one warp per query, the head fused.
//     Both routes take the same operands (Operands below): stages 1-4's
//     float32 weights and BN scales, folded in the kernel as the plain
//     version folds them, and the head's w5, which the wrapper folds.
//
// A second entry point, dgcnn_edges_launch, replaces
// ogmm_tpu/ops/pallas_dgcnn.py:dgcnn_edges_pallas (_dgcnn_edges_kernel): the
// same stage chain over pre-gathered float32 neighbour coordinates
// (B, N, k, 3) instead of indices, at any N (the indoor clouds, N = 35,000,
// whose graph comes from knn_stream.cu). Eval only, BN folded, as kernel 1.
//
// Bound: operations. The stage products are 2*45,440 flops for each of the
// B*N*k edge rows plus 2*512*emb for each point, against 12 bytes in and
// 2*emb bytes out for each point: at (48, 717, k = 20, emb 512) bf16 8.1e10
// flops, 0.08 ms at the tensor cores' 989 TFLOP/s. The bf16 design reads
// each stage weight once a block of 8 points (94 KB, from L2) and w5 once a
// tile of 128 rows. What bounds it now: ldmatrix's shared-memory reads of
// the activations (each warp re-reads its row group's tiles for its own
// channels; stage 4 is half the kernel) and mma.sync's issue rate, the
// stage barriers, and the selection kernel, which it shares with
// graph_stage1.cu. The float32 route is bound by the CUDA cores' 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"  // knn_alpha_kernel, DGCNN_KS, MAXN, QPB
#include "mma_bf16.cuh"  // mma_bf16, ldsm_x4, cp_async16

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define CATW 512   // 64 + 64 + 128 + 256

// float32: the sum plus the bias, ReLU
__device__ __forceinline__ float bias_relu(float acc, float bias) {
  return fmaxf(acc + bias, 0.f);
}

// the float32 coordinates of edge row j of point n: the neighbour from nbr
// (B, N, KNN, 3) where it is given, else from x through idx
template <int KNN>
__device__ __forceinline__ const float* neighbour(const float* x, const int* idx,
                                                  const float* nbr, size_t row,
                                                  int b, int N, int j) {
  return nbr != nullptr ? nbr + (row * KNN + j) * 3
                        : x + ((size_t)b * N + idx[row * KNN + j]) * 3;
}

// ------------------------------------------------ float32, CUDA cores

#define TQ 8       // queries (= warps) per block of the float32 stage kernel

// acc[r][c] = sum_kk in[r][kk] * W[kk][col0 + lane + 32 c] for RT rows held
// in shared memory (all lanes read the same address: a broadcast) and CT
// columns a lane (neighbouring lanes read neighbouring weights). W is w
// (cin, cout) with, where FOLD, the BN scale folded in here, float32(w
// scale) as the plain version folds it, and depths from CIN_W up zero (the
// head's w5 comes folded).
template <int RT, int CT, bool FOLD, int CIN_W>
__device__ __forceinline__ void dense_tile(const float* __restrict__ in, int cin,
                                           const float* __restrict__ w,
                                           const float* __restrict__ scale,
                                           int cout, int col0, float (&acc)[RT][CT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  float sc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) sc[c] = FOLD ? scale[col0 + lane + 32 * c] : 1.f;
  for (int kk = 0; kk < cin; kk += 4) {
    float wv[4][CT];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float wt = kk + v < CIN_W ? w[(size_t)(kk + v) * cout + col0 + lane + 32 * c]
                                        : 0.f;
        wv[v][c] = FOLD ? __fmul_rn(wt, sc[c]) : wt;
      }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(in + r * cin + kk);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[r][c] = fmaf(av[v], wv[v][c], acc[r][c]);
    }
  }
}

// one edge-conv stage for this warp's query: rows [warp*KNN, +KNN) of `in`
// (row length cin) -> the same rows of `outbuf` (row length cout, may be
// null) and the max over the rows -> cat[warp][cat_off + col]; w (CIN_W,
// cout) and scale the float32 weight and BN scale
template <int KNN, int CIN_W>
__device__ __forceinline__ void edge_stage(const float* in, int cin,
                                           const float* __restrict__ w,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int cout,
                                           float* outbuf, float* cat, int cat_off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int col0 = 0; col0 < cout; col0 += 64) {
    float acc[KNN][2];
    dense_tile<KNN, 2, true, CIN_W>(in + (size_t)warp * KNN * cin, cin, w, scale,
                                    cout, col0, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + lane + 32 * c;
      const float bv = bias[col];
      float mx = 0.f;                        // ReLU outputs are >= 0
#pragma unroll
      for (int r = 0; r < KNN; ++r) {
        const float v = bias_relu(acc[r][c], bv);
        if (outbuf) outbuf[(size_t)(warp * KNN + r) * cout + col] = v;
        mx = fmaxf(mx, v);
      }
      cat[warp * CATW + cat_off + col] = mx;
    }
  }
}

template <int KNN>
__global__ void __launch_bounds__(TQ * 32)
dgcnn_stage_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const float* __restrict__ nbr,
                   const float* w1, const float* w2, const float* w3,
                   const float* w4, const float* w5,
                   const float* s1, const float* s2, const float* s3,
                   const float* s4, const float* b1, const float* b2,
                   const float* b3, const float* b4, const float* b5,
                   float* __restrict__ out, int N, int emb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = TQ * KNN;
  float* bufA = reinterpret_cast<float*>(smem_raw);  // R x 64
  float* bufB = bufA + R * 64;                       // R x 128
  float* cat = bufB + R * 128;                       // TQ x 512
  const int b = blockIdx.y, n0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // edge rows, 8 wide: [nbr - q, q, 0, 0]
  for (int r = tid; r < R; r += TQ * 32) {
    const size_t row = (size_t)b * N + min(n0 + r / KNN, N - 1);
    const float* pq = x + row * 3;
    const float* pn = neighbour<KNN>(x, idx, nbr, row, b, N, r % KNN);
    float* e = bufA + r * 8;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      e[i] = pn[i] - pq[i];
      e[3 + i] = pq[i];
    }
    e[6] = 0.f;
    e[7] = 0.f;
  }
  __syncthreads();
  edge_stage<KNN, 6>(bufA, 8, w1, s1, b1, 64, bufB, cat, 0);
  __syncthreads();
  edge_stage<KNN, 64>(bufB, 64, w2, s2, b2, 64, bufA, cat, 64);
  __syncthreads();
  edge_stage<KNN, 64>(bufA, 64, w3, s3, b3, 128, bufB, cat, 128);
  __syncthreads();
  edge_stage<KNN, 128>(bufB, 128, w4, s4, b4, 256, nullptr, cat, 256);
  __syncthreads();

  // head: (TQ, 512) x (512, emb), 64 columns a warp at a time
  for (int col0 = warp * 64; col0 < emb; col0 += TQ * 64) {
    float acc[TQ][2];
    dense_tile<TQ, 2, false, CATW>(cat, CATW, w5, nullptr, emb, col0, acc);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + lane + 32 * c;
      const float bv = b5[col];
#pragma unroll
      for (int r = 0; r < TQ; ++r)
        if (n0 + r < N)
          out[((size_t)b * N + n0 + r) * emb + col] = bias_relu(acc[r][c], bv);
    }
  }
}

// ------------------------------------------------ bf16, tensor cores

#define QB 8       // points a block of the bf16 stage kernel
#define NWS 8      // warps a block of the bf16 stage kernel
// row strides (in bf16) of the staged tiles: multiples of 16 bytes that keep
// ldmatrix's eight row reads free of bank conflicts
#define LD_E 24    // edge rows, 16 channels (6 used)
#define LD_X 72    // 64 channels
#define LD_Y 136   // 128 channels
#define LD_CAT 520 // the block's concat rows
#define HR 128     // rows of a head tile (8 warps x 16)
#define HC 64      // columns of a head tile
#define HK 64      // depth of a staged head chunk
#define LD_H 72

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(bf162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ bf162 as_bf162(uint32_t v) { return *reinterpret_cast<bf162*>(&v); }

// the max of this lane's (channel g, channel g + 8) pair over the 4 lanes
// of the pair, written to the concat row of a point by the first of them
__device__ __forceinline__ void flush_max(bf162 m, bf16* cat_row, int ch) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1)
    m = __hmax2(m, as_bf162(__shfl_xor_sync(0xffffffffu, as_u32(m), o)));
  if ((threadIdx.x & 3) == 0) {
    cat_row[ch] = m.x;
    cat_row[ch + 8] = m.y;
  }
}

// One stage over the block's R = QB * KNN edge rows: in (R, CIN) with row
// stride ld_in -> out (R, COUT) with row stride ld_out (null: not kept) and
// the max over each point's rows -> cat[q][cat_off + c]. w (CIN_W, COUT),
// scale and bias (COUT) are the float32 weight and folded BN; the weight is
// folded and rounded here, bf16(w scale) as the plain version folds it, and
// depths from CIN_W up to CIN are zero. A warp computes MTW tiles of 16
// output channels over the edge rows of one row group (a whole number of
// points): one tile for the narrow stages, two for the 256 of stage 4.
template <int KNN, int CIN_W, int CIN, int COUT>
__device__ __forceinline__ void stage_mma(const bf16* in, int ld_in, bf16* out,
                                          int ld_out, const float* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          bf16* cat, int cat_off) {
  constexpr int KS = CIN / 16, MT = COUT / 16;
  constexpr int MTW = MT > NWS ? MT / NWS : 1;     // channel tiles a warp
  constexpr int RG = NWS * MTW / MT;               // row groups
  constexpr int NTG = QB * KNN / 8 / RG;           // 8-row tiles a row group
  // row tiles an iteration: more independent accumulators where the
  // registers allow (stage 4 holds 32 channels of W^T)
  constexpr int TPI = MTW == 2 ? 1 : NTG % 4 == 0 ? 4 : 2;
  static_assert(KNN >= 8 && (NWS * MTW) % MT == 0 && QB % RG == 0 && NTG % TPI == 0,
                "stage tiling");
  static_assert(KS == 1 || KS % 2 == 0, "depth");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = (warp % (MT / MTW)) * MTW * 16, nt0 = (warp / (MT / MTW)) * NTG;

  // A = W^T rows c + g and c + g + 8 of this warp's tiles: a0 (g, 2t),
  // a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8) of each 16-deep slice
  uint32_t a[MTW][KS][4];
  bf162 bias_lo[MTW], bias_hi[MTW];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
    const int clo = c0 + 16 * mi + g, chi = clo + 8;
    const float slo = __ldg(scale + clo), shi = __ldg(scale + chi);
    auto wt = [&](int k, int c, float sc) {
      return k < CIN_W ? __fmul_rn(__ldg(w + k * COUT + c), sc) : 0.f;
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int k = ks * 16 + 2 * t;
      a[mi][ks][0] = pack_bf16(wt(k, clo, slo), wt(k + 1, clo, slo));
      a[mi][ks][1] = pack_bf16(wt(k, chi, shi), wt(k + 1, chi, shi));
      a[mi][ks][2] = pack_bf16(wt(k + 8, clo, slo), wt(k + 9, clo, slo));
      a[mi][ks][3] = pack_bf16(wt(k + 8, chi, shi), wt(k + 9, chi, shi));
    }
    bias_lo[mi] = __float2bfloat162_rn(__ldg(bias + clo));
    bias_hi[mi] = __float2bfloat162_rn(__ldg(bias + chi));
  }
  const bf162 zero = __float2bfloat162_rn(0.f);

  bf162 run[MTW];   // this lane's max of channels (g, g + 8) for the open point
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) run[mi] = zero;
#pragma unroll 1
  for (int j = 0; j < NTG; j += TPI) {
    // B fragments of TPI 8-row tiles: b[u][ks] = rows of tile u, depth
    // 16 ks + (2t, 2t + 8); ldmatrix gives a lane row g, columns 2t, 2t + 1
    uint32_t bfr[TPI][KS][2];
    if constexpr (KS == 1) {
      static_assert(TPI % 2 == 0, "stage 1 takes row tiles in pairs");
#pragma unroll
      for (int u = 0; u < TPI; u += 2) {
        uint32_t r[4];
        ldsm_x4(r, in + (size_t)(8 * (nt0 + j + u + (lane >> 4)) + (lane & 7)) * ld_in
                       + 8 * ((lane >> 3) & 1));
        bfr[u][0][0] = r[0]; bfr[u][0][1] = r[1];
        bfr[u + 1][0][0] = r[2]; bfr[u + 1][0][1] = r[3];
      }
    } else {
#pragma unroll
      for (int u = 0; u < TPI; ++u)
#pragma unroll
        for (int p = 0; p < KS / 2; ++p) {
          uint32_t r[4];
          ldsm_x4(r, in + (size_t)(8 * (nt0 + j + u) + (lane & 7)) * ld_in
                         + 32 * p + 8 * (lane >> 3));
          bfr[u][2 * p][0] = r[0]; bfr[u][2 * p][1] = r[1];
          bfr[u][2 * p + 1][0] = r[2]; bfr[u][2 * p + 1][1] = r[3];
        }
    }
    float acc[TPI][MTW][4];
#pragma unroll
    for (int u = 0; u < TPI; ++u)
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        acc[u][mi][0] = acc[u][mi][1] = acc[u][mi][2] = acc[u][mi][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma_bf16(acc[u][mi], a[mi][ks], bfr[u][ks][0], bfr[u][ks][1]);
      }
    // accumulator: (channel c + g, row 2t), (c + g, 2t + 1), (c + g + 8, 2t),
    // (c + g + 8, 2t + 1) of the tile, in tile order. The epilogue of
    // bias_relu on pairs: the sum rounded to bf16, the bias added in bf16
    // (one rounding of the exact sum, as a float32 add of two bf16 values
    // then rounded), ReLU
#pragma unroll
    for (int u = 0; u < TPI; ++u) {
      const int rb = 8 * (nt0 + j + u), r0 = rb + 2 * t;
      // the tile's rows belong to point qa and maybe qa + 1 (k >= 8)
      const int qa = rb / KNN, qb = (rb + 7) / KNN;
      const bool in0 = r0 / KNN == qa, in1 = (r0 + 1) / KNN == qa;
      const bool ends = (rb + 8) % KNN == 0;   // the tile ends a point
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        const int c = c0 + 16 * mi + g;
        const bf162 lo = __hmax2(__hadd2(__floats2bfloat162_rn(acc[u][mi][0], acc[u][mi][1]),
                                         bias_lo[mi]), zero);
        const bf162 hi = __hmax2(__hadd2(__floats2bfloat162_rn(acc[u][mi][2], acc[u][mi][3]),
                                         bias_hi[mi]), zero);
        if (out != nullptr) {
          out[(size_t)r0 * ld_out + c] = lo.x;
          out[(size_t)(r0 + 1) * ld_out + c] = lo.y;
          out[(size_t)r0 * ld_out + c + 8] = hi.x;
          out[(size_t)(r0 + 1) * ld_out + c + 8] = hi.y;
        }
        // (channel c, channel c + 8) of rows r0 and r0 + 1
        const bf162 row0 = __lows2bfloat162(lo, hi), row1 = __highs2bfloat162(lo, hi);
        run[mi] = __hmax2(run[mi], __hmax2(in0 ? row0 : zero, in1 ? row1 : zero));
        const bf162 nxt = __hmax2(in0 ? zero : row0, in1 ? zero : row1);
        if (qb != qa || ends) {                  // point qa is complete
          flush_max(run[mi], cat + qa * LD_CAT, cat_off + c);
          run[mi] = nxt;
          if (qb != qa && ends) {
            flush_max(run[mi], cat + qb * LD_CAT, cat_off + c);
            run[mi] = zero;
          }
        }
      }
    }
  }
}

__host__ __device__ constexpr size_t mma_smem(int knn) {
  return sizeof(bf16) * ((size_t)QB * knn * (LD_X + LD_Y) + QB * LD_CAT);
}

// the four stages of QB points of cloud blockIdx.y -> their concat rows
// cat_out (B*N, 512); stage i's float32 weight wi (C_in, C_out) and folded
// BN scale si and bias bi
template <int KNN>
__global__ void __launch_bounds__(NWS * 32, 2)
dgcnn_stage_mma_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                       const float* __restrict__ nbr, const float* w1,
                       const float* w2, const float* w3, const float* w4,
                       const float* s1, const float* s2, const float* s3,
                       const float* s4, const float* b1, const float* b2,
                       const float* b3, const float* b4,
                       bf16* __restrict__ cat_out, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = QB * KNN;
  bf16* bufX = reinterpret_cast<bf16*>(smem_raw);  // R x LD_X (first the edges)
  bf16* bufY = bufX + R * LD_X;                    // R x LD_Y
  bf16* cat = bufY + R * LD_Y;                     // QB x LD_CAT
  const int b = blockIdx.y, n0 = blockIdx.x * QB, tid = threadIdx.x;

  // edge rows, 16 wide: [nbr - q, q, 0 ...]; the offset in float32, then cast
  for (int r = tid; r < R; r += NWS * 32) {
    const size_t row = (size_t)b * N + min(n0 + r / KNN, N - 1);
    const float* pq = x + row * 3;
    const float* pn = neighbour<KNN>(x, idx, nbr, row, b, N, r % KNN);
    uint4* dst = reinterpret_cast<uint4*>(bufX + r * LD_E);
    dst[0] = make_uint4(pack_bf16(pn[0] - pq[0], pn[1] - pq[1]),
                        pack_bf16(pn[2] - pq[2], pq[0]), pack_bf16(pq[1], pq[2]), 0u);
    dst[1] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  stage_mma<KNN, 6, 16, 64>(bufX, LD_E, bufY, LD_Y, w1, s1, b1, cat, 0);
  __syncthreads();
  stage_mma<KNN, 64, 64, 64>(bufY, LD_Y, bufX, LD_X, w2, s2, b2, cat, 64);
  __syncthreads();
  stage_mma<KNN, 64, 64, 128>(bufX, LD_X, bufY, LD_Y, w3, s3, b3, cat, 128);
  __syncthreads();
  stage_mma<KNN, 128, 128, 256>(bufY, LD_Y, nullptr, 0, w4, s4, b4, cat, 256);
  __syncthreads();

  // the concat rows of the block's points, 16 bytes a thread
  constexpr int PER_ROW = CATW / 8;
  for (int e = tid; e < QB * PER_ROW; e += NWS * 32) {
    const int q = e / PER_ROW, c = (e % PER_ROW) * 8;
    if (n0 + q < N)
      *reinterpret_cast<uint4*>(cat_out + ((size_t)b * N + n0 + q) * CATW + c) =
          *reinterpret_cast<const uint4*>(cat + q * LD_CAT + c);
  }
}

// depth [k0, k0 + HK) of rows [r0, r0 + HR) of the concat into sa, and
// rows [k0, k0 + HK), columns [c0, c0 + HC) of w5 (512, emb) into sw;
// concat rows past `rows` read as 0
__device__ __forceinline__ void stage_head(bf16* sa, bf16* sw,
                                           const bf16* __restrict__ cat, int rows,
                                           const bf16* __restrict__ w5, int emb,
                                           int r0, int c0, int k0) {
  constexpr int PER_ROW = HK / 8;
  for (int e = threadIdx.x; e < HR * PER_ROW; e += 256) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    const bool valid = r0 + r < rows;
    cp_async16(sa + r * LD_H + c,
               cat + (valid ? (size_t)(r0 + r) * CATW + k0 + c : 0), valid);
  }
  for (int e = threadIdx.x; e < HK * (HC / 8); e += 256) {
    const int r = e / (HC / 8), c = (e % (HC / 8)) * 8;
    cp_async16(sw + r * LD_H + c, w5 + (size_t)(k0 + r) * emb + c0 + c, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out (rows, emb) = relu(bf16(cat w5) + b5) for the (HR, HC) tile at
// (blockIdx.y HR, blockIdx.x HC); warp w owns rows 16 w .. 16 w + 15
__global__ void __launch_bounds__(256)
dgcnn_head_kernel(const bf16* __restrict__ cat, const bf16* __restrict__ w5,
                  const float* __restrict__ b5, bf16* __restrict__ out, int rows,
                  int emb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  bf16* sa[2] = {base, base + HR * LD_H};
  bf16* sw[2] = {base + 2 * HR * LD_H, base + 2 * HR * LD_H + HK * LD_H};
  const int r0 = blockIdx.y * HR, c0 = blockIdx.x * HC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[HC / 8][4];
#pragma unroll
  for (int nt = 0; nt < HC / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  constexpr int NK = CATW / HK;
  stage_head(sa[0], sw[0], cat, rows, w5, emb, r0, c0, 0);
  for (int j = 0; j < NK; ++j) {
    if (j + 1 < NK) {
      stage_head(sa[(j + 1) & 1], sw[(j + 1) & 1], cat, rows, w5, emb, r0, c0,
                 (j + 1) * HK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const bf16* a = sa[j & 1];
    const bf16* w = sw[j & 1];
#pragma unroll
    for (int ks = 0; ks < HK / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, a + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD_H
                      + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < HC / 16; ++np) {
        // n-tiles 2 np and 2 np + 1, depth halves 0 and 1: the (depth,
        // column) tiles of w5 transposed give a lane depths 2t, 2t + 1 of
        // column g
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, w + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD_H
                               + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();   // the buffer of this chunk is refilled next trip
  }
  // accumulator entry e of n-tile nt: row g + 8 (e / 2), column 2 t + e % 2
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HC / 8; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
    const bf162 bias = __floats2bfloat162_rn(__ldg(b5 + col), __ldg(b5 + col + 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * 16 + g + 8 * h;
      if (r < rows)
        *reinterpret_cast<bf162*>(out + (size_t)r * emb + col) = __hmax2(
            __hadd2(__floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]), bias),
            __float2bfloat162_rn(0.f));
    }
  }
}

static constexpr int HEAD_SMEM = 2 * (HR + HK) * LD_H * (int)sizeof(bf16);

// The operands of both compute types: w holds stages 1-4's float32 weights
// (C_in, C_out), ss their BN scales, bs b1 .. b5 in float32, and w5 the
// head's weight (512, emb), BN folded, in the compute type.
struct Operands {
  const float* w[4];
  const void* w5;
  const float* ss[4];
  const float* bs[5];
};

// bf16: the stage launch, then the head over the concat in device memory
template <int KNN>
static cudaError_t launch_stages_bf16(const float* x, const int* idx,
                                      const float* nbr, const Operands& o,
                                      void* cat, void* out, int B, int N, int emb,
                                      cudaStream_t stream) {
  const size_t smem = mma_smem(KNN);
  cudaError_t err = cudaFuncSetAttribute(
      dgcnn_stage_mma_kernel<KNN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dgcnn_head_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, HEAD_SMEM);
  if (err != cudaSuccess) return err;
  dgcnn_stage_mma_kernel<KNN><<<dim3((N + QB - 1) / QB, B), NWS * 32, smem, stream>>>(
      x, idx, nbr, o.w[0], o.w[1], o.w[2], o.w[3], o.ss[0], o.ss[1], o.ss[2],
      o.ss[3], o.bs[0], o.bs[1], o.bs[2], o.bs[3], (bf16*)cat, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * N;
  dgcnn_head_kernel<<<dim3(emb / HC, (rows + HR - 1) / HR), 256, HEAD_SMEM, stream>>>(
      (const bf16*)cat, (const bf16*)o.w5, o.bs[4], (bf16*)out, rows, emb);
  return cudaGetLastError();
}

// float32: one launch, the head fused
template <int KNN>
static cudaError_t launch_stages_f32(const float* x, const int* idx,
                                     const float* nbr, const Operands& o, void* out,
                                     int B, int N, int emb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(TQ * KNN * (64 + 128) + TQ * CATW);
  cudaError_t err = cudaFuncSetAttribute(
      dgcnn_stage_kernel<KNN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  dgcnn_stage_kernel<KNN><<<grid, TQ * 32, smem, stream>>>(
      x, idx, nbr, o.w[0], o.w[1], o.w[2], o.w[3], (const float*)o.w5, o.ss[0],
      o.ss[1], o.ss[2], o.ss[3], o.bs[0], o.bs[1], o.bs[2], o.bs[3], o.bs[4],
      (float*)out, N, emb);
  return cudaGetLastError();
}

template <int KNN>
static cudaError_t launch_stages(const float* x, const int* idx,
                                 const float* nbr, const Operands& o, void* cat,
                                 void* out, int B, int N, int emb, int is_bf16,
                                 cudaStream_t stream) {
  if (is_bf16)
    return launch_stages_bf16<KNN>(x, idx, nbr, o, cat, out, B, N, emb, stream);
  return launch_stages_f32<KNN>(x, idx, nbr, o, out, B, N, emb, stream);
}

template <int KNN>
static cudaError_t launch_k(const float* x, const Operands& o, int* idx,
                            float* alpha, void* cat, void* out, int B, int N,
                            int emb, int pk, int is_bf16, cudaStream_t stream) {
  if (N < KNN || pk > KNN) return cudaErrorInvalidValue;
  const dim3 grid((N + QPB - 1) / QPB, B);
  knn_alpha_kernel<KNN><<<grid, 256, 0, stream>>>(x, nullptr, idx, alpha, N, pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stages<KNN>(x, idx, nullptr, o, cat, out, B, N, emb, is_bf16,
                            stream);
}

// w1 .. w4 (C_in, C_out), s1 .. s4 and b1 .. b5 float32 as Operands; w5
// (512, emb) folded, in the compute type (is_bf16: bf16, else float32). cat: (B*N, 512) bf16 scratch for bf16, unused (may be null) for
// float32.
extern "C" int dgcnn_eval_launch(
    const float* x, const float* w1, const float* w2, const float* w3,
    const float* w4, const void* w5, const float* s1, const float* s2,
    const float* s3, const float* s4, const float* b1, const float* b2,
    const float* b3, const float* b4, const float* b5, int* idx, float* alpha,
    void* cat, void* out, int B, int N, int emb, int k, int pk, int is_bf16,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || emb % 64 != 0) return (int)cudaErrorInvalidValue;
  const Operands o = {{w1, w2, w3, w4}, w5, {s1, s2, s3, s4}, {b1, b2, b3, b4, b5}};
  switch (k) {
#define CASE(K)                                                              \
  case K:                                                                    \
    return (int)launch_k<K>(x, o, idx, alpha, cat, out, B, N, emb, pk,       \
                            is_bf16, stream);
    DGCNN_KS(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (B, N, 3) and nbr (B, N, k, 3) float32 -> out (B, N, emb): the stage
// chain alone, over the given neighbours, at any N >= 1; the other operands
// as dgcnn_eval_launch
extern "C" int dgcnn_edges_launch(
    const float* x, const float* nbr, const float* w1, const float* w2,
    const float* w3, const float* w4, const void* w5, const float* s1,
    const float* s2, const float* s3, const float* s4, const float* b1,
    const float* b2, const float* b3, const float* b4, const float* b5,
    void* cat, void* out, int B, int N, int emb, int k, int is_bf16,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N < 1 || emb % 64 != 0) return (int)cudaErrorInvalidValue;
  const Operands o = {{w1, w2, w3, w4}, w5, {s1, s2, s3, s4}, {b1, b2, b3, b4, b5}};
  switch (k) {
#define CASE(K)                                                              \
  case K:                                                                    \
    return (int)launch_stages<K>(x, nullptr, nbr, o, cat, out, B, N, emb,    \
                                 is_bf16, stream);
    DGCNN_KS(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
