// Fused eval DGCNN encoder for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_dgcnn.py:dgcnn_eval_pallas
// (_dgcnn_kernel + _run_stages). Takes any k from 1 to N <= 1024, the TPU
// kernel's envelope: the stage chains are compiled for the row counts of
// DGCNN_KS (knn_select.cuh), a point's k edge rows padded to dgcnn_rows(k)
// by repeating its nearest neighbour (exact: the max over a point's rows
// ignores a repeated row, and BN is folded from the running statistics);
// above DGCNN_MAX_K = 32 the neighbours run through the same chains in
// chunks of at most 32 (launch_stages), the chunks' maxes merged in the
// concat, and the selection is knn_wide_kernel (knn_wide.cuh); k = 20
// below. Nothing but the neighbour indices (B*N*k ints) and the 512-wide
// concat pass through device memory between the launches:
//
//  1. knn_kernel<k, GraphOut> (knn_lanes.cuh, the dense selection shared
//     with graph_stage1.cu, knn.cu and posenc_angles.cu): the cloud
//     (N <= 1024) in shared memory, 64 queries a block, four lanes a query
//     with sorted register lists, a threshold from a first pass over
//     sub-tile minima, buffered insertion and a merge by rank; the
//     neighbours in ascending order, ties to the lowest index, and the
//     position-encoding angle cos(angle(p -> nbr, p -> centroid)) of the
//     first posenc_k from float32 coordinates. Distances are formed without
//     fused multiply-adds in a fixed order,
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
//     float32: the same two launches on the tensor cores in 3xTF32
//     (mma.sync m16n8k8 .tf32, float32 sums): each float32 operand a is
//     split into a_hi = tf32(a) and a_lo = tf32(a - a_hi), TF32 being
//     cvt.rna's rounding (to nearest, ties away; done with integer
//     operations, the same bits for every finite a and cheaper), and a
//     product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, which holds
//     about 2^-22 of a b (one TF32 product would not hold the float32
//     route's 1e-4: tests/test_torch_tf32x3.py). dgcnn_stage_tf32_kernel: a
//     block of 8 warps owns QF = 8 points (160 edge rows at k = 20; 4 points
//     at 24 rows a point or more, f32_points), float32
//     activations in shared memory (228,864 B at k = 20: one block an SM, so
//     a thread may take up to 255 registers); a stage is computed transposed
//     as in bf16, a warp holding the split W^T fragments of one 16-channel
//     tile (stage 4's 128-deep tile: 128 registers; its warps take their two
//     tiles one after the other), loading the next depth's B fragments before
//     this depth's products and issuing one product at a time over its row
//     tiles. Stages 1-3 split their B fragments as they read them (a stride
//     of 4 or 12 mod 32 keeps those reads free of bank conflicts); stage 3
//     writes its output split, in two planes, so that stage 4, 72% of the
//     products, whose 16 channel tiles each read every row, converts
//     nothing. The max over k comes from the accumulators as in bf16.
//     dgcnn_head_tf32_kernel: the float32 concat (B*N, 512) times w5 in 128
//     x 64 tiles, chunks of 32 deep staged with cp.async and
//     double-buffered, a warp owning 32 x 32, both operands split as read.
//     mma.sync and not wgmma: wgmma takes TF32 operands only K-major from
//     shared memory, so every operand's split halves would be staged there,
//     where mma.sync splits them in registers as they are read.
//     Both routes take the same operands (Operands below): stages 1-4's
//     float32 weights and BN scales, folded in the kernel as the plain
//     version folds them, and the head's w5, which the wrapper folds.
//
// A second entry point, dgcnn_edges_launch, replaces
// ogmm_tpu/ops/pallas_dgcnn.py:dgcnn_edges_pallas (_dgcnn_edges_kernel): the
// same stage chain over pre-gathered float32 neighbour coordinates
// (B, N, k, 3) instead of indices, at any N (the indoor clouds, N = 35,000,
// whose graph comes from knn_stream.cu) and any k (in chunks above 32, as
// kernel 1). Eval only, BN folded, as kernel 1.
//
// Bound: operations. The stage products are 2*45,440 flops for each of the
// B*N*k edge rows plus 2*512*emb for each point, against 12 bytes in and
// 2*emb bytes out for each point: at (48, 717, k = 20, emb 512) 8.1e10 flops,
// 0.08 ms at the tensor cores' 989 TFLOP/s in bf16; in float32 1.20 ms at the
// CUDA cores' 67 TFLOP/s, or 0.49 ms for three TF32 products a product at
// 495 TFLOP/s. The bf16 design reads each stage weight once a block of 8
// points (94 KB, from L2) and w5 once a tile of 128 rows. What bounds it
// now: ldmatrix's shared-memory reads of the activations (each warp re-reads
// its row group's tiles for its own channels; stage 4 is half the kernel)
// and mma.sync's issue rate, the stage barriers, and the selection kernel,
// which it shares with graph_stage1.cu. The float32 design: mma.sync
// m16n8k8 TF32 alone reaches 313 TFLOP/s at 8 warps an SM on an H100
// (scripts/torch_port_profile.py --probe dgcnn_eval), a floor of 0.59 ms
// for the stage chain and 0.17 for the head; the rest is the conversions
// and fragment loads around each product at 8 warps an SM, the weights'
// fragments read from L2 and split once a block, and the stage barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_lanes.cuh"   // GraphOut
#include "knn_select.cuh"  // DGCNN_KS, DGCNN_MAX_K, MAXN
#include "knn_wide.cuh"    // graph_select_launch
#include "mma_bf16.cuh"  // mma_bf16, ldsm_x4, cp_async16
#include "tf32.cuh"      // tf32, split_tf32, mma_tf32

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define CATW 512   // 64 + 64 + 128 + 256

// the float32 coordinates of edge row j of point n: neighbour j, or the
// first (j = 0) for a padded row j >= k, from nbr (B, N, ld, 3) where it is
// given, else from x through idx (B, N, ld); a launch of a chunk of a
// point's neighbours gets idx and nbr at its first
__device__ __forceinline__ const float* neighbour(const float* x, const int* idx,
                                                  const float* nbr, size_t row,
                                                  int b, int N, int j, int k, int ld) {
  const size_t e = row * ld + (j < k ? j : 0);
  return nbr != nullptr ? nbr + e * 3 : x + ((size_t)b * N + idx[e]) * 3;
}

// ------------------------------------- float32, tensor cores in 3xTF32

#define QF 8       // points a block of the float32 stage kernel (4 above 20
                   // rows a point: f32_points)
#define NWF 8      // warps a block of the float32 stage kernel
#define TPI4 4     // 8-row tiles a warp takes at a time in stage 4 (128 deep)
// row strides (in floats) of the staged float32 tiles: a B fragment's lanes
// (g, t) read row g, column t, so a stride of 4 or 12 mod 32 puts the 32
// lanes on 32 banks
#define LDF_E 12   // edge rows, 8 channels (6 used)
#define LDF_X 68   // 64 channels
#define LDF_Y 132  // 128 channels
#define FHR 128    // rows of a float32 head tile (4 warps x 32)
#define FHC 64     // columns of a float32 head tile (2 warps x 32)
#define FHK 32     // depth of a staged head chunk
#define LDF_HA 36  // the concat chunk's row stride (A reads: 4 mod 32)
#define LDF_HW 72  // the w5 chunk's row stride (B reads of row t, column g: 8 mod 32)

// the max of this lane's channels (c, c + 8) over the 4 lanes of the pair,
// written to the concat row of a point by the first of them
__device__ __forceinline__ void flush_max_f32(float m0, float m1, float* cat_row, int ch) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  if ((threadIdx.x & 3) == 0) {
    cat_row[ch] = m0;
    cat_row[ch + 8] = m1;
  }
}

// One stage over the block's R = QP * KNN edge rows in 3xTF32, computed
// transposed (out^T = W^T h^T, rows along the mma's n): in (R, CIN) float32
// with row stride ld_in -> out (R, COUT) with row stride ld_out (null: not
// kept) and the max over each point's rows -> cat[q * CATW + cat_off + c].
// SPLIT_IN: in holds the TF32 high parts and, R ld_in floats further, the
// low parts; SPLIT_OUT: out is written so (stage 3 for stage 4, whose 16
// channel tiles each read every row: split once by the producer, not once
// by each reader).
// w (CIN_W, COUT), scale and bias (COUT) are the float32 weight and folded
// BN: the weight is folded here, float32(w scale) as the plain version folds
// it, split into TF32 high and low parts and held as A fragments (depths
// from CIN_W up zero). A warp takes CTW channel tiles of 16 one after the
// other (stage 4: 2) over the rows of one row group (whole points), TPI
// 8-row tiles at a time. The activations' B fragments are split as they are
// read, the next depth's loaded before this depth's products; the three
// products go to one accumulator, issued one product at a time over the TPI
// tiles, so that an mma waits on none of the TPI before it (an accumulator
// for each product measured slower).
template <int KNN, int QP, int CIN_W, int CIN, int COUT, bool SPLIT_IN, bool SPLIT_OUT>
__device__ __forceinline__ void stage_tf32(const float* in, int ld_in, float* out,
                                           int ld_out, const float* __restrict__ w,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, float* cat,
                                           int cat_off) {
  constexpr int KS = CIN / 8, MT = COUT / 16;
  constexpr int CTW = MT > NWF ? MT / NWF : 1;     // channel tiles a warp
  constexpr int RG = MT >= NWF ? 1 : NWF / MT;     // row groups
  constexpr int NTG = QP * KNN / 8 / RG;           // 8-row tiles a row group
  constexpr int TPI = CIN >= 128 && NTG % TPI4 == 0 ? TPI4
                      : NTG % 4 == 0 ? 4 : NTG % 5 == 0 ? 5 : NTG % 2 == 0 ? 2 : 1;
  static_assert(KNN >= 8 && (MT % NWF == 0 || NWF % MT == 0) && QP % RG == 0 &&
                (QP * KNN) % (8 * RG) == 0 && NTG % TPI == 0, "stage tiling");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile0 = MT >= NWF ? warp * CTW : warp % MT;
  const int nt0 = MT >= NWF ? 0 : (warp / MT) * NTG;
#pragma unroll 1
  for (int ct = 0; ct < CTW; ++ct) {
    const int c = (tile0 + ct) * 16 + g;         // this lane's channels c, c + 8
    uint32_t ah[KS][4], al[KS][4];
    {
      const float slo = __ldg(scale + c), shi = __ldg(scale + c + 8);
      auto wt = [&](int k, int ch, float sc) {
        return k < CIN_W ? __fmul_rn(__ldg(w + k * COUT + ch), sc) : 0.f;
      };
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int k = ks * 8 + t;
        split_tf32(wt(k, c, slo), ah[ks][0], al[ks][0]);
        split_tf32(wt(k, c + 8, shi), ah[ks][1], al[ks][1]);
        split_tf32(wt(k + 4, c, slo), ah[ks][2], al[ks][2]);
        split_tf32(wt(k + 4, c + 8, shi), ah[ks][3], al[ks][3]);
      }
    }
    const float blo = __ldg(bias + c), bhi = __ldg(bias + c + 8);
    float run0 = 0.f, run1 = 0.f;   // this lane's max of channels c, c + 8 for the open point
#pragma unroll 1
    for (int j = 0; j < NTG; j += TPI) {
      float acc[TPI][4];
#pragma unroll
      for (int u = 0; u < TPI; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      // B fragments: depth 8 ks + (t, t + 4) of row g of each 8-row tile
      const float* rows = in + (size_t)(8 * (nt0 + j) + g) * ld_in + t;
      constexpr int NR = SPLIT_IN ? 4 : 2;
      constexpr int LO = QP * KNN;               // rows to the low parts, in rows
      float raw[TPI][NR];
      auto fetch = [&](int ks) {
#pragma unroll
        for (int u = 0; u < TPI; ++u) {
          const float* p = rows + 8 * u * ld_in + 8 * ks;
          raw[u][0] = p[0];
          raw[u][1] = p[4];
          if constexpr (SPLIT_IN) {
            raw[u][2] = p[LO * ld_in];
            raw[u][3] = p[LO * ld_in + 4];
          }
        }
      };
      fetch(0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bh[TPI][2], bl[TPI][2];
#pragma unroll
        for (int u = 0; u < TPI; ++u) {
          if constexpr (SPLIT_IN) {
            bh[u][0] = __float_as_uint(raw[u][0]); bh[u][1] = __float_as_uint(raw[u][1]);
            bl[u][0] = __float_as_uint(raw[u][2]); bl[u][1] = __float_as_uint(raw[u][3]);
          } else {
            split_tf32(raw[u][0], bh[u][0], bl[u][0]);
            split_tf32(raw[u][1], bh[u][1], bl[u][1]);
          }
        }
        if (ks + 1 < KS) fetch(ks + 1);
        // the small products first: a_lo b_hi, a_hi b_lo, then a_hi b_hi
        // (a_lo b_lo, about 2^-22 of a b, dropped)
#pragma unroll
        for (int u = 0; u < TPI; ++u) mma_tf32(acc[u], al[ks], bh[u][0], bh[u][1]);
#pragma unroll
        for (int u = 0; u < TPI; ++u) mma_tf32(acc[u], ah[ks], bl[u][0], bl[u][1]);
#pragma unroll
        for (int u = 0; u < TPI; ++u) mma_tf32(acc[u], ah[ks], bh[u][0], bh[u][1]);
      }
      // accumulator: (channel c, row 2t), (c, 2t + 1), (c + 8, 2t), (c + 8,
      // 2t + 1) of the tile, in tile order; bias and ReLU in float32
#pragma unroll
      for (int u = 0; u < TPI; ++u) {
        const int rb = 8 * (nt0 + j + u), r0 = rb + 2 * t;
        // the tile's rows belong to point qa and maybe qa + 1 (k >= 8)
        const int qa = rb / KNN, qb = (rb + 7) / KNN;
        const bool in0 = r0 / KNN == qa, in1 = (r0 + 1) / KNN == qa;
        const bool ends = (rb + 8) % KNN == 0;   // the tile ends a point
        const float v00 = fmaxf(acc[u][0] + blo, 0.f), v01 = fmaxf(acc[u][1] + blo, 0.f);
        const float v10 = fmaxf(acc[u][2] + bhi, 0.f), v11 = fmaxf(acc[u][3] + bhi, 0.f);
        if (out != nullptr) {
          const float vs[4] = {v00, v01, v10, v11};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* o = out + (size_t)(r0 + (e & 1)) * ld_out + c + 8 * (e >> 1);
            if constexpr (SPLIT_OUT) {
              uint32_t h, l;
              split_tf32(vs[e], h, l);
              o[0] = __uint_as_float(h);
              o[QP * KNN * ld_out] = __uint_as_float(l);
            } else {
              o[0] = vs[e];
            }
          }
        }
        // ReLU outputs are >= 0, so 0 stands for a row of the other point
        run0 = fmaxf(run0, fmaxf(in0 ? v00 : 0.f, in1 ? v01 : 0.f));
        run1 = fmaxf(run1, fmaxf(in0 ? v10 : 0.f, in1 ? v11 : 0.f));
        const float nxt0 = fmaxf(in0 ? 0.f : v00, in1 ? 0.f : v01);
        const float nxt1 = fmaxf(in0 ? 0.f : v10, in1 ? 0.f : v11);
        if (qb != qa || ends) {                  // point qa is complete
          flush_max_f32(run0, run1, cat + qa * CATW, cat_off + c);
          run0 = nxt0; run1 = nxt1;
          if (qb != qa && ends) {
            flush_max_f32(run0, run1, cat + qb * CATW, cat_off + c);
            run0 = run1 = 0.f;
          }
        }
      }
    }
  }
}

// the edge rows, then stage 2's output, in a buffer of R x LDF_X; stage 1's
// output, then stage 3's split in two planes, in 2 R x LDF_Y; the block's
// concat rows (228,864 B at k = 20 and qp = 8)
__host__ __device__ constexpr size_t f32_smem(int knn, int qp) {
  return sizeof(float) * ((size_t)qp * knn * (LDF_X + 2 * LDF_Y) + qp * CATW);
}

// points a block of the float32 stage kernel at knn rows a point: QF, or
// half of it where QF points' rows do not fit the 227 KB of a block (knn of
// 24 and more)
__host__ __device__ constexpr int f32_points(int knn) {
  return f32_smem(knn, QF) <= 232448 ? QF : QF / 2;
}

// the four stages of QP points of cloud blockIdx.y in 3xTF32 -> their
// concat rows cat_out (B*N, 512) float32 (with merge, the max of those and
// the rows there); stage i's float32 weight wi (C_in, C_out) and folded BN
// scale si and bias bi; KNN rows a point, the first k of them its
// neighbours, idx or nbr rows ld neighbours long
template <int KNN, int QP>
__global__ void __launch_bounds__(NWF * 32, 1)
dgcnn_stage_tf32_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        const float* __restrict__ nbr, const float* w1,
                        const float* w2, const float* w3, const float* w4,
                        const float* s1, const float* s2, const float* s3,
                        const float* s4, const float* b1, const float* b2,
                        const float* b3, const float* b4,
                        float* __restrict__ cat_out, int N, int k, int ld,
                        int merge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = QP * KNN;
  float* bufX = reinterpret_cast<float*>(smem_raw);  // R x LDF_X (first the edges)
  float* bufY = bufX + R * LDF_X;                    // 2 R x LDF_Y (two planes)
  float* cat = bufY + 2 * R * LDF_Y;                 // QP x CATW
  const int b = blockIdx.y, n0 = blockIdx.x * QP, tid = threadIdx.x;

  // edge rows, 8 wide: [nbr - q, q, 0, 0] in float32
  for (int r = tid; r < R; r += NWF * 32) {
    const size_t row = (size_t)b * N + min(n0 + r / KNN, N - 1);
    const float* pq = x + row * 3;
    const float* pn = neighbour(x, idx, nbr, row, b, N, r % KNN, k, ld);
    float4* dst = reinterpret_cast<float4*>(bufX + r * LDF_E);
    dst[0] = make_float4(pn[0] - pq[0], pn[1] - pq[1], pn[2] - pq[2], pq[0]);
    dst[1] = make_float4(pq[1], pq[2], 0.f, 0.f);
  }
  __syncthreads();
  stage_tf32<KNN, QP, 6, 8, 64, false, false>(bufX, LDF_E, bufY, LDF_Y, w1, s1, b1, cat, 0);
  __syncthreads();
  stage_tf32<KNN, QP, 64, 64, 64, false, false>(bufY, LDF_Y, bufX, LDF_X, w2, s2, b2, cat,
                                                64);
  __syncthreads();
  stage_tf32<KNN, QP, 64, 64, 128, false, true>(bufX, LDF_X, bufY, LDF_Y, w3, s3, b3, cat,
                                                128);
  __syncthreads();
  stage_tf32<KNN, QP, 128, 128, 256, true, false>(bufY, LDF_Y, nullptr, 0, w4, s4, b4, cat,
                                                  256);
  __syncthreads();

  // the concat rows of the block's points, 16 bytes a thread; merged with
  // an earlier chunk's maxes by a max (exact: ReLU outputs)
  constexpr int PER_ROW = CATW / 4;
  for (int e = tid; e < QP * PER_ROW; e += NWF * 32) {
    const int q = e / PER_ROW, c = (e % PER_ROW) * 4;
    if (n0 + q < N) {
      float4* dst = reinterpret_cast<float4*>(cat_out + ((size_t)b * N + n0 + q) * CATW + c);
      float4 v = *reinterpret_cast<const float4*>(cat + q * CATW + c);
      if (merge) {
        const float4 o = *dst;
        v = make_float4(fmaxf(v.x, o.x), fmaxf(v.y, o.y), fmaxf(v.z, o.z), fmaxf(v.w, o.w));
      }
      *dst = v;
    }
  }
}

// depth [k0, k0 + FHK) of rows [r0, r0 + FHR) of the float32 concat into
// sa, and rows [k0, k0 + FHK), columns [c0, c0 + FHC) of w5 (512, emb) into
// sw; concat rows past `rows` read as 0
__device__ __forceinline__ void stage_head_f32(float* sa, float* sw,
                                               const float* __restrict__ cat, int rows,
                                               const float* __restrict__ w5, int emb,
                                               int r0, int c0, int k0) {
  constexpr int PER_ROW = FHK / 4;
  for (int e = threadIdx.x; e < FHR * PER_ROW; e += NWF * 32) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 4;
    const bool valid = r0 + r < rows;
    cp_async16(sa + r * LDF_HA + c,
               cat + (valid ? (size_t)(r0 + r) * CATW + k0 + c : 0), valid);
  }
  for (int e = threadIdx.x; e < FHK * (FHC / 4); e += NWF * 32) {
    const int r = e / (FHC / 4), c = (e % (FHC / 4)) * 4;
    cp_async16(sw + r * LDF_HW + c, w5 + (size_t)(k0 + r) * emb + c0 + c, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// out (rows, emb) = relu(cat w5 + b5) in 3xTF32 for the (FHR, FHC) tile at
// (blockIdx.y FHR, blockIdx.x FHC): warp w owns rows 32 (w / 2) .. + 31 and
// columns 32 (w % 2) .. + 31 (2 x 4 accumulator tiles of 16 x 8), both
// operands split as they are read; two blocks an SM
__global__ void __launch_bounds__(NWF * 32, 2)
dgcnn_head_tf32_kernel(const float* __restrict__ cat, const float* __restrict__ w5,
                       const float* __restrict__ b5, float* __restrict__ out, int rows,
                       int emb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  float* sa[2] = {base, base + FHR * LDF_HA};
  float* sw[2] = {base + 2 * FHR * LDF_HA, base + 2 * FHR * LDF_HA + FHK * LDF_HW};
  const int r0 = blockIdx.y * FHR, c0 = blockIdx.x * FHC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
  constexpr int NK = CATW / FHK;
  stage_head_f32(sa[0], sw[0], cat, rows, w5, emb, r0, c0, 0);
  for (int j = 0; j < NK; ++j) {
    if (j + 1 < NK) {
      stage_head_f32(sa[(j + 1) & 1], sw[(j + 1) & 1], cat, rows, w5, emb, r0, c0,
                     (j + 1) * FHK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* a = sa[j & 1] + wr * LDF_HA + g * LDF_HA + t;
    const float* w = sw[j & 1] + wc + t * LDF_HW + g;
    // A: rows g, g + 8 and depths t, t + 4 of each 16-row tile; B: depths
    // t, t + 4 of column g of each 8-column tile; the next depth's loaded
    // before this depth's products, issued one product at a time
    float ra[2][4], rb[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ra[mi][0] = a[16 * mi * LDF_HA];
      ra[mi][1] = a[(16 * mi + 8) * LDF_HA];
      ra[mi][2] = a[16 * mi * LDF_HA + 4];
      ra[mi][3] = a[(16 * mi + 8) * LDF_HA + 4];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      rb[ni][0] = w[8 * ni];
      rb[ni][1] = w[4 * LDF_HW + 8 * ni];
    }
#pragma unroll
    for (int ks = 0; ks < FHK / 8; ++ks) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(ra[mi][e], ah[mi][e], al[mi][e]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(rb[ni][e], bh[ni][e], bl[ni][e]);
      if (ks + 1 < FHK / 8) {
        const int k1 = 8 * (ks + 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          ra[mi][0] = a[16 * mi * LDF_HA + k1];
          ra[mi][1] = a[(16 * mi + 8) * LDF_HA + k1];
          ra[mi][2] = a[16 * mi * LDF_HA + k1 + 4];
          ra[mi][3] = a[(16 * mi + 8) * LDF_HA + k1 + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          rb[ni][0] = w[k1 * LDF_HW + 8 * ni];
          rb[ni][1] = w[(k1 + 4) * LDF_HW + 8 * ni];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
    }
    __syncthreads();   // the buffer of this chunk is refilled next trip
  }
  // accumulator entry e of tile (mi, ni): row 16 mi + g + 8 (e / 2), column
  // 8 ni + 2 t + e % 2
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = c0 + wc + 8 * ni + 2 * t;
    const float bx = __ldg(b5 + col), by = __ldg(b5 + col + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wr + 16 * mi + g + 8 * h;
        if (r < rows)
          *reinterpret_cast<float2*>(out + (size_t)r * emb + col) =
              make_float2(fmaxf(acc[mi][ni][2 * h] + bx, 0.f),
                          fmaxf(acc[mi][ni][2 * h + 1] + by, 0.f));
      }
  }
}

static constexpr int HEAD_F32_SMEM = 2 * (FHR * LDF_HA + FHK * LDF_HW) * (int)sizeof(float);

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
// cat_out (B*N, 512) (with merge, the max of those and the rows there);
// stage i's float32 weight wi (C_in, C_out) and folded BN scale si and bias
// bi; KNN rows a point, the first k of them its neighbours, idx or nbr rows
// ld neighbours long
template <int KNN>
__global__ void __launch_bounds__(NWS * 32, 2)
dgcnn_stage_mma_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                       const float* __restrict__ nbr, const float* w1,
                       const float* w2, const float* w3, const float* w4,
                       const float* s1, const float* s2, const float* s3,
                       const float* s4, const float* b1, const float* b2,
                       const float* b3, const float* b4,
                       bf16* __restrict__ cat_out, int N, int k, int ld,
                       int merge) {
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
    const float* pn = neighbour(x, idx, nbr, row, b, N, r % KNN, k, ld);
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

  // the concat rows of the block's points, 16 bytes a thread; merged with
  // an earlier chunk's maxes by a max (exact: ReLU outputs)
  constexpr int PER_ROW = CATW / 8;
  for (int e = tid; e < QB * PER_ROW; e += NWS * 32) {
    const int q = e / PER_ROW, c = (e % PER_ROW) * 8;
    if (n0 + q < N) {
      uint4* dst = reinterpret_cast<uint4*>(cat_out + ((size_t)b * N + n0 + q) * CATW + c);
      uint4 v = *reinterpret_cast<const uint4*>(cat + q * LD_CAT + c);
      if (merge) {
        const uint4 o = *dst;
        v = make_uint4(as_u32(__hmax2(as_bf162(v.x), as_bf162(o.x))),
                       as_u32(__hmax2(as_bf162(v.y), as_bf162(o.y))),
                       as_u32(__hmax2(as_bf162(v.z), as_bf162(o.z))),
                       as_u32(__hmax2(as_bf162(v.w), as_bf162(o.w))));
      }
      *dst = v;
    }
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

// bf16: the stage launch over k neighbours a point (rows of ld), into the
// concat in device memory (merge: a max with what is there)
template <int KNN>
static cudaError_t stage_launch_bf16(const float* x, const int* idx, const float* nbr,
                                     const Operands& o, void* cat, int B, int N, int k,
                                     int ld, int merge, cudaStream_t stream) {
  const size_t smem = mma_smem(KNN);
  const cudaError_t err = cudaFuncSetAttribute(
      dgcnn_stage_mma_kernel<KNN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dgcnn_stage_mma_kernel<KNN><<<dim3((N + QB - 1) / QB, B), NWS * 32, smem, stream>>>(
      x, idx, nbr, o.w[0], o.w[1], o.w[2], o.w[3], o.ss[0], o.ss[1], o.ss[2],
      o.ss[3], o.bs[0], o.bs[1], o.bs[2], o.bs[3], (bf16*)cat, N, k, ld, merge);
  return cudaGetLastError();
}

// bf16: the head over the concat in device memory
static cudaError_t head_launch_bf16(const Operands& o, const void* cat, void* out,
                                    int rows, int emb, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dgcnn_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HEAD_SMEM);
  if (err != cudaSuccess) return err;
  dgcnn_head_kernel<<<dim3(emb / HC, (rows + HR - 1) / HR), 256, HEAD_SMEM, stream>>>(
      (const bf16*)cat, (const bf16*)o.w5, o.bs[4], (bf16*)out, rows, emb);
  return cudaGetLastError();
}

// float32: the 3xTF32 stage launch, as stage_launch_bf16
template <int KNN>
static cudaError_t stage_launch_f32(const float* x, const int* idx, const float* nbr,
                                    const Operands& o, void* cat, int B, int N, int k,
                                    int ld, int merge, cudaStream_t stream) {
  constexpr int QP = f32_points(KNN);
  const size_t smem = f32_smem(KNN, QP);
  const cudaError_t err = cudaFuncSetAttribute(
      dgcnn_stage_tf32_kernel<KNN, QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dgcnn_stage_tf32_kernel<KNN, QP><<<dim3((N + QP - 1) / QP, B), NWF * 32, smem, stream>>>(
      x, idx, nbr, o.w[0], o.w[1], o.w[2], o.w[3], o.ss[0], o.ss[1], o.ss[2],
      o.ss[3], o.bs[0], o.bs[1], o.bs[2], o.bs[3], (float*)cat, N, k, ld, merge);
  return cudaGetLastError();
}

// float32: the 3xTF32 head over the concat in device memory
static cudaError_t head_launch_f32(const Operands& o, const void* cat, void* out,
                                   int rows, int emb, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dgcnn_head_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HEAD_F32_SMEM);
  if (err != cudaSuccess) return err;
  dgcnn_head_tf32_kernel<<<dim3(emb / FHC, (rows + FHR - 1) / FHR), NWF * 32,
                           HEAD_F32_SMEM, stream>>>(
      (const float*)cat, (const float*)o.w5, o.bs[4], (float*)out, rows, emb);
  return cudaGetLastError();
}

// The stage chain over k neighbours a point, then the head. A point's edge
// rows run through the stages each on its own and meet only in the max over
// them, so the neighbours go in chunks of at most DGCNN_MAX_K, in order
// (ops/cuda_dgcnn.py:stage_chunks mirrors them): one stage launch a chunk at
// its compiled row count dgcnn_rows(kc), the rows past kc repeating the
// chunk's first neighbour, the second and later chunks' maxes merged into
// the concat by a max. One chunk where k <= DGCNN_MAX_K.
static cudaError_t launch_stages(const float* x, const int* idx, const float* nbr,
                                 const Operands& o, void* cat, void* out, int B, int N,
                                 int emb, int k, int is_bf16, cudaStream_t stream) {
  for (int j0 = 0; j0 < k; j0 += DGCNN_MAX_K) {
    const int kc = k - j0 < DGCNN_MAX_K ? k - j0 : DGCNN_MAX_K;
    const int* ci = idx != nullptr ? idx + j0 : nullptr;
    const float* cn = nbr != nullptr ? nbr + 3 * (size_t)j0 : nullptr;
    cudaError_t err;
    switch (dgcnn_rows(kc)) {
#define CASE(K)                                                                    \
  case K:                                                                          \
    err = is_bf16 ? stage_launch_bf16<K>(x, ci, cn, o, cat, B, N, kc, k, j0 > 0,   \
                                         stream)                                   \
                  : stage_launch_f32<K>(x, ci, cn, o, cat, B, N, kc, k, j0 > 0,    \
                                        stream);                                   \
    break;
      DGCNN_KS(CASE)
#undef CASE
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  return is_bf16 ? head_launch_bf16(o, cat, out, B * N, emb, stream)
                 : head_launch_f32(o, cat, out, B * N, emb, stream);
}

// w1 .. w4 (C_in, C_out), s1 .. s4 and b1 .. b5 float32 as Operands; w5
// (512, emb) folded, in the compute type (is_bf16: bf16, else float32);
// cat: (B*N, 512) scratch in the compute type. The selection is
// graph_select_launch's (knn_wide.cuh).
extern "C" int dgcnn_eval_launch(
    const float* x, const float* w1, const float* w2, const float* w3,
    const float* w4, const void* w5, const float* s1, const float* s2,
    const float* s3, const float* s4, const float* b1, const float* b2,
    const float* b3, const float* b4, const float* b5, int* idx, float* alpha,
    void* cat, void* out, int B, int N, int emb, int k, int pk, int is_bf16,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || N < k || emb % 64 != 0 || k < 1 || pk > k)
    return (int)cudaErrorInvalidValue;
  const Operands o = {{w1, w2, w3, w4}, w5, {s1, s2, s3, s4}, {b1, b2, b3, b4, b5}};
  const GraphOut graph{idx, alpha, nullptr, pk};
  const cudaError_t err = graph_select_launch(x, graph, B, N, k, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stages(x, idx, nullptr, o, cat, out, B, N, emb, k, is_bf16, stream);
}

// x (B, N, 3) and nbr (B, N, k, 3) float32 -> out (B, N, emb): the stage
// chain alone, over the given neighbours, at any N >= 1 and k >= 1; the
// other operands as dgcnn_eval_launch
extern "C" int dgcnn_edges_launch(
    const float* x, const float* nbr, const float* w1, const float* w2,
    const float* w3, const float* w4, const void* w5, const float* s1,
    const float* s2, const float* s3, const float* s4, const float* b1,
    const float* b2, const float* b3, const float* b4, const float* b5,
    void* cat, void* out, int B, int N, int emb, int k, int is_bf16,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N < 1 || emb % 64 != 0 || k < 1) return (int)cudaErrorInvalidValue;
  const Operands o = {{w1, w2, w3, w4}, w5, {s1, s2, s3, s4}, {b1, b2, b3, b4, b5}};
  return (int)launch_stages(x, nullptr, nbr, o, cat, out, B, N, emb, k, is_bf16, stream);
}
