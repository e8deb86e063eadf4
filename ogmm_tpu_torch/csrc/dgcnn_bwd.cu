// Backward of the DGCNN edge stages 4..1 in training, for Hopper (sm_90a),
// plain C interface. Replaces the TPU kernels of
// ogmm_tpu/ops/pallas_dgcnn_train.py:
//
//   bwd_reduce_launch  bwd_reduce_pallas (_bwd_reduce_kernel): the BatchNorm
//                      sums S = (sum dy, sum dy zhat) of the last stage
//   bwd_stage_launch   bwd_stage_pallas (_bwd_stage_kernel): dz_i, dW_i and
//   bwd_stage_bf16_launch  the sums of stage i-1, for stages 4, 3 and 2
//   bwd_edge_launch    bwd_edge_pallas (_bwd_edge_kernel): stage 1, dW_1,
//   bwd_edge_bf16_launch   dq and the neighbour scatter dscat
//
// Layout: stage tensors are (B, k, N, C) in the compute type T (float32 or
// bf16), taps (B, N, C). A "tile" is the rows (b, j, n0 + t) of each of a few
// points n0 + t: the max over k of a column needs all k rows of its point,
// which is why the TPU kernel takes every k of a tile too. Its row tail is a
// bounds check on n; rows past N enter no output and no sum.
//
// Row classes. The file is compiled once a class (ops/dispatch.py: nvcc with
// -DBWD_KP=KP, KP in 4, 8, 12, 16, 20, 24, 32; ops/cuda_dgcnn_bwd.py:
// row_class), and a launch of class KP takes any graph of 1 <= k <= KP
// neighbours: a tile holds KP rows a point (WTN or FTN points), and its rows
// j >= k are padding. Unlike the forward's, they cannot repeat a real row: a
// padded row must add nothing to dW_i, S, de, dW_1 or the scatter, and must
// never win a column's argmax (h = ReLU(BN(0)) can exceed every real row).
// So every kernel runs the argmax over j < k only, writes dz_i = 0 and
// h_{i-1} = 0 on padded rows before any product reads them, adds no padded
// row to a sum and stores none: the tensor maps are 4-D, (C, N, k, B) with
// boxes of KP rows a point in one cloud, so that TMA zero-fills the padded
// rows on load and drops them on store, and the bulk copies of the float32
// stage kernel copy rows j < k only. Every kernel is also compiled with PAD =
// false for k = KP, where k is the constant KP, every guard folds away and
// the boxes are the 3-D ones of a (C, N, B KP) view: the class of k = 20
// runs the code of k = 20 alone.
//
// Every call is one pass over a persistent grid (the reduce's last block adds
// the partials; the stage and edge passes leave one partial a block, added in
// block order by sum_parts_kernel), each described where it is defined:
//  - bf16 stages 4..2 and stage 1 on wgmma (stage_wgmma_kernel,
//    edge_wgmma_kernel): TMA-fed tiles, resident weights, the weight gradient
//    held in registers across a block's tiles;
//  - float32 stages 4..2 and stage 1 on mma.sync in 3xTF32 (stage_tf32_kernel,
//    edge_tf32_kernel): tiles by bulk copies or TMA, the products' operands
//    split in registers;
//  - the reduce (reduce_kernel, both types): only each column's max-over-k
//    argmax row contributes to its sums, so a thread streams a point's rows
//    as 16-byte loads and keeps one running argmax a channel.
// dz_1 never leaves shared memory. Both edge routes end with scatter_kernel:
// dscat[b, p] = sum of de[:3] over the rows (b, j, n) with idx[b, n, j] == p,
// taken in (j, n) order, a block for each range of SCAT_P points of a cloud,
// its lists filled in that order. No float atomics anywhere (the reduce's
// last block takes an integer ticket), so two launches on the same input give
// the same bits.
//
// Every product of the TPU kernel's body is computed here: for bf16 on wgmma
// (bf16 operands, float32 accumulation); for float32 on mma.sync in 3xTF32,
// but for stage 1's two small products (de = dz_1 W_1^T, dW_1 = e^T dz_1),
// which take float32 FMAs on the CUDA cores.
//
// Bound: at B=24, N=717 one backward (five calls) moves about 1.3 GB and
// does about 93 GFLOP, mostly bf16 products: the bytes bound it (about 0.4
// ms at 3.35 TB/s). The bf16 edge call alone needs about 104 MB: z_1, dz_2
// (44 MB each), e, idx and dtap read once, dneigh (4 MB) written and read
// once; 0.031 ms. The bf16 reduce reads z_4 (176 MB) and dtap once: 0.055 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"      // mbarriers, TMA, wgmma, tensor maps
#include "knn_select.cuh"  // MAXN, to_f, from_f
#include "tf32.cuh"        // split_tf32, mma_tf32x3

#ifndef BWD_KP
#error "compile with -DBWD_KP=<rows a point of the row class>"
#endif
// the row class: a point's rows in a tile; a launch takes any 1 <= k <= KP
constexpr int KP = BWD_KP;
static_assert(KP % 4 == 0 && KP >= 4 && KP <= 32, "row classes");
#define FULL_MASK 0xffffffffu

#define NT 256           // threads of a sum_parts_kernel block

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Per-channel constants, packed (6, C) float32 by the wrapper with the same
// PyTorch operations as the plain version: mean, inv*gamma and beta rounded
// to T, then mean, inv = rsqrt(var + eps) and inv*gamma in float32.
struct BnC {
  float mean_t = 0.f, scale_t = 0.f, beta_t = 0.f, mean = 0.f, inv = 0.f, ig = 0.f;
  __device__ BnC(const float* bn, int C, int c) {
    if (bn) {
      mean_t = bn[c]; scale_t = bn[C + c]; beta_t = bn[2 * C + c];
      mean = bn[3 * C + c]; inv = bn[4 * C + c]; ig = bn[5 * C + c];
    }
  }
  // the three constants bn_y reads
  __device__ BnC(float m, float s, float b) : mean_t(m), scale_t(s), beta_t(b) {}
};

// The same constants formed from the float32 batch statistics by the
// operations of ops/cuda_dgcnn_bwd.py:_bn_pack (rsqrt, then the products and
// the roundings to T), for the kernels that take the statistics as they are.
template <typename T>
__device__ __forceinline__ BnC bn_stats(const float* __restrict__ mean,
                                        const float* __restrict__ var,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, int c) {
  BnC k(nullptr, 0, 0);
  k.mean = mean[c];
  k.inv = rsqrtf(__fadd_rn(var[c], 1e-5f));
  k.ig = __fmul_rn(k.inv, gamma[c]);
  k.mean_t = rnd<T>(k.mean);
  k.scale_t = rnd<T>(k.ig);
  k.beta_t = rnd<T>(beta[c]);
  return k;
}

// y = BN(z) in T, rounded after each operation like the eager forward
template <typename T>
__device__ __forceinline__ float bn_y(float z, const BnC& k) {
  const float a = rnd<T>(__fsub_rn(z, k.mean_t));
  const float b = rnd<T>(__fmul_rn(a, k.scale_t));
  return rnd<T>(__fadd_rn(b, k.beta_t));
}

__device__ __forceinline__ float zhat(float z, const BnC& k) {
  return __fmul_rn(__fsub_rn(z, k.mean), k.inv);
}

// cotangent of max(y, 0): g where y > 0, g / 2 where y == 0
template <typename T>
__device__ __forceinline__ float relu_vjp(float g, float y) {
  return y > 0.f ? g : (y == 0.f ? rnd<T>(__fmul_rn(0.5f, g)) : 0.f);
}

// out[i] = sum over g of part[g][i], in g order
__global__ void __launch_bounds__(NT)
sum_parts_kernel(const float* __restrict__ part, int G, int L, float* __restrict__ out) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= L) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s = __fadd_rn(s, part[(size_t)g * L + i]);
  out[i] = s;
}

// ------------------------------------------------------------- the reduce
//
// bwd_reduce has no cotangent from above, so dh is 0 on every row but the
// max-over-k argmax of its column, where it is rnd(dtap), and ReLU-VJP(0, y)
// is 0: of a column's k rows only the argmax row adds to S1 and S2
// (pallas_dgcnn_train.py:_bwd_reduce_kernel states it densely). A thread owns
// RED_CH adjacent channels of one point (b, n), a warp 256 contiguous
// channels (256 / C points), and streams the point's k rows as 16-byte
// loads (one a row for bf16, two for float32), U rows in flight at once (the
// row class's KP rows unrolled, the rows j >= k neither loaded nor compared),
// keeping for each channel only the running first argmax of max(y, 0): its
// bits as an integer key (negative y and -0 below every key of y >= 0), z
// there, and whether y of row 0 is 0 (the argmax where every y <= 0). Then
// one contribution a column: dy = ReLU-VJP(rnd(dtap), y_am), S1 += dy,
// S2 += dy zhat(z_am). bf16 forms y two channels at a time
// (sub/mul/add.rn.bf16x2: each a single rounding of the exact result, the
// float32 operation then the rounding to bf16 of the plain version, bit for
// bit); float32 with __fsub_rn/__fmul_rn/__fadd_rn. The BN constants come
// from the statistics in the kernel (bn_stats). A persistent grid of one
// block an SM (ops/cuda_dgcnn_bwd.py:reduce_plan) walks the points in (b, n)
// order, block i the range [i P / G, (i + 1) P / G); the block adds its
// threads' sums in thread order into one partial, and the last block to
// finish (an integer ticket, reset by that block) adds the partials in block
// order. No float atomics: two launches give the same bits.
#define RED_NT 512                 // threads of a reduce block
#define RED_W (RED_NT / 32)
#define RED_CH 8                   // adjacent channels a thread

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// y = BN(z) of two bf16 channels, a rounding to bf16 after each operation
__device__ __forceinline__ uint32_t bn_y2(uint32_t z, uint32_t m, uint32_t s, uint32_t b) {
  uint32_t y;
  asm("{\n\t.reg .b32 t;\n\t"
      "sub.rn.bf16x2 t, %1, %2;\n\t"
      "mul.rn.bf16x2 t, t, %3;\n\t"
      "add.rn.bf16x2 %0, t, %4;\n\t}"
      : "=r"(y) : "r"(z), "r"(m), "r"(s), "r"(b));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, int C, bool PAD>
__global__ void __launch_bounds__(RED_NT, 1)
reduce_kernel(const T* __restrict__ z, const T* __restrict__ dtap,
              const float* __restrict__ mean, const float* __restrict__ var,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              float* __restrict__ part, unsigned* __restrict__ ticket,
              float* __restrict__ s, int B, int N, int k, int tstride) {
  if constexpr (!PAD) k = KP;   // no padded row: the guards fold
  constexpr bool BF = sizeof(T) == 2;
  constexpr int TPP = C / RED_CH;            // threads a point
  constexpr int PPW = 32 / TPP;              // points a warp takes at once
  constexpr int V = BF ? 1 : 2;              // 16-byte loads a row
  constexpr int U = KP < (BF ? 10 : 4) ? KP : (BF ? 10 : 4);   // rows in flight
  constexpr int L = 2 * C, SL = RED_NT / L;  // outputs; slices of the last sum
  static_assert(RED_NT % L == 0 && 32 % TPP == 0, "shapes");
  __shared__ float red[RED_NT][2 * RED_CH + 1];
  __shared__ float2 szh[C];                  // (mean, inv) of each channel
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = RED_CH * (lane % TPP);

  for (int c = tid; c < C; c += RED_NT) {
    const BnC k = bn_stats<T>(mean, var, gamma, beta, c);
    szh[c] = make_float2(k.mean, k.inv);
  }
  float mt[RED_CH], st[RED_CH], bt[RED_CH];
  uint32_t m2[RED_CH / 2], s2[RED_CH / 2], b2[RED_CH / 2];
#pragma unroll
  for (int e = 0; e < RED_CH; ++e) {
    const BnC k = bn_stats<T>(mean, var, gamma, beta, c0 + e);
    mt[e] = k.mean_t; st[e] = k.scale_t; bt[e] = k.beta_t;
  }
#pragma unroll
  for (int q = 0; q < RED_CH / 2; ++q) {
    m2[q] = pack2(mt[2 * q], mt[2 * q + 1]);
    s2[q] = pack2(st[2 * q], st[2 * q + 1]);
    b2[q] = pack2(bt[2 * q], bt[2 * q + 1]);
  }
  __syncthreads();

  float a1[RED_CH], a2[RED_CH];
#pragma unroll
  for (int e = 0; e < RED_CH; ++e) a1[e] = a2[e] = 0.f;
  const int P = B * N;
  const int p0 = (int)((long long)P * blockIdx.x / gridDim.x);
  const int p1 = (int)((long long)P * (blockIdx.x + 1) / gridDim.x);
  const size_t rstride = (size_t)N * C;      // elements from row j to j + 1
  for (int p = p0 + warp * PPW + lane / TPP; p < p1; p += RED_W * PPW) {
    const int b = p / N, n = p - b * N;
    const T* zp = z + ((size_t)b * k * N + n) * C + c0;
    uint4 tap[V];
#pragma unroll
    for (int h = 0; h < V; ++h)
      tap[h] = ld_stream(reinterpret_cast<const uint4*>(dtap + (size_t)p * tstride + c0) + h);
    int best[RED_CH];
    uint32_t zam[RED_CH];      // the word holding z at the argmax
    unsigned zero0 = 0;        // bit e: y of row 0 is 0
#pragma unroll
    for (int j0 = 0; j0 < KP; j0 += U) {
      if (j0 >= k) break;
      uint4 v[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < V; ++h)
          v[u][h] = j0 + u < k
                        ? ld_stream(reinterpret_cast<const uint4*>(zp + (j0 + u) * rstride) + h)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        if (j >= k) break;
#pragma unroll
        for (int e = 0; e < RED_CH; ++e) {
          uint32_t w;
          int key;
          if constexpr (BF) {
            w = word(v[u][0], e / 2);
            const uint32_t y = bn_y2(w, m2[e / 2], s2[e / 2], b2[e / 2]);
            key = (int)(e % 2 ? y & 0xffff0000u : y << 16);
          } else {
            w = word(v[u][e / 4], e % 4);
            key = __float_as_int(bn_y<float>(__uint_as_float(w), BnC(mt[e], st[e], bt[e])));
          }
          if (j == 0) {
            best[e] = max(key, 0);
            zam[e] = w;
            zero0 |= (key & 0x7fffffff) == 0 ? 1u << e : 0u;
          } else if (key > best[e]) {
            best[e] = key;
            zam[e] = w;
          }
        }
      }
    }
    // one contribution a column
#pragma unroll
    for (int e = 0; e < RED_CH; ++e) {
      float zf, g;
      if constexpr (BF) {
        zf = __uint_as_float(e % 2 ? zam[e] & 0xffff0000u : zam[e] << 16);
        const uint32_t tw = word(tap[0], e / 2);
        g = __uint_as_float(e % 2 ? tw & 0xffff0000u : tw << 16);
      } else {
        zf = __uint_as_float(zam[e]);
        g = __uint_as_float(word(tap[e / 4], e % 4));
      }
      const float dh = rnd<T>(__fadd_rn(g, 0.f));
      const float dy = best[e] > 0 ? dh : (zero0 >> e & 1u) ? rnd<T>(__fmul_rn(0.5f, dh)) : 0.f;
      const float2 k = szh[c0 + e];
      a1[e] = __fadd_rn(a1[e], dy);
      a2[e] = __fadd_rn(a2[e], __fmul_rn(dy, __fmul_rn(__fsub_rn(zf, k.x), k.y)));
    }
  }

  // the block's partial: each channel's threads in thread order
#pragma unroll
  for (int e = 0; e < RED_CH; ++e) {
    red[tid][e] = a1[e];
    red[tid][RED_CH + e] = a2[e];
  }
  __syncthreads();
  if (tid < L) {
    const int which = tid / C, ch = tid % C, g = ch / RED_CH, e = ch % RED_CH;
    float v = 0.f;
    for (int w = 0; w < RED_W; ++w)
#pragma unroll
      for (int q = 0; q < PPW; ++q)
        v = __fadd_rn(v, red[w * 32 + q * TPP + g][which * RED_CH + e]);
    part[(size_t)blockIdx.x * L + tid] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: the partials in block order, SL slices of them at once
  __threadfence();
  {
    const int o = tid % L, k = tid / L, G = gridDim.x;
    float v = 0.f;
#pragma unroll 8
    for (int gg = G * k / SL; gg < G * (k + 1) / SL; ++gg)
      v = __fadd_rn(v, __ldcg(part + (size_t)gg * L + o));
    red[tid][0] = v;
  }
  __syncthreads();
  if (tid < L) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < SL; ++k) v = __fadd_rn(v, red[k * L + tid][0]);
    s[tid] = v;
  }
  if (tid == 0) *ticket = 0u;
}

// dscat[b][p] = sum of dneigh[b][s] over the rows s = j N + n with
// idx[b][n][j] == p, in ascending s order, from idx^T (B, k, N): s runs
// along memory. Block (r, b) owns the points [r SCAT_P, (r + 1) SCAT_P) of
// cloud b and builds the inverse of idx for them alone in shared memory,
// already in s order, with no sort: warp w takes the rows of its contiguous
// share of s, 32 at a time;
//  1. counts, for each point, its rows in each warp's share (cw[w][p]);
//  2. the lists' offsets: the prefix over the points of their counts, and
//     within a point over the warps in order;
//  3. fills each point's list: within 32 rows in s order by lane (the rank
//     among the lanes of the same point, __match_any_sync), then the next
//     32, then the next warp's share;
//  4. one thread a point adds its rows in s order, SCAT_U loads in flight.
// The sums are those of a scan of the rows in order: the same bits on every
// launch, and the order of the CPU's index_add_.
#define SCAT_P 256       // points of a block
#define SCAT_NT 512      // threads of a block
#define SCAT_W (SCAT_NT / 32)
#define SCAT_U 8         // loads a thread keeps in flight
__global__ void __launch_bounds__(SCAT_NT)
scatter_kernel(const int* __restrict__ idxT, const float* __restrict__ dneigh,
               float* __restrict__ dscat, int N, int k) {
  extern __shared__ int sm[];
  int* cw = sm;                      // [SCAT_W][SCAT_P] counts, then cursors
  int* off = cw + SCAT_W * SCAT_P;   // [SCAT_P] start of each point's list
  int* tot = off + SCAT_P;           // [SCAT_P] length of each point's list
  int* wsum = tot + SCAT_P;          // [SCAT_W] the scan's warp totals
  int* rows = wsum + SCAT_W;         // (at most k N) the lists
  const size_t b = blockIdx.y;
  const int p0 = blockIdx.x * SCAT_P, np = min(SCAT_P, N - p0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* ib = idxT + b * k * N;
  const int S = k * N, share = (S + SCAT_W * 32 - 1) / (SCAT_W * 32) * 32;
  const int s_lo = min(S, warp * share), s_hi = min(S, s_lo + share);
  for (int i = tid; i < SCAT_W * SCAT_P; i += SCAT_NT) cw[i] = 0;
  __syncthreads();
  // 1. counts; SCAT_U rows of the warp's share a lane in flight
  for (int s0 = s_lo; s0 < s_hi; s0 += 32 * SCAT_U) {
    int p[SCAT_U];
#pragma unroll
    for (int u = 0; u < SCAT_U; ++u) {
      const int s = s0 + 32 * u + lane;
      p[u] = s < s_hi ? __ldg(ib + s) - p0 : -1;
    }
#pragma unroll
    for (int u = 0; u < SCAT_U; ++u)
      if ((unsigned)p[u] < (unsigned)np) atomicAdd(&cw[warp * SCAT_P + p[u]], 1);
  }
  __syncthreads();
  // 2. offsets: the totals' exclusive prefix over the points (a warp scan,
  //    then the warps' totals), then the warps' cursors within a point
  if (tid < SCAT_P) {
    int t = 0;
    for (int w = 0; w < SCAT_W; ++w) t += cw[w * SCAT_P + tid];
    tot[tid] = t;
    int incl = t;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += v;
    }
    off[tid] = incl - t;
    if (lane == 31) wsum[warp] = incl;
  }
  __syncthreads();
  if (tid < SCAT_P) {
    int base = off[tid];
    for (int w = 0; w < warp; ++w) base += wsum[w];
    off[tid] = base;
    for (int w = 0; w < SCAT_W; ++w) {
      const int c = cw[w * SCAT_P + tid];
      cw[w * SCAT_P + tid] = base;
      base += c;
    }
  }
  __syncthreads();
  // 3. the lists, in s order
  for (int s0 = s_lo; s0 < s_hi; s0 += 32 * SCAT_U) {
    int p[SCAT_U];
#pragma unroll
    for (int u = 0; u < SCAT_U; ++u) {
      const int s = s0 + 32 * u + lane;
      p[u] = s < s_hi ? __ldg(ib + s) - p0 : -1;
    }
#pragma unroll
    for (int u = 0; u < SCAT_U; ++u) {
      const bool in = (unsigned)p[u] < (unsigned)np;
      const unsigned same = __match_any_sync(FULL_MASK, in ? p[u] : -1);
      if (in) {
        const int at = cw[warp * SCAT_P + p[u]] + __popc(same & ((1u << lane) - 1u));
        rows[at] = s0 + 32 * u + lane;
      }
      __syncwarp();
      if (in && lane == __ffs(same) - 1) cw[warp * SCAT_P + p[u]] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
  // 4. the sums
  if (tid < np) {
    const float* dn = dneigh + b * k * N * 3;
    const int* l = rows + off[tid];
    const int c = tot[tid];
    float x = 0.f, y = 0.f, zz = 0.f;
    int a = 0;
    for (; a + SCAT_U <= c; a += SCAT_U) {
      float v[SCAT_U][3];
#pragma unroll
      for (int u = 0; u < SCAT_U; ++u)
#pragma unroll
        for (int d = 0; d < 3; ++d) v[u][d] = dn[(size_t)l[a + u] * 3 + d];
#pragma unroll
      for (int u = 0; u < SCAT_U; ++u) {
        x = __fadd_rn(x, v[u][0]);
        y = __fadd_rn(y, v[u][1]);
        zz = __fadd_rn(zz, v[u][2]);
      }
    }
    for (; a < c; ++a) {
      const float* d = dn + (size_t)l[a] * 3;
      x = __fadd_rn(x, d[0]);
      y = __fadd_rn(y, d[1]);
      zz = __fadd_rn(zz, d[2]);
    }
    float* o = dscat + (b * N + p0 + tid) * 3;
    o[0] = x; o[1] = y; o[2] = zz;
  }
}

static cudaError_t launch_scatter(const int* idxT, const float* dneigh, float* dscat,
                                  int B, int N, int k, cudaStream_t st) {
  const size_t bytes =
      sizeof(int) * ((SCAT_W + 2) * SCAT_P + SCAT_W + (size_t)k * N);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  scatter_kernel<<<dim3((N + SCAT_P - 1) / SCAT_P, B), SCAT_NT, bytes, st>>>(
      idxT, dneigh, dscat, N, k);
  return cudaGetLastError();
}

// ------------------------------------------- bf16 stage kernel, one pass (wgmma)
//
// stage_wgmma_kernel: bwd_stage for bf16 in one pass, as the TPU kernel does
// (dW_i accumulated from the tiles the row pass already holds). A persistent
// grid of at most WBLOCKS blocks, one an SM, each walking an equal contiguous
// share of the tiles (WTN points of KP rows, WROWS rows r = j WTN + t: 80 in
// the class of k = 20; WTN from the class, so that a tile keeps at most 80
// rows, a multiple of wgmma's k16, as stage 4's buffers need). Per block:
//  - W_i (C_in, C) and W_{i+1} (C, C_next), float32, are rounded to bf16 and
//    loaded once into shared memory as K-major panels (128-byte swizzle) for
//    the block's lifetime; the BN constants are formed from the float32 batch
//    statistics with the operations of the plain version (bn_stats), so that
//    the wrapper launches no PyTorch operation;
//  - a tile's z_i, z_{i-1} and dz_{i+1} arrive by TMA, each 64-channel panel
//    one box (64 channels, WTN points, KP neighbours of one cloud: tile_load),
//    rows past N and past k as zeros; the next tile's boxes are in flight (a
//    ring of two buffers on mbarriers) while this one is computed;
//  - extra^T = W_{i+1} dz_{i+1}^T and dh_{i-1}^T = W_i dz_i^T are m64nRNk16
//    wgmma (the weights as A, half the tile's rows as N: RN = 40 at k = 20),
//    rounded to bf16 into a row-major scratch tile;
//  - the element work is WL lanes a (point, channel) column (a pair at
//    k = 20), WROWS / 8 of its rows each (rows_a_lane), reading the swizzled
//    panels: h recomputed with the forward's rounding, the first argmax over
//    the rows j < k (the lanes' maxima combined by shuffles), dz_i (written
//    over z_i in place, 0 on the rows past N or k, then stored by TMA, which
//    drops those rows), and for the stage below dy_{i-1}, its sums and
//    h_{i-1} (written over z_{i-1} in place, 0 on the same rows); a column's
//    tap cotangent is loaded before its first pass, so that the load's
//    latency runs under it;
//  - dW_i += h_{i-1}^T dz_i: wgmma with both operands MN-major straight from
//    those panels (K = the tile's rows), the accumulators held in
//    registers across the block's tiles: (C_in / 64) (C / min(C, 128)) jobs of
//    m64 x min(C, 128), one a warpgroup.
// At the end each block writes its float32 dW_i and S_{i-1} partials;
// sum_parts_kernel adds them in block order (no float atomics).
// Bound: bytes (one backward's three calls at B=24, N=717 move about 1.06 GB:
// 0.32 ms at 3.35 TB/s; their products take 0.09 ms at the tensor cores'
// rate). What holds it from the bound: the element work on the CUDA cores,
// with 16 warps an SM (512 threads, 128 registers each, some spilled beside
// stage 4's 64 accumulator registers a thread), and each tile's five phases
// in turn behind block-wide barriers. Tried and dropped (probe builds,
// timed on the card): row products of 80 rows a job (more spills), the
// stage 3/2 weight gradient's k steps shared by the four warpgroups, the
// weight-gradient products left running into the next tile, the taps of a
// whole tile loaded at its start (more spills): none faster.

// points of a bf16 (and float32 edge) tile: 80 rows or fewer, a multiple of
// 16 (ops/cuda_dgcnn_bwd.py:tile_points)
constexpr int WTN = KP <= 8 ? 8 : KP <= 20 ? 4 : 2;
constexpr int WROWS = KP * WTN;     // rows a tile: 80 at k = 20
#define WTHREADS 512           // four warpgroups
#define WBLOCKS 132            // the persistent grid: one block an SM of an H100
constexpr int PANEL = WROWS * 128;  // bytes of a tile's 64-channel panel
constexpr int RN = WROWS / 2;       // tile rows a row product's job takes
static_assert(WROWS % 16 == 0 && WROWS <= 80 && 8 % WTN == 0, "bf16 tiles");

// A tile's box of a stage tensor, channels [c0, c0 + box), points [n0, n0 +
// WTN) of cloud b: with padded rows (PAD) a 4-D box (channels, WTN points, KP
// rows, one cloud) whose rows past k TMA zero-fills on load and drops on
// store; for k = KP the 3-D box (channels, WTN points, KP rows) over the
// (C, N, B KP) view (stage_map builds the map of either)
template <bool PAD>
__device__ __forceinline__ void tile_load(uint32_t dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int n0, int b) {
  if constexpr (PAD) tma_load_4d(dst, map, bar, c0, n0, 0, b);
  else tma_load_3d(dst, map, bar, c0, n0, b * KP);
}

template <bool PAD>
__device__ __forceinline__ void tile_store(const CUtensorMap* map, uint32_t src, int c0,
                                           int n0, int b) {
  if constexpr (PAD) tma_store_4d(map, src, c0, n0, 0, b);
  else tma_store_3d(map, src, c0, n0, b * KP);
}

// lanes a (point, channel) column of C channels in the element work: at
// most 8 / WTN (a lane's rows then lie 8 rows apart), and few enough that
// each thread keeps one channel over its passes
template <int C>
__host__ __device__ constexpr int column_lanes() {
  return 8 / WTN < WTHREADS / C ? 8 / WTN : WTHREADS / C;
}

typedef __nv_bfloat16 bf16;

// the float32 batch statistics (mean, var, gamma, beta) of stage i, then of
// stage i-1, passed by value
struct BatchStats {
  const float* p[8];
};

template <int C, int CIN, int CN>
struct StagePlan {
  static constexpr int Z = (C / 64) * PANEL, ZP = (CIN / 64) * PANEL,
                       DZN = (CN / 64) * PANEL;
  static constexpr int BUF = Z + ZP + DZN;         // one tile's inputs
  static constexpr int W = CIN * C * 2;            // W_i: C / 64 panels of CIN rows
  static constexpr int WN = C * CN * 2;            // W_{i+1}: CN / 64 panels of C rows
  // the scratch tile E: extra (WROWS x C) then dh_{i-1} (WROWS x CIN), bf16, rows
  // padded; it lives in the dz_{i+1} panels (dead once extra is formed), or
  // beside the buffers for the last stage
  static constexpr int E_LD1 = C + 8, E_LD2 = CIN + 8;
  static constexpr int E = CN > 0 ? 0 : (WROWS * E_LD2 * 2 + 1023) / 1024 * 1024;
  static constexpr int SMEM = 2 * BUF + W + WN + E + 1024;
  static_assert(CN == 0 || WROWS * (C > CIN ? E_LD1 : E_LD2) * 2 <= DZN, "E in dz_{i+1}");
  static_assert(SMEM <= 232448, "shared memory");
};

// one (rows x K) float32 matrix, K contiguous, rounded to bf16 (as
// `.to(torch.bfloat16)`) into K-major swizzled panels of `rows` rows each
__device__ __forceinline__ void load_panels(unsigned char* dst, const float* __restrict__ src,
                                            int rows, int K) {
  for (int e = threadIdx.x; e < rows * K / 8; e += WTHREADS) {
    const int r = e / (K / 8), q = e % (K / 8);
    const float4 a = *reinterpret_cast<const float4*>(src + (size_t)r * K + q * 8);
    const float4 b = *reinterpret_cast<const float4*>(src + (size_t)r * K + q * 8 + 4);
    __nv_bfloat162 v[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                           __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
    *reinterpret_cast<uint4*>(dst + (q / 8) * (rows * 128) + sw128_offset(r, (q % 8) * 8)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The element work: WL lanes a (point t, channel ch) column, lane h holding
// rows j = WL i + h (i < KP / WL). Row r = WTN j + t of a tile is then
// RS i + WTN h + t with RS = WTN WL rows: at RS = 8 (a pair of lanes at
// k = 20: 8 i + 4 h + t) the lane's rows lie at one pointer plus 1024 i, at
// RS = 4 at two (even and odd i) plus 1024 (i / 2): constant offsets once
// the loop over i unrolls (pointers, so that they fold into the loads).
template <int WL>
struct LaneRows {
  static constexpr int RS = WTN * WL;
  static_assert(RS == 8 || RS == 4, "a lane's rows");
  unsigned char* even;
  unsigned char* odd;
  __device__ __forceinline__ LaneRows(unsigned char* Zp, int t, int ch, int h)
      : even(Zp + (ch / 64) * PANEL + sw128_offset(WTN * h + t, ch % 64)),
        odd(RS == 8 ? even : Zp + (ch / 64) * PANEL + sw128_offset(WTN * h + t + 4, ch % 64)) {}
  __device__ __forceinline__ unsigned char* operator()(int i) const {
    if constexpr (RS == 8) return even + i * 1024;
    return (i & 1 ? odd : even) + (i >> 1) * 1024;
  }
};

// the first maximum of a column from its G lanes' (best, j), G a power of
// two, lanes of a column adjacent: the larger value, the lower j on a tie
template <int G>
__device__ __forceinline__ int group_argmax(float best, int am) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, am, o);
    if (ob > best || (ob == best && oa < am)) {
      best = ob;
      am = oa;
    }
  }
  return am;
}

// whether row j of a point is real: j < k, or every row where none pads (a
// constant, so that the kernels built for k = KP carry no guard)
template <bool PAD>
__device__ __forceinline__ bool real_row(int j, int k) { return !PAD || j < k; }

// The element work of a stage: dz over the tile's z panels at Zp, in place,
// WL = column_lanes<C>() lanes a (point t, channel c) column (c and the lane
// h = tid % WL fixed for the thread): h recomputed with the forward's
// rounding, the first argmax over the rows j < k, dh = extra (E, rows of
// ELD; none where ELD is 0) plus the tap's cotangent at the argmax, dy, dz;
// rows past N or k get 0. A column's tap cotangent is loaded before its
// first pass, so that the load's latency runs under it.
template <int C, int ELD, bool PAD>
__device__ __forceinline__ void dz_columns(unsigned char* Zp, const bf16* E,
                                           const bf16* __restrict__ dtap, int b, int n0,
                                           int N, int k, int c, int h, const BnC& kc,
                                           float a1, float a2) {
  constexpr int WL = column_lanes<C>();
  for (int e = threadIdx.x / WL; e < WTN * C; e += WTHREADS / WL) {
    const int t = e / C, n = n0 + t;
    const float tap = n < N ? __bfloat162float(dtap[((size_t)b * N + n) * C + c]) : 0.f;
    const LaneRows<WL> rows(Zp, t, c, h);
    float y[KP / WL], best = -1.f;
    int am = 0;
#pragma unroll
    for (int i = 0; i < KP / WL; ++i) {
      const int j = WL * i + h;
      y[i] = bn_y<bf16>(__bfloat162float(*reinterpret_cast<const bf16*>(rows(i))), kc);
      const float hv = fmaxf(y[i], 0.f);
      if (real_row<PAD>(j, k) && hv > best) { best = hv; am = j; }
    }
    am = group_argmax<WL>(best, am);
#pragma unroll
    for (int i = 0; i < KP / WL; ++i) {
      const int j = WL * i + h;
      unsigned char* zr = rows(i);
      float dh = ELD > 0 ? __bfloat162float(E[(j * WTN + t) * ELD + c]) : 0.f;
      if (j == am) dh = rnd<bf16>(__fadd_rn(tap, dh));
      const float dy = relu_vjp<bf16>(dh, y[i]);
      const float d = __fmul_rn(kc.ig, __fsub_rn(__fsub_rn(dy, a1), __fmul_rn(zhat(__bfloat162float(*reinterpret_cast<const bf16*>(zr)), kc), a2)));
      *reinterpret_cast<bf16*>(zr) = __float2bfloat16(n < N && real_row<PAD>(j, k) ? d : 0.f);
    }
  }
}

// m64nNRk16 with both operands K-major, NR = RN the tile rows of a job
template <int NR>
__device__ __forceinline__ void wgmma_rows(float (&d)[NR / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  static_assert(NR == 16 || NR == 24 || NR == 32 || NR == 40, "a job's rows");
  if constexpr (NR == 40) wgmma_ss_n40<0, 0>(d, da, db, scale_d);
  else if constexpr (NR == 32) wgmma_ss_n32<0, 0>(d, da, db, scale_d);
  else if constexpr (NR == 24) wgmma_ss_n24<0, 0>(d, da, db, scale_d);
  else wgmma_ss_n16<0, 0>(d, da, db, scale_d);
}

// d (the tile's rows as N) of A (64 x K, K-major panels of `arows` rows,
// m-tile mt) times the rows [RN nh, RN nh + RN) of a tile's K-major panels
template <int K>
__device__ __forceinline__ void rows_product(float (&d)[RN / 2], uint32_t a, int arows, int mt,
                                             uint32_t b, int nh) {
  wgmma_fence();
  fence_acc(d);
#pragma unroll
  for (int kq = 0; kq < K / 16; ++kq) {
    const uint64_t da = desc_k(a + (kq / 4) * (arows * 128) + mt * 64 * 128 + (kq % 4) * 32);
    const uint64_t db = desc_k(b + (kq / 4) * PANEL + nh * RN * 128 + (kq % 4) * 32);
    wgmma_rows<RN>(d, da, db, kq > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
}

// the rounded product into E[r][ch]: d[4 j + e] is channel 64 mt + 16 warp
// + g + 8 (e / 2), row RN nh + 8 j + 2 t + e % 2
__device__ __forceinline__ void rows_store(const float (&d)[RN / 2], bf16* E, int ld, int mt, int nh) {
  const int warp = (threadIdx.x / 32) % 4, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < RN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      E[(nh * RN + 8 * j + 2 * t + (e & 1)) * ld + mt * 64 + warp * 16 + g + 8 * (e >> 1)] =
          __float2bfloat16(d[4 * j + e]);
}

template <int DWN>
__device__ __forceinline__ void dw_product(float (&d)[DWN / 2], uint64_t da, uint64_t db) {
  if constexpr (DWN == 128) wgmma_ss_n128<1, 1>(d, da, db, 1);
  else wgmma_ss_n64<1, 1>(d, da, db, 1);
}

template <int C, int CIN, int CN, bool PAD>
__global__ void __launch_bounds__(WTHREADS, 1)
stage_wgmma_kernel(const __grid_constant__ CUtensorMap zmap,
                   const __grid_constant__ CUtensorMap zpmap,
                   const __grid_constant__ CUtensorMap dznmap,
                   const __grid_constant__ CUtensorMap dzmap,
                   const bf16* __restrict__ dtap, const BatchStats st,
                   const float* __restrict__ s12, const float* __restrict__ wn,
                   const float* __restrict__ w, const bf16* __restrict__ dtapp,
                   float* __restrict__ part_s, float* __restrict__ part_w, int B, int N,
                   int k) {
  if constexpr (!PAD) k = KP;   // no padded row: the guards fold
  typedef StagePlan<C, CIN, CN> P;
  constexpr int DWN = C < 128 ? C : 128, DW_JOBS = (CIN / 64) * (C / DWN);
  constexpr int WLP = column_lanes<CIN>();
  static_assert(DW_JOBS <= 4, "widths");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  unsigned char* Wp = base + 2 * P::BUF;
  unsigned char* WNp = Wp + P::W;
  const uint32_t Ws = sbase + 2 * P::BUF, WNs = Ws + P::W;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int ntn = (N + WTN - 1) / WTN, T = B * ntn;
  const int tile0 = (int)((long long)blockIdx.x * T / gridDim.x);
  const int tile1 = (int)((long long)(blockIdx.x + 1) * T / gridDim.x);
  const float m = (float)B * k * N;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
  }
  load_panels(Wp, w, CIN, C);
  if constexpr (CN > 0) load_panels(WNp, wn, C, CN);
  fence_proxy_async();   // the weights are wgmma operands
  __syncthreads();

  auto issue = [&](int tile, int s) {
    const int b = tile / ntn, n0 = (tile % ntn) * WTN;
    const uint32_t dst = sbase + s * P::BUF;
    mbar_expect_tx(&full[s], P::BUF);
#pragma unroll
    for (int p = 0; p < C / 64; ++p)
      tile_load<PAD>(dst + p * PANEL, &zmap, &full[s], 64 * p, n0, b);
#pragma unroll
    for (int p = 0; p < CIN / 64; ++p)
      tile_load<PAD>(dst + P::Z + p * PANEL, &zpmap, &full[s], 64 * p, n0, b);
#pragma unroll
    for (int p = 0; p < CN / 64; ++p)
      tile_load<PAD>(dst + P::Z + P::ZP + p * PANEL, &dznmap, &full[s], 64 * p, n0, b);
  };
  if (tid == 0 && tile0 < tile1) issue(tile0, 0);

  // the channels of this lane's columns are fixed (column_lanes), and its
  // lane of them (hp for stage i-1)
  const int c = (tid / column_lanes<C>()) % C, h = tid % column_lanes<C>();
  const int cp = (tid / WLP) % CIN, hp = tid % WLP;
  const BnC kc = bn_stats<bf16>(st.p[0], st.p[1], st.p[2], st.p[3], c);
  const BnC kp = bn_stats<bf16>(st.p[4], st.p[5], st.p[6], st.p[7], cp);
  const float a1 = __fdiv_rn(s12[c], m), a2 = __fdiv_rn(s12[C + c], m);
  float s1 = 0.f, s2 = 0.f;
  float dw[DWN / 2];
#pragma unroll
  for (int i = 0; i < DWN / 2; ++i) dw[i] = 0.f;
  const int dw_m = wg / (C / DWN), dw_n = (wg % (C / DWN)) * DWN;

  int s = 0;
  uint32_t ph = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int b = tile / ntn, n0 = (tile % ntn) * WTN;
    unsigned char* Zp = base + s * P::BUF;
    unsigned char* ZPp = Zp + P::Z;
    const uint32_t Zs = sbase + s * P::BUF, ZPs = Zs + P::Z, DZNs = ZPs + P::ZP;
    bf16* E = reinterpret_cast<bf16*>(CN > 0 ? ZPp + P::ZP : WNp + P::WN);
    mbar_wait(&full[s], ph);
    if (tid == 0 && tile + 1 < tile1) {
      tma_store_wait_read();   // tile - 1's dz store has read the other buffer
      issue(tile + 1, s ^ 1);
    }

    // 1. extra^T = W_{i+1} dz_{i+1}^T, rounded to bf16: E[r][c]
    constexpr int NH = WROWS / RN;   // jobs of a row product: (m-tile, rows)
    if constexpr (CN > 0) {
      float d[RN / 2];
      const int mt = wg / NH, nh = wg % NH;
      if (wg < NH * (C / 64)) rows_product<CN>(d, WNs, C, mt, DZNs, nh);
      __syncthreads();   // every warpgroup is done with dz_{i+1}: E overwrites it
      if (wg < NH * (C / 64)) rows_store(d, E, P::E_LD1, mt, nh);
      __syncthreads();
    }

    // 2. stage i: dz_i over z_i
    dz_columns<C, (CN > 0 ? P::E_LD1 : 0), PAD>(Zp, E, dtap, b, n0, N, k, c, h, kc, a1, a2);
    fence_proxy_async();   // dz_i is read by TMA and wgmma next
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < C / 64; ++p) tile_store<PAD>(&dzmap, Zs + p * PANEL, 64 * p, n0, b);
      tma_store_commit();
    }

    // 3. dh_{i-1}^T = W_i dz_i^T, rounded to bf16: E[r][cin]
    if (wg < NH * (CIN / 64)) {
      float d[RN / 2];
      rows_product<C>(d, Ws, CIN, wg / NH, Zs, wg % NH);
      rows_store(d, E, P::E_LD2, wg / NH, wg % NH);
    }
    __syncthreads();

    // 4. stage i-1: dy_{i-1}, its sums, h_{i-1} over z_{i-1}
    for (int e = tid / WLP; e < WTN * CIN; e += WTHREADS / WLP) {
      const int t = e / CIN, n = n0 + t;
      const float tap = n < N ? __bfloat162float(dtapp[((size_t)b * N + n) * CIN + cp]) : 0.f;
      const LaneRows<WLP> rows(ZPp, t, cp, hp);
      float y[KP / WLP], best = -1.f;
      int am = 0;
#pragma unroll
      for (int i = 0; i < KP / WLP; ++i) {
        const int j = WLP * i + hp;
        y[i] = bn_y<bf16>(__bfloat162float(*reinterpret_cast<const bf16*>(rows(i))), kp);
        const float hv = fmaxf(y[i], 0.f);
        if (real_row<PAD>(j, k) && hv > best) { best = hv; am = j; }
      }
      am = group_argmax<WLP>(best, am);
#pragma unroll
      for (int i = 0; i < KP / WLP; ++i) {
        const int j = WLP * i + hp;
        unsigned char* zr = rows(i);
        float dh = __bfloat162float(E[(j * WTN + t) * P::E_LD2 + cp]);
        if (j == am) dh = rnd<bf16>(__fadd_rn(tap, dh));
        const float dy = relu_vjp<bf16>(dh, y[i]);
        const bool real = n < N && real_row<PAD>(j, k);
        if (real) {
          s1 = __fadd_rn(s1, dy);
          s2 = __fadd_rn(s2, __fmul_rn(dy, zhat(__bfloat162float(*reinterpret_cast<const bf16*>(zr)), kp)));
        }
        *reinterpret_cast<bf16*>(zr) = __float2bfloat16(real ? fmaxf(y[i], 0.f) : 0.f);
      }
    }
    fence_proxy_async();   // h_{i-1} is read by wgmma next
    __syncthreads();

    // 5. dW_i += h_{i-1}^T dz_i over the tile's rows, MN-major operands
    if (wg < DW_JOBS) {
      wgmma_fence();
      fence_acc(dw);
#pragma unroll
      for (int kq = 0; kq < WROWS / 16; ++kq)
        dw_product<DWN>(dw, desc_mn(ZPs + dw_m * PANEL + kq * 2048, PANEL),
                        desc_mn(Zs + (dw_n / 64) * PANEL + kq * 2048, PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dw);
    }
    __syncthreads();   // the buffers are free for the tile after next
    s ^= 1;
    if (s == 0) ph ^= 1u;
  }

  // the block's partials: dW_i from the accumulators, the sums in thread order
  if (wg < DW_JOBS) {
    const int warp = (tid / 32) % 4, g = lane / 4, t = lane % 4;
    float* pw = part_w + (size_t)blockIdx.x * CIN * C;
#pragma unroll
    for (int j = 0; j < DWN / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = dw_m * 64 + warp * 16 + g + 8 * u, col = dw_n + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(pw + (size_t)i * C + col) = make_float2(dw[4 * j + 2 * u], dw[4 * j + 2 * u + 1]);
      }
  }
  float* RED = reinterpret_cast<float*>(Wp);   // the weights are no longer read
  RED[tid] = s1;
  RED[WTHREADS + tid] = s2;
  __syncthreads();
  if (tid < CIN) {   // the lanes of channel tid: WLP (tid + CIN q) + h, in order
    float u = 0.f, v = 0.f;
    for (int q = WLP * tid; q < WTHREADS; q += WLP * CIN)
      for (int x = q; x < q + WLP; ++x) { u = __fadd_rn(u, RED[x]); v = __fadd_rn(v, RED[WTHREADS + x]); }
    part_s[(size_t)blockIdx.x * 2 * CIN + tid] = u;
    part_s[(size_t)blockIdx.x * 2 * CIN + CIN + tid] = v;
  }
  if (tid == 0) tma_store_wait();
}

// ---------------------------- float32 stage kernel, one pass (mma.sync, 3xTF32)
//
// stage_tf32_kernel: bwd_stage for float32 in one pass, on the frame of
// stage_wgmma_kernel (a persistent grid of at most WBLOCKS blocks, one an
// SM, each walking an equal contiguous share of the tiles; the weight
// gradient held in registers across a block's tiles; one partial of dW_i and
// of S_{i-1} a block, added in block order by sum_parts_kernel), with each
// product on the tensor cores as three TF32 products (tf32.cuh: a_lo b_hi +
// a_hi b_lo + a_hi b_hi, about 2^-22 of it from float32) on mma.sync
// m16n8k8, every operand split in registers. Why not wgmma: TF32 wgmma
// reads B only K-major from shared memory, and the weight gradient's depth
// is the tile's rows, so h_{i-1} or dz_i would have to be staged transposed
// and split into high and low planes; and float32 doubles every buffer:
// W_4 alone is 128 KB, its two planes 256 KB, beyond a block's 227 KB. mma.sync
// reads each operand from wherever a lane finds it: the weights straight
// from device memory (the L2 holds them; each block reads each weight
// element once a tile), the tile's rows from shared memory in either
// orientation. Per block:
//  - a tile of FTN points (2 up to k = 20, 1 above: FROWS = KP FTN rows
//    r = j FTN + t, 40 at k = 20) of z_i, z_{i-1} and dz_{i+1}, and the
//    points' tap cotangents, arrive by bulk copies (one a row j < k of the
//    stage tensors) into rows padded to C + 4 floats (the
//    fragment loads of lanes (g, t), rows t and columns g or the reverse,
//    fall on 32 banks): z_i, z_{i-1} and the taps into the other of two
//    buffers while this tile is computed, dz_{i+1} into its one buffer as
//    soon as the extra cotangent is formed (two of them would not fit
//    beside stage 3's slices). Lanes 0-7 of every warp issue the copies,
//    and store dz_i's rows the same way: 16-byte cp.async from every
//    thread, or bulk copies from warp 0 alone, held every warp at the next
//    barrier. Rows past N or k are not
//    loaded: what they hold enters only those rows, whose dz and h are
//    written as zeros;
//  - extra^T = W_{i+1} dz_{i+1}^T and dh_{i-1}^T = W_i dz_i^T (the weights
//    as A, the tile's rows as B): a warp takes one m-tile of 16 output
//    channels (two in stage 3's extra product: a tile-row fragment split
//    once serves both, where stage 4's 64 weight-gradient registers leave
//    no room) and one K slice of the depth for all the 8-row column tiles,
//    so that each weight fragment is loaded and split once and used five
//    times, the loads two k8 steps ahead of their use (the L2's latency);
//    the slices' partial sums land in E and are added in slice order where
//    the element work reads them;
//  - the element work, 1, 2 or 4 lanes a (point, channel) column (every
//    thread one column; the lanes' first maxima combined by shuffles): h
//    recomputed from z with the forward's rounding (bn_y: a rounding after
//    the subtract, the multiply and the add, no contraction, as eager
//    PyTorch), the first argmax over k, dh = extra plus the tap's cotangent
//    at the argmax (over the rows j < k), dy (half the cotangent at
//    ReLU(0)), dz_i = inv gamma
//    (dy - S1/m - zhat S2/m) (over z_i in place, then stored); for the stage
//    below dy_{i-1}, its sums and h_{i-1} (over z_{i-1} in place);
//  - dW_i += h_{i-1}^T dz_i over the tile's rows (K = FROWS / 8 k8 steps): warp
//    w takes two m-tiles of C_in and a contiguous run of the 8-column tiles
//    of C (each B fragment split once for both), its accumulators in
//    registers across the tiles, added into the block's partial every
//    DW_FLUSH tiles (a float32 chain of 186 tiles a block at k = 32,
//    N = 1024 held the weight gradient at 94% of its error limit).
// Bound: bytes and operations about alike (the three calls at B=24, N=717
// move about 2.2 GB, 0.65 ms at 3.35 TB/s, and take 9.0e10 float32 product
// operations, 0.55 ms as three TF32 products at 495 TFLOP/s); mma.sync TF32
// reached 313-325 TFLOP/s on the card (PERF.md), a floor of 0.86 ms for
// the products. What holds it at 2.9 ms (NVIDIA H100 80GB HBM3, PERF.md,
// PR 23): the row products split every tile-row fragment in each of the
// warps that share it and re-read the weights from L2 every 40-row tile
// (the largest share of a tile's time, well above its tensor work), then
// the weight-gradient product, and five barriers a tile. Tried and
// dropped: dz_i and h_{i-1} written split into TF32 planes (dz_i then went
// out from every thread: slower); a split that leaves lo unrounded (4%
// faster, but its bias doubled the error of the weight gradient's 344,160-
// row sums).

// points of a float32 stage tile (ops/cuda_dgcnn_bwd.py:f32_tile_points):
// two, one above k = 20, where two points' rows outgrow stage 3's buffers
// and a column's rows a lane's registers
constexpr int FTN = KP <= 20 ? 2 : 1;
constexpr int FROWS = KP * FTN;     // rows a tile: five 8-row column tiles at k = 20
static_assert(FROWS % 8 == 0, "float32 tiles");
#define FWARPS 16
#define FTHREADS (32 * FWARPS)
// the tiles a block's weight-gradient accumulators take before they are
// added to its partial: a float32 sum over one chain of at most 96 tiles
// (3,840 rows at k = 20; 3,072 at 32), where a block's share at k = 32,
// N = 1024 is 186 tiles (ops/cuda_dgcnn_bwd.py:bwd_stage_plan, dw_flush)
#define DW_FLUSH 96

// a row product of M output channels over the block's warps: m-tiles, K
// slices, the row stride of a slice's partial in E (M + 4: the lanes' stores
// of rows 2 t, columns g fall on 32 banks)
template <int M, int MPW_ = 1>
struct RowSplit {
  // m-tiles a warp (with two, a tile-row fragment split once serves both),
  // warps' groups of them, K slices
  static constexpr int MPW = MPW_, MG = M / (16 * MPW), KS = FWARPS / MG;
  static constexpr int LD = M + 4, FLOATS = KS * FROWS * LD;
  static_assert(FWARPS % MG == 0 && MG * MPW * 16 == M, "m-tiles");
};

// the weight gradient's (C_in, C) over the warps: m-tiles of C_in, taken
// MPW a warp (MG groups), 8-column tiles of C, the column tiles a warp holds
template <int CIN, int C>
struct DwSplit {
  static constexpr int MT = CIN / 16, CT = C / 8, MPW = 2, MG = MT / MPW;
  static constexpr int NPW = CT * MG / FWARPS;
  static_assert(MT % MPW == 0 && FWARPS % MG == 0 && NPW * FWARPS == CT * MG,
                "weight-gradient tiles");
};

// shared memory of stage_tf32_kernel, in floats: two buffers of a tile's
// z_i and z_{i-1} rows and its points' rows of dtap_i and dtap_{i-1}, one of
// its dz_{i+1} rows (the next tile's arrive once the extra cotangent is
// formed), then E (the larger row product's slices; at the end the block's
// sums): ops/cuda_dgcnn_bwd.py:bwd_stage_plan
template <int C, int CIN, int CN>
struct F32Plan {
  static constexpr int LDZ = C + 4, LDP = CIN + 4, LDN = CN > 0 ? CN + 4 : 0;
  static constexpr int TAP = FROWS * (LDZ + LDP);   // the taps' cotangents
  static constexpr int BUF = TAP + FTN * (C + CIN);
  static constexpr int DZN = FROWS * LDN;           // one buffer: loaded after stage 1
  // the extra cotangent's product takes two m-tiles a warp at 128 channels
  // (stage 3; stage 4's weight-gradient accumulators leave no registers)
  static constexpr int XPW = C == 128 ? 2 : 1;
  static constexpr int E1 = CN > 0 ? RowSplit<C, XPW>::FLOATS : 0, E3 = RowSplit<CIN>::FLOATS;
  static constexpr int E = E1 > E3 ? E1 : E3;
  static constexpr int SMEM = 4 * (2 * BUF + DZN + E);
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(E >= 2 * FTHREADS, "the block's sums");
};

// E[ks][r][m] = the ks-th K slice of sum_k W[m][k] T[r][k] over the tile's
// rows: W (M, K) float32 in device memory, T the tile's rows in shared
// memory (row stride ldt)
template <int M, int K, int MPW_ = 1>
__device__ __forceinline__ void rows_tf32(const float* __restrict__ W, const float* T,
                                          int ldt, float* E) {
  typedef RowSplit<M, MPW_> S;
  constexpr int KJ = K / S::KS;
  static_assert(KJ % 8 == 0, "slices of whole k8 steps");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int MPW = S::MPW;
  const int mg = warp % S::MG, ks = warp / S::MG, k0 = ks * KJ;
  const float* w0 = W + (size_t)(16 * MPW * mg + g) * K + k0 + t;   // m-tile u: + 16 u K
  const float* tr = T + g * ldt + k0 + t;
  float acc[MPW][FROWS / 8][4];
#pragma unroll
  for (int u = 0; u < MPW; ++u)
#pragma unroll
    for (int nt = 0; nt < FROWS / 8; ++nt)
      acc[u][nt][0] = acc[u][nt][1] = acc[u][nt][2] = acc[u][nt][3] = 0.f;
  // the weight values of k8 step k in wv[(k / 8) & 1], loaded two steps ahead
  float wv[2][MPW][4];
  auto wload = [&](float (&v)[MPW][4], int k) {
#pragma unroll
    for (int u = 0; u < MPW; ++u) {
      const float* wu = w0 + (size_t)16 * u * K + k;
      v[u][0] = __ldg(wu);
      v[u][1] = __ldg(wu + 8 * K);
      v[u][2] = __ldg(wu + 4);
      v[u][3] = __ldg(wu + 8 * K + 4);
    }
  };
  wload(wv[0], 0);
  if (KJ > 8) wload(wv[1], 8);
#pragma unroll
  for (int k = 0; k < KJ; k += 8) {
    uint32_t ah[MPW][4], al[MPW][4];
#pragma unroll
    for (int u = 0; u < MPW; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(wv[(k / 8) & 1][u][i], ah[u][i], al[u][i]);
    if (k + 16 < KJ) wload(wv[(k / 8) & 1], k + 16);
#pragma unroll
    for (int nt = 0; nt < FROWS / 8; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(tr[nt * 8 * ldt + k], bh0, bl0);
      split_tf32(tr[nt * 8 * ldt + k + 4], bh1, bl1);
#pragma unroll
      for (int u = 0; u < MPW; ++u) mma_tf32x3(acc[u][nt], ah[u], al[u], bh0, bh1, bl0, bl1);
    }
  }
  // acc[u][nt][i]: channel 16 (MPW mg + u) + g + 8 (i >> 1), row 8 nt + 2 t + (i & 1)
  float* e = E + ks * (FROWS * S::LD) + 16 * MPW * mg + g;
#pragma unroll
  for (int u = 0; u < MPW; ++u)
#pragma unroll
    for (int nt = 0; nt < FROWS / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[(8 * nt + 2 * t + (i & 1)) * S::LD + 16 * u + 8 * (i >> 1)] = acc[u][nt][i];
}

// a row product's value at (r, m): its K slices added in slice order
template <int M, int MPW = 1>
__device__ __forceinline__ float row_value(const float* E, int r, int m) {
  typedef RowSplit<M, MPW> S;
  float v = E[r * S::LD + m];
#pragma unroll
  for (int ks = 1; ks < S::KS; ++ks) v = __fadd_rn(v, E[(ks * FROWS + r) * S::LD + m]);
  return v;
}

template <int C, int CIN, int CN, bool PAD>
__global__ void __launch_bounds__(FTHREADS, 1)
stage_tf32_kernel(const float* __restrict__ z, const float* __restrict__ dtap,
                  const float* __restrict__ bn, const float* __restrict__ s12,
                  const float* __restrict__ dzn, const float* __restrict__ wn,
                  const float* __restrict__ w, const float* __restrict__ zp,
                  const float* __restrict__ dtapp, const float* __restrict__ bnp,
                  float* __restrict__ dz, float* __restrict__ part_s,
                  float* __restrict__ part_w, int B, int N, int k) {
  if constexpr (!PAD) k = KP;   // no padded row: the guards fold
  typedef F32Plan<C, CIN, CN> P;
  typedef DwSplit<CIN, C> D;
  static_assert(FTHREADS % C == 0 && FTHREADS % CIN == 0, "a thread's channels are fixed");
  extern __shared__ __align__(16) float fsm[];
  __shared__ __align__(8) uint64_t full[2], nfull;
  float* E = fsm + 2 * P::BUF + P::DZN;
  const uint32_t sbase = smem_u32(fsm);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ntn = (N + FTN - 1) / FTN, T = B * ntn;
  const int tile0 = (int)((long long)blockIdx.x * T / gridDim.x);
  const int tile1 = (int)((long long)(blockIdx.x + 1) * T / gridDim.x);
  const float m = (float)B * k * N;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&nfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the element work: G2 (G4) lanes a (point, channel) column of stage i
  // (i-1), lane l of a column taking its rows j = l mod G2 (G4); every
  // thread one column
  constexpr int G2 = FTHREADS / (FTN * C), G4 = FTHREADS / (FTN * CIN);
  static_assert(G2 * FTN * C == FTHREADS && G4 * FTN * CIN == FTHREADS && KP % G4 == 0 &&
                KP % G2 == 0, "columns");
  const int c = (tid / G2) % C, tp2 = tid / (G2 * C), l2 = tid % G2;
  const int cp = (tid / G4) % CIN, tp4 = tid / (G4 * CIN), l4 = tid % G4;
  const BnC kc(bn, C, c), kp(bnp, CIN, cp);
  const float a1 = __fdiv_rn(s12[c], m), a2 = __fdiv_rn(s12[C + c], m);
  float s1 = 0.f, s2 = 0.f;
  float dw[D::MPW][D::NPW][4];
#pragma unroll
  for (int u = 0; u < D::MPW; ++u)
#pragma unroll
    for (int j = 0; j < D::NPW; ++j) dw[u][j][0] = dw[u][j][1] = dw[u][j][2] = dw[u][j][3] = 0.f;
  const int dmg = warp % D::MG, dnt = (warp / D::MG) * D::NPW;
  // the accumulators added to the block's partial and zeroed, every DW_FLUSH
  // tiles and at the end (dw[u][j][i] is row 16 (MPW dmg + u) + g + 8 (i >>
  // 1), column 8 (dnt + j) + 2 t + (i & 1)): a thread adds to its own
  // entries, in tile order
  float* pw = part_w + (size_t)blockIdx.x * CIN * C;
  bool flushed = false;   // the partial holds a run's sums
  auto flush_dw = [&]() {
#pragma unroll
    for (int u = 0; u < D::MPW; ++u)
#pragma unroll
      for (int j = 0; j < D::NPW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(
              pw + (size_t)(16 * (D::MPW * dmg + u) + g + 8 * h) * C + 8 * (dnt + j) + 2 * t);
          float2 v = make_float2(dw[u][j][2 * h], dw[u][j][2 * h + 1]);
          if (flushed) v = make_float2(__fadd_rn(p->x, v.x), __fadd_rn(p->y, v.y));
          *p = v;
          dw[u][j][2 * h] = dw[u][j][2 * h + 1] = 0.f;
        }
    flushed = true;
  };

  // The bulk copies of a tile, spread over the warps (lanes 0..7 of each;
  // one warp issuing them all held every other warp at the next barrier):
  // copy q < 2 the points' tap cotangents, then the rows (b, j, n0 + t) of
  // z_i and z_{i-1}, j < k, t below the points left in the cloud, on full[s]; and
  // on nfull the rows of dz_{i+1}, whose buffer is free once stage 1 is done
  const int q = lane < 8 ? warp * 8 + lane : FTHREADS;
  auto points = [&](int tile) { return min(FTN, N - (tile % ntn) * FTN); };
  auto load = [&](int tile, int s) {   // after full[s]'s expect_tx
    const int b = tile / ntn, n0 = (tile % ntn) * FTN, np = points(tile);
    if (q >= 2 + 2 * k * np) return;
    const uint32_t zs = sbase + (uint32_t)(s * P::BUF) * 4u;
    const size_t p0 = (size_t)b * N + n0;
    if (q < 2) {
      bulk_load(zs + (P::TAP + q * FTN * C) * 4u, q ? dtapp + p0 * CIN : dtap + p0 * C,
                np * (q ? CIN : C) * 4, &full[s]);
      return;
    }
    const int rr = (q - 2) % (k * np), j = rr / np, r = j * FTN + rr % np;
    const size_t row = ((size_t)b * k + j) * N + n0 + rr % np;
    if (q - 2 < k * np) bulk_load(zs + (uint32_t)(r * P::LDZ) * 4u, z + row * C, C * 4, &full[s]);
    else
      bulk_load(zs + (uint32_t)(FROWS * P::LDZ + r * P::LDP) * 4u, zp + row * CIN, CIN * 4,
                &full[s]);
  };
  auto load_next = [&](int tile) {   // after nfull's expect_tx
    const int b = tile / ntn, n0 = (tile % ntn) * FTN, np = points(tile);
    if (q >= k * np) return;
    const int j = q / np, r = j * FTN + q % np;
    bulk_load(sbase + (uint32_t)(2 * P::BUF + r * P::LDN) * 4u,
              dzn + (((size_t)b * k + j) * N + n0 + q % np) * CN, CN * 4, &nfull);
  };
  if (tid == 0 && tile0 < tile1) {
    mbar_expect_tx(&full[0], (uint32_t)(points(tile0) * (k * (C + CIN) + C + CIN) * 4));
    if (CN > 0) mbar_expect_tx(&nfull, (uint32_t)(points(tile0) * k * CN * 4));
  }
  __syncthreads();
  if (tile0 < tile1) {
    load(tile0, 0);
    if (CN > 0) load_next(tile0);
  }

  int s = 0;
  uint32_t ph = 0, nph = 0;
  // the block's tiles in runs of DW_FLUSH, the accumulators flushed after each
  for (int run = tile0; run < tile1; run += DW_FLUSH) {
    for (int tile = run; tile < min(run + DW_FLUSH, tile1); ++tile) {
      const int b = tile / ntn, n0 = (tile % ntn) * FTN;
      float* Z = fsm + s * P::BUF;
      float* ZP = Z + FROWS * P::LDZ;
      const float* DZN = fsm + 2 * P::BUF;
      const float* TAP = Z + P::TAP;            // (FTN, C), then (FTN, C_in)
      mbar_wait(&full[s], ph);
      tma_store_wait_read();   // this thread's dz_i rows of the last tile are read
      if (tid == 0 && tile + 1 < tile1)
        mbar_expect_tx(&full[s ^ 1], (uint32_t)(points(tile + 1) * (k * (C + CIN) + C + CIN) * 4));
      __syncthreads();   // every warp is done with the other buffer's tile
      if (tile + 1 < tile1) load(tile + 1, s ^ 1);

      // 1. extra^T = W_{i+1} dz_{i+1}^T: E; then the next tile's dz_{i+1}
      if constexpr (CN > 0) {
        mbar_wait(&nfull, nph);
        nph ^= 1u;
        rows_tf32<C, CN, P::XPW>(wn, DZN, P::LDN, E);
        fence_proxy_async();   // the dz_{i+1} buffer is written by bulk copies next
        if (tid == 0 && tile + 1 < tile1)
          mbar_expect_tx(&nfull, (uint32_t)(points(tile + 1) * k * CN * 4));
        __syncthreads();
        if (tile + 1 < tile1) load_next(tile + 1);
      }

      // 2. stage i: dz_i over z_i
      {
        const int n = n0 + tp2;
        float y[KP / G2], best = -1.f;
        int am = 0;
#pragma unroll
        for (int i = 0; i < KP / G2; ++i) {
          const int j = G2 * i + l2;
          y[i] = bn_y<float>(Z[(j * FTN + tp2) * P::LDZ + c], kc);
          const float hv = fmaxf(y[i], 0.f);
          if (real_row<PAD>(j, k) && hv > best) { best = hv; am = j; }
        }
        am = group_argmax<G2>(best, am);
        const float tap = n < N ? TAP[tp2 * C + c] : 0.f;
#pragma unroll
        for (int i = 0; i < KP / G2; ++i) {
          const int j = G2 * i + l2;
          float* zr = Z + (j * FTN + tp2) * P::LDZ + c;
          float dh = 0.f;
          if constexpr (CN > 0) dh = row_value<C, P::XPW>(E, j * FTN + tp2, c);
          if (j == am) dh = __fadd_rn(tap, dh);
          const float dy = relu_vjp<float>(dh, y[i]);
          const float d = __fmul_rn(kc.ig, __fsub_rn(__fsub_rn(dy, a1), __fmul_rn(zhat(*zr, kc), a2)));
          *zr = n < N && real_row<PAD>(j, k) ? d : 0.f;
        }
      }
      fence_proxy_async();   // dz_i is read by the bulk stores next
      __syncthreads();

      // dz_i out (copy q < the tile's rows, row q); 3. dh_{i-1}^T = W_i dz_i^T: E
      {
        const int np = points(tile);
        if (q < k * np) {
          const int j = q / np, r = j * FTN + q % np;
          bulk_store(dz + (((size_t)b * k + j) * N + n0 + q % np) * C,
                     sbase + (uint32_t)(s * P::BUF + r * P::LDZ) * 4u, C * 4);
          tma_store_commit();
        }
      }
      rows_tf32<CIN, C>(w, Z, P::LDZ, E);
      __syncthreads();

      // 4. stage i-1: dy_{i-1}, its sums, h_{i-1} over z_{i-1}
      {
        const int n = n0 + tp4;
        float y[KP / G4], best = -1.f;
        int am = 0;
#pragma unroll
        for (int i = 0; i < KP / G4; ++i) {
          const int j = G4 * i + l4;
          y[i] = bn_y<float>(ZP[(j * FTN + tp4) * P::LDP + cp], kp);
          const float hv = fmaxf(y[i], 0.f);
          if (real_row<PAD>(j, k) && hv > best) { best = hv; am = j; }
        }
        am = group_argmax<G4>(best, am);
        const float tap = n < N ? TAP[FTN * C + tp4 * CIN + cp] : 0.f;
#pragma unroll
        for (int i = 0; i < KP / G4; ++i) {
          const int j = G4 * i + l4;
          float* zr = ZP + (j * FTN + tp4) * P::LDP + cp;
          float dh = row_value<CIN>(E, j * FTN + tp4, cp);
          if (j == am) dh = __fadd_rn(tap, dh);
          const float dy = relu_vjp<float>(dh, y[i]);
          const bool real = n < N && real_row<PAD>(j, k);
          if (real) {
            s1 = __fadd_rn(s1, dy);
            s2 = __fadd_rn(s2, __fmul_rn(dy, zhat(*zr, kp)));
          }
          *zr = real ? fmaxf(y[i], 0.f) : 0.f;
        }
      }
      __syncthreads();

      // 5. dW_i += h_{i-1}^T dz_i over the tile's rows: A[m][r] = h[r][m],
      //    B[r][n] = dz[r][n]
#pragma unroll
      for (int r0 = 0; r0 < FROWS; r0 += 8) {
        uint32_t ah[D::MPW][4], al[D::MPW][4];
#pragma unroll
        for (int u = 0; u < D::MPW; ++u) {
          const float* hp = ZP + (r0 + t) * P::LDP + 16 * (D::MPW * dmg + u) + g;
          split_tf32(hp[0], ah[u][0], al[u][0]);
          split_tf32(hp[8], ah[u][1], al[u][1]);
          split_tf32(hp[4 * P::LDP], ah[u][2], al[u][2]);
          split_tf32(hp[4 * P::LDP + 8], ah[u][3], al[u][3]);
        }
#pragma unroll
        for (int j = 0; j < D::NPW; ++j) {
          const float* dp = Z + (r0 + t) * P::LDZ + 8 * (dnt + j) + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(dp[0], bh0, bl0);
          split_tf32(dp[4 * P::LDZ], bh1, bl1);
#pragma unroll
          for (int u = 0; u < D::MPW; ++u) mma_tf32x3(dw[u][j], ah[u], al[u], bh0, bh1, bl0, bl1);
        }
      }
      fence_proxy_async();   // the buffer is written by bulk copies next
      s ^= 1;
      if (s == 0) ph ^= 1u;
    }
    flush_dw();
  }

  // the block's partials: dW_i from the accumulators (flushed above), the
  // sums in thread order
  float* RED = E;   // E was last read before the last tile's fourth barrier
  RED[tid] = s1;
  RED[FTHREADS + tid] = s2;
  __syncthreads();
  if (tid < CIN) {   // the threads of channel tid: G4 (tid + CIN t) + l, in order
    float u = 0.f, v = 0.f;
    for (int k = 0; k < FTHREADS / CIN; ++k) {
      const int x = G4 * (tid + CIN * (k / G4)) + k % G4;
      u = __fadd_rn(u, RED[x]);
      v = __fadd_rn(v, RED[FTHREADS + x]);
    }
    part_s[(size_t)blockIdx.x * 2 * CIN + tid] = u;
    part_s[(size_t)blockIdx.x * 2 * CIN + CIN + tid] = v;
  }
  tma_store_wait();
}

// ------------------------------------------- bf16 edge kernel, one pass (wgmma)
//
// edge_wgmma_kernel: bwd_edge for bf16 in one pass on stage_wgmma_kernel's
// frame (its tiles of WTN points, WROWS rows; its persistent grid of at most
// WBLOCKS blocks, each walking an equal contiguous share of the tiles; its
// BN constants from the batch statistics, bn_stats). Per block:
//  - W_2 (64 x 64) and W_1 (6 x 64), float32, are rounded to bf16 and loaded
//    once as K-major panels (W_1's rows 6..63 zero);
//  - a tile's z_1 and dz_2 panels arrive by TMA on the two-buffer ring; its
//    e rows (12 bytes each, below TMA's 16-byte box) by plain loads one tile
//    ahead, thread r < WROWS holding row r in registers (zeros past N or k),
//    written into the chunk 0 of row r of an MN-major e panel (the other
//    chunks zero);
//  - extra^T = W_2 dz_2^T: wgmma m64nRNk16, rounded to bf16 into E;
//  - the element work of the stage kernel (dz_columns): dz_1 over z_1 in
//    shared memory; dz_1 never goes to global memory;
//  - dW_1^T += ... as dW_1 (padded to 64 rows) += e_pad^T dz_1: m64n64k16,
//    both operands MN-major from the e and dz_1 panels (K = the tile's
//    rows), held in registers across the block's tiles; de^T = W_1 dz_1^T:
//    m64nRNk16 (W_1 padded to 64 rows as A), float32 accumulation of the
//    exact bf16 products, the rows 0..5 into DE;
//  - dq = sum_k (de[3:] - de[:3]) in k order, de[:3] per row j < k to dneigh.
// At the end each block writes its float32 dW_1 partial; sum_parts_kernel
// adds them in block order, and scatter_kernel adds dneigh onto the points.
// Bound: bytes (z_1, dz_2, dtap, e and idx read once, dneigh written and read
// once, about 104 MB at B=24, N=717: 0.031 ms at 3.35 TB/s); the products
// take 0.002 ms at the tensor cores' rate. What holds it from the bound: the
// element work on the CUDA cores and each tile's phases in turn behind
// block-wide barriers, as in the stage kernel.

struct EdgePlan {
  static constexpr int BUF = 2 * PANEL;            // z_1 and dz_2 of a tile
  static constexpr int W = 64 * 64 * 2;            // W_2, W_1: a 64-row panel each
  static constexpr int EP = PANEL;                 // the e panel, MN-major
  static constexpr int E_LD = 64 + 8;              // extra, bf16 rows of E_LD
  static constexpr int E = WROWS * E_LD * 2;
  static constexpr int DE = WROWS * 8 * 4;         // de[:6] of a tile, float32
  static constexpr int SMEM = 2 * BUF + 2 * W + EP + E + DE + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

template <bool PAD>
__global__ void __launch_bounds__(WTHREADS, 1)
edge_wgmma_kernel(const __grid_constant__ CUtensorMap zmap,
                  const __grid_constant__ CUtensorMap dznmap,
                  const bf16* __restrict__ dtap, const BatchStats st,
                  const float* __restrict__ s12, const float* __restrict__ w2,
                  const bf16* __restrict__ e, const float* __restrict__ w1,
                  float* __restrict__ part_w, float* __restrict__ dq,
                  float* __restrict__ dneigh, int B, int N, int k) {
  if constexpr (!PAD) k = KP;   // no padded row: the guards fold
  typedef EdgePlan P;
  constexpr int C = 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  unsigned char* W2p = base + 2 * P::BUF;
  unsigned char* W1p = W2p + P::W;
  unsigned char* EPp = W1p + P::W;
  bf16* E = reinterpret_cast<bf16*>(EPp + P::EP);
  float* DE = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(E) + P::E);
  const uint32_t W2s = sbase + 2 * P::BUF, W1s = W2s + P::W, EPs = W1s + P::W;
  const int tid = threadIdx.x, wg = tid / 128;
  const int ntn = (N + WTN - 1) / WTN, T = B * ntn;
  const int tile0 = (int)((long long)blockIdx.x * T / gridDim.x);
  const int tile1 = (int)((long long)(blockIdx.x + 1) * T / gridDim.x);
  const float m = (float)B * k * N;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
  }
  load_panels(W2p, w2, C, C);
  load_panels(W1p, w1, 6, C);
  for (int i = tid; i < (64 - 6) * 8; i += WTHREADS)   // W_1's rows 6..63
    reinterpret_cast<uint4*>(W1p + 6 * 128)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < P::EP / 16; i += WTHREADS)
    reinterpret_cast<uint4*>(EPp)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();   // the weights and the e panel are wgmma operands
  __syncthreads();

  auto issue = [&](int tile, int s) {
    const int b = tile / ntn, n0 = (tile % ntn) * WTN;
    const uint32_t dst = sbase + s * P::BUF;
    mbar_expect_tx(&full[s], P::BUF);
    tile_load<PAD>(dst, &zmap, &full[s], 0, n0, b);
    tile_load<PAD>(dst + PANEL, &dznmap, &full[s], 0, n0, b);
  };
  if (tid == 0 && tile0 < tile1) issue(tile0, 0);
  // thread r < WROWS: row r (j = r / WTN, point t = r % WTN) of a tile's e,
  // six bf16 in three words, zeros past N or k
  uint32_t ev[3] = {0u, 0u, 0u};
  auto load_e = [&](int tile) {
    const int b = tile / ntn, n = (tile % ntn) * WTN + tid % WTN, j = tid / WTN;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(e + (((size_t)b * k + j) * N + n) * 6);
#pragma unroll
    for (int w = 0; w < 3; ++w) ev[w] = n < N && real_row<PAD>(j, k) ? __ldg(p + w) : 0u;
  };
  if (tid < WROWS && tile0 < tile1) load_e(tile0);

  const int c = (tid / column_lanes<C>()) % C, h = tid % column_lanes<C>();
  const BnC kc = bn_stats<bf16>(st.p[0], st.p[1], st.p[2], st.p[3], c);
  const float a1 = __fdiv_rn(s12[c], m), a2 = __fdiv_rn(s12[C + c], m);
  float dw[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dw[i] = 0.f;

  int s = 0;
  uint32_t ph = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    const int b = tile / ntn, n0 = (tile % ntn) * WTN;
    unsigned char* Zp = base + s * P::BUF;
    const uint32_t Zs = sbase + s * P::BUF, DZNs = Zs + PANEL;
    mbar_wait(&full[s], ph);
    if (tid == 0 && tile + 1 < tile1) issue(tile + 1, s ^ 1);

    // 1. extra^T = W_2 dz_2^T, rounded to bf16: E[r][c]; the tile's e rows
    float d[RN / 2];
    if (wg < WROWS / RN) rows_product<C>(d, W2s, C, 0, DZNs, wg);
    if (tid < WROWS) {
      *reinterpret_cast<uint4*>(EPp + sw128_offset(tid, 0)) = make_uint4(ev[0], ev[1], ev[2], 0u);
      if (tile + 1 < tile1) load_e(tile + 1);
    }
    if (wg < WROWS / RN) rows_store(d, E, P::E_LD, 0, wg);
    __syncthreads();

    // 2. dz_1 over z_1
    dz_columns<C, P::E_LD, PAD>(Zp, E, dtap, b, n0, N, k, c, h, kc, a1, a2);
    fence_proxy_async();   // dz_1 and the e panel are read by wgmma next
    __syncthreads();

    // 3. warpgroup 0: dW_1 += e^T dz_1; 1 and 2: de^T = W_1 dz_1^T, rows
    //    [RN (wg - 1), RN wg) of the tile
    if (wg == 0) {
      wgmma_fence();
      fence_acc(dw);
#pragma unroll
      for (int kq = 0; kq < WROWS / 16; ++kq)
        dw_product<64>(dw, desc_mn(EPs + kq * 2048, PANEL), desc_mn(Zs + kq * 2048, PANEL));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dw);
    } else if (wg <= WROWS / RN) {
      rows_product<C>(d, W1s, 64, 0, Zs, wg - 1);
      // d[4 j + e]: de column 16 warp + g + 8 (e / 2), row RN (wg - 1) + 8 j
      // + 2 t + e % 2; columns 0..5 are warp 0's lanes g < 6, e < 2
      const int warp = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
      if (warp == 0 && g < 6) {
#pragma unroll
        for (int j = 0; j < RN / 8; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) DE[(RN * (wg - 1) + 8 * j + 2 * t + x) * 8 + g] = d[4 * j + x];
      }
    }
    __syncthreads();

    // 4. warpgroups 2 and 3, while 0 and 1 start the next tile's extra
    //    cotangent: dq in k order, de[:3] to dneigh (DE is written again
    //    after the next tile's first barrier)
    if (tid >= 3 * 128 && tid < 3 * 128 + WTN * 3) {
      const int t = (tid - 3 * 128) / 3, dd = (tid - 3 * 128) % 3, n = n0 + t;
      if (n < N) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (j >= k) break;
          const float* de = DE + (j * WTN + t) * 8;
          acc = __fadd_rn(acc, __fsub_rn(de[3 + dd], de[dd]));
        }
        dq[((size_t)b * N + n) * 3 + dd] = acc;
      }
    }
    for (int i = tid - 2 * 128; i >= 0 && i < WROWS * 3; i += WTHREADS / 2) {
      const int r = i / 3, dd = i % 3, j = r / WTN, n = n0 + r % WTN;
      if (n < N && real_row<PAD>(j, k))
        dneigh[(((size_t)b * k + j) * N + n) * 3 + dd] = DE[r * 8 + dd];
    }
    s ^= 1;
    if (s == 0) ph ^= 1u;
  }

  // the block's dW_1 partial: accumulator rows 0..5 (warp 0 of warpgroup 0,
  // lanes g < 6)
  if (tid < 32 && tid / 4 < 6) {
    const int g = tid / 4, t = tid % 4;
    float* pw = part_w + ((size_t)blockIdx.x * 6 + g) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(pw + 8 * j + 2 * t) = make_float2(dw[4 * j], dw[4 * j + 1]);
  }
}

// ------------------------- float32 edge kernel, one pass (mma.sync, 3xTF32)
//
// edge_tf32_kernel: bwd_edge for float32 in one pass, on edge_wgmma_kernel's
// plan (tiles of WTN points, WROWS rows r = j WTN + t; a persistent grid of
// at most WBLOCKS blocks, each walking an equal contiguous share of the
// tiles; the BN constants from the batch statistics, bn_stats) with
// stage_tf32_kernel's arithmetic (the extra cotangent as three TF32 products
// on mma.sync m16n8k8, tf32.cuh). Per block of 16 warps:
//  - W_2's A fragments for extra^T = W_2 dz_2^T (the 64 output channels as
//    M, the depth as K) are loaded and split once into registers: warp w
//    holds the m-tile w % 4 over the K half (w / 4) % 2, 32 registers a
//    lane, for the block's lifetime, so W_2 is read once a block and never
//    split again; W_1 (6 x 64) lies in shared memory;
//  - a tile's z_1 and dz_2 arrive by TMA, each as two boxes of (32
//    channels, WTN points, KP neighbours of one cloud) with the 128-byte
//    swizzle (zoff: the fragment loads of lanes (g, t) and the element
//    work's lanes fall on 32 banks; rows past N or k come as zeros), its
//    points' tap
//    cotangents by one bulk copy, on a ring of two buffers: the tile after
//    next is issued as soon as a tile's buffers are read. The e rows (24
//    bytes, below TMA's 16-byte strides) come by plain loads one tile ahead,
//    thread r < WROWS holding row r (zeros past N or k);
//  - extra^T: warp w takes its m-tile and K half for the 8-row column tiles
//    (five at k = 20) of half the tile's rows (w / 8), splitting each dz_2
//    fragment once for its m-tile; each SM sub-partition gets the same
//    products (240 at k = 20).
//    The two K halves' partial sums land in E and are added in order where
//    the element work reads them;
//  - the element work of stage_tf32_kernel, 8 / WTN lanes a (point,
//    channel) column (two at k = 20): h recomputed with the forward's
//    rounding, the first argmax over the rows j < k, dh = extra plus the
//    tap's cotangent at the argmax, dy, and dz_1 over z_1 in shared memory
//    (0 on the rows past N or k). dz_1 never goes to device memory;
//  - de = dz_1 W_1^T (WROWS x 6) and dW_1 += e^T dz_1 (6 x 64) as float32 FMAs
//    on the CUDA cores in a fixed order (0.53 GFLOP at B=24, N=717, a fifth
//    of the extra product's; no padding of W_1's 6 rows to an m-tile): de
//    one thread a (row, output) over the channels in order; dW_1 on every
//    thread, a (channel, eighth of the tile's rows) each, the six inputs'
//    sums over its rows in order held in registers across the block's
//    tiles, and the eighths added in order at the end;
//  - dq = sum_k (de[3:] - de[:3]) in k order and de[:3] per row j < k to
//    dneigh, while the other warps start the next tile.
// At the end each block writes its dW_1 partial; sum_parts_kernel adds them
// in block order, and scatter_kernel adds dneigh onto the points.
// Bound: bytes (z_1 and dz_2, 88 MB each at B=24, N=717, dtap, e and idx read
// once, dneigh written and read once: about 190 MB, 0.057 ms at 3.35 TB/s);
// the extra product's 2.8 GFLOP take about 0.009 ms as three TF32 products
// at 495 TFLOP/s, 0.027 ms at the 313 TFLOP/s mma.sync reached on the card.
// What holds it at 0.16 ms (NVIDIA H100 80GB HBM3, PERF.md §6; each phase
// removed in turn from a copy of the kernel): the extra product's
// phase (each dz_2 fragment split in the four warps of its K half and rows,
// the three products of a k8 step in one chain), then the element work,
// de and dW_1; the loads and barriers alone take 0.07 ms. In the design
// before this one, 161 bulk copies a tile (a row each) and dW_1 on three
// warps cost most; a third buffer gained nothing there.

#define ETHREADS 512             // 16 warps
constexpr int EPANEL = WROWS * 32;  // floats of a tile's 32-channel panel
constexpr int EL = 8 / WTN;         // lanes a column of the element work
#define ELD (64 + 4)             // floats of a row of E
#define EDW_PARTS (ETHREADS / 64)  // the weight gradient's parts of a tile's rows

// float offset of (row r, channel c) in a tile's two 32-channel panels, as
// TMA's 128-byte swizzle writes them: 16-byte chunk (c / 4) XOR r of row r
__device__ __forceinline__ int zoff(int r, int c) {
  return (c >> 5) * EPANEL + r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// shared memory of edge_tf32_kernel, offsets in floats from a 1024-byte
// boundary (ops/cuda_dgcnn_bwd.py:bwd_edge_plan): two buffers of a tile's
// z_1 and dz_2 panels and its points' tap cotangents, the extra cotangent's
// two K halves (at the end the weight gradient's parts), the e rows, de, W_1
struct EdgeF32Plan {
  static constexpr int DZN = 2 * EPANEL;            // a buffer: z_1, dz_2, taps
  static constexpr int TAP = 4 * EPANEL;
  static constexpr int BUF = (TAP + WTN * 64 + 255) / 256 * 256;
  static constexpr int E = 2 * BUF;                 // [2][WROWS][ELD]
  static constexpr int EP = E + 2 * WROWS * ELD;    // [WROWS][8]
  static constexpr int DE = EP + WROWS * 8;         // [WROWS][8]
  static constexpr int W1 = DE + WROWS * 8;         // [6][ELD]
  static constexpr int SMEM = 4 * (W1 + 6 * ELD) + 1024;
  static_assert(EPANEL % 256 == 0 && BUF % 256 == 0, "panels on 1024-byte boundaries");
  static_assert(EDW_PARTS * 6 * 64 <= 2 * WROWS * ELD, "the weight gradient's parts in E");
  static_assert(SMEM <= 232448, "shared memory");
};

template <bool PAD>
__global__ void __launch_bounds__(ETHREADS, 1)
edge_tf32_kernel(const __grid_constant__ CUtensorMap zmap,
                 const __grid_constant__ CUtensorMap dznmap,
                 const float* __restrict__ dtap, const float* __restrict__ mean,
                 const float* __restrict__ var, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ s12,
                 const float* __restrict__ w2, const float* __restrict__ e,
                 const float* __restrict__ w1, float* __restrict__ part_w,
                 float* __restrict__ dq, float* __restrict__ dneigh, int B, int N,
                 int k) {
  if constexpr (!PAD) k = KP;   // no padded row: the guards fold
  typedef EdgeF32Plan P;
  constexpr int C = 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  float* fsm = reinterpret_cast<float*>(smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  float* E = fsm + P::E;
  float* EP = fsm + P::EP;
  float* DE = fsm + P::DE;
  float* W1 = fsm + P::W1;
  const uint32_t sbase = smem_u32(fsm);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int ntn = (N + WTN - 1) / WTN, T = B * ntn;
  const int tile0 = (int)((long long)blockIdx.x * T / gridDim.x);
  const int tile1 = (int)((long long)(blockIdx.x + 1) * T / gridDim.x);
  const float m = (float)B * k * N;

  // thread 0: a tile's four boxes and its taps (the points left in the
  // cloud) into buffer s
  auto issue = [&](int tile, int s) {
    const int b = tile / ntn, n0 = (tile % ntn) * WTN, np = min(WTN, N - n0);
    const uint32_t dst = sbase + (uint32_t)(s * P::BUF) * 4u;
    mbar_expect_tx(&full[s], (uint32_t)(4 * EPANEL + np * C) * 4u);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      tile_load<PAD>(dst + p * EPANEL * 4, &zmap, &full[s], 32 * p, n0, b);
      tile_load<PAD>(dst + (P::DZN + p * EPANEL) * 4, &dznmap, &full[s], 32 * p, n0, b);
    }
    bulk_load(dst + P::TAP * 4, dtap + ((size_t)b * N + n0) * C, np * C * 4, &full[s]);
  };
  // thread r < WROWS: row r (j = r / WTN, point r % WTN) of a tile's e,
  // zeros past N or k
  float ev[6];
  auto load_e = [&](int tile) {
    const int b = tile / ntn, n = (tile % ntn) * WTN + tid % WTN, j = tid / WTN;
    const float* p = e + (((size_t)b * k + j) * N + n) * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) ev[i] = n < N && real_row<PAD>(j, k) ? __ldg(p + i) : 0.f;
  };

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
    for (int i = 0; i < 2 && tile0 + i < tile1; ++i) issue(tile0 + i, i);
  }
  for (int i = tid; i < 6 * C; i += ETHREADS) W1[(i / C) * ELD + i % C] = w1[i];
  if (tid < WROWS && tile0 < tile1) load_e(tile0);

  // W_2's fragments of warp w: rows (channels) 16 mt + g (+ 8), k8 steps
  // 4 kh + kk; a[i] is row g + 8 (i & 1), column t + 4 (i >> 1)
  const int mt = warp % 4, kh = (warp / 4) % 2, nh = warp / 8;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* wp = w2 + (size_t)(16 * mt + g) * C + 8 * (4 * kh + kk) + t;
    split_tf32(__ldg(wp), ah[kk][0], al[kk][0]);
    split_tf32(__ldg(wp + 8 * C), ah[kk][1], al[kk][1]);
    split_tf32(__ldg(wp + 4), ah[kk][2], al[kk][2]);
    split_tf32(__ldg(wp + 8 * C + 4), ah[kk][3], al[kk][3]);
  }
  // the element work's column: point tp, channel c, rows j = EL i + l
  const int c = (tid / EL) % C, tp = tid / (EL * C), l = tid % EL;
  const BnC kc = bn_stats<float>(mean, var, gamma, beta, c);
  const float a1 = __fdiv_rn(s12[c], m), a2 = __fdiv_rn(s12[C + c], m);
  // dW_1: thread tid owns channel tid % 64 over the rows of part tid / 64
  const int dc = tid % C, dr0 = (tid / C) * (WROWS / EDW_PARTS);
  float dw[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  __syncthreads();   // the barriers, W_1

  for (int tile = tile0; tile < tile1; ++tile) {
    const int it = tile - tile0, s = it & 1;
    const int b = tile / ntn, n0 = (tile % ntn) * WTN;
    float* Z = fsm + s * P::BUF;
    const float* DZN = Z + P::DZN;
    const float* TAP = Z + P::TAP;
    mbar_wait(&full[s], (uint32_t)(it >> 1) & 1u);

    // 1. extra^T = W_2 dz_2^T over K half kh: E[kh][r][c]; the tile's e rows
    {
      constexpr int NU = WROWS / 16;   // column tiles of half the tile's rows
      float acc[NU][4];
#pragma unroll
      for (int u = 0; u < NU; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      // b0 = dz_2[8 nt + g][8 ks + t], b1 four columns on; row WROWS / 2 nh
      // + 8 u + g of panel kh, whose chunks are XORed by g
      const float* dp = DZN + kh * EPANEL + (WROWS / 2 * nh + g) * 32 + t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = ((2 * kk) ^ g) << 2, c1 = ((2 * kk + 1) ^ g) << 2;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(dp[u * 8 * 32 + c0], bh0, bl0);
          split_tf32(dp[u * 8 * 32 + c1], bh1, bl1);
          mma_tf32x3(acc[u], ah[kk], al[kk], bh0, bh1, bl0, bl1);
        }
      }
      // acc[u][i]: channel 16 mt + g + 8 (i >> 1), row WROWS / 2 nh + 8 u + 2 t
      // + (i & 1)
      float* ep = E + kh * (WROWS * ELD) + (WROWS / 2 * nh + 2 * t) * ELD + 16 * mt + g;
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) ep[(8 * u + (i & 1)) * ELD + 8 * (i >> 1)] = acc[u][i];
    }
    if (tid < WROWS) {
#pragma unroll
      for (int i = 0; i < 6; ++i) EP[tid * 8 + i] = ev[i];
      if (tile + 1 < tile1) load_e(tile + 1);
    }
    __syncthreads();

    // 2. dz_1 over z_1
    {
      const int n = n0 + tp;
      float y[KP / EL], best = -1.f;
      int am = 0;
#pragma unroll
      for (int i = 0; i < KP / EL; ++i) {
        const int j = EL * i + l;
        y[i] = bn_y<float>(Z[zoff(j * WTN + tp, c)], kc);
        const float hv = fmaxf(y[i], 0.f);
        if (real_row<PAD>(j, k) && hv > best) { best = hv; am = j; }
      }
      am = group_argmax<EL>(best, am);
      const float tap = n < N ? TAP[tp * C + c] : 0.f;
#pragma unroll
      for (int i = 0; i < KP / EL; ++i) {
        const int j = EL * i + l, r = j * WTN + tp;
        float* zr = Z + zoff(r, c);
        float dh = __fadd_rn(E[r * ELD + c], E[(WROWS + r) * ELD + c]);
        if (j == am) dh = __fadd_rn(tap, dh);
        const float dy = relu_vjp<float>(dh, y[i]);
        const float d = __fmul_rn(kc.ig, __fsub_rn(__fsub_rn(dy, a1), __fmul_rn(zhat(*zr, kc), a2)));
        *zr = n < N && real_row<PAD>(j, k) ? d : 0.f;
      }
    }
    __syncthreads();

    // 3. de = dz_1 W_1^T: thread 6 r + o (row r, output o), over the
    //    channels in order; dW_1 += e^T dz_1 over the thread's part of the
    //    rows, in order
    if (tid < 6 * WROWS) {
      const int r = tid / 6, o = tid % 6;
      const float4* wr = reinterpret_cast<const float4*>(W1 + o * ELD);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(
            Z + (q >> 3) * EPANEL + r * 32 + (((q ^ r) & 7) << 2));
        const float4 w = wr[q];
        acc = fmaf(a.x, w.x, acc);
        acc = fmaf(a.y, w.y, acc);
        acc = fmaf(a.z, w.z, acc);
        acc = fmaf(a.w, w.w, acc);
      }
      DE[r * 8 + o] = acc;
    }
#pragma unroll
    for (int r = dr0; r < dr0 + WROWS / EDW_PARTS; ++r) {
      const float d = Z[zoff(r, dc)];
      const float4 a = *reinterpret_cast<const float4*>(EP + r * 8);
      const float2 a45 = *reinterpret_cast<const float2*>(EP + r * 8 + 4);
      dw[0] = fmaf(a.x, d, dw[0]);
      dw[1] = fmaf(a.y, d, dw[1]);
      dw[2] = fmaf(a.z, d, dw[2]);
      dw[3] = fmaf(a.w, d, dw[3]);
      dw[4] = fmaf(a45.x, d, dw[4]);
      dw[5] = fmaf(a45.y, d, dw[5]);
    }
    fence_proxy_async();   // the buffer is written by TMA next
    __syncthreads();
    if (tid == 0 && tile + 2 < tile1) issue(tile + 2, s);

    // 4. warps 8-15, while the others start the next tile: dq in k order,
    //    de[:3] to dneigh (DE is written again after the next tile's second
    //    barrier)
    if (tid >= 384 && tid < 384 + WTN * 3) {
      const int tq = (tid - 384) / 3, dd = (tid - 384) % 3, n = n0 + tq;
      if (n < N) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KP; ++j) {
          if (j >= k) break;
          const float* de = DE + (j * WTN + tq) * 8;
          acc = __fadd_rn(acc, __fsub_rn(de[3 + dd], de[dd]));
        }
        dq[((size_t)b * N + n) * 3 + dd] = acc;
      }
    }
    for (int i = tid - ETHREADS / 2; i >= 0 && i < WROWS * 3; i += ETHREADS / 2) {
      const int r = i / 3, dd = i % 3, j = r / WTN, n = n0 + r % WTN;
      if (n < N && real_row<PAD>(j, k))
        dneigh[(((size_t)b * k + j) * N + n) * 3 + dd] = DE[r * 8 + dd];
    }
  }

  // the block's dW_1 partial, (6, 64): each (input, channel)'s parts in
  // order (E was last read before the last tile's second barrier)
  float* RED = E;   // [EDW_PARTS][6][64]
#pragma unroll
  for (int i = 0; i < 6; ++i) RED[((tid / C) * 6 + i) * C + dc] = dw[i];
  __syncthreads();
  if (tid < 6 * C) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < EDW_PARTS; ++q) v = __fadd_rn(v, RED[q * 6 * C + tid]);
    part_w[(size_t)blockIdx.x * 6 * C + tid] = v;
  }
}

// ------------------------------------------------------------------ launchers

// the row class this library was compiled for: its launchers take 1 <= k <= KP
extern "C" int dgcnn_bwd_row_class() { return KP; }

static cudaError_t sum_parts(const float* part, int G, int L, float* out,
                             cudaStream_t st) {
  sum_parts_kernel<<<(L + NT - 1) / NT, NT, 0, st>>>(part, G, L, out);
  return cudaGetLastError();
}

// bwd_reduce, both types: reduce_kernel over `blocks` blocks
// (ops/cuda_dgcnn_bwd.py:reduce_plan), part (blocks, 2, C) float32 scratch,
// ticket one zeroed unsigned the kernel leaves zeroed, s (2, C). The batch
// statistics come as they are, float32; dtap's points lie tstride elements
// apart (C, or the width of the concatenated taps it is a slice of), its
// rows 16-byte aligned; z holds k <= KP rows a point.
extern "C" int bwd_reduce_launch(const void* z, const void* dtap, const float* mean,
                                 const float* var, const float* gamma,
                                 const float* beta, float* part, unsigned* ticket,
                                 float* s, int B, int N, int k, int C, int tstride,
                                 int is_bf16, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || N < 1 || k < 1 || k > KP || (long long)B * N > INT_MAX || blocks < 1 ||
      blocks > B * N ||
      tstride < C || tstride * (is_bf16 ? 2 : 4) % 16 != 0 || (uintptr_t)dtap % 16 != 0)
    return (int)cudaErrorInvalidValue;
#define R(c, T, pad)                                                                   \
  if (C == c && (is_bf16 != 0) == (sizeof(T) == 2) && (k < KP) == pad) {               \
    reduce_kernel<T, c, pad><<<blocks, RED_NT, 0, st>>>(                               \
        (const T*)z, (const T*)dtap, mean, var, gamma, beta, part, ticket, s, B, N, k, \
        tstride);                                                                      \
    return (int)cudaGetLastError();                                                    \
  }
#define RT(c) R(c, __nv_bfloat16, false) R(c, __nv_bfloat16, true) R(c, float, false) \
  R(c, float, true)
  RT(64) RT(128) RT(256)
#undef RT
#undef R
  return (int)cudaErrorInvalidValue;
}

// the tensor map of tile_load / tile_store over a (B, k, N, c) stage tensor:
// for k < KP a (c, N, k, B) view, boxes of (bc channels, WTN points, KP rows,
// one cloud): TMA fills the rows past N or k with zeros on load and drops
// them on store, so that a box never reads or writes the next cloud's rows;
// for k = KP a (c, N, B KP) view, boxes of (bc, WTN, KP)
static cudaError_t stage_map(CUtensorMap* m, const void* p, int c, int k, int B, int N,
                             int bc = 64,
                             CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t es = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 4;
  const cuuint32_t box[4] = {(cuuint32_t)bc, WTN, KP, 1};
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)N,
                              (cuuint64_t)k * (k < KP ? 1 : B), (cuuint64_t)B};
  const cuuint64_t strides[3] = {c * es, (cuuint64_t)N * c * es, (cuuint64_t)k * N * c * es};
  return make_map(m, p, k < KP ? 4 : 3, dims, strides, box, type);
}

template <int C, int CIN, int CN, bool PAD>
static cudaError_t launch_stage_wgmma(const void* z, const void* dtap, const BatchStats& st,
                                      const float* s12, const void* dzn, const float* wn,
                                      const float* w, const void* zp, const void* dtapp,
                                      void* dz, float* part_s, float* sp, float* part_w,
                                      float* dw, int B, int N, int k, int blocks,
                                      cudaStream_t stream) {
  typedef StagePlan<C, CIN, CN> P;
  const int tiles = B * ((N + WTN - 1) / WTN);
  if (blocks < 1 || blocks > tiles || blocks > WBLOCKS) return cudaErrorInvalidValue;
  CUtensorMap zmap, zpmap, dznmap, dzmap;
  cudaError_t err = stage_map(&zmap, z, C, k, B, N);
  if (err == cudaSuccess) err = stage_map(&zpmap, zp, CIN, k, B, N);
  if (err == cudaSuccess) err = CN > 0 ? stage_map(&dznmap, dzn, CN, k, B, N)
                                       : stage_map(&dznmap, z, C, k, B, N);
  if (err == cudaSuccess) err = stage_map(&dzmap, dz, C, k, B, N);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stage_wgmma_kernel<C, CIN, CN, PAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  stage_wgmma_kernel<C, CIN, CN, PAD><<<blocks, WTHREADS, P::SMEM, stream>>>(
      zmap, zpmap, dznmap, dzmap, (const bf16*)dtap, st, s12, wn, w,
      (const bf16*)dtapp, part_s, part_w, B, N, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_parts(part_s, blocks, 2 * CIN, sp, stream);
  if (err != cudaSuccess) return err;
  return sum_parts(part_w, blocks, CIN * C, dw, stream);
}

// bwd_stage for bf16: the one-pass stage_wgmma_kernel over `blocks` blocks
// (ops/cuda_dgcnn_bwd.py:bwd_stage_plan), part_s (blocks, 2, cin) and
// part_w (blocks, cin, C) scratch. The batch statistics come as they are,
// float32 (mean, var, gamma, beta of stage i, then of stage i-1); the
// weights w (cin, C) and wn (C, cn) float32; the stage tensors hold
// k <= KP rows a point.
extern "C" int bwd_stage_bf16_launch(const void* z, const void* dtap, const float* mean,
                                     const float* var, const float* gamma,
                                     const float* beta, const float* meanp,
                                     const float* varp, const float* gammap,
                                     const float* betap, const float* s12,
                                     const void* dzn, const float* wn,
                                     const float* w, const void* zp,
                                     const void* dtapp, void* dz, float* part_s,
                                     float* sp, float* part_w, float* dw, int B,
                                     int N, int k, int C, int cin, int cn, int blocks,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || N > MAXN || k < 1 || k > KP) return (int)cudaErrorInvalidValue;
  const BatchStats st = {{mean, var, gamma, beta, meanp, varp, gammap, betap}};
#define S(c, ci, n)                                                                     \
  if (C == c && cin == ci && cn == n)                                                 \
    return (int)(k < KP ? launch_stage_wgmma<c, ci, n, true>(                           \
                              z, dtap, st, s12, dzn, wn, w, zp, dtapp, dz, part_s, sp,  \
                              part_w, dw, B, N, k, blocks, s)                            \
                        : launch_stage_wgmma<c, ci, n, false>(                          \
                              z, dtap, st, s12, dzn, wn, w, zp, dtapp, dz, part_s, sp,  \
                              part_w, dw, B, N, k, blocks, s));
  S(256, 128, 0) S(128, 64, 256) S(64, 64, 128)
#undef S
  return (int)cudaErrorInvalidValue;
}

template <int C, int CIN, int CN, bool PAD>
static cudaError_t launch_stage_tf32(const void* z, const void* dtap, const float* bn,
                                     const float* s12, const void* dzn, const float* wn,
                                     const float* w, const void* zp, const void* dtapp,
                                     const float* bnp, void* dz, float* part_s, float* sp,
                                     float* part_w, float* dw, int B, int N, int k,
                                     int blocks, cudaStream_t stream) {
  typedef F32Plan<C, CIN, CN> P;
  const int tiles = B * ((N + FTN - 1) / FTN);
  if (blocks < 1 || blocks > tiles || blocks > WBLOCKS) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stage_tf32_kernel<C, CIN, CN, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return err;
  stage_tf32_kernel<C, CIN, CN, PAD><<<blocks, FTHREADS, P::SMEM, stream>>>(
      (const float*)z, (const float*)dtap, bn, s12, (const float*)dzn, wn, w,
      (const float*)zp, (const float*)dtapp, bnp, (float*)dz, part_s, part_w, B, N, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_parts(part_s, blocks, 2 * CIN, sp, stream);
  if (err != cudaSuccess) return err;
  return sum_parts(part_w, blocks, CIN * C, dw, stream);
}

// bwd_stage for float32: the one-pass stage_tf32_kernel over `blocks` blocks
// (ops/cuda_dgcnn_bwd.py:bwd_stage_plan), part_s (blocks, 2, cin) and
// part_w (blocks, cin, C) scratch; bn and bnp the (6, C) / (6, cin) packed
// BN constants of stages i and i-1 (_bn_pack); the weights w (cin, C) and
// wn (C, cn) float32 as they are; rows 16-byte aligned; k <= KP rows a point.
extern "C" int bwd_stage_launch(const void* z, const void* dtap, const float* bn,
                                const float* s12, const void* dzn, const float* wn,
                                const float* w, const void* zp, const void* dtapp,
                                const float* bnp, void* dz, float* part_s, float* sp,
                                float* part_w, float* dw, int B, int N, int k, int C,
                                int cin, int cn, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || N > MAXN || k < 1 || k > KP) return (int)cudaErrorInvalidValue;
#define S(c, ci, n)                                                                    \
  if (C == c && cin == ci && cn == n)                                                  \
    return (int)(k < KP ? launch_stage_tf32<c, ci, n, true>(z, dtap, bn, s12, dzn, wn, w, \
                                                            zp, dtapp, bnp, dz, part_s, sp, \
                                                            part_w, dw, B, N, k, blocks, st) \
                        : launch_stage_tf32<c, ci, n, false>(z, dtap, bn, s12, dzn, wn, w, \
                                                             zp, dtapp, bnp, dz, part_s, sp, \
                                                             part_w, dw, B, N, k, blocks, st));
  S(256, 128, 0) S(128, 64, 256) S(64, 64, 128)
#undef S
  return (int)cudaErrorInvalidValue;
}

// bwd_edge for bf16: the one-pass edge_wgmma_kernel over `blocks` blocks
// (ops/cuda_dgcnn_bwd.py:bwd_edge_plan), its dW_1 partials (blocks, 6, 64)
// added in block order, then the scatter. The batch statistics of stage 1
// come as they are, float32; w2 (64, 64) and w1 (6, 64) float32; idxT the
// neighbour indices as (B, k, N) int32; dneigh (B, k, N, 3) float32
// scratch; k <= KP.
extern "C" int bwd_edge_bf16_launch(const void* z1, const void* dtap1, const float* mean,
                                    const float* var, const float* gamma,
                                    const float* beta, const float* s12,
                                    const void* dz2, const float* w2, const void* e,
                                    const float* w1, const int* idxT, float* dneigh,
                                    float* part_w, float* dw, float* dq, float* dscat,
                                    int B, int N, int k, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = B * ((N + WTN - 1) / WTN);
  if (N < 1 || N > MAXN || B < 1 || B > 65535 || k < 1 || k > KP || blocks < 1 ||
      blocks > tiles || blocks > WBLOCKS)
    return (int)cudaErrorInvalidValue;
  const BatchStats bs = {{mean, var, gamma, beta, mean, var, gamma, beta}};
  CUtensorMap zmap, dznmap;
  cudaError_t err = stage_map(&zmap, z1, 64, k, B, N);
  if (err == cudaSuccess) err = stage_map(&dznmap, dz2, 64, k, B, N);
  if (err != cudaSuccess) return (int)err;
  auto kernel = k < KP ? edge_wgmma_kernel<true> : edge_wgmma_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             EdgePlan::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, WTHREADS, EdgePlan::SMEM, st>>>(
      zmap, dznmap, (const bf16*)dtap1, bs, s12, w2, (const bf16*)e, w1, part_w, dq,
      dneigh, B, N, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_parts(part_w, blocks, 6 * 64, dw, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_scatter(idxT, dneigh, dscat, B, N, k, st);
}

// bwd_edge for float32: the one-pass edge_tf32_kernel over `blocks` blocks
// (ops/cuda_dgcnn_bwd.py:bwd_edge_plan), its dW_1 partials (blocks, 6, 64)
// added in block order, then the scatter. The arguments are those of
// bwd_edge_bf16_launch; z1, dtap1 and dz2 start 16-byte aligned.
extern "C" int bwd_edge_launch(const void* z1, const void* dtap1, const float* mean,
                               const float* var, const float* gamma, const float* beta,
                               const float* s12, const void* dz2, const float* w2,
                               const void* e, const float* w1, const int* idxT,
                               float* dneigh, float* part_w, float* dw, float* dq,
                               float* dscat, int B, int N, int k, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = B * ((N + WTN - 1) / WTN);
  if (N < 1 || N > MAXN || B < 1 || B > 65535 || k < 1 || k > KP || blocks < 1 ||
      blocks > tiles || blocks > WBLOCKS || (uintptr_t)dtap1 % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // edge_tf32_kernel's panels: boxes of 32 float32 channels
  CUtensorMap zmap, dznmap;
  cudaError_t err = stage_map(&zmap, z1, 64, k, B, N, 32, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = stage_map(&dznmap, dz2, 64, k, B, N, 32, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  auto kernel = k < KP ? edge_tf32_kernel<true> : edge_tf32_kernel<false>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               EdgeF32Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, ETHREADS, EdgeF32Plan::SMEM, st>>>(
      zmap, dznmap, (const float*)dtap1, mean, var, gamma, beta, s12, w2, (const float*)e,
      w1, part_w, dq, dneigh, B, N, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_parts(part_w, blocks, 6 * 64, dw, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_scatter(idxT, dneigh, dscat, B, N, k, st);
}
