// The overlap head's streamed projection softmax(q k^T) v for a one-column v,
// with the row logsumexp, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_stream.py:wproject_stream_lse
// (_wproject_kernel): q (B, N, D), k (B, M, D) in the body's type, v (B, M)
// float32 -> out (B, N) = sum_m softmax_m(q_n . k_m) v_m and lse (B, N) =
// log sum_m exp(q_n . k_m), both float32. The (N, M) similarity never exists
// in device memory (at the indoor request it would be 4.9 GB a pair).
//
// Both forms run a flash-style online softmax: each row keeps its running
// max m, sum l and accumulator acc in float32, rescaled by exp(m_old - m_new)
// when the max grows; out = acc / l and lse = m + log l. Keys past M never
// reach a sum: their logits are replaced by -inf (a select, not a product),
// so no padding value can. Both share one frame: a block of one producer
// warpgroup and two consumer warpgroups of 64 query rows each (a work unit
// is 128 rows); the producer keeps key tiles in flight by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, mbarrier-guarded stages; rows
// past M arrive as zeros and are masked by column index); the consumers
// take S = q k^T a tile with wgmma.mma_async (A, q, from registers; B, k,
// K-major from shared memory) and run the online softmax on the accumulator
// fragments (a lane holds rows g and g + 8, columns 2t, 2t + 1 of every 8),
// in base 2, p . v on the CUDA cores (v has one column). The two warpgroups
// take turns to issue their products (named barriers, as FlashAttention-3
// does), so that one runs its softmax while the tensor cores take the
// other's products. A persistent grid of one block an SM walks the
// flattened (query tile, key tile) pairs, each block an equal contiguous
// share, so every SM has work to the end; a block's share splits at
// query-tile boundaries into units (a tile and a key range), each writing
// its rows' partial (m, l, acc). A second small launch merges the partials
// of a row in unit order (no float atomics: the same bits every launch).
// ops/cuda_stream.py:wproject_units mirrors the split.
//
//  - bf16 (wproject_wgmma_kernel, D in {64, 128, 256, 512}, tiles of 64
//    keys). Bound: operations, 2 D flops a (query, key) pair at the tensor
//    cores' rate; at the indoor call (N = M = 35,000, D = 512) 1.25 TFLOP,
//    1.27 ms at 989 TFLOP/s, against 72 MB to read. The consumers hold their
//    q rows as A fragments in registers for the whole unit (D / 4 of them,
//    128 at D = 512: setmaxnreg moves registers from the producer to the
//    consumers) and take D / 16 m64n64k16 products a tile (bf16 products,
//    exact, summed in float32). Every block reads all of k: (N / 128) M D 2
//    bytes from L2, 9.8 GB at the indoor call, which the L2 holds (36 MB).
//    Clusters of two blocks sharing each tile by TMA multicast halve that,
//    but measured slower: the L2 does not bound the kernel, and two blocks'
//    rings in lockstep stall each other. Without its softmax the kernel
//    measured most of its time: the m64n64k16 products from register
//    fragments, which the 128 registers of q keep from a wider N, stand
//    between it and the bound.
//  - float32 (wproject_tf32_kernel, D a multiple of 32, tiles of 256 keys).
//    Each product q k runs on the tensor cores as three TF32 products: an
//    operand x splits into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's
//    rounding), and q k = q_lo k_hi + q_hi k_lo + q_hi k_hi into one float32
//    accumulator, about 2^-22 of each product from float32 (as
//    dgcnn_eval.cu's float32 stage chain). Bound: operations, 3 x 2 N M D
//    flops at 495 TFLOP/s and 4 N M softmax operations at 67: 7.68 ms at
//    the indoor call (18.80 ms for one float32 product on the CUDA cores).
//    TF32 wgmma takes B only K-major from shared memory, and at 128 rows a
//    q tile is 256 KB at D = 512, so neither q nor k stays resident: every
//    (unit, key tile) pair streams both in chunks of 32 features (one
//    128-byte swizzled row of float32). Tile: m64n256k8 (128 accumulator
//    registers a consumer thread) against 128 rows is 131 flops a byte of
//    operands, 3.8 TB/s from L2 at the tensor cores' rate (64 keys would
//    need 9.9). k arrives raw (32 KB a chunk, three raw slots in flight);
//    the producer warpgroup's 128 threads split each raw chunk into a high
//    and a low plane (two split stages of 64 KB: 224 KB of shared memory in
//    all), so the L2 carries k once, not twice as a split pass in device
//    memory would (6.3 TB/s). q takes no shared memory: each consumer lane
//    reads its fragment values with two 16-byte __ldg a row one chunk ahead
//    and splits them in registers, which the order of a chunk's features
//    along the products' depth allows (below). The L2 (50 MB) holds neither
//    k nor q at the indoor call (72 MB each), and the blocks' q tiles alone
//    are 34 MB: so the key order of each query tile is rotated so that
//    every block reads key tile s mod n_kt at its s-th pair (a unit that
//    finishes a tile begun by the block before lags by that block's share
//    mod n_kt), and the k in use at once is a few 0.5 MB tiles (`rotation`,
//    ops/cuda_stream.py:wproject_key_tiles). Masking, the softmax, the turns
//    and the merge are the bf16 form's.
//    Conditions that keep it fast: the next chunk's q loads go after the
//    commit (before the waits, ptxas serializes the products: C7520 in
//    ptxas -v, 13.1-13.4 ms); the producer's TMA coordinates advance by
//    ChunkCursor steps (64-bit divisions there held the producer back by
//    about 1.2 ms). The launch bound's 168 registers leave no room for a
//    second chunk of q in flight or a second producer warpgroup (512
//    threads: 128 registers, below the accumulators' 158).
//    Measured (scripts/torch_port_profile.py --probe wproject, NVIDIA H100
//    80GB HBM3, 700.00 W): 10.34 ms at the indoor call (364 TFLOP/s of TF32
//    products, 74% of the bound's rate); the key tiles in plain order 11.25;
//    for timing only, without the split 8.99, without the q loads 9.35, k by
//    TMA alone 8.36, one product a step 6.68. The tensor cores' float32
//    sums are not round-to-nearest: on trained features lse comes out about
//    1e-6 low (out within 1e-7), inside the 1e-4 the checks hold it to.
#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps
#include "tf32.cuh"    // tf32

#define WQ 128         // query rows a work unit: two consumer warpgroups of 64
#define WTHREADS 384   // one producer and two consumer warpgroups
#define L2E 1.4426950408889634f

// named barriers 1 and 2 over the 256 consumer threads: a warpgroup waits
// for its turn to issue products, then hands the turn to the other
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the integer split of a persistent grid of G blocks over T (query tile, key
// tile) pairs: block i takes pairs [i T / G, (i + 1) T / G); block_of(p) is
// the block holding pair p
__device__ __forceinline__ long long share_start(long long i, long long T, long long G) {
  return i * T / G;
}
__device__ __forceinline__ long long block_of(long long p, long long T, long long G) {
  return ((p + 1) * G - 1) / T;
}

// ---------------------------------------------------------------- bf16

#define WK 64          // keys a tile: the wgmma's N

template <int D>
struct WPlan {
  static constexpr int STAGES = D >= 512 ? 3 : D >= 256 ? 6 : 8;
  static constexpr int STAGE_BYTES = WK * D * 2;
  // + 1024: the ring starts at the first 1024-byte boundary (the swizzle's)
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
wproject_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __nv_bfloat16* __restrict__ q,
                      const float* __restrict__ v, float* __restrict__ part,
                      int B, int N, int M, int slots) {
  constexpr int KS = D / 16, ST = WPlan<D>::STAGES, SB = WPlan<D>::STAGE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n_qt = (N + WQ - 1) / WQ, n_kt = (M + WK - 1) / WK;
  const long long T = (long long)B * n_qt * n_kt, G = gridDim.x;
  const long long p0 = share_start(blockIdx.x, T, G);
  const long long p1 = share_start(blockIdx.x + 1, T, G);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long p = p0; p < p1; ++p) {
        const int tile = (int)(p / n_kt), kt = (int)(p % n_kt);
        mbar_wait(&empty[stage], phase ^ 1u);   // the first lap passes
        mbar_expect_tx(&full[stage], SB);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(ring + stage * SB + c * (WK * 128), &kmap, &full[stage],
                      c * 64, kt * WK, tile / n_qt);
        if (++stage == ST) { stage = 0; phase ^= 1u; }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tile0 = (int)(p0 / n_kt);
  int stage = 0;
  uint32_t phase = 0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (cw == 1) turn_pass(cw);   // warpgroup 0 issues first
  for (long long p = p0; p < p1;) {
    // a unit: query tile `tile`, key tiles [k0, k1)
    const int tile = (int)(p / n_kt), k0 = (int)(p % n_kt);
    const int k1 = (int)(k0 + p1 - p < n_kt ? k0 + p1 - p : n_kt);
    const int b = tile / n_qt, rr = (tile % n_qt) * WQ + cw * 64 + warp * 16 + g;
    const __nv_bfloat16* qb = q + (size_t)b * N * D;
    const float* vb = v + (size_t)b * M;
    // rows rr and rr + 8 of q as A fragments: (g, 2t), (g + 8, 2t),
    // (g, 2t + 8), (g + 8, 2t + 8) of each 16-feature step
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rr + 8 * (i & 1), c = ks * 16 + 2 * t + 8 * (i >> 1);
        qa[ks][i] = r < N ? __ldg(reinterpret_cast<const unsigned int*>(qb + (size_t)r * D + c)) : 0u;
      }
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // base-2 logits
    float l_run[2] = {0.f, 0.f}, a_run[2] = {0.f, 0.f};
    for (int kt = k0; kt < k1; ++kt) {
      const int m0 = kt * WK;
      const bool whole = m0 + WK <= M;
      float vv[8][2];   // v of this lane's columns 8 j + 2 t + e
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = m0 + 8 * j + 2 * t + e;
          vv[j][e] = whole || col < M ? __ldg(vb + col) : 0.f;
        }
      mbar_wait(&full[stage], phase);
      // the two warpgroups issue their products in turn, so that one's
      // softmax runs while the tensor cores take the other's products
      turn_wait(cw);
      fence_acc(acc);
      wgmma_fence();
      const uint32_t kbase = ring + stage * SB;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs_n64(acc, qa[ks], desc_k(kbase + (ks / 4) * (WK * 128) + (ks % 4) * 32),
                     ks > 0);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with it
      if (++stage == ST) { stage = 0; phase ^= 1u; }
      // online softmax over the tile's 64 keys: acc[4 j + e] is row g,
      // acc[4 j + 2 + e] row g + 8, column 8 j + 2 t + e
      if (!whole) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (m0 + 8 * j + 2 * t + e >= M) acc[4 * j + e] = acc[4 * j + 2 + e] = -CUDART_INF_F;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx * L2E);  // finite: a tile has a key
        const float alpha = ex2(m_run[h] - m_new);      // 0 on a unit's first tile
        float ps = 0.f, pv = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(fmaf(acc[4 * j + 2 * h + e], L2E, -m_new));  // -inf -> 0
            ps += pe;
            pv = fmaf(pe, vv[j][e], pv);
          }
        l_run[h] = fmaf(l_run[h], alpha, ps);
        a_run[h] = fmaf(a_run[h], alpha, pv);
        m_run[h] = m_new;
      }
    }
    // the unit's partial (m, l, acc) of each row, lanes of a row summed
    float* dst = part + (size_t)((long long)blockIdx.x * slots + (tile - tile0)) * 3 * WQ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h], a = a_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (t == 0) {
        const int row = cw * 64 + warp * 16 + g + 8 * h;
        dst[row] = m_run[h];
        dst[WQ + row] = l;
        dst[2 * WQ + row] = a;
      }
    }
    p += k1 - k0;
  }
}

// ------------------------------------------------------------- float32

#define FK 256         // keys a tile: the TF32 wgmma's N
#define FC 32          // features a chunk: a 128-byte swizzled row of float32
#define FSTAGES 2      // split chunks (a high and a low plane each) in a block
#define FRAW 3         // raw chunks in flight by TMA
#define FCHUNK (FK * FC * 4)   // bytes of one plane of a chunk
// two planes a split stage and the raw slots, from the first 1024-byte
// boundary (the swizzle's): ops/cuda_stream.py:wproject_f32_smem_bytes
#define FSMEM ((2 * FSTAGES + FRAW) * FCHUNK + 1024)

// the first logical key tile of query tile `tile` is physical key tile
// rotation(...): the block holding the tile's last pair reads, at the s-th
// pair of its share, key tile s mod n_kt, as every block does
__device__ __forceinline__ int rotation(int tile, int n_kt, long long T, long long G) {
  const long long i = block_of((long long)tile * n_kt + n_kt - 1, T, G);
  return (int)((n_kt - share_start(i, T, G) % n_kt) % n_kt);
}

// the chunks of a block's share in order, for the producer's TMA: chunk c
// (features c FC) of logical key tile k of query tile `tile`, which is
// physical key tile kt of batch b; a step costs divisions only where a
// query tile begins
struct ChunkCursor {
  int c, k, tile, kt, b;
  __device__ __forceinline__ void at(long long p, int n_kt, int n_qt, long long T,
                                     long long G) {
    c = 0;
    tile = (int)(p / n_kt);
    k = (int)(p % n_kt);
    b = tile / n_qt;
    kt = k + rotation(tile, n_kt, T, G);
    if (kt >= n_kt) kt -= n_kt;
  }
  __device__ __forceinline__ void next(int nch, int n_kt, int n_qt, long long T,
                                       long long G) {
    if (++c < nch) return;
    c = 0;
    if (++k < n_kt) {
      if (++kt == n_kt) kt = 0;
      return;
    }
    k = 0;
    ++tile;
    b = tile / n_qt;
    kt = rotation(tile, n_kt, T, G);
  }
};

// this lane's q rows (row_in and row_in + 8 of the query tile of pair p;
// null past N)
__device__ __forceinline__ void q_rows(const float* q, long long p, int n_kt, int n_qt,
                                       int N, int D, int row_in, const float*& r0,
                                       const float*& r1) {
  const int tile = (int)(p / n_kt), b = tile / n_qt, r = (tile % n_qt) * WQ + row_in;
  const float* qb = q + (size_t)b * N * D;
  r0 = r < N ? qb + (size_t)r * D : nullptr;
  r1 = r + 8 < N ? qb + (size_t)(r + 8) * D : nullptr;
}

// The order of a chunk's 32 features along the products' depth: k8 step st
// takes features 8 j + 2 st (A column j, j < 4) and 8 j + 2 st + 1 (column
// j + 4). So lane t's A values over the 4 steps are features 8 t .. 8 t + 7
// of its rows, one 32-byte run each, and the k planes hold, at 16-byte
// chunk 4 h + e of a key's row, features 8 j + 4 h + e for j = 0..3: the
// transpose of the raw chunks h, 2 + h, 4 + h, 6 + h.

// the lane's q values of the chunk at feature f0: features f0 + 8 t .. + 7
// of rows g (qr[0..7]) and g + 8 (qr[8..15])
__device__ __forceinline__ void load_q(float (&qr)[16], const float* r0, const float* r1,
                                       int f0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* r = h ? r1 : r0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 x = r != nullptr
          ? __ldg(reinterpret_cast<const float4*>(r + f0 + 8 * t) + u)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[8 * h + 4 * u] = x.x;
      qr[8 * h + 4 * u + 1] = x.y;
      qr[8 * h + 4 * u + 2] = x.z;
      qr[8 * h + 4 * u + 3] = x.w;
    }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(WTHREADS, 1)
wproject_tf32_kernel(const __grid_constant__ CUtensorMap kmap,
                     const float* __restrict__ q, const float* __restrict__ v,
                     float* __restrict__ part, int B, int N, int M, int D, int slots) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kfull[FSTAGES], kempty[FSTAGES], rawfull[FRAW];
  // split stage s: its high plane at base + 2 s FCHUNK, the low plane
  // FCHUNK further; raw slot r at base + (2 FSTAGES + r) FCHUNK
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  const int nch = D / FC;
  const int n_qt = (N + WQ - 1) / WQ, n_kt = (M + FK - 1) / FK;
  const long long T = (long long)B * n_qt * n_kt, G = gridDim.x;
  const long long p0 = share_start(blockIdx.x, T, G);
  const long long p1 = share_start(blockIdx.x + 1, T, G);
  const long long chunks = (p1 - p0) * nch;   // of this block's share
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&kfull[s], 128);   // every producer thread, after its split
      mbar_init(&kempty[s], 8);    // one arrival from each consumer warp
    }
#pragma unroll
    for (int r = 0; r < FRAW; ++r) mbar_init(&rawfull[r], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pt = threadIdx.x;
    ChunkCursor cur;   // thread 0's next chunk to fetch
    auto fetch = [&](int r) {
      mbar_expect_tx(&rawfull[r], FCHUNK);
      tma_load_3d(base + (uint32_t)(2 * FSTAGES + r) * FCHUNK, &kmap, &rawfull[r],
                  cur.c * FC, cur.kt * FK, cur.b);
      cur.next(nch, n_kt, n_qt, T, G);
    };
    if (pt == 0) {
      cur.at(p0, n_kt, n_qt, T, G);
      for (int r = 0; r < FRAW && r < chunks; ++r) fetch(r);
    }
    int r = 0, s = 0;
    uint32_t rph = 0, sph = 0;   // the rings' parities
    for (long long j = 0; j < chunks; ++j) {
      mbar_wait(&rawfull[r], rph);
      mbar_wait(&kempty[s], sph ^ 1u);   // the first lap passes
      // the raw chunk -> TF32 high and low planes in the products' feature
      // order (above), a half row of a key at a time: raw 16-byte chunks h,
      // 2 + h, 4 + h, 6 + h transposed into chunks 4 h .. 4 h + 3, each at
      // its swizzled place (chunk c of row n at c ^ (n mod 8))
      const float4* raw = reinterpret_cast<const float4*>(sm + (2 * FSTAGES + r) * FCHUNK);
      uint4* hi = reinterpret_cast<uint4*>(sm + 2 * s * FCHUNK);
      uint4* lo = reinterpret_cast<uint4*>(sm + (2 * s + 1) * FCHUNK);
#pragma unroll 2
      for (int w = pt; w < 2 * FK; w += 128) {
        const int n = w % FK, h = w / FK, sw = n % 8;
        float4 in[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) in[jj] = raw[8 * n + ((2 * jj + h) ^ sw)];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hv[4], lv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float x = lane4(in[jj], e);
            hv[jj] = tf32(x);
            lv[jj] = tf32(__fsub_rn(x, __uint_as_float(hv[jj])));
          }
          hi[8 * n + ((4 * h + e) ^ sw)] = make_uint4(hv[0], hv[1], hv[2], hv[3]);
          lo[8 * n + ((4 * h + e) ^ sw)] = make_uint4(lv[0], lv[1], lv[2], lv[3]);
        }
      }
      // the planes to the consumers' wgmma, the raw slot to the next TMA
      fence_proxy_async();
      mbar_arrive(&kfull[s]);
      asm volatile("bar.sync 3, 128;\n" ::: "memory");   // every thread is done with slot r
      if (pt == 0 && j + FRAW < chunks) fetch(r);
      if (++r == FRAW) { r = 0; rph ^= 1u; }
      if (++s == FSTAGES) { s = 0; sph ^= 1u; }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row_in = cw * 64 + warp * 16 + g;   // this lane's rows of a unit: +0, +8
  const int tile0 = (int)(p0 / n_kt);
  float acc[128];
  float qr[16];            // the next chunk's q values, as loaded (load_q)
  uint32_t qh[4][4], ql[4][4];   // this chunk's A fragments, high and low
  const float *r0, *r1;
  q_rows(q, p0, n_kt, n_qt, N, D, row_in, r0, r1);
  load_q(qr, r0, r1, 0, t);
  int s = 0;
  uint32_t sph = 0;   // the split ring's stage and parity
  if (cw == 1) turn_pass(cw);   // warpgroup 0 issues first
  for (long long p = p0; p < p1;) {
    // a unit: query tile `tile`, logical key tiles [k0, k1)
    const int tile = (int)(p / n_kt), k0 = (int)(p % n_kt);
    const int k1 = (int)(k0 + p1 - p < n_kt ? k0 + p1 - p : n_kt);
    const int rot = rotation(tile, n_kt, T, G);
    const float* vb = v + (size_t)(tile / n_qt) * M;
    const long long pn = p + (k1 - k0);   // the next unit's first pair
    const float *n0 = nullptr, *n1 = nullptr;
    if (pn < p1) q_rows(q, pn, n_kt, n_qt, N, D, row_in, n0, n1);
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // base-2 logits
    float l_run[2] = {0.f, 0.f}, a_run[2] = {0.f, 0.f};
    for (int kk = k0; kk < k1; ++kk) {
      const int m0 = (kk + rot < n_kt ? kk + rot : kk + rot - n_kt) * FK;
      for (int c = 0; c < nch; ++c) {
        mbar_wait(&kfull[s], sph);
        turn_wait(cw);
        // the A fragments, split right before the fence: no divergent path
        // (the waits' spin loops) between their writes and the products;
        // a[i] of step st is row g + 8 (i & 1), feature 8 t + 2 st + (i >> 1)
#pragma unroll
        for (int st = 0; st < 4; ++st)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = qr[8 * (i & 1) + 2 * st + (i >> 1)];
            qh[st][i] = tf32(x);
            ql[st][i] = tf32(__fsub_rn(x, __uint_as_float(qh[st][i])));
          }
        fence_acc(acc);
        wgmma_fence();
        const uint32_t hi = base + 2 * s * FCHUNK, lo = hi + FCHUNK;
#pragma unroll
        for (int st = 0; st < 4; ++st) {   // k8 step st: the planes' bytes 32 st..
          wgmma_rs_n256_tf32(acc, ql[st], desc_k(hi + st * 32), c > 0 || st > 0);
          wgmma_rs_n256_tf32(acc, qh[st], desc_k(lo + st * 32), 1);
          wgmma_rs_n256_tf32(acc, qh[st], desc_k(hi + st * 32), 1);
        }
        wgmma_commit();
        turn_pass(cw);
        // the next chunk's q, in flight under this chunk's products
        if (c + 1 < nch) load_q(qr, r0, r1, (c + 1) * FC, t);
        else if (kk + 1 < k1) load_q(qr, r0, r1, 0, t);
        else if (pn < p1) load_q(qr, n0, n1, 0, t);
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&kempty[s]);   // this warp is done with it
        if (++s == FSTAGES) { s = 0; sph ^= 1u; }
      }
      // online softmax over the tile's 256 keys: acc[4 jj + e] is row g,
      // acc[4 jj + 2 + e] row g + 8, column 8 jj + 2 t + e
      const bool whole = m0 + FK <= M;
      if (!whole) {
#pragma unroll
        for (int jj = 0; jj < 32; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (m0 + 8 * jj + 2 * t + e >= M) acc[4 * jj + e] = acc[4 * jj + 2 + e] = -CUDART_INF_F;
      }
      float m_new[2], alpha[2], ps[2] = {0.f, 0.f}, pv[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int jj = 0; jj < 32; ++jj)
          mx = fmaxf(mx, fmaxf(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[h] = fmaxf(m_run[h], mx * L2E);   // finite: a tile has a key
        alpha[h] = ex2(m_run[h] - m_new[h]);    // 0 on a unit's first tile
      }
#pragma unroll
      for (int jj = 0; jj < 32; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = m0 + 8 * jj + 2 * t + e;
          const float vv = whole || col < M ? __ldg(vb + col) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float pe = ex2(fmaf(acc[4 * jj + 2 * h + e], L2E, -m_new[h]));  // -inf -> 0
            ps[h] += pe;
            pv[h] = fmaf(pe, vv, pv[h]);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] = fmaf(l_run[h], alpha[h], ps[h]);
        a_run[h] = fmaf(a_run[h], alpha[h], pv[h]);
        m_run[h] = m_new[h];
      }
    }
    // the unit's partial (m, l, acc) of each row, lanes of a row summed
    float* dst = part + (size_t)((long long)blockIdx.x * slots + (tile - tile0)) * 3 * WQ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h], a = a_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (t == 0) {
        dst[row_in + 8 * h] = m_run[h];
        dst[WQ + row_in + 8 * h] = l;
        dst[2 * WQ + row_in + 8 * h] = a;
      }
    }
    r0 = n0;
    r1 = n1;
    p = pn;
  }
}

// ---------------------------------------------------------------- merge

// one thread a row: the partials of its query tile's units (key tiles of
// `keys`), in unit order -> out, lse
__global__ void __launch_bounds__(256)
wproject_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                      float* __restrict__ lse, int B, int N, int M, int keys, int slots,
                      int G) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * N) return;
  const int b = idx / N, n = idx % N;
  const int n_qt = (N + WQ - 1) / WQ, n_kt = (M + keys - 1) / keys;
  const long long T = (long long)B * n_qt * n_kt;
  const int tile = b * n_qt + n / WQ, row = n % WQ;
  const long long pa = (long long)tile * n_kt;
  const int g0 = (int)block_of(pa, T, G), g1 = (int)block_of(pa + n_kt - 1, T, G);
  float mx = -CUDART_INF_F;
  for (int i = g0; i <= g1; ++i) {
    const int s = tile - (int)(share_start(i, T, G) / n_kt);
    mx = fmaxf(mx, part[((size_t)i * slots + s) * 3 * WQ + row]);
  }
  float l = 0.f, a = 0.f;
  for (int i = g0; i <= g1; ++i) {
    const int s = tile - (int)(share_start(i, T, G) / n_kt);
    const float* src = part + ((size_t)i * slots + s) * 3 * WQ;
    const float w = exp2f(src[row] - mx);
    l = fmaf(src[WQ + row], w, l);
    a = fmaf(src[2 * WQ + row], w, a);
  }
  out[idx] = a / l;
  lse[idx] = (mx + log2f(l)) * 0.6931471805599453f;
}

// ---------------------------------------------------------------- launch

// k (B, M, D) as a 3-D tensor map of boxes (box0 features, keys, 1)
static cudaError_t key_map(CUtensorMap* map, const void* k, CUtensorMapDataType type,
                           int esize, int B, int M, int D, int box0, int keys) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * esize, (cuuint64_t)M * D * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)keys, 1};
  return make_map(map, k, 3, dims, strides, box, type);
}

static cudaError_t merge(const float* part, float* out, float* lse, int B, int N, int M,
                         int keys, int slots, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();   // the projection's launch
  if (err != cudaSuccess) return err;
  wproject_merge_kernel<<<(B * N + 255) / 256, 256, 0, stream>>>(
      part, out, lse, B, N, M, keys, slots, blocks);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_bf16(const void* q, const void* k, const float* v,
                               float* out, float* lse, float* part, int B, int N,
                               int M, int blocks, int slots, cudaStream_t stream) {
  CUtensorMap kmap;
  cudaError_t err = key_map(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, M, D, 64, WK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wproject_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WPlan<D>::SMEM);
  if (err != cudaSuccess) return err;
  wproject_wgmma_kernel<D><<<blocks, WTHREADS, WPlan<D>::SMEM, stream>>>(
      kmap, (const __nv_bfloat16*)q, v, part, B, N, M, slots);
  return merge(part, out, lse, B, N, M, WK, slots, blocks, stream);
}

static cudaError_t launch_f32(const void* q, const void* k, const float* v, float* out,
                              float* lse, float* part, int B, int N, int M, int D,
                              int blocks, int slots, cudaStream_t stream) {
  CUtensorMap kmap;
  cudaError_t err = key_map(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, M, D, FC, FK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wproject_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, FSMEM);
  if (err != cudaSuccess) return err;
  wproject_tf32_kernel<<<blocks, WTHREADS, FSMEM, stream>>>(
      kmap, (const float*)q, v, part, B, N, M, D, slots);
  return merge(part, out, lse, B, N, M, FK, slots, blocks, stream);
}

// blocks and slots: ops/cuda_stream.py:wproject_plan (keys a tile 64 bf16,
// 256 float32)
extern "C" int wproject_launch(const void* q, const void* k, const float* v,
                               float* out, float* lse, float* part, int B, int N,
                               int M, int D, int is_bf16, int blocks, int slots,
                               void* stream_ptr) {
  if (B < 1 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int keys = is_bf16 ? WK : FK;
  const long long T = (long long)B * ((N + WQ - 1) / WQ) * ((M + keys - 1) / keys);
  if (blocks < 1 || blocks > T || slots < 1 || part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (D) {
      case 64: return (int)launch_bf16<64>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      case 128: return (int)launch_bf16<128>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      case 256: return (int)launch_bf16<256>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      case 512: return (int)launch_bf16<512>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D < FC || D % FC != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_f32(q, k, v, out, lse, part, B, N, M, D, blocks, slots, stream);
}
