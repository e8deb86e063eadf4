// The attention blocks' eval PointMLP, Dense -> InstanceNorm -> ReLU ->
// Dense, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_mlp.py:pointmlp_eval_pallas
// (_mlp_kernel): x (B, N, Cin) in the compute type T (bf16 or float32),
// weights in the nn.Linear layout w1 (H, Cin), w2 (Cout, H), biases in T:
//   z   = T(x w1^T, summed in float32) + b1          (the add in T)
//   mu, var over the N points of a cloud, float32, two passes, biased
//   h   = relu(T((z - mu) / sqrt(var + 1e-5)))
//   out = T(h w2^T, summed in float32) + b2           (the add in T)
// the rounding points of the TPU kernel and of the eager chain
// (Dense(dtype) -> instance_norm -> relu -> Dense(dtype)), so that the
// moments are taken over the rounded z.
//
// Two launches, one call:
//  1. mlp_norm_kernel: a block owns one cloud and a tile of TC columns of H.
//     It walks the cloud's rows in tiles of 128, computes z for them and
//     keeps all N <= 1024 rows of its columns in shared memory (in T: the
//     values are exactly representable after the rounding), then takes the
//     moments over them in a fixed order and writes h (B, N, H) in T.
//  2. mlp_out_kernel: h w2^T + b2 over tiles of 128 rows of the B N rows.
// Both products come from one tile routine: bf16 on the tensor cores with
// mma.sync m16n8k16 (bf16 products, exact, summed in float32), A and B
// fragments by ldmatrix from chunks of 64 of the depth, double-buffered in
// shared memory with cp.async (the fragment code of wproject.cu); float32 on
// the CUDA cores, each thread 4 rows by 4 columns.
//
// Bound: operations. 2 B N (Cin H + H Cout) products at the tensor cores'
// rate (1.08e11 at the attention shape, 0.11 ms) against 0.1 GB moved. The
// first kernel keeps the moments' reduction over N on chip, which the eager
// chain pays for with separate passes over z in device memory; staging both
// operands through shared memory with ldmatrix, not wgmma, bounds the
// products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define NT 256     // threads a block, 8 warps
#define BR 128     // rows of a product tile (8 warps x 16 for bf16)
#define MAXN 1024  // the rows of one cloud held in shared memory

typedef __nv_bfloat16 bf16;

// column tile, depth of a staged chunk and padded row strides per type;
// a staged row of 36 words (4 mod 32) keeps the fragment loads free of bank
// conflicts
template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int TC = 64, KC = 64, LD = 72, ZLD = 72;
  static constexpr int STAGE_BYTES = 2 * (BR + TC) * LD * 2;
};
template <> struct Tile<float> {
  static constexpr int TC = 32, KC = 32, LD = 36, ZLD = 36;
  static constexpr int STAGE_BYTES = (BR + TC) * LD * 4;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// T(acc) + b in T: the float32 sum of the two T values, rounded to T
template <typename T>
__device__ __forceinline__ T add_bias(float acc, T b) {
  return from_f<T>(__fadd_rn(to_f(from_f<T>(acc)), to_f(b)));
}

// ------------------------------------------------------- bf16 products

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the rows of
// matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global -> shared without registers; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0));
}

// depth [k0, k0 + KC) of rows [r0, r0 + BR) of A (rows, K) and of rows
// [c0, c0 + TC) of W (cols, K) into sa (BR x LD) and sw (TC x LD); rows of A
// past `rows` read as zeros
__device__ __forceinline__ void stage_bf16(bf16* sa, bf16* sw,
                                           const bf16* __restrict__ A, int rows,
                                           const bf16* __restrict__ W, int K,
                                           int r0, int c0, int k0) {
  typedef Tile<bf16> TL;
  constexpr int PER_ROW = TL::KC / 8;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < BR * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    const bool valid = r0 + r < rows;
    cp_async16(sa + r * TL::LD + c,
               A + (valid ? (size_t)(r0 + r) * K + k0 + c : 0), valid);
  }
  for (int e = threadIdx.x; e < TL::TC * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    cp_async16(sw + r * TL::LD + c, W + (size_t)(c0 + r) * K + k0 + c, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The (BR, TC) tile at (r0, c0) of A W^T, A (rows, K), W (cols, K), bf16,
// summed in float32; emit(row, col, value) for each entry (rows past `rows`
// included: the caller drops them). Warp w owns rows 16 w .. 16 w + 15.
template <class Emit>
__device__ __forceinline__ void product(const bf16* __restrict__ A, int rows,
                                        const bf16* __restrict__ W, int K,
                                        int r0, int c0, unsigned char* smem,
                                        Emit emit) {
  typedef Tile<bf16> TL;
  bf16* base = reinterpret_cast<bf16*>(smem);
  bf16* sa[2] = {base, base + BR * TL::LD};
  bf16* sw[2] = {base + 2 * BR * TL::LD, base + 2 * BR * TL::LD + TL::TC * TL::LD};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[TL::TC / 8][4];
#pragma unroll
  for (int nt = 0; nt < TL::TC / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int nk = K / TL::KC;
  stage_bf16(sa[0], sw[0], A, rows, W, K, r0, c0, 0);
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      stage_bf16(sa[(j + 1) & 1], sw[(j + 1) & 1], A, rows, W, K, r0, c0,
                 (j + 1) * TL::KC);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const bf16* a = sa[j & 1];
    const bf16* w = sw[j & 1];
#pragma unroll
    for (int ks = 0; ks < TL::KC / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, a + (warp * 16 + (lane % 8) + ((lane >> 3) & 1) * 8) * TL::LD
                      + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < TL::TC / 16; ++np) {
        uint32_t bfr[4];  // n-tiles 2 np and 2 np + 1, depth halves 0 and 1
        ldsm_x4(bfr, w + (np * 16 + (lane % 8) + (lane >> 4) * 8) * TL::LD
                         + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();   // the buffer of this chunk is refilled next trip
  }
  // accumulator entry e of n-tile nt: row g + 8 (e / 2), column 2 t + e % 2
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < TL::TC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      emit(r0 + warp * 16 + g + 8 * (e / 2), c0 + nt * 8 + 2 * t + e % 2, acc[nt][e]);
}

// ---------------------------------------------------- float32 products

// The same tile of A W^T in float32 on the CUDA cores: thread (i, j) of the
// (32, 8) grid owns rows 4 i .. 4 i + 3 and columns j, j + 8, j + 16, j + 24.
template <class Emit>
__device__ __forceinline__ void product(const float* __restrict__ A, int rows,
                                        const float* __restrict__ W, int K,
                                        int r0, int c0, unsigned char* smem,
                                        Emit emit) {
  typedef Tile<float> TL;
  float* sa = reinterpret_cast<float*>(smem);
  float* sw = sa + BR * TL::LD;
  const int tid = threadIdx.x, rg = (tid / 8) * 4, cg = tid % 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += TL::KC) {
    __syncthreads();
    for (int e = tid; e < BR * TL::KC / 4; e += NT) {
      const int r = e / (TL::KC / 4), c = (e % (TL::KC / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows)
        v = *reinterpret_cast<const float4*>(A + (size_t)(r0 + r) * K + k0 + c);
      *reinterpret_cast<float4*>(sa + r * TL::LD + c) = v;
    }
    for (int e = tid; e < TL::TC * TL::KC / 4; e += NT) {
      const int r = e / (TL::KC / 4), c = (e % (TL::KC / 4)) * 4;
      *reinterpret_cast<float4*>(sw + r * TL::LD + c) =
          *reinterpret_cast<const float4*>(W + (size_t)(c0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TL::KC; kk += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sa + (rg + i) * TL::LD + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(sw + (cg + 8 * j) * TL::LD + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) emit(r0 + rg + i, c0 + cg + 8 * j, acc[i][j]);
}

// ---------------------------------------------------------- the kernels

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mlp_norm_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ b1, T* __restrict__ h, int N, int Cin,
                int H) {
  typedef Tile<T> TL;
  constexpr int P = NT / TL::TC;        // row groups of the moments
  extern __shared__ __align__(16) unsigned char smem[];
  T* zs = reinterpret_cast<T*>(smem);   // (N, ZLD): z of this column tile
  unsigned char* stage = smem + align16(N * TL::ZLD * (int)sizeof(T));
  __shared__ float red[P][TL::TC];
  __shared__ float mean[TL::TC], inv[TL::TC];
  const int b = blockIdx.y, c0 = blockIdx.x * TL::TC, tid = threadIdx.x;
  const T* xb = x + (size_t)b * N * Cin;

  for (int r0 = 0; r0 < N; r0 += BR)
    product(xb, N, w1, Cin, r0, c0, stage, [&](int r, int c, float acc) {
      if (r < N) zs[r * TL::ZLD + c - c0] = add_bias<T>(acc, b1[c]);
    });
  __syncthreads();

  // moments over the N rows, each column in P row groups, summed in order
  const int col = tid % TL::TC, part = tid / TL::TC;
  float s = 0.f;
  for (int r = part; r < N; r += P) s += to_f(zs[r * TL::ZLD + col]);
  red[part][col] = s;
  __syncthreads();
  if (tid < TL::TC) {
    float tot = 0.f;
    for (int p = 0; p < P; ++p) tot += red[p][tid];
    mean[tid] = tot / (float)N;
  }
  __syncthreads();
  const float mu = mean[col];
  s = 0.f;
  for (int r = part; r < N; r += P) {
    const float d = __fsub_rn(to_f(zs[r * TL::ZLD + col]), mu);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  red[part][col] = s;
  __syncthreads();
  if (tid < TL::TC) {
    float tot = 0.f;
    for (int p = 0; p < P; ++p) tot += red[p][tid];
    inv[tid] = 1.0f / sqrtf(tot / (float)N + 1e-5f);
  }
  __syncthreads();

  // h = relu(T((z - mu) * inv)), a row's TC columns by consecutive threads
  T* hb = h + (size_t)b * N * H + c0;
  for (int e = tid; e < N * TL::TC; e += NT) {
    const int r = e / TL::TC, c = e % TL::TC;
    const float v = to_f(from_f<T>(__fmul_rn(
        __fsub_rn(to_f(zs[r * TL::ZLD + c]), mean[c]), inv[c])));
    hb[(size_t)r * H + c] = from_f<T>(v > 0.f ? v : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlp_out_kernel(const T* __restrict__ h, const T* __restrict__ w2,
               const T* __restrict__ b2, T* __restrict__ out, int rows, int H,
               int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * BR, c0 = blockIdx.x * Tile<T>::TC;
  product(h, rows, w2, H, r0, c0, smem, [&](int r, int c, float acc) {
    if (r < rows) out[(size_t)r * Cout + c] = add_bias<T>(acc, b2[c]);
  });
}

template <typename T>
static cudaError_t launch(const void* x, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* h, void* out,
                          int B, int N, int Cin, int H, int Cout,
                          cudaStream_t stream) {
  typedef Tile<T> TL;
  const int smem1 = align16(N * TL::ZLD * (int)sizeof(T)) + TL::STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::STAGE_BYTES);
  if (err != cudaSuccess) return err;
  mlp_norm_kernel<T><<<dim3(H / TL::TC, B), NT, smem1, stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (T*)h, N, Cin, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * N;
  mlp_out_kernel<T><<<dim3(Cout / TL::TC, (rows + BR - 1) / BR), NT,
                      TL::STAGE_BYTES, stream>>>(
      (const T*)h, (const T*)w2, (const T*)b2, (T*)out, rows, H, Cout);
  return cudaGetLastError();
}

// x (B, N, Cin), w1 (H, Cin), b1 (H), w2 (Cout, H), b2 (Cout), all in the
// compute type; h (B, N, H) scratch, out (B, N, Cout). Takes N <= 1024 and
// Cin, H, Cout multiples of 64; 16-byte aligned rows.
extern "C" int pointmlp_launch(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h,
                               void* out, int B, int N, int Cin, int H,
                               int Cout, int is_bf16, void* stream_ptr) {
  if (B < 1 || N < 1 || N > MAXN || Cin % 64 || H % 64 || Cout % 64 ||
      Cin < 64 || H < 64 || Cout < 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_bf16)
    return (int)launch<bf16>(x, w1, b1, w2, b2, h, out, B, N, Cin, H, Cout, stream);
  return (int)launch<float>(x, w1, b1, w2, b2, h, out, B, N, Cin, H, Cout, stream);
}
