// k nearest neighbours of 3-D points for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:knn_pallas
// (_knn_kernel), which keeps the whole target cloud on chip for M <= 4096 and
// runs k passes of (min, argmin, mask) over a (tile, M) distance block.
//
// Here it is knn_kernel<K, IndexOut> of knn_lanes.cuh, the dense selection
// the DGCNN graphs and the angle kernel share: the target cloud in shared
// memory as (x, y, z, |t|^2), 64 queries a block, four lanes a query with
// sorted register lists, a threshold from a first pass over sub-tile
// minima, buffered insertion and a merge by rank.
//
// K is a template parameter, compiled for the k the paths and the checks use
// (KNN_KS: 1, 5, 20, 32); any other k <= 32 takes the next compiled K and
// writes the first k of its K pairs, which are the k smallest in order
// (ops/cuda_knn.py:knn_plan mirrors the choice and the launch). Above
// k = 32, to k = M, the TPU kernel's envelope, it is knn_wide_kernel<IndexOut>
// of knn_wide.cuh, whatever K the wrapper passes: a warp a query, the k-th
// smallest distance by bisection of its bits, the k pairs gathered in index
// order and sorted in shared memory, exact and in the same order. The output
// is int64 (B, N, k), ascending distance, ties to the lowest index: the
// order of k passes of argmin-and-mask over the whole row
// (ops/common.py:select_smallest). Distances are the fixed-order float32 form
// of knn_select.cuh, clamped at 1e-12, so the kernel and its plain version
// (ops/cuda_knn.py:knn_reference) pick the same neighbours in the same
// order. N and M may differ (a cross kNN).
//
// Bound: operations. Each (query, target) pair costs 8 flops of distance and
// a compare; bytes are 12 per point read and 8 k per query written. What
// holds it from the bound: the second pass over the distances, the insertion
// chains (K compare-and-swap steps a candidate, the warp waiting for its
// busiest lane) and the merge.
#include <cuda_runtime.h>

#include "knn_lanes.cuh"   // knn_kernel, knn_launch_k, IndexOut
#include "knn_wide.cuh"    // knn_wide_launch

#define MAXM 4096          // the TPU kernel's envelope
#define MAXK 32            // the register lists' longest
// the compiled K (ascending); X is a macro of one K
#define KNN_KS(X) X(1) X(5) X(20) X(32)

// K: the compiled list length the wrapper chose (ops/cuda_knn.py:knn_plan),
// the smallest of KNN_KS at or above k; above MAXK the wide selection runs
// and K is not read
extern "C" int knn_launch(const float* src, const float* tgt, long long* idx,
                          int B, int N, int M, int k, int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (M < 1 || M > MAXM || N < 1 || B < 1 || B > 65535 || k < 1 || k > M)
    return (int)cudaErrorInvalidValue;
  if (k > MAXK)
    return (int)knn_wide_launch(src, tgt, IndexOut{idx}, B, N, M, k, stream);
  if (K < k) return (int)cudaErrorInvalidValue;
#define CASE(KK) \
  if (K == KK) return (int)knn_launch_k<KK>(src, tgt, IndexOut{idx}, B, N, M, k, stream);
  KNN_KS(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
