// Exact kNN (k <= 8) over a resident Morton-sorted cloud, with an early
// exit: row 7.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _vmem_kernel (pallas_call at knn_bucketed.py:493 in _vmem_call), which the
// JAX package runs with use_vmem=True (ops.set_fusion_variant("resident")
// here). Its operands come from mvpnet_torch/ops/morton.py::prepare_device
// (csrc/morton.cu) with 64-row query tiles and 1024-ref tiles; the cloud
// holds at most 2^17 refs.
//
// The TPU kernel keeps the whole sorted cloud in VMEM (fetched once per
// batch row) and walks one query tile's ref tiles in ascending lower-bound
// order in a while loop that ends at the first lb >= worst. An H100 block
// has at most 227 KB of shared memory, too little for 2^17 x 16 B, but the
// card's L2 is 50 MB, so the cloud (0.9 MB a batch row at the train shape,
// at most 2 MB) stays L2-resident across a row's blocks, and each visited
// tile comes from there into shared memory by cp.async.bulk,
// double-buffered. The search is common.cuh's gated_search, shared with row
// 6: lanes a query row, a warp gate on the tiles' boxes under the block's
// early exit, ties by visit position. Unlike row 6 the first slot is
// gated too (the while loop's first lb < +inf).
//
// Bound on the H100: instructions, 9 a (query, ref) pair the search needs,
// at 33.5e12 lane-instructions a second (chip_smoke.py counts the pairs
// these inputs need, and those the gates let through).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
knn_resident_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4, const int* __restrict__ order,
                 const float* __restrict__ lb, const float* __restrict__ rbox, int M, int M_pad, int N_pad,
                 int tile_m, int tile_n, int lanes, int rows, float* __restrict__ out_d, int* __restrict__ out_i,
                 unsigned long long* __restrict__ scanned) {
  extern __shared__ __align__(128) float4 buf[];  // two chunks of refs
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[32];
  gated_search<K>(q4, r4, order, lb, rbox, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, false, out_d, out_i,
                  scanned, buf, bar, red);
}

template <int K>
cudaError_t launch(const float4* q4, const float4* r4, const int* order, const float* lb, const float* rbox,
                   int B, int M, int M_pad, int N_pad, int tile_m, int tile_n, int lanes, int rows, float* d,
                   int* i, unsigned long long* scanned, cudaStream_t st) {
  const int chunk = tile_n < kGatedChunk ? tile_n : kGatedChunk;
  const size_t shared = 2 * (size_t)chunk * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(knn_resident_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return err;
  const int parts = (tile_m + rows - 1) / rows;
  const int threads = (rows * lanes + 31) / 32 * 32;
  knn_resident_kernel<K><<<dim3(M_pad / tile_m * parts, B), threads, shared, st>>>(
      q4, r4, order, lb, rbox, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, d, i, scanned);
  return cudaGetLastError();
}

}  // namespace

// Operands and outputs as knn_gated's (csrc/knn_gated.cu); the Python
// wrapper takes at most 2^17 refs. `lanes` threads a query row (a power of two up to 32),
// `rows` rows a block (rows x lanes <= 512). Writes out_d (B, M, k) f32
// ascending squared distances and out_i (B, M, k) int32 original ref
// indices, in the original query order. When `scanned` is not null, the
// kernel adds to it the (real query row, ref) pairs its gates let through.
// Returns cudaError_t.
extern "C" int knn_resident(const float* q4, const float* r4, const int* order, const float* lb, const float* rbox,
                         int B, int M, int M_pad, int N_pad, int tile_m, int tile_n, int k, int lanes, int rows,
                         float* out_d, int* out_i, unsigned long long* scanned, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (!gated_args_ok(B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, kMaxThreads)) return cudaErrorInvalidValue;
  const float4* q = reinterpret_cast<const float4*>(q4);
  const float4* r = reinterpret_cast<const float4*>(r4);
  switch (k) {
    case 1: return launch<1>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 2: return launch<2>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 3: return launch<3>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 4: return launch<4>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 5: return launch<5>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 6: return launch<6>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 7: return launch<7>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    case 8: return launch<8>(q, r, order, lb, rbox, B, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, out_d, out_i, scanned, st);
    default: return cudaErrorInvalidValue;
  }
}
