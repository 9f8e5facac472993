// Exact kNN (k <= 8) over Morton-sorted refs, gated per ref tile: row 6.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _gated_kernel (pallas_call at knn_bucketed.py:797 in _knn_forward), which
// the JAX package runs with _USE_DEMAND = False (ops.set_fusion_variant
// ("gated") here). Its operands come from mvpnet_torch/ops/morton.py::
// prepare_device (csrc/morton.cu): 256-row query tiles, 2048-ref tiles below
// 2^18 refs and 8192 from there up.
//
// The TPU kernel runs a grid (B, query tile, visit slot) whose last axis is
// sequential and carries the running top-k in scratch; each slot is gated by
// lb < the query tile's worst k-th distance, and from 2^18 refs each 8-row
// subgroup by its own box. Blocks on Hopper run in parallel and in no
// order, so a block loops over its query tile's visit list itself: the
// search is common.cuh's gated_search, shared with row 7, where the lanes of
// a query row, the warp gate (the subgroup gate at a warp's rows, at every
// size: a GPU saves work only where a whole warp skips), the bulk-copied
// chunks and the tie order are described. The first slot is always
// scanned, as the TPU kernel's t == 0.
//
// Bound on the H100: instructions, 9 a (query, ref) pair the search needs
// (-fmad=false: each operation its own), at 33.5e12 lane-instructions a
// second; chip_smoke.py counts the pairs these inputs need (each row's tiles
// whose box lies nearer than its k-th distance), and beside them the pairs
// the gates let through. The design cuts the pairs by gating finer than the
// tile, and the time a slow block takes by splitting its rows over lanes.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
knn_gated_kernel(const float4* __restrict__ q4, const float4* __restrict__ r4, const int* __restrict__ order,
                 const float* __restrict__ lb, const float* __restrict__ rbox, int M, int M_pad, int N_pad,
                 int tile_m, int tile_n, int lanes, int rows, float* __restrict__ out_d, int* __restrict__ out_i,
                 unsigned long long* __restrict__ scanned) {
  extern __shared__ __align__(128) float4 buf[];  // two chunks of refs
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[32];
  gated_search<K>(q4, r4, order, lb, rbox, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, true, out_d, out_i,
                  scanned, buf, bar, red);
}

template <int K>
cudaError_t launch(const float4* q4, const float4* r4, const int* order, const float* lb, const float* rbox,
                   int B, int M, int M_pad, int N_pad, int tile_m, int tile_n, int lanes, int rows, float* d,
                   int* i, unsigned long long* scanned, cudaStream_t st) {
  const int chunk = tile_n < kGatedChunk ? tile_n : kGatedChunk;
  const size_t shared = 2 * (size_t)chunk * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(knn_gated_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return err;
  const int parts = (tile_m + rows - 1) / rows;
  const int threads = (rows * lanes + 31) / 32 * 32;
  knn_gated_kernel<K><<<dim3(M_pad / tile_m * parts, B), threads, shared, st>>>(
      q4, r4, order, lb, rbox, M, M_pad, N_pad, tile_m, tile_n, lanes, rows, d, i, scanned);
  return cudaGetLastError();
}

}  // namespace

// q4 (B, M_pad, 4), r4 (B, N_pad, 4), rbox (B, Nt, 6), order (B, Mt, Nt)
// int32 and lb (B, Mt, Nt) f32, as ops/morton.py::prepare_device writes them
// (Mt = M_pad / tile_m, Nt = N_pad / tile_n; tile_n at most 2048 or a
// multiple of it). `lanes` threads a query row (a power of two up to 32),
// `rows` rows a block (rows x lanes <= 512). Writes out_d (B, M, k) f32
// ascending squared distances and out_i (B, M, k) int32 original ref
// indices, in the original query order. When `scanned` is not null, the
// kernel adds to it the (real query row, ref) pairs its gates let through.
// Returns cudaError_t.
extern "C" int knn_gated(const float* q4, const float* r4, const int* order, const float* lb, const float* rbox,
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
