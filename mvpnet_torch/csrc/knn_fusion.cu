// Exact kNN (k <= 8) of chunk points over the fusion-scale pixel cloud.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _demand_kernel (pallas_call at knn_bucketed.py:562 in _demand_call). On the
// slice's path it is the fusion kNN: 8192 chunk points over V*H*W = 96,000
// unprojected pixels (invalid pixels sit at the 1e6 fill), k = 3.
//
// The TPU kernel walks the ref tiles of one query tile in order inside one
// program. Blocks on Hopper run in parallel and in no order, and 8192 queries
// at one thread each would fill few of the 132 SMs, so the search is split
// in two passes:
//   1. a grid over (query tile, ref slice, batch row): each block scans one
//      contiguous slice of refs, in index order, through shared memory and
//      writes every query's partial top-K for that slice;
//   2. a merge per query over the slices' lists in slice order, with the
//      same strict '<' insertion. Slices cover ascending index ranges and
//      each list is sorted by (distance, index), so the merge yields the
//      exact global top-K ordered by (distance, index): ties go to the lower
//      index (the TPU kernel breaks them by its visit order instead).
// The Morton sort and the lower-bound gate of the TPU kernel, which let it
// skip most ref tiles, are not ported yet: this is the brute search.
//
// Bound on the H100: operations, 9 f32 operations per query-ref pair on the
// CUDA cores; the bytes (inputs read once, outputs written once) weigh far
// less. chip_smoke.py computes the bound from the run's shapes.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kBlock = 128;
constexpr int kMergeBlock = 256;

template <int K>
__global__ void knn_slice_kernel(const float* __restrict__ q,
                                 const float* __restrict__ r, int M, int N,
                                 int slice_len, float* __restrict__ part_d,
                                 int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int S = gridDim.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = m < M;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + 3 * ((size_t)b * M + m);
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf: an unfilled slot
    bi[t] = 0;
  }
  const int n0 = min(N, s * slice_len);
  const int n1 = min(N, n0 + slice_len);
  mvp_scan_refs<K, kTile>(r + 3 * (size_t)b * N, n0, n1, active, qx, qy, qz,
                          bd, bi, tile);
  if (active) {
    // partial lists laid out (B, M, S, K): one query's slices are adjacent
    const size_t o = (((size_t)b * M + m) * S + s) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      part_d[o + t] = bd[t];
      part_i[o + t] = bi[t];
    }
  }
}

template <int K>
__global__ void knn_merge_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_i, int BM, int S,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;  // b * M + m
  if (row >= BM) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = __int_as_float(0x7f800000);
    bi[t] = 0;
  }
  const size_t base = (size_t)row * S * K;
  for (int c = 0; c < S * K; ++c) {
    const float d = part_d[base + c];
    // an unfilled slot (+inf) of a short slice never enters: strict '<'
    mvp_topk_insert<K>(bd, bi, d, part_i[base + c]);
  }
  const size_t o = (size_t)row * K;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    out_d[o + t] = bd[t];
    out_i[o + t] = bi[t];
  }
}

template <int K>
void launch(const float* q, const float* r, int B, int M, int N, int S,
            int slice_len, float* pd, int* pi, float* d, int* i,
            cudaStream_t st) {
  dim3 grid((M + kBlock - 1) / kBlock, S, B);
  knn_slice_kernel<K><<<grid, kBlock, 0, st>>>(q, r, M, N, slice_len, pd, pi);
  const int BM = B * M;
  knn_merge_kernel<K><<<(BM + kMergeBlock - 1) / kMergeBlock, kMergeBlock, 0,
                        st>>>(pd, pi, BM, S, d, i);
}

}  // namespace

// q (B, M, 3) f32, r (B, N, 3) f32 contiguous; S slices of slice_len refs
// (S * slice_len >= N); scratch part_d/part_i (B, M, S, k). Writes out_d
// (B, M, k) f32 ascending squared distances and out_i (B, M, k) int32.
// Returns cudaError_t.
extern "C" int knn_fusion(const float* q, const float* r, int B, int M, int N,
                          int k, int S, int slice_len, float* part_d,
                          int* part_i, float* out_d, int* out_i,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (S <= 0 || slice_len <= 0 || (long long)S * slice_len < N)
    return cudaErrorInvalidValue;
  switch (k) {
    case 1: launch<1>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 2: launch<2>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 3: launch<3>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 4: launch<4>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 5: launch<5>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 6: launch<6>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 7: launch<7>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    case 8: launch<8>(q, r, B, M, N, S, slice_len, part_d, part_i, out_d, out_i, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
