// Exact kNN (k <= 8) of chunk points over the fusion-scale pixel cloud: the
// fusion kNN, in two modes of one source.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _demand_kernel (pallas_call at knn_bucketed.py:562 in _demand_call). On the
// port's paths: 8192 chunk points over V*H*W = 96,000 pixels (chunk
// request), 8 x 8192 over 57,600 (train step, about half of them
// invalid-depth sentinels at 1e6), 4 x 102,400 over 1,228,800 (a scene
// forward at the high-resolution config) and one (1, 409,600) query set over
// the scene's prepared cloud (the fused estimator); k = 3.
//
// Contract (reference.knn): the k smallest squared distances, ascending,
// ties to the lower ref index. ops/knn_bucketed.py::route picks the mode by
// size.
//
// knn_fusion_demand (knn_demand_kernel), the demand-gated search the TPU
// kernel does. Its operands come from ops/morton.py (prepare_refs,
// prepare_queries): Morton-sorted queries padded to tiles of tile_m rows;
// Morton-sorted refs padded to tiles of tile_n, as float4 (x, y, z, original
// index as int bits), so a tile is one contiguous span and every candidate
// carries the index the tie rule needs; per ref tile two boxes, over its
// real refs (|c| < 1e5) and over its sentinel refs, so that the tile's bound
// min(lb_real, lb_sentinel) holds for every ref in it; and for each query
// tile its ref tiles in ascending bound order with those bounds. One block
// per (batch row, query tile), 4 threads a query row (lane j scans columns
// j, j + 4, ... of a tile into its own register top-k), 8 rows a warp:
//   * each ref tile comes into shared memory with cp.async.bulk (the 1-D TMA
//     copy) completing on an mbarrier, double-buffered: tile t + 1 is in
//     flight while tile t is scanned, and it is issued only if its bound can
//     still matter (knn_bucketed.py:313-318);
//   * the gate is lb > worst, where worst is the block max over its real
//     rows of the row's k-th distance (the merge of its 4 lanes' lists): the
//     loop ends at the first tile whose bound exceeds it. A tile whose bound
//     equals the k-th distance is still scanned, since it may hold a ref at
//     that distance with a lower index. An all-sentinel tile is scanned while
//     a row has fewer than k refs (worst = +inf), and is bounded by its
//     sentinel box after that;
//   * from 2^18 refs up each warp (8 query rows) also gates a tile on its own
//     box against the tile's two boxes (the sub-gate of knn_bucketed.py:
//     346-382, at warp granularity, where a GPU skips work);
//   * lists are ordered by (distance, original index) and insertion takes a
//     candidate only if it precedes the k-th entry in that order, so the
//     result equals the plain version exactly, ties to the lower index.
//     Each bound is computed as mvp_sqdist orders its operations, so
//     lb <= d holds in f32 for every pair.
//
// knn_fusion (knn_slice_kernel + knn_merge_kernel), the brute two-pass mode
// for searches too small for the sort and gate to pay: a grid over (query
// tile, ref slice, batch row) writes every query's top-K of one contiguous
// slice of refs, scanned in index order, and a merge takes the slices' lists
// in slice order with strict '<', so ties go to the lower index.
//
// Bound on the H100: instructions, 9 per (query, ref) pair that is scanned
// (-fmad=false: each operation its own), at 33.5e12 lane-instructions a
// second; the brute mode scans every pair (5.0e11 at the scene shape: 135 ms),
// the demand mode the pairs its gates let through (it
// counts them into `scanned`), with each scanned tile read from L2 or device
// memory once per block. On an H100 80GB HBM3 at 700 W the scene shape takes
// 256 ms brute and 14.6 ms in the demand mode with its prep (1.7% of the
// pairs scanned, 11.2 ms in the kernel); the chunk and train shapes are
// faster brute (0.63 vs 3.3 ms, 2.41 vs 2.72 ms: the prep's plain PyTorch
// ops cost more than the pairs they save), hence the route by size.
// chip_smoke.py computes both bounds from the run's data.
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

// ---------------------------------------------------------------------------
// The demand-gated mode
// ---------------------------------------------------------------------------

constexpr int kLanes = 4;                     // threads a query row
constexpr int kRowsPerWarp = 32 / kLanes;     // 8: the sub-gate's subgroup
constexpr int kMaxTileM = 128;
constexpr int kBoxFloats = 12;                // real lo, hi; sentinel lo, hi

template <int K>
__global__ void __launch_bounds__(kMaxTileM * kLanes)
knn_demand_kernel(const float* __restrict__ q, const float4* __restrict__ r4,
                  const int* __restrict__ order, const float* __restrict__ lb,
                  const float* __restrict__ boxes, int M, int M_pad, int N,
                  int N_pad, int tile_m, int tile_n, int sub_gate,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  unsigned long long* __restrict__ scanned) {
  extern __shared__ __align__(128) float4 buf[];  // two tiles of tile_n refs
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[32];
  const float inf = __int_as_float(0x7f800000);
  const int mt = blockIdx.x;
  const int b = blockIdx.y;
  const int Mt = gridDim.x;
  const int Nt = N_pad / tile_n;
  const int tid = threadIdx.x;
  const int lane4 = tid % kLanes;
  const int m = mt * tile_m + tid / kLanes;  // this thread's sorted query row
  const bool real = m < M;                   // pad rows vote in no gate
  const size_t qrow = (size_t)b * M_pad + m;
  const float qx = q[3 * qrow], qy = q[3 * qrow + 1], qz = q[3 * qrow + 2];
  // the warp's box over its real rows (the sub-gate's query box)
  float glo[3], ghi[3];
  if (sub_gate) {
    const float c[3] = {qx, qy, qz};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      glo[d] = mvp_group_min<32>(real ? c[d] : inf);
      ghi[d] = mvp_group_max<32>(real ? c[d] : -inf);
    }
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = inf;  // an unfilled slot: after every real candidate
    bi[t] = INT_MAX;
  }
  float kth = inf;  // the row's k-th distance over its 4 lanes
  const size_t list = ((size_t)b * Mt + mt) * Nt;
  const float4* rb = r4 + (size_t)b * N_pad;
  const float* bx = boxes + (size_t)b * Nt * kBoxFloats;
  const uint32_t bytes = (uint32_t)tile_n * sizeof(float4);
  if (tid == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile t lands in buffer t & 1 on barrier t & 1, whose (t >> 1)-th phase
  // it completes; a tile is waited for iff it was issued
  if (tid == 0) bulk_load(buf, rb + (size_t)order[list] * tile_n, bytes, &bar[0]);
  int issued = 1;  // worst starts at +inf: the first tile's gate is open
  float worst = inf;
  unsigned long long pairs = 0;  // scanned by this warp (counted by lane 0)
  for (int t = 0; t < issued; ++t) {
    // prefetch the next tile iff its bound can still matter; worst only
    // shrinks, so a tile not issued here is never needed
    if (t + 1 < Nt && !(lb[list + t + 1] > worst)) {
      if (tid == 0)
        bulk_load(buf + ((t + 1) & 1) * tile_n, rb + (size_t)order[list + t + 1] * tile_n, bytes,
                  &bar[(t + 1) & 1]);
      issued = t + 2;
    }
    bar_wait(&bar[t & 1], (t >> 1) & 1);
    if (!(lb[list + t] > worst)) {  // re-checked under the current worst
      const int tile_id = order[list + t];
      bool scan = true;
      if (sub_gate) {
        const float* tb = bx + (size_t)tile_id * kBoxFloats;
        const float lb_sub =
            fminf(mvp_box_sqdist(glo, ghi, tb, tb + 3), mvp_box_sqdist(glo, ghi, tb + 6, tb + 9));
        scan = !(lb_sub > mvp_group_max<32>(real ? kth : -inf));  // warp-uniform
      }
      if (scan) {
        const float4* tile = buf + (t & 1) * tile_n;
        const int ncols = min(tile_n, N - tile_id * tile_n);  // pad refs are never candidates
#pragma unroll 4
        for (int c = lane4; c < ncols; c += kLanes) {
          const float4 r = tile[c];
          insert_ordered<K>(bd, bi, mvp_sqdist(qx, qy, qz, r.x, r.y, r.z), __float_as_int(r.w));
        }
        if ((tid & 31) == 0) pairs += (unsigned long long)kRowsPerWarp * ncols;
        float md[K];
        int mi[K];
        merge_lanes<K>(bd, bi, md, mi, kLanes);
        kth = md[K - 1];
      }
    }
    // every thread is past buffer t & 1 before tile t + 2 is issued into it
    worst = mvp_block_max(real ? kth : -inf, red);
  }

  float md[K];
  int mi[K];
  merge_lanes<K>(bd, bi, md, mi, kLanes);
  if (real && lane4 == 0) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_d[qrow * K + t] = md[t];
      out_i[qrow * K + t] = mi[t];
    }
  }
  if (scanned != nullptr && pairs > 0) atomicAdd(scanned, pairs);
}

template <int K>
cudaError_t launch_demand(const float* q, const float4* r4, const int* order, const float* lb,
                          const float* boxes, int B, int M, int M_pad, int N, int N_pad,
                          int tile_m, int tile_n, int sub_gate, float* d, int* i,
                          unsigned long long* scanned, cudaStream_t st) {
  const size_t shared = 2 * (size_t)tile_n * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(knn_demand_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return err;
  knn_demand_kernel<K><<<dim3(M_pad / tile_m, B), tile_m * kLanes, shared, st>>>(
      q, r4, order, lb, boxes, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, d, i, scanned);
  return cudaGetLastError();
}

}  // namespace

// Brute mode. q (B, M, 3) f32, r (B, N, 3) f32 contiguous; S slices of
// slice_len refs (S * slice_len >= N); scratch part_d/part_i (B, M, S, k).
// Writes out_d (B, M, k) f32 ascending squared distances and out_i (B, M, k)
// int32. Returns cudaError_t.
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

// Demand-gated mode. q (B, M_pad, 3) f32 sorted queries (rows >= M are
// padding); r4 (B, N_pad, 4) f32 sorted refs with their original index's
// bits in .w (refs >= N are padding, never candidates); order (B, Mt, Nt)
// int32 ref tiles in visit order and lb (B, Mt, Nt) f32 their bounds,
// ascending (Mt = M_pad / tile_m, Nt = N_pad / tile_n); boxes (B, Nt, 12) f32
// each ref tile's real and sentinel boxes (lo, hi each). tile_m a multiple
// of 8 up to 128; 2 * 16 * tile_n bytes of shared memory; k <= N. Writes
// out_d (B, M_pad, k) f32 ascending squared distances and out_i (B, M_pad,
// k) int32 original ref indices for the real rows. When `scanned` is not
// null the kernel adds to it the (query row, ref) pairs it scanned.
// Returns cudaError_t.
extern "C" int knn_fusion_demand(const float* q, const float* r4, const int* order,
                                 const float* lb, const float* boxes, int B, int M,
                                 int M_pad, int N, int N_pad, int tile_m, int tile_n, int k,
                                 int sub_gate, float* out_d, int* out_i,
                                 unsigned long long* scanned, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (tile_m < kRowsPerWarp || tile_m > kMaxTileM || tile_m % kRowsPerWarp || tile_n <= 0 ||
      M_pad % tile_m || N_pad % tile_n || M > M_pad || N > N_pad || k > N || N <= 0)
    return cudaErrorInvalidValue;
  const float4* r = reinterpret_cast<const float4*>(r4);
  switch (k) {
    case 1: return launch_demand<1>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 2: return launch_demand<2>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 3: return launch_demand<3>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 4: return launch_demand<4>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 5: return launch_demand<5>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 6: return launch_demand<6>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 7: return launch_demand<7>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 8: return launch_demand<8>(q, r, order, lb, boxes, B, M, M_pad, N, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    default: return cudaErrorInvalidValue;
  }
}
