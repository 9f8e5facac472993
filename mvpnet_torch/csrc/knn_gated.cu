// Exact kNN (k <= 8) over Morton-sorted refs, gated per ref tile.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _gated_kernel (pallas_call at knn_bucketed.py:797 in _knn_forward). Its
// operands come from mvpnet_torch/ops/morton.py::prepare: Morton-sorted,
// tile-padded queries and refs, and for each query tile its ref tiles in
// ascending lower-bound order with those bounds.
//
// The TPU kernel runs a grid (B, query tiles, visit slot) whose last axis is
// sequential and carries the running top-k in scratch. Blocks on Hopper run
// in parallel and in no order, so here one block owns one (row, query tile)
// and loops over the visit slots itself:
//   * the gate of slot t is (t == 0) || lb[t] < worst_all, where worst_all is
//     the block's max over its rows of the k-th best distance. lb ascends
//     along the visit list and worst_all only shrinks, so the first closed
//     gate closes every later one: the loop stops there (the TPU kernel
//     branches past each remaining tile instead; the same tiles are read);
//   * an open tile is staged in shared memory (tile_n x 12 B: 24 KB at 2048
//     refs, 96 KB at 8192) and every thread, one per query row, inserts its
//     distances into a register top-k with strict '<' in visit order and
//     column order. That is _merge_candidate's tie rule (an entry already
//     held wins a tie), so results equal the plain version in
//     mvpnet_torch/ops/morton.py::gated_plain exactly, ties included;
//   * sub_gate (refs >= 2^18, tiles of 8192): each 8-row subgroup also
//     compares its own box against the tile's box over real coordinates
//     (|c| < 1e5) and scans the tile only if that bound is below the
//     subgroup's worst k-th distance.
//
// Bound on the H100: operations, 9 f32 operations per query-ref pair that an
// open tile holds (the gate decides how many; chip_smoke.py counts them from
// the run's data). The design cuts the operations by skipping tiles, and
// reads each open tile from device memory once per block.
#include "common.cuh"

namespace {

constexpr int kSub = 8;
constexpr float kSentinelMin = 1e5f;

// Box (lo, hi) of the real points of the staged tile, to every thread.
__device__ __forceinline__ void tile_box(const float* tile, int tile_n,
                                         float (&lo)[3], float (&hi)[3],
                                         float* red) {
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = inf;
    hi[d] = -inf;
  }
  for (int c = threadIdx.x; c < tile_n; c += blockDim.x) {
    const float x = tile[3 * c], y = tile[3 * c + 1], z = tile[3 * c + 2];
    if (fabsf(x) < kSentinelMin && fabsf(y) < kSentinelMin && fabsf(z) < kSentinelMin) {
      lo[0] = fminf(lo[0], x);
      lo[1] = fminf(lo[1], y);
      lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x);
      hi[1] = fmaxf(hi[1], y);
      hi[2] = fmaxf(hi[2], z);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(MVP_FULL_MASK, lo[d], o));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(MVP_FULL_MASK, hi[d], o));
    }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    float* w = red + 6 * (threadIdx.x >> 5);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = lo[d];
      w[3 + d] = hi[d];
    }
  }
  __syncthreads();
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], red[6 * w + d]);
      hi[d] = fmaxf(hi[d], red[6 * w + 3 + d]);
    }
  }
}

template <int K>
__global__ void knn_gated_kernel(const float* __restrict__ q,
                                 const float* __restrict__ r,
                                 const int* __restrict__ order,
                                 const float* __restrict__ lb, int Mt, int Nt,
                                 int M_pad, int N_pad, int tile_m, int tile_n,
                                 int sub_gate, float* __restrict__ out_d,
                                 int* __restrict__ out_i,
                                 unsigned long long* __restrict__ scanned) {
  extern __shared__ float tile[];  // 3 * tile_n floats, xyz interleaved
  __shared__ float red[6 * 32];
  const float inf = __int_as_float(0x7f800000);
  const int mt = blockIdx.x;
  const int b = blockIdx.y;
  const bool active = (int)threadIdx.x < tile_m;
  const size_t qrow = (size_t)b * M_pad + (size_t)mt * tile_m + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * qrow];
    qy = q[3 * qrow + 1];
    qz = q[3 * qrow + 2];
  }
  // this subgroup's box over all its rows (pad rows included, as on the
  // TPU); threads past tile_m are whole subgroups of their own
  float glo[3], ghi[3];
  if (sub_gate) {
    const float c[3] = {qx, qy, qz};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      glo[d] = mvp_group_min<kSub>(active ? c[d] : inf);
      ghi[d] = mvp_group_max<kSub>(active ? c[d] : -inf);
    }
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = inf;  // an unfilled slot
    bi[t] = 0;
  }
  const size_t list = ((size_t)b * Mt + mt) * Nt;
  const float* rb = r + (size_t)b * N_pad * 3;
  float worst_all = inf;
  int tiles_scanned = 0;  // by this thread's row
  for (int t = 0; t < Nt; ++t) {
    // the gate; lb ascends and worst_all only shrinks, so a closed gate
    // stays closed for every later slot
    if (t > 0 && !(lb[list + t] < worst_all)) break;
    const int tile_id = order[list + t];
    const float* src = rb + (size_t)tile_id * tile_n * 3;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < 3 * tile_n; i += blockDim.x) tile[i] = src[i];
    __syncthreads();
    bool scan = active;
    if (sub_gate) {
      float rlo[3], rhi[3];
      tile_box(tile, tile_n, rlo, rhi, red);
      const float lb_sub = mvp_box_sqdist(glo, ghi, rlo, rhi);
      const float worst_sub = mvp_group_max<kSub>(active ? bd[K - 1] : -inf);
      scan = active && lb_sub < worst_sub;
    }
    if (scan) {
      ++tiles_scanned;
      const int base = tile_id * tile_n;
      for (int c = 0; c < tile_n; ++c) {
        mvp_topk_insert<K>(bd, bi, mvp_sqdist(qx, qy, qz, tile[3 * c], tile[3 * c + 1], tile[3 * c + 2]),
                           base + c);
      }
    }
    worst_all = mvp_block_max(active ? bd[K - 1] : -inf, red);
  }
  if (scanned != nullptr && tiles_scanned > 0)
    atomicAdd(scanned, (unsigned long long)tiles_scanned * tile_n);
  if (active) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_d[qrow * K + t] = bd[t];
      out_i[qrow * K + t] = bi[t];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, const float* r, const int* order,
                   const float* lb, int B, int M_pad, int N_pad, int tile_m,
                   int tile_n, int sub_gate, float* d, int* i,
                   unsigned long long* scanned, cudaStream_t st) {
  const int Mt = M_pad / tile_m;
  const int Nt = N_pad / tile_n;
  const int threads = (tile_m + 31) / 32 * 32;
  const size_t shared = (size_t)3 * tile_n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_gated_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return err;
  knn_gated_kernel<K><<<dim3(Mt, B), threads, shared, st>>>(
      q, r, order, lb, Mt, Nt, M_pad, N_pad, tile_m, tile_n, sub_gate, d, i, scanned);
  return cudaGetLastError();
}

}  // namespace

// q (B, M_pad, 3) and r (B, N_pad, 3) f32 sorted and padded; order (B, Mt,
// Nt) int32 ref tiles in visit order and lb (B, Mt, Nt) f32 their bounds
// (Mt = M_pad / tile_m, Nt = N_pad / tile_n). Writes out_d (B, M_pad, k) f32
// ascending squared distances and out_i (B, M_pad, k) int32 sorted-ref
// indices. tile_m <= 1024 (a multiple of 8 with sub_gate). When `scanned`
// is not null, the kernel adds to it the (query row, ref) pairs it scanned:
// the work its gates let through.
// Returns cudaError_t.
extern "C" int knn_gated(const float* q, const float* r, const int* order,
                         const float* lb, int B, int M_pad, int N_pad,
                         int tile_m, int tile_n, int k, int sub_gate,
                         float* out_d, int* out_i, unsigned long long* scanned,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M_pad <= 0) return cudaSuccess;
  if (tile_m <= 0 || tile_m > 1024 || tile_n <= 0 || M_pad % tile_m ||
      N_pad % tile_n || (sub_gate && tile_m % kSub))
    return cudaErrorInvalidValue;
  switch (k) {
    case 1: return launch<1>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 2: return launch<2>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 3: return launch<3>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 4: return launch<4>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 5: return launch<5>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 6: return launch<6>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 7: return launch<7>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    case 8: return launch<8>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, sub_gate, out_d, out_i, scanned, st);
    default: return cudaErrorInvalidValue;
  }
}
