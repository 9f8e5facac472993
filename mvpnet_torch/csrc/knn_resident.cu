// Exact kNN (k <= 8) over a resident Morton-sorted cloud, with an early exit.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _vmem_kernel (pallas_call at knn_bucketed.py:493 in _vmem_call). Its
// operands come from mvpnet_torch/ops/morton.py::prepare with 64-row query
// tiles and 1024-ref tiles; the cloud holds at most 2^17 refs.
//
// The TPU kernel keeps the whole sorted cloud in VMEM (fetched once per
// batch row) and walks one query tile's ref tiles in ascending lower-bound
// order in a while loop that ends at the first lb >= worst. An H100 block
// has at most 227 KB of shared memory, too little for 2^17 x 12 B, but the
// card's L2 is 50 MB: here one block of 64 threads owns one query tile and
// reads the tiles it visits straight from the sorted cloud in device memory,
// where the 1.5 MB a batch row holds stay L2-resident across the row's
// blocks. All lanes of a warp read the same ref at once, a broadcast load.
// There are no copies to double-buffer and nothing to drain.
//
// Each thread holds one query row's top-k in registers and inserts with
// strict '<' in visit order and column order (_merge_candidate's tie rule),
// so results equal mvpnet_torch/ops/morton.py::gated_plain exactly.
//
// Bound on the H100: operations, 9 f32 operations per query-ref pair of the
// visited tiles (chip_smoke.py counts them from the run's data).
#include "common.cuh"

namespace {

template <int K>
__global__ void knn_resident_kernel(const float* __restrict__ q,
                                    const float* __restrict__ r,
                                    const int* __restrict__ order,
                                    const float* __restrict__ lb, int Mt,
                                    int Nt, int M_pad, int N_pad, int tile_m,
                                    int tile_n, float* __restrict__ out_d,
                                    int* __restrict__ out_i,
                                    unsigned long long* __restrict__ scanned) {
  __shared__ float red[32];
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
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = inf;
    bi[t] = 0;
  }
  const size_t list = ((size_t)b * Mt + mt) * Nt;
  const float* rb = r + (size_t)b * N_pad * 3;
  float worst = inf;
  int t = 0;
  for (; t < Nt && lb[list + t] < worst; ++t) {
    const int tile_id = order[list + t];
    const float* src = rb + (size_t)tile_id * tile_n * 3;
    if (active) {
      const int base = tile_id * tile_n;
      for (int c = 0; c < tile_n; ++c) {
        mvp_topk_insert<K>(bd, bi,
                           mvp_sqdist(qx, qy, qz, __ldg(src + 3 * c), __ldg(src + 3 * c + 1), __ldg(src + 3 * c + 2)),
                           base + c);
      }
    }
    worst = mvp_block_max(active ? bd[K - 1] : -inf, red);
  }
  // every active row scanned the t tiles visited
  if (scanned != nullptr && active && t > 0) atomicAdd(scanned, (unsigned long long)t * tile_n);
  if (active) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[qrow * K + s] = bd[s];
      out_i[qrow * K + s] = bi[s];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, const float* r, const int* order,
                   const float* lb, int B, int M_pad, int N_pad, int tile_m,
                   int tile_n, float* d, int* i, unsigned long long* scanned,
                   cudaStream_t st) {
  const int Mt = M_pad / tile_m;
  const int Nt = N_pad / tile_n;
  const int threads = (tile_m + 31) / 32 * 32;
  knn_resident_kernel<K><<<dim3(Mt, B), threads, 0, st>>>(
      q, r, order, lb, Mt, Nt, M_pad, N_pad, tile_m, tile_n, d, i, scanned);
  return cudaGetLastError();
}

}  // namespace

// Operands as knn_gated's (csrc/knn_gated.cu): q (B, M_pad, 3), r (B, N_pad,
// 3) f32 sorted and padded, order / lb (B, Mt, Nt). Writes out_d (B, M_pad,
// k) f32 and out_i (B, M_pad, k) int32 sorted-ref indices. tile_m <= 1024.
// When `scanned` is not null, the kernel adds to it the (query row, ref)
// pairs it scanned. Returns cudaError_t.
extern "C" int knn_resident(const float* q, const float* r, const int* order,
                            const float* lb, int B, int M_pad, int N_pad,
                            int tile_m, int tile_n, int k, float* out_d,
                            int* out_i, unsigned long long* scanned,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M_pad <= 0) return cudaSuccess;
  if (tile_m <= 0 || tile_m > 1024 || tile_n <= 0 || M_pad % tile_m || N_pad % tile_n)
    return cudaErrorInvalidValue;
  switch (k) {
    case 1: return launch<1>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 2: return launch<2>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 3: return launch<3>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 4: return launch<4>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 5: return launch<5>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 6: return launch<6>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 7: return launch<7>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    case 8: return launch<8>(q, r, order, lb, B, M_pad, N_pad, tile_m, tile_n, out_d, out_i, scanned, st);
    default: return cudaErrorInvalidValue;
  }
}
