// Farthest point sampling: two kernels, one contract.
//
// Replaces the Pallas kernels of mvpnet_tpu/ops/pallas/fps.py:
//   * `fps` (fps_shared_kernel): _fps_batched_kernel (pallas_call at
//     fps.py:133), the row in one block's registers and shared memory. On
//     the chunk and train paths it samples SA1-SA4 (8192 -> 1024 at SA1); on
//     the whole-scene path at the high-resolution config, SA2-SA4 (8192 ->
//     2048 at SA2).
//   * `fps_perrow` (fps_cluster_kernel): _fps_kernel (pallas_call at
//     fps.py:174 in _fps_perrow), which keeps a whole long row in VMEM. On
//     the whole-scene path it samples 4 x 102,400 -> 8192 at SA1.
// The TPU splits the two by VMEM (_MAX_BN, fps.py:30); here the wrapper
// (mvpnet_torch/ops/fps.py, `route`) sends a row to the shared-memory kernel
// when its 16 bytes a point fit one block's shared memory (fps_shared_bytes),
// and to the cluster kernel otherwise.
//
// Contract (mvpnet_tpu/ops/reference.py:67): the seed is the first valid
// index (0 when unmasked or when no point is valid); each step takes
// dist = min(dist, |p - last|^2) and the argmax with the first occurrence on
// ties; invalid points start at -inf and so are never selected while a valid
// point remains.
//
// fps_shared_kernel: one block per batch row. Thread t keeps the points
// j = q * T + t (q < P, j < P * T) in registers as (x, y, z, dist), the
// rest of a long row's distances in dynamic shared memory, which holds the
// whole row as float4 (x, y, z, dist): every warp reads the winner's
// coordinates from there with one broadcast load. That load is kept on
// purpose: carrying the coordinates with the winner through the slots, as
// fps_cluster_kernel does, needs the winning lane to pick its point out of
// its P registers (a select chain of P, or three more selects a point in the
// update), more work a step than one broadcast load, and the shared row is
// what holds route's boundary at 16 bytes a point. P (points a thread, a
// template argument, at most kBlockPoints) and T (threads, at most
// kBlockThreads) come from the wrapper (ops/fps.py::block_layout): 16 a
// thread at 512 threads for N = 8192; a point a thread up to 256 threads for
// rows that 256 threads hold at 16 a thread (faster there than fewer, longer
// threads). A thread visits its points in ascending index order. Each step:
//   1. update the thread's distances and keep its best (d, i);
//   2. the warp's argmax under the tie rule (d > bd) || (d == bd && i < bi),
//      in two redux.sync reductions (warp_argmax); lane 0 writes it to slot
//      [step parity][warp] in shared memory;
//   3. one __syncthreads();
//   4. every warp reduces the slots itself, in one order, so every thread
//      knows the next point: no broadcast, no second barrier. A warp writes
//      slots [s & 1] again at step s + 2, after the barrier of step s + 1,
//      which every reader of step s has passed.
//   5. thread 0 writes out[step].
//
// Bound on the H100: the npoint - 1 steps are sequential, and one step of a
// block is an update of N points (about 12 instructions a point: 8192
// points are ~3,100 warp instructions over one SM's 4 schedulers, some 770
// cycles), two pairs of warp reductions and one barrier. On an H100 80GB
// HBM3 at 700 W a step over 8192 points takes about 0.77 us of device time
// (8192 -> 1024: 0.787-0.794 ms at 512 threads x 16 points; 0.96-0.97 ms
// with CUDA events at 1024 x 8, which was dropped; 1.40-1.41 ms for the
// former kernel, one shared-memory row, a butterfly argmax and two barriers
// a step; PERF.md). The card's bytes and operations (10 f32 operations a
// point and step) are far below it; chip_smoke.py computes both from the
// run.
//
// fps_cluster_kernel: one thread-block cluster of C = 16 CTAs (a
// non-portable cluster size; 8 took longer, PERF.md) per batch row, 512
// threads each. CTA r owns the contiguous slice [r * S, (r + 1) * S) of the
// row, S = ceil(N / C), and keeps it on chip for all npoint - 1 steps:
// kRegPoints points a thread in registers, the rest of the slice in dynamic
// shared memory as float4, and what neither holds (rows beyond about
// C * 21,700 points, up to the 2^19 of the TPU wrapper) in a device-memory
// scratch that only the owning CTA reads. ops/fps.py::cluster_split computes
// the same split. Each step:
//   1. update the slice's distances (mvp_sqdist, as the plain version);
//   2. a block argmax of (d, i) with the tie rule above (slices cover
//      ascending index ranges, so the lower index still wins across CTAs);
//      the lane that owns a warp's winner adds its (x, y, z);
//   3. warp 0 pushes the CTA's winner (d, i, x, y, z) into slot
//      [step parity][rank] of every CTA of the cluster through distributed
//      shared memory (cluster.map_shared_rank); one cluster.sync();
//   4. every warp reduces the C slots in its own shared memory in one
//      order, so every thread of the cluster agrees on the next point and
//      its coordinates without another read. The parity slots make one
//      barrier a step enough: a CTA writes slots [s & 1] again at step
//      s + 2, after the barrier of step s + 1, which every reader of step s
//      has passed.
//   5. rank 0 writes out[step].
//
// Bound on the H100: the npoint - 1 steps are sequential. The old per-row
// kernel (one 1024-thread block a row) streamed the 1.6 MB row through one SM
// from L2 every step: 24.7 us a step, 202 ms at 4 x 102,400 -> 8192, with 4
// of 132 SMs working. Here a step reads only on-chip memory (at C = 16 and
// N = 102,400: 6400 points a CTA, all in registers), so what bounds it is the
// latency of the step: the update of a slice, a block reduction, one cluster
// barrier. On an H100 80GB HBM3 at 700 W that is about 2.0 us a step (16.4
// ms at that shape with warp_argmax's redux.sync reductions; 20.6 ms with
// butterfly shuffles, 24.7 ms on clusters of 8; PERF.md). The first version
// of this kernel, 1024 threads a CTA reading the C winners from the other
// CTAs after the barrier, took 32 ms on 8 CTAs and 47 ms on 16: the step's
// synchronization, not its arithmetic, sets the pace. Neither the card's
// bytes nor its operations (10 f32 operations a point and step, 0.50 ms at
// that shape) come near; chip_smoke.py computes both from the run.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// fps_shared_kernel: the most threads a block takes and the most points a
// thread keeps in registers; mirrored by mvpnet_torch/ops/fps.py
// (BLOCK_THREADS, BLOCK_POINTS), whose block_layout picks the layout
constexpr int kBlockThreads = 512;
constexpr int kBlockPoints = 16;
// fps_cluster_kernel: CTAs a cluster, threads a CTA and points a thread
// keeps in registers; mirrored by mvpnet_torch/ops/fps.py (CLUSTER,
// CLUSTER_THREADS, REG_POINTS)
constexpr int kCluster = 16;
constexpr int kClusterThreads = 512;
constexpr int kRegPoints = 14;

struct ArgMax {
  float d;
  int i;
};

// The warp's best (d, i) under the tie rule (d > bd) || (d == bd && i < bi),
// to every lane, in two warp reductions (redux.sync): the largest distance
// as an order-preserving key (distances are >= 0, or -inf for invalid
// points, which keys below all of them), then the least index among the
// lanes that hold it.
__device__ __forceinline__ ArgMax warp_argmax(ArgMax v) {
  const unsigned key = v.d < 0.f ? 0u : __float_as_uint(v.d) + 1u;
  const unsigned top = __reduce_max_sync(MVP_FULL_MASK, key);
  const int i = __reduce_min_sync(MVP_FULL_MASK, key == top ? v.i : INT_MAX);
  return ArgMax{top == 0u ? -__int_as_float(0x7f800000) : __uint_as_float(top - 1u), i};
}

// The winner of a CTA or the cluster in fps_cluster_kernel: (d, i) and the
// point's coordinates.
struct __align__(16) Cand {
  float d;
  int i;
  float x, y, z;
};

// The best of the candidates c[0, n) (n <= 32), to every lane of the warp.
__device__ __forceinline__ Cand best_of(const Cand* c, int n) {
  const int lane = threadIdx.x & 31;
  const Cand m = lane < n ? c[lane] : Cand{-__int_as_float(0x7f800000), INT_MAX, 0.f, 0.f, 0.f};
  const ArgMax b = warp_argmax(ArgMax{m.d, m.i});
  // every lane takes the coordinates from the lane that read the winner
  const int src = __ffs(__ballot_sync(MVP_FULL_MASK, lane < n && m.i == b.i)) - 1;
  return Cand{b.d, b.i, __shfl_sync(MVP_FULL_MASK, m.x, src), __shfl_sync(MVP_FULL_MASK, m.y, src),
              __shfl_sync(MVP_FULL_MASK, m.z, src)};
}

template <int P>
__global__ void __launch_bounds__(kBlockThreads)
fps_shared_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask, int N,
                  int npoint, int* __restrict__ out) {
  extern __shared__ float4 row[];  // the whole row: (x, y, z, dist)
  __shared__ ArgMax slots[2][kBlockThreads / 32];  // each warp's winner, by step parity

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = blockDim.x;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float* p = pts + 3 * (size_t)b * N;
  const uint8_t* mk = mask ? mask + (size_t)b * N : nullptr;
  const float inf = __int_as_float(0x7f800000);
  const ArgMax none{-inf, INT_MAX};
  // points j < n_reg live in registers (j = q * T + tid; past n_reg at dist
  // -inf, never a winner), the rest's distances in row[j].w; a thread
  // visits its points in ascending index order
  const int n_reg = min(N, P * T);

  float4 rp[P];
  // init: dist +inf for valid points, -inf for invalid; the seed is the
  // first valid point: each thread's candidate is its first valid one at 0
  ArgMax best = none;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = q * T + tid;
    rp[q] = make_float4(0.f, 0.f, 0.f, -inf);
    if (j < n_reg) {
      const bool valid = mk == nullptr || mk[j] != 0;
      rp[q] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], valid ? inf : -inf);
      row[j] = rp[q];
      if (valid && best.i == INT_MAX) best = ArgMax{0.f, j};
    }
  }
  for (int j = n_reg + tid; j < N; j += T) {
    const bool valid = mk == nullptr || mk[j] != 0;
    row[j] = make_float4(p[3 * j], p[3 * j + 1], p[3 * j + 2], valid ? inf : -inf);
    if (valid && best.i == INT_MAX) best = ArgMax{0.f, j};
  }
  int* o = out + (size_t)b * npoint;
  int last = 0;  // the step's winner; with no valid point left, index 0
  for (int step = 0; step < npoint; ++step) {
    if (step > 0) {
      const float4 l = row[last];  // a broadcast read: the winner's coordinates
      // ascending indices: a later point wins only on a larger distance;
      // invalid points stay at -inf and never win
      best = none;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float nd = fminf(rp[q].w, mvp_sqdist(rp[q].x, rp[q].y, rp[q].z, l.x, l.y, l.z));
        rp[q].w = nd;
        if (nd > best.d) best = ArgMax{nd, q * T + tid};
      }
      for (int j = n_reg + tid; j < N; j += T) {
        const float4 v = row[j];
        const float nd = fminf(v.w, mvp_sqdist(v.x, v.y, v.z, l.x, l.y, l.z));
        if (nd < v.w) row[j].w = nd;
        if (nd > best.d) best = ArgMax{nd, j};
      }
    }
    const ArgMax w = warp_argmax(best);
    if (lane == 0) slots[step & 1][warp] = w;
    __syncthreads();
    // every warp reduces the slots itself: slots [s & 1] are written again
    // at step s + 2, after the barrier of step s + 1, which every reader of
    // step s has passed
    last = warp_argmax(lane < nwarps ? slots[step & 1][lane] : none).i;
    if (last == INT_MAX) last = 0;
    if (tid == 0) o[step] = last;
  }
}

// The cluster's winner of this step, to every thread, from each thread's
// best (d, i) and the coordinates of its point `xyz` (read by the lane that
// owns the warp's winner only): the warps' winners; warp 0 reduces them and
// pushes the CTA's winner into slot [parity][rank] of every CTA of the
// cluster through distributed shared memory; one cluster barrier; then each
// warp reduces the kCluster slots in its own shared memory.
template <typename Coords>
__device__ __forceinline__ Cand cluster_best(cg::cluster_group& cluster, ArgMax v, Coords xyz,
                                             Cand* red, Cand (*slots)[kCluster], int step) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const ArgMax w = warp_argmax(v);
  if (w.i == INT_MAX) {
    if (lane == 0) red[warp] = Cand{w.d, INT_MAX, 0.f, 0.f, 0.f};  // a warp without points
  } else if (v.i == w.i) {
    float x, y, z;
    xyz(x, y, z);
    red[warp] = Cand{w.d, w.i, x, y, z};
  }
  __syncthreads();
  Cand* slot = slots[step & 1];
  if (threadIdx.x < 32) {
    const Cand win = best_of(red, blockDim.x >> 5);
    if (lane < kCluster) *cluster.map_shared_rank(slot + cluster.block_rank(), lane) = win;
  }
  cluster.sync();
  return best_of(slot, kCluster);
}

__global__ void __launch_bounds__(kClusterThreads, 1)
fps_cluster_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                   int N, int npoint, int slice_len, int smem_points,
                   float4* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ float4 srow[];  // the slice's shared-memory part
  __shared__ Cand red[kClusterThreads / 32];
  __shared__ Cand slots[2][kCluster];  // every CTA's winner, by step parity and rank

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const float* p = pts + 3 * (size_t)b * N;
  const uint8_t* mk = mask ? mask + (size_t)b * N : nullptr;
  float4* ov = scratch ? scratch + (size_t)b * N : nullptr;
  const float inf = __int_as_float(0x7f800000);

  // this CTA's slice [s0, s0 + len): local j < n_reg in registers (j = q * T
  // + tid), then n_sm in shared memory, then the overflow in `ov`. A thread
  // visits its points in ascending index order.
  const int s0 = (int)min((long long)N, (long long)rank * slice_len);
  const int len = min(N - s0, slice_len);
  const int n_reg = min(len, kRegPoints * T);
  const int n_sm = min(len - n_reg, smem_points);
  const int n_on = n_reg + n_sm;

  float4 rp[kRegPoints];
  ArgMax best{-inf, INT_MAX};  // this thread's best (d, i)
  // the coordinates of this thread's best point
  auto coords = [&](float& x, float& y, float& z) {
    const int j = best.i - s0;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j >= n_on) {
      v = ov[best.i];
    } else if (j >= n_reg) {
      v = srow[j - n_reg];
    } else {
#pragma unroll
      for (int q = 0; q < kRegPoints; ++q)
        if (q * T + tid == j) v = rp[q];
    }
    x = v.x;
    y = v.y;
    z = v.z;
  };

  // init: dist +inf for valid points, -inf for invalid; the seed is the
  // first valid point: each thread's candidate is its first valid one at 0
#pragma unroll
  for (int q = 0; q < kRegPoints; ++q) {
    const int j = q * T + tid;
    rp[q] = make_float4(0.f, 0.f, 0.f, -inf);
    if (j < n_reg) {
      const int g = s0 + j;
      const bool valid = mk == nullptr || mk[g] != 0;
      rp[q] = make_float4(p[3 * g], p[3 * g + 1], p[3 * g + 2], valid ? inf : -inf);
      if (valid && best.i == INT_MAX) best = ArgMax{0.f, g};
    }
  }
  for (int j = n_reg + tid; j < len; j += T) {
    const int g = s0 + j;
    const bool valid = mk == nullptr || mk[g] != 0;
    const float4 v = make_float4(p[3 * g], p[3 * g + 1], p[3 * g + 2], valid ? inf : -inf);
    if (j < n_on) srow[j - n_reg] = v;
    else ov[g] = v;
    if (valid && best.i == INT_MAX) best = ArgMax{0.f, g};
  }
  Cand w = cluster_best(cluster, best, coords, red, slots, 0);
  if (w.i == INT_MAX) w = Cand{0.f, 0, p[0], p[1], p[2]};  // no valid point: seed 0
  int* o = out + (size_t)b * npoint;
  if (rank == 0 && tid == 0) o[0] = w.i;

  for (int step = 1; step < npoint; ++step) {
    const float lx = w.x, ly = w.y, lz = w.z;
    // ascending indices: a later point wins only on a larger distance
    best = ArgMax{-inf, INT_MAX};
#pragma unroll
    for (int q = 0; q < kRegPoints; ++q) {
      const int j = q * T + tid;
      if (j < n_reg) {
        const float nd = fminf(rp[q].w, mvp_sqdist(rp[q].x, rp[q].y, rp[q].z, lx, ly, lz));
        rp[q].w = nd;
        if (nd > best.d || best.i == INT_MAX) best = ArgMax{nd, s0 + j};
      }
    }
    for (int j = n_reg + tid; j < n_on; j += T) {
      const float4 v = srow[j - n_reg];
      const float nd = fminf(v.w, mvp_sqdist(v.x, v.y, v.z, lx, ly, lz));
      if (nd < v.w) srow[j - n_reg].w = nd;
      if (nd > best.d || best.i == INT_MAX) best = ArgMax{nd, s0 + j};
    }
    for (int j = n_on + tid; j < len; j += T) {
      const float4 v = ov[s0 + j];
      const float nd = fminf(v.w, mvp_sqdist(v.x, v.y, v.z, lx, ly, lz));
      if (nd < v.w) ov[s0 + j].w = nd;
      if (nd > best.d || best.i == INT_MAX) best = ArgMax{nd, s0 + j};
    }
    w = cluster_best(cluster, best, coords, red, slots, step);
    if (rank == 0 && tid == 0) o[step] = w.i;
  }
  cluster.sync();  // no CTA leaves while another may still write its slots
}

using SharedKernel = void (*)(const float*, const uint8_t*, int, int, int*);

// fps_shared_kernel for P points a thread in registers, or null
SharedKernel shared_kernel(int P) {
  switch (P) {
    case 1: return fps_shared_kernel<1>;
    case 2: return fps_shared_kernel<2>;
    case 4: return fps_shared_kernel<4>;
    case 8: return fps_shared_kernel<8>;
    case 16: return fps_shared_kernel<16>;
    default: return nullptr;
  }
}

cudaError_t optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// Dynamic shared memory a block of either kernel may take on the current
// device: the opt-in limit less the larger static shared memory of the two.
// A row of N points fits fps when 16 * N <= *bytes; fps_perrow keeps at most
// *bytes / 16 points of a CTA's slice in shared memory. Returns cudaError_t.
extern "C" int fps_shared_bytes(int* bytes) {
  int optin = 0;
  cudaError_t e = optin_bytes(&optin);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a, c;
  e = cudaFuncGetAttributes(&a, fps_shared_kernel<kBlockPoints>);
  if (e != cudaSuccess) return e;
  e = cudaFuncGetAttributes(&c, fps_cluster_kernel);
  if (e != cudaSuccess) return e;
  const size_t stat = a.sharedSizeBytes > c.sharedSizeBytes ? a.sharedSizeBytes : c.sharedSizeBytes;
  *bytes = optin - (int)stat;
  return cudaSuccess;
}

// pts (B, N, 3) f32 contiguous; mask (B, N) uint8 or null; out (B, npoint)
// int32. One block of `threads` threads a row (a multiple of 32, at most
// kBlockThreads), each keeping `reg_points` (1, 2, 4, 8 or 16) points in
// registers (ops/fps.py::block_layout). The row must fit in shared memory
// (see fps_shared_bytes), else cudaErrorInvalidValue. Returns cudaError_t.
extern "C" int fps(const float* pts, const uint8_t* mask, int B, int N, int npoint,
                   int reg_points, int threads, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  const SharedKernel kernel = shared_kernel(reg_points);
  if (N <= 0 || kernel == nullptr || threads < 32 || threads % 32 != 0 || threads > kBlockThreads)
    return cudaErrorInvalidValue;
  int avail = 0;
  cudaError_t e = static_cast<cudaError_t>(fps_shared_bytes(&avail));
  if (e != cudaSuccess) return e;
  const size_t bytes = sizeof(float4) * (size_t)N;
  if (bytes > (size_t)avail) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kernel<<<B, threads, bytes, st>>>(pts, mask, N, npoint, out);
  return cudaGetLastError();
}

// fps_perrow's launch: B clusters of kCluster CTAs, kClusterThreads threads
// each, smem_points float4 of dynamic shared memory a CTA. Sets the kernel's
// attributes and fills cfg, which points at attr. Returns cudaError_t.
static cudaError_t perrow_launch_config(int B, int smem_points, cudaStream_t st,
                                        cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  int avail = 0;
  cudaError_t e = static_cast<cudaError_t>(fps_shared_bytes(&avail));
  if (e != cudaSuccess) return e;
  const size_t bytes = sizeof(float4) * (size_t)smem_points;
  if (bytes > (size_t)avail) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * kCluster);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// pts (B, N, 3) f32 contiguous; mask (B, N) uint8 or null; out (B, npoint)
// int32. One cluster of kCluster CTAs a row; CTA r owns points
// [r * slice_len, (r + 1) * slice_len) (kCluster * slice_len >= N) and keeps
// up to kRegPoints * kClusterThreads of them in registers and the next
// smem_points in shared memory; scratch (B, N, 4) f32 holds the rest and may
// be null when no slice has a rest (ops/fps.py::cluster_split). Returns
// cudaError_t.
extern "C" int fps_perrow(const float* pts, const uint8_t* mask, int B, int N,
                          int npoint, int slice_len, int smem_points,
                          float* scratch, int* out, void* stream) {
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  if (N <= 0 || slice_len <= 0 || smem_points < 0 ||
      (long long)kCluster * slice_len < N)
    return cudaErrorInvalidValue;
  if (scratch == nullptr &&
      (long long)slice_len > (long long)kRegPoints * kClusterThreads + smem_points)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = perrow_launch_config(B, smem_points, static_cast<cudaStream_t>(stream), attr, &cfg);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, pts, mask, N, npoint, slice_len, smem_points,
                         reinterpret_cast<float4*>(scratch), out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many of fps_perrow's clusters the card holds at once with smem_points
// float4 of shared memory a CTA (cudaOccupancyMaxActiveClusters on the
// launch configuration fps_perrow uses); a launch of more rows runs its rows
// in waves. Launches nothing. Returns cudaError_t.
extern "C" int fps_cluster_occupancy(int smem_points, int* clusters) {
  if (smem_points < 0 || clusters == nullptr) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = perrow_launch_config(1, smem_points, nullptr, attr, &cfg);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveClusters(clusters, fps_cluster_kernel, &cfg);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
