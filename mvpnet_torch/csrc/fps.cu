// Farthest point sampling: two kernels, one contract.
//
// Replaces the Pallas kernels of mvpnet_tpu/ops/pallas/fps.py:
//   * `fps` (fps_shared_kernel): _fps_batched_kernel (pallas_call at
//     fps.py:133), the row in one block's shared memory. On the chunk path
//     it samples 8192 -> 1024 at SA1 and 1024 -> 256 at SA2; on the
//     whole-scene path at the high-resolution config, 8192 -> 2048 at SA2
//     and below.
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
// fps_shared_kernel: one block per batch row, up to 1024 threads, the row as
// float4 (x, y, z, dist) in dynamic shared memory (128 KB at N = 8192); each
// step is a strided update, then a warp-shuffle argmax with the tie rule
// (d > bd) || (d == bd && i < bi) and a second pass over the warps' winners.
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
// barrier. On an H100 80GB HBM3 at 700 W that is about 2.5 us a step (20.6
// ms at that shape; 24.7 ms on clusters of 8; PERF.md). The first version of this
// kernel, 1024 threads a CTA reading the C winners from the other CTAs after
// the barrier, took 32 ms on 8 CTAs and 47 ms on 16: the step's
// synchronization, not its arithmetic, sets the pace. Neither the card's
// bytes nor its operations (10 f32 operations a point and step, 0.50 ms at
// that shape) come near; chip_smoke.py computes both from the run.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
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

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.d > a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

// The best (d, i) over lanes that are W apart or less (W a power of two),
// to every one of them (butterfly: the tie rule is a total order).
template <int W>
__device__ __forceinline__ ArgMax group_argmax(ArgMax v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    ArgMax o;
    o.d = __shfl_xor_sync(MVP_FULL_MASK, v.d, off);
    o.i = __shfl_xor_sync(MVP_FULL_MASK, v.i, off);
    v = better(v, o);
  }
  return v;
}

// Block-wide argmax; thread 0 gets the winner. `red` holds one entry a warp.
__device__ __forceinline__ ArgMax block_argmax(ArgMax v, ArgMax* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = group_argmax<32>(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float ninf = -__int_as_float(0x7f800000);
    v = group_argmax<32>(lane < nwarps ? red[lane] : ArgMax{ninf, INT_MAX});
  }
  return v;
}

__global__ void fps_shared_kernel(const float* __restrict__ pts,
                                  const uint8_t* __restrict__ mask, int N,
                                  int npoint, int* __restrict__ out) {
  extern __shared__ float4 row[];
  __shared__ ArgMax red[kMaxThreads / 32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* p = pts + 3 * (size_t)b * N;
  const uint8_t* mk = mask ? mask + (size_t)b * N : nullptr;
  int* o = out + (size_t)b * npoint;
  const float inf = __int_as_float(0x7f800000);

  // init: dist +inf for valid points, -inf for invalid; seed = first valid
  int first = INT_MAX;
  for (int i = tid; i < N; i += blockDim.x) {
    const bool valid = mk == nullptr || mk[i] != 0;
    row[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], valid ? inf : -inf);
    if (valid && i < first) first = i;
  }
  // block min of `first` through the same argmax machinery (lower index wins)
  ArgMax f = block_argmax(ArgMax{first == INT_MAX ? -inf : 0.f, first}, red);
  if (tid == 0) {
    s_last = f.i == INT_MAX ? 0 : f.i;
    o[0] = s_last;
  }
  __syncthreads();
  int last = s_last;

  for (int step = 1; step < npoint; ++step) {
    const float4 l = row[last];
    ArgMax best{-inf, INT_MAX};
    for (int i = tid; i < N; i += blockDim.x) {
      const float4 v = row[i];
      const float nd = fminf(v.w, mvp_sqdist(v.x, v.y, v.z, l.x, l.y, l.z));
      if (nd < v.w) row[i].w = nd;
      best = better(best, ArgMax{nd, i});
    }
    best = block_argmax(best, red);
    if (tid == 0) {
      s_last = best.i;
      o[step] = best.i;
    }
    __syncthreads();
    last = s_last;
  }
}

// The winner of a warp, a CTA or the cluster: (d, i) and the point's
// coordinates.
struct __align__(16) Cand {
  float d;
  int i;
  float x, y, z;
};

// The cluster's winner of this step, to every thread, from each thread's
// best (d, i) and the coordinates of its point `xyz` (read by the lane that
// owns the warp's winner only): a warp and a block reduction; warp 0 pushes
// the CTA's winner into slot [parity][rank] of every CTA of the cluster
// through distributed shared memory; one cluster barrier; then each warp
// reduces the kCluster slots in its own shared memory.
template <typename Coords>
__device__ __forceinline__ Cand cluster_best(cg::cluster_group& cluster, ArgMax v, Coords xyz,
                                             Cand* red, Cand (*slots)[kCluster], int step) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float ninf = -__int_as_float(0x7f800000);
  const Cand none{ninf, INT_MAX, 0.f, 0.f, 0.f};
  const ArgMax w = group_argmax<32>(v);
  if (w.i == INT_MAX) {
    if (lane == 0) red[warp] = none;  // a warp without points
  } else if (v.i == w.i) {
    float x, y, z;
    xyz(x, y, z);
    red[warp] = Cand{w.d, w.i, x, y, z};
  }
  __syncthreads();
  Cand* slot = slots[step & 1];
  if (warp == 0) {
    const Cand c = lane < (int)(blockDim.x >> 5) ? red[lane] : none;
    const ArgMax b = group_argmax<32>(ArgMax{c.d, c.i});
    const int src = __ffs(__ballot_sync(MVP_FULL_MASK, c.i == b.i)) - 1;
    const Cand win{b.d, b.i, __shfl_sync(MVP_FULL_MASK, c.x, src), __shfl_sync(MVP_FULL_MASK, c.y, src),
                   __shfl_sync(MVP_FULL_MASK, c.z, src)};
    if (lane < kCluster) *cluster.map_shared_rank(slot + cluster.block_rank(), lane) = win;
  }
  cluster.sync();
  const Cand c = lane < kCluster ? slot[lane] : none;
  const ArgMax b = group_argmax<kCluster>(ArgMax{c.d, c.i});
  // lanes 0..kCluster-1 hold the winner; every lane takes it from the one
  // that read it
  const int src = __ffs(__ballot_sync(MVP_FULL_MASK, lane < kCluster && c.i == b.i)) - 1;
  return Cand{__shfl_sync(MVP_FULL_MASK, c.d, src), __shfl_sync(MVP_FULL_MASK, c.i, src),
              __shfl_sync(MVP_FULL_MASK, c.x, src), __shfl_sync(MVP_FULL_MASK, c.y, src),
              __shfl_sync(MVP_FULL_MASK, c.z, src)};
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

int block_threads(int N) {
  const int threads = ((N + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
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
  e = cudaFuncGetAttributes(&a, fps_shared_kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncGetAttributes(&c, fps_cluster_kernel);
  if (e != cudaSuccess) return e;
  const size_t stat = a.sharedSizeBytes > c.sharedSizeBytes ? a.sharedSizeBytes : c.sharedSizeBytes;
  *bytes = optin - (int)stat;
  return cudaSuccess;
}

// pts (B, N, 3) f32 contiguous; mask (B, N) uint8 or null; out (B, npoint)
// int32. The row must fit in shared memory (see fps_shared_bytes), else
// cudaErrorInvalidValue. Returns cudaError_t.
extern "C" int fps(const float* pts, const uint8_t* mask, int B, int N,
                   int npoint, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  if (N <= 0) return cudaErrorInvalidValue;
  int avail = 0;
  cudaError_t e = static_cast<cudaError_t>(fps_shared_bytes(&avail));
  if (e != cudaSuccess) return e;
  const size_t bytes = sizeof(float4) * (size_t)N;
  if (bytes > (size_t)avail) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fps_shared_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  fps_shared_kernel<<<B, block_threads(N), bytes, st>>>(pts, mask, N, npoint,
                                                        out);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  if (N <= 0 || slice_len <= 0 || smem_points < 0 ||
      (long long)kCluster * slice_len < N)
    return cudaErrorInvalidValue;
  if (scratch == nullptr &&
      (long long)slice_len > (long long)kRegPoints * kClusterThreads + smem_points)
    return cudaErrorInvalidValue;
  int avail = 0;
  cudaError_t e = static_cast<cudaError_t>(fps_shared_bytes(&avail));
  if (e != cudaSuccess) return e;
  const size_t bytes = sizeof(float4) * (size_t)smem_points;
  if (bytes > (size_t)avail) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, pts, mask, N, npoint, slice_len, smem_points,
                         reinterpret_cast<float4*>(scratch), out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
