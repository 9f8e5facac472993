// Farthest point sampling: two entry points over one step loop.
//
// Replaces the Pallas kernels of mvpnet_tpu/ops/pallas/fps.py:
//   * `fps` (fps_shared_kernel): _fps_batched_kernel (pallas_call at
//     fps.py:133), the row in shared memory. On the chunk path it samples
//     8192 -> 1024 at SA1 and 1024 -> 256 at SA2; on the whole-scene path at
//     the high-resolution config, 8192 -> 2048 at SA2 and below.
//   * `fps_perrow` (fps_perrow_kernel): _fps_kernel (pallas_call at fps.py:174
//     in _fps_perrow), the row in device memory. On the whole-scene path it
//     samples 4 x 102,400 -> 8192 at SA1.
// The TPU splits the two by VMEM (_MAX_BN, fps.py:30); here the wrapper
// (mvpnet_torch/ops/fps.py, `route`) sends a row to the shared-memory kernel
// when its 16 bytes a point fit the block's shared memory (fps_shared_bytes),
// and to the per-row kernel otherwise.
//
// Contract (mvpnet_tpu/ops/reference.py:67): the seed is the first valid
// index (0 when unmasked or when no point is valid); each step takes
// dist = min(dist, |p - last|^2) and the argmax with the first occurrence on
// ties; invalid points start at -inf and so are never selected while a valid
// point remains.
//
// Design: one block per batch row, up to 1024 threads. The row lives as
// float4 (x, y, z, dist): in dynamic shared memory (16 B a point, 128 KB at
// N = 8192, above the 48 KB default so it needs the opt-in), or, for a row
// too long for that, in a (B, N, 4) scratch in device memory, where each step
// reads every point with one coalesced 16-byte load (from L2: 1.6 MB a row at
// N = 102,400) and writes back only the distances that shrank. Each step is
// a strided update, then a warp-shuffle argmax with the tie rule
// (d > bd) || (d == bd && i < bi) and a second pass over the warps' winners.
//
// Bound on the H100: the npoint - 1 steps are sequential and each is a
// block-wide reduction, so each row runs on one SM and the kernel is bound by
// the latency of the step loop (and, per row, by one SM's share of L2
// bandwidth in the per-row kernel), not by the card's bytes or operations (10
// f32 operations per point and step). chip_smoke.py computes both roofs from
// the run's shapes.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

struct ArgMax {
  float d;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.d > a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.d = __shfl_down_sync(MVP_FULL_MASK, v.d, off);
    o.i = __shfl_down_sync(MVP_FULL_MASK, v.i, off);
    v = better(v, o);
  }
  return v;
}

// Block-wide argmax; thread 0 gets the winner. `red` holds one entry a warp.
__device__ __forceinline__ ArgMax block_argmax(ArgMax v, ArgMax* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_argmax(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float ninf = -__int_as_float(0x7f800000);
    v = lane < nwarps ? red[lane] : ArgMax{ninf, INT_MAX};
    v = warp_argmax(v);
  }
  return v;
}

// The FPS of batch row blockIdx.x over `row`, N float4 (x, y, z, dist) in
// shared or device memory that only this block touches.
__device__ __forceinline__ void fps_row(const float* __restrict__ pts,
                                        const uint8_t* __restrict__ mask,
                                        int N, int npoint, float4* row,
                                        int* __restrict__ out) {
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

__global__ void fps_shared_kernel(const float* __restrict__ pts,
                                  const uint8_t* __restrict__ mask, int N,
                                  int npoint, int* __restrict__ out) {
  extern __shared__ float4 sp[];
  fps_row(pts, mask, N, npoint, sp, out);
}

__global__ void fps_perrow_kernel(const float* __restrict__ pts,
                                  const uint8_t* __restrict__ mask, int N,
                                  int npoint, float4* __restrict__ scratch,
                                  int* __restrict__ out) {
  fps_row(pts, mask, N, npoint, scratch + (size_t)blockIdx.x * N, out);
}

int block_threads(int N) {
  const int threads = ((N + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace

// Dynamic shared memory a block of fps_shared_kernel may take on the current
// device: the opt-in limit less the kernel's static shared memory. A row of
// N points fits when 16 * N <= *bytes. Returns cudaError_t.
extern "C" int fps_shared_bytes(int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fps_shared_kernel);
  if (e != cudaSuccess) return e;
  *bytes = optin - (int)attr.sharedSizeBytes;
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

// pts (B, N, 3) f32 contiguous; mask (B, N) uint8 or null; scratch (B, N, 4)
// f32, the rows as (x, y, z, dist); out (B, npoint) int32. Any N. Returns
// cudaError_t.
extern "C" int fps_perrow(const float* pts, const uint8_t* mask, int B, int N,
                          int npoint, float* scratch, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  if (N <= 0) return cudaErrorInvalidValue;
  fps_perrow_kernel<<<B, block_threads(N), 0, st>>>(
      pts, mask, N, npoint, reinterpret_cast<float4*>(scratch), out);
  return cudaGetLastError();
}
