// What the kernels of B1 share (the forward variants of instance_norm.cu and
// instance_norm_split.cu, the backward ones of instance_norm_bwd.cu): type
// conversions, the activation, 16-byte vectors, cp.async, the
// cluster barrier's halves, the fixed-order sums over a block and over a
// cluster, and the checked launch of a cluster kernel.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <tuple>

#include "device_guard.cuh"

namespace b1 {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // a cluster variant's CTA
constexpr int kWarpsC = kThreads / 32;
constexpr int kMaxGroup = 32;
constexpr int kSliceBytes = 110 * 1024;  // ops/instance_norm.py CTA_BYTES

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// The activation after the normalization: kAct 0 none, 1 ReLU, 2 LeakyReLU.
template <int kAct>
__device__ __forceinline__ float activate(float v, float slope) {
  if (kAct == 1) return v >= 0.f ? v : 0.f;
  if (kAct == 2) return v >= 0.f ? v : v * slope;
  return v;
}

// A 16-byte vector: 4 fp32 or 8 bf16 values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static float2 two(uint32_t w) {
    __nv_bfloat162 b;
    memcpy(&b, &w, 4);
    return __bfloat1622float2(b);
  }
  __device__ static uint32_t word(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
  __device__ static void unpack(const uint4& u, float* f) {
    float2 t = two(u.x); f[0] = t.x; f[1] = t.y;
    t = two(u.y); f[2] = t.x; f[3] = t.y;
    t = two(u.z); f[4] = t.x; f[5] = t.y;
    t = two(u.w); f[6] = t.x; f[7] = t.y;
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]),
                      word(f[6], f[7]));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Wait for every cp.async of this thread, then for the whole block's.
__device__ __forceinline__ void cp_async_wait_block() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The cluster barrier in two halves: arrive when this CTA is done reading
// its peers' shared memory, wait before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Per-channel sums of the block: thread t holds the kVec channels
// v*kVec.. of vector slot v = t % vpp; lanes with the same slot meet by
// shuffles, warps in warp_part, and threads < group write out[channel].
template <int kVec>
__device__ __forceinline__ void block_channel_sum(
    float (&acc)[kVec], int vpp, int group, float (*warp_part)[kMaxGroup],
    float* out) {
  for (int off = 16; off >= vpp; off >>= 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < vpp) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) warp_part[warp][lane * kVec + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < group) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsC; ++w) t += warp_part[w][threadIdx.x];
    out[threadIdx.x] = t;
  }
}

// Sum of element i of a partial over the cluster's CTAs in rank order, so
// that every CTA gets bitwise the same value.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* part, int k, int i) {
  float t = 0.f;
  for (int r = 0; r < k; ++r) t += cluster.map_shared_rank(part, r)[i];
  return t;
}

// A launch of a cluster kernel on a 1-D grid of `grid` CTAs in clusters of
// k, with `smem` bytes of dynamic shared memory. Once per (device, kernel)
// the kernel is allowed the whole slice budget; once per (device, kernel,
// k, bytes) the occupancy query checks that at least one cluster fits, as
// a launch that cannot fit fails only later, at the next synchronisation.
template <typename... Params, typename... Args>
cudaError_t launch_cluster_kernel(void (*kernel)(Params...), long long grid,
                                  int k, size_t smem, int device,
                                  cudaStream_t stream, Args... args) {
  if (smem > static_cast<size_t>(kSliceBytes) || grid <= 0 ||
      grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  const void* fn = reinterpret_cast<const void*>(kernel);
  static std::mutex mu;
  static std::set<std::tuple<int, const void*>> ready;
  static std::map<std::tuple<int, const void*, int, size_t>, int> fits;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready.count({device, fn})) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceBytes);
      if (err != cudaSuccess) return err;
      ready.insert({device, fn});
    }
    const auto key = std::make_tuple(device, fn, k, smem);
    auto it = fits.find(key);
    if (it == fits.end()) {
      int clusters = 0;
      cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
      if (err != cudaSuccess) return err;
      it = fits.emplace(key, clusters).first;
    }
    if (it->second == 0) return cudaErrorLaunchOutOfResources;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace b1
