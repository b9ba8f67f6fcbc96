// What the kernels of B1 share (the forward variants of instance_norm.cu,
// instance_norm_split.cu and instance_norm_resident.cu, the backward ones of
// instance_norm_bwd.cu, both of instance_norm_sample.cu): type conversions,
// the activation and its derivative, 16-byte vectors,
// cp.async, the cluster barrier's halves, the fixed-order sums over a block
// and over a cluster, the fixed-order combine of a unit's chunk statistics,
// and the checked launches of a cluster kernel and of a cooperative one.
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
// a resident CTA's chunk when it has an SM to itself: the 227 KB a block may
// use less 2 KB for its static shared memory
// (ops/instance_norm.py RESIDENT_CTA_BYTES)
constexpr int kResidentBytes = 225 * 1024;

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

// dy times the activation's derivative at x^, for the backward kernels
// (JAX's rules at exactly 0: jnp.where(x >= 0, ...) passes 1, nn.relu
// passes 0).
template <int kAct>
__device__ __forceinline__ float act_grad(float dy, float xh, float slope) {
  if (kAct == 1) return xh > 0.f ? dy : 0.f;
  if (kAct == 2) return xh >= 0.f ? dy : dy * slope;
  return dy;
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

// Close a group of this thread's cp.async copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's groups of cp.async copies are in
// flight (n a compile-time constant).
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Wait for every cp.async of this thread, then for the whole block's.
__device__ __forceinline__ void cp_async_wait_block() {
  cp_async_commit();
  cp_async_wait<0>();
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

// Chan's combine, in fp64, of one unit's per-chunk statistics (count n_s =
// the chunk's pixels, fp32 mean m_s and sum of squared deviations M2_s),
// laid out [unit][channel][chunk] in rows of whole float4s:
//   mean = sum n_s m_s / N,  M2 = sum M2_s + sum n_s (m_s - mean)^2.
// Each channel's sums are taken by tpc = min(32, kThreads / group) threads
// (a power of 2 that divides 32), each over float4s r = sub, sub + tpc, ...
// of the channel's row in that order, kBatch loads in flight, then a fixed
// xor butterfly: the same order in every CTA and on every run. A row of at
// most tpc * kBatch float4s (every chunking of the resident variant) is
// read once, both sums from the same registers. Returns true on the thread
// that holds channel *ch's fp32 mean and rstd = 1/sqrt(M2/N + eps). The
// partials were written by other CTAs of this grid, so they are read
// through L2 (ld.global.cg).
__device__ __forceinline__ bool combine_unit(const float* part_mean,
                                             const float* part_m2, int unit,
                                             int group, int chunks, int ppc,
                                             int hw, float eps, int* ch_out,
                                             float* mean_out,
                                             float* rstd_out) {
  constexpr int kBatch = 5;  // float4 loads of partials in flight
  const int stride = (chunks + 3) & ~3;
  const int tpc = min(32, kThreads / group);
  const int ch = threadIdx.x / tpc, sub = threadIdx.x & (tpc - 1);
  if (ch >= group) return false;
  const size_t row = (static_cast<size_t>(unit) * group + ch) * stride;
  const float4* pm = reinterpret_cast<const float4*>(part_mean + row);
  const float4* pq = reinterpret_cast<const float4*>(part_m2 + row);
  const int nv = stride >> 2;
  const bool once = nv <= tpc * kBatch;  // one batch: both rows kept
  // n_s: ppc pixels, the last chunk what is left
  const double n_full = static_cast<double>(ppc);
  const double n_last = static_cast<double>(hw - (chunks - 1) * ppc);
  float4 a[kBatch], b[kBatch];
  double t = 0.0;
  for (int r0 = sub; r0 < nv; r0 += tpc * kBatch) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (r0 + k * tpc < nv) {
        a[k] = __ldcg(pm + r0 + k * tpc);
        if (once) b[k] = __ldcg(pq + r0 + k * tpc);
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = r0 + k * tpc;
      const float mv[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * r + e;
        if (r < nv && j < chunks)
          t += (j == chunks - 1 ? n_last : n_full) *
               static_cast<double>(mv[e]);
      }
    }
  }
  for (int off = tpc >> 1; off >= 1; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  const double mu = t / static_cast<double>(hw);
  double m2 = 0.0;
  for (int r0 = sub; r0 < nv; r0 += tpc * kBatch) {
    if (!once) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (r0 + k * tpc < nv) {
          a[k] = __ldcg(pm + r0 + k * tpc);
          b[k] = __ldcg(pq + r0 + k * tpc);
        }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = r0 + k * tpc;
      const float mv[4] = {a[k].x, a[k].y, a[k].z, a[k].w};
      const float qv[4] = {b[k].x, b[k].y, b[k].z, b[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * r + e;
        if (r < nv && j < chunks) {
          const double d = static_cast<double>(mv[e]) - mu;
          m2 += static_cast<double>(qv[e]) +
                (j == chunks - 1 ? n_last : n_full) * d * d;
        }
      }
    }
  }
  for (int off = tpc >> 1; off >= 1; off >>= 1)
    m2 += __shfl_xor_sync(0xffffffffu, m2, off);
  if (sub != 0) return false;
  const float var = static_cast<float>(m2 / static_cast<double>(hw));
  *ch_out = ch;
  *mean_out = static_cast<float>(mu);
  *rstd_out = 1.0f / sqrtf(var + eps);
  return true;
}

// A launch of a cluster kernel on a 1-D grid of `grid` CTAs of `threads`
// in clusters of k, with `smem` bytes of dynamic shared memory. Once per
// (device, kernel) the kernel is allowed the whole slice budget; once per
// (device, kernel, k, bytes) the occupancy query checks that at least one
// cluster fits, as a launch that cannot fit fails only later, at the next
// synchronisation.
template <typename... Params, typename... Args>
cudaError_t launch_cluster_kernel_of(int threads, void (*kernel)(Params...),
                                     long long grid, int k, size_t smem,
                                     int device, cudaStream_t stream,
                                     Args... args) {
  if (smem > static_cast<size_t>(kSliceBytes) || grid <= 0 ||
      grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(threads);
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

// launch_cluster_kernel_of with CTAs of kThreads.
template <typename... Params, typename... Args>
cudaError_t launch_cluster_kernel(void (*kernel)(Params...), long long grid,
                                  int k, size_t smem, int device,
                                  cudaStream_t stream, Args... args) {
  return launch_cluster_kernel_of(kThreads, kernel, grid, k, smem, device,
                                  stream, args...);
}

// A cooperative launch of `grid` CTAs of kThreads with `smem` bytes of
// dynamic shared memory: every CTA is resident at once, so the kernel may
// wait at cg::this_grid().sync(). Once per (device, kernel) the kernel is
// allowed kResidentBytes and the largest shared-memory carve-out; once per
// (device, kernel, bytes) the occupancy query gives the CTAs that fit the
// device's SMs together. A grid larger than that returns
// cudaErrorCooperativeLaunchTooLarge and launches nothing.
template <typename... Params, typename... Args>
cudaError_t launch_cooperative_kernel(void (*kernel)(Params...),
                                      long long grid, size_t smem,
                                      int device, cudaStream_t stream,
                                      Args... args) {
  if (smem > static_cast<size_t>(kResidentBytes) || grid <= 0 ||
      grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(kernel);
  static std::mutex mu;
  static std::set<std::tuple<int, const void*>> ready;
  static std::map<std::tuple<int, const void*, size_t>, long long> fits;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready.count({device, fn})) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kResidentBytes);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
      ready.insert({device, fn});
    }
    const auto key = std::make_tuple(device, fn, smem);
    auto it = fits.find(key);
    if (it == fits.end()) {
      int per_sm = 0, sms = 0, coop = 0;
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, kThreads, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     device);
      if (err != cudaSuccess) return err;
      it = fits.emplace(key, coop ? static_cast<long long>(per_sm) * sms
                                  : 0LL).first;
    }
    if (grid > it->second) return cudaErrorCooperativeLaunchTooLarge;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace b1
