// Fused InstanceNorm + activation over NHWC for full-frame planes: the split
// variant of kernel B1.
//
// Replaces patch_toon_tpu/ops/pallas_norm.py::instance_norm_act (its Pallas
// body _kernel) where the cluster variant of instance_norm.cu cannot hold a
// unit: a full frame's plane, such as 512x912x32 at the stem or 512x912x128
// at the last upsample, is up to 30 MB a unit of 32 channels, and 8 CTAs
// hold at most 880 KB. It computes what the other variants compute: for
// each (sample, channel) the fp32 mean over H*W, the biased variance as the
// mean of squared deviations (never E[x^2]-E[x]^2), y = (x - mean) /
// sqrt(var + eps), LeakyReLU, ReLU or nothing, and one cast back.
//
// Bound: bytes, one read and one write of the tensor at the memory rate.
// The TPU kernel read a sample once from VMEM; here the statistics of a
// unit need every CTA that holds a part of it, and Hopper's CTAs share
// nothing across a grid, so the reduction is split across CTAs in two
// launches over the same grid, one CTA a chunk of ppc pixels of one unit
// (sample, group of G channels). The CTAs of a chunk's units are
// neighbours in the grid, so the CTAs that run together read whole pixel
// rows.
//
// Launch 1 (statistics). Each thread streams its pixels of the chunk with
// 16-byte loads, four in flight, and keeps Welford's running mean and sum
// of squared deviations per channel in fp32; the threads' statistics are
// merged by Chan's formula, down each warp and then across the warps in a
// fixed order, into the chunk's count n_s, mean m_s and M2_s, written to a
// workspace laid out [unit][channel][chunk]. (A first design loaded each
// chunk into shared memory with cp.async and took two passes there; its
// whole-chunk loads left the statistics launch at about a third of the
// memory rate.) The CTA that finishes its unit last (a counter a unit, the
// only atomic; it counts CTAs, not values) combines the unit's partials
// with Chan's formula in fp64,
//   mean = sum n_s m_s / N,  M2 = sum M2_s + sum n_s (m_s - mean)^2,
// writes the unit's fp32 mean and rstd = 1/sqrt(M2/N + eps), and sets the
// counter back to 0 for the next launch. The combine (b1_common.cuh
// combine_unit) sums in the same fixed order on every run, whichever CTA
// comes last, so the result is deterministic. Combining once a unit,
// rather than in every CTA of launch 2, reads the workspace once.
//
// Launch 2 (normalize). Each CTA reads its unit's mean and rstd and
// normalizes its chunk: one read and one write, with 16-byte loads and
// stores, four in flight a thread. It walks the chunk's pixels from the
// last: launch 1 ran in one wave and read each chunk from its first pixel,
// so what L2 still holds of the plane is the chunks' ends (3 % faster at
// upsample1's 119.5 MB bf16 plane, 4 % at the 59.8 MB fp32 stem, on an
// NVIDIA H100 80GB HBM3 at 700.00 W).
//
// So three transfers of the tensor against the bound's two: at most 67 %
// of the bound. A plane that fits the SMs' shared memory goes to the
// resident variant instead (instance_norm_resident.cu: one launch, one
// read); this one takes the rest (upsample1's 119.5 MB plane at bf16, and
// at fp32 also the stem's and upsample2's). ops/instance_norm.py::plan
// picks G (the largest of 32, 16, 8, 4 that takes C in whole 16-byte
// vectors) and the chunking (two CTAs an SM over the whole launch, so one
// wave); the entry point checks what it is given again and returns an
// error code, never falls back.
#include "b1_common.cuh"

namespace {

using namespace b1;

constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

// Chan's merge of the statistics (nb, mb[], qb[]) of other pixels into
// (na, ma[], qa[]): counts, means and sums of squared deviations, in fp32.
// An empty side changes nothing; an empty na takes nb's values.
template <int kVec>
__device__ __forceinline__ void chan_merge(float& na, float* ma, float* qa,
                                           float nb, const float* mb,
                                           const float* qb) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float fb = nb / n;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float d = mb[e] - ma[e];
    ma[e] += d * fb;
    qa[e] += qb[e] + d * d * na * fb;
  }
  na = n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_split_stats_kernel(const T* __restrict__ x,
                                 float* __restrict__ part_mean,
                                 float* __restrict__ part_m2,
                                 float* __restrict__ mean_out,
                                 float* __restrict__ rstd_out,
                                 unsigned* __restrict__ counters, int hw,
                                 int c, int group, int ppc, int chunks,
                                 float eps) {
  constexpr int kVec = Vec<T>::n;
  __shared__ float warp_n[kWarpsC][kMaxGroup];
  __shared__ float warp_m[kWarpsC][kMaxGroup];
  __shared__ float warp_q[kWarpsC][kMaxGroup];
  __shared__ bool last;

  const int units = gridDim.x / chunks;
  const int s = blockIdx.x / units;  // the units of one chunk run together
  const int unit = blockIdx.x - s * units;
  const int groups = c / group;
  const int n = unit / groups, g = unit - n * groups;
  const int p0 = s * ppc;
  const int np = min(ppc, hw - p0);  // at least 1: chunks = ceil(hw / ppc)
  const int vpp = group / kVec;      // 16-byte vectors a pixel, divides 32
  const int vshift = __ffs(vpp) - 1;
  const int nvec = np * vpp;
  const int v = threadIdx.x & (vpp - 1);  // the same slot for every i
  const size_t base = (static_cast<size_t>(n) * hw + p0) * c +
                      static_cast<size_t>(g) * group + v * kVec;

  // each thread: Welford's update over its pixels of the chunk, with four
  // 16-byte loads in flight
  float cnt = 0.f, m[kVec], q[kVec], f[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) m[e] = q[e] = 0.f;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kThreads * kUnroll) {
    uint4 u[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int i = i0 + r * kThreads;
      if (i < nvec)
        u[r] = __ldg(reinterpret_cast<const uint4*>(
            x + base + static_cast<size_t>(i >> vshift) * c));
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      if (i0 + r * kThreads < nvec) {
        Vec<T>::unpack(u[r], f);
        cnt += 1.f;
        const float inv = 1.f / cnt;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = f[e] - m[e];
          m[e] += d * inv;
          q[e] += d * (f[e] - m[e]);
        }
      }
    }
  }

  // merge the threads of each slot: down a warp, then across the warps in
  // order, by Chan's formula; thread t < group ends with channel t's
  // count, mean and M2 over the chunk
  float mb[kVec], qb[kVec];
  for (int off = 16; off >= vpp; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, off);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      mb[e] = __shfl_down_sync(0xffffffffu, m[e], off);
      qb[e] = __shfl_down_sync(0xffffffffu, q[e], off);
    }
    chan_merge<kVec>(cnt, m, q, nb, mb, qb);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < vpp) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      warp_n[warp][lane * kVec + e] = cnt;
      warp_m[warp][lane * kVec + e] = m[e];
      warp_q[warp][lane * kVec + e] = q[e];
    }
  }
  __syncthreads();
  const int stride = (chunks + 3) & ~3;  // a channel's row, whole float4s
  if (threadIdx.x < group) {
    float tn = 0.f, tm = 0.f, tq = 0.f;
    for (int w = 0; w < kWarpsC; ++w)
      chan_merge<1>(tn, &tm, &tq, warp_n[w][threadIdx.x],
                    &warp_m[w][threadIdx.x], &warp_q[w][threadIdx.x]);
    const size_t o =
        (static_cast<size_t>(unit) * group + threadIdx.x) * stride + s;
    part_mean[o] = tm;
    part_m2[o] = tq;
    __threadfence();  // the writers' fence, before the count says "done"
  }

  // the last CTA of the unit combines its partials
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + unit, 1u) == static_cast<unsigned>(chunks - 1);
    __threadfence();  // the partials of the other CTAs are visible after it
  }
  __syncthreads();
  if (!last) return;
  int ch;
  float mu, rs;
  if (combine_unit(part_mean, part_m2, unit, group, chunks, ppc, hw, eps, &ch,
                   &mu, &rs)) {
    const size_t o =
        static_cast<size_t>(n) * c + static_cast<size_t>(g) * group + ch;
    mean_out[o] = mu;
    rstd_out[o] = rs;
  }
  if (threadIdx.x == 0) counters[unit] = 0u;
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
instance_norm_split_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ mean_in,
                                 const float* __restrict__ rstd_in, int hw,
                                 int c, int group, int ppc, int chunks,
                                 float slope) {
  constexpr int kVec = Vec<T>::n;
  const int units = gridDim.x / chunks;
  const int s = blockIdx.x / units;
  const int unit = blockIdx.x - s * units;
  const int groups = c / group;
  const int n = unit / groups, g = unit - n * groups;
  const int p0 = s * ppc;
  const int np = min(ppc, hw - p0);
  const int vpp = group / kVec;
  const int vshift = __ffs(vpp) - 1;
  const int nvec = np * vpp;
  const int v = threadIdx.x & (vpp - 1);

  float mean[kVec], rstd[kVec], f[kVec];
  const size_t so = static_cast<size_t>(n) * c +
                    static_cast<size_t>(g) * group + v * kVec;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    mean[e] = mean_in[so + e];
    rstd[e] = rstd_in[so + e];
  }
  const size_t base = (static_cast<size_t>(n) * hw + p0) * c +
                      static_cast<size_t>(g) * group + v * kVec;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kThreads * kUnroll) {
    uint4 u[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int i = i0 + r * kThreads;
      if (i < nvec)
        u[r] = __ldg(reinterpret_cast<const uint4*>(
            x + base + static_cast<size_t>(np - 1 - (i >> vshift)) * c));
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int i = i0 + r * kThreads;
      if (i < nvec) {
        Vec<T>::unpack(u[r], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          f[e] = activate<kAct>((f[e] - mean[e]) * rstd[e], slope);
        *reinterpret_cast<uint4*>(
            y + base + static_cast<size_t>(np - 1 - (i >> vshift)) * c) =
            Vec<T>::pack(f);
      }
    }
  }
}

template <typename T>
cudaError_t launch_split(const void* x, void* y, float* mean, float* rstd,
                         float* part, unsigned* counters, int n, int hw,
                         int c, int group, int ppc, int chunks, int act,
                         float slope, float eps, int device,
                         cudaStream_t stream) {
  constexpr int kVec = Vec<T>::n;
  if (group <= 0 || group > kMaxGroup || group % kVec != 0 ||
      c % group != 0)
    return cudaErrorInvalidValue;
  const int vpp = group / kVec;
  if ((vpp & (vpp - 1)) != 0) return cudaErrorInvalidValue;
  if (ppc <= 0 || chunks <= 0 ||
      static_cast<long long>(ppc) * (chunks - 1) >= hw ||
      static_cast<long long>(ppc) * chunks < hw)
    return cudaErrorInvalidValue;  // chunks must be ceil(hw / ppc)
  const long long units = static_cast<long long>(n) * (c / group);
  const long long grid = units * chunks;
  if (grid <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(part)) % 16)
    return cudaErrorMisalignedAddress;
  float* part_mean = part;
  float* part_m2 = part + units * group * ((chunks + 3) & ~3);

  const dim3 blocks(static_cast<unsigned>(grid));
  instance_norm_split_stats_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part_mean, part_m2, mean, rstd, counters, hw,
      c, group, ppc, chunks, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (act) {
    case 0:
      instance_norm_split_apply_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(
          xi, yo, mean, rstd, hw, c, group, ppc, chunks, slope);
      break;
    case 1:
      instance_norm_split_apply_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
          xi, yo, mean, rstd, hw, c, group, ppc, chunks, slope);
      break;
    case 2:
      instance_norm_split_apply_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(
          xi, yo, mean, rstd, hw, c, group, ppc, chunks, slope);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16. act: 0 none, 1 relu, 2 leaky_relu. mean and rstd
// are (n, c) fp32 outputs, always written (launch 2 reads them); part is a
// 16-byte aligned workspace of 2 * n * c * round_up(chunks, 4) floats;
// counters holds n * (c / group) zeros and is left zero.
extern "C" int ptt_instance_norm_act_split(const void* x, void* y,
                                           float* mean, float* rstd,
                                           float* part, unsigned* counters,
                                           int n, int hw, int c, int group,
                                           int ppc, int chunks, int dtype,
                                           int act, float slope, float eps,
                                           int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0) return cudaErrorInvalidValue;
  if (mean == nullptr || rstd == nullptr || part == nullptr ||
      counters == nullptr)
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_split<float>(x, y, mean, rstd, part, counters, n, hw, c,
                               group, ppc, chunks, act, slope, eps, device,
                               s);
  if (dtype == 1)
    return launch_split<__nv_bfloat16>(x, y, mean, rstd, part, counters, n,
                                       hw, c, group, ppc, chunks, act, slope,
                                       eps, device, s);
  return cudaErrorInvalidValue;
}
