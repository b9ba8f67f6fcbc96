// Fused InstanceNorm + activation over NHWC for full-frame planes that fit
// the SMs' shared memory together: the resident variant of kernel B1.
//
// Replaces patch_toon_tpu/ops/pallas_norm.py::instance_norm_act (its Pallas
// body _kernel) at the full-frame planes that no cluster of 8 CTAs holds
// but that the whole grid does: the H100's 132 SMs have 132 x 227 KB, about
// 30 MB, of shared memory, so at bf16 every site of a 512x912 pass but
// upsample1 (119.5 MB), and at fp32 the quarter-resolution sites and
// downsample1. It computes what the other variants compute: for each
// (sample, channel) the fp32 mean over H*W, the biased variance as the mean
// of squared deviations (never E[x^2]-E[x]^2), y = (x - mean) /
// sqrt(var + eps), LeakyReLU, ReLU or nothing, and one cast back.
//
// Bound: bytes, one read and one write of the tensor at the memory rate.
// The split variant (instance_norm_split.cu) reaches it in two launches
// that read the tensor twice; here one cooperative launch reads it once.
// The unit of work is one (sample, group of G channels); each CTA holds one
// chunk of ppc pixels of one unit in dynamic shared memory, and every CTA
// of the grid is resident at once, one an SM (ops/instance_norm.py::
// resident_plan: as many chunks a unit as the SMs allow; two smaller CTAs
// an SM were slower, as the combine below grows with the chunks). Each CTA:
//   1. loads its chunk once, with 16-byte cp.async copies in kStages
//      groups, and sums each channel as the groups land;
//   2. takes the chunk's per-channel fp32 mean (sum / count), then the sum
//      of squared deviations from it over shared memory, and publishes
//      both to a workspace laid out [unit][channel][chunk];
//   3. waits at the grid barrier (cg::this_grid().sync());
//   4. combines its unit's partials with Chan's formula in fp64, in a fixed
//      order (b1_common.cuh combine_unit), so every CTA of a unit gets
//      bitwise the same mean and rstd, and every run the same;
//   5. normalizes its chunk from shared memory and writes y with 16-byte
//      stores.
// Every thread reads and writes only the vectors i = threadIdx.x (mod
// kThreads) of the chunk in every pass, so no pass waits for another
// thread's copies. Chunk 0's CTA writes the unit's mean and rstd when they
// are asked for (autograd's backward pass).
//
// The grid barrier needs every CTA resident: the launch is cooperative
// (cudaLaunchAttributeCooperative), so CUDA places the whole grid or
// refuses it, and never leaves part of it waiting behind other kernels of
// other streams; the occupancy query checks once per (device, kernel,
// bytes) that the grid fits the device's SMs. A grid that does not fit,
// a chunk beyond kResidentBytes, or anything else the entry is not given
// as the plan says returns an error code: nothing falls back.
#include "b1_common.cuh"

namespace {

using namespace b1;

constexpr int kStages = 4;  // groups of cp.async copies a chunk is loaded in

// acc += the vectors chunk[i], i = lo + threadIdx.x, lo + threadIdx.x +
// kThreads, ... below hi, in that order.
template <typename T>
__device__ __forceinline__ void sum_vectors(const uint4* chunk, int lo,
                                            int hi, float* acc) {
  float f[Vec<T>::n];
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    Vec<T>::unpack(chunk[i], f);
#pragma unroll
    for (int e = 0; e < Vec<T>::n; ++e) acc[e] += f[e];
  }
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
instance_norm_resident_kernel(const T* __restrict__ x, T* __restrict__ y,
                              float* __restrict__ part_mean,
                              float* __restrict__ part_m2,
                              float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int hw, int c,
                              int group, int ppc, int chunks, float slope,
                              float eps) {
  constexpr int kVec = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char chunk_raw[];
  uint4* chunk = reinterpret_cast<uint4*>(chunk_raw);
  __shared__ float warp_part[kWarpsC][kMaxGroup];
  __shared__ float stat[2][kMaxGroup];  // chunk sums, then mean and rstd

  const int units = gridDim.x / chunks;
  const int s = blockIdx.x / units;
  const int unit = blockIdx.x - s * units;
  const int groups = c / group;
  const int n = unit / groups, g = unit - n * groups;
  const int p0 = s * ppc;
  const int np = min(ppc, hw - p0);  // at least 1: chunks = ceil(hw / ppc)
  const int vpp = group / kVec;      // 16-byte vectors a pixel, divides 32
  const int vshift = __ffs(vpp) - 1;
  const int nvec = np * vpp;
  const int v = threadIdx.x & (vpp - 1);  // the same slot for every i
  const size_t off0 = (static_cast<size_t>(n) * hw + p0) * c +
                      static_cast<size_t>(g) * group + v * kVec;

  // the loads in kStages groups of whole rounds of kThreads vectors; each
  // thread sums its vectors, in the order of one loop over the chunk, as
  // its groups land
  const int per =
      ((nvec + kThreads - 1) / kThreads + kStages - 1) / kStages * kThreads;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int hi = min(nvec, (st + 1) * per);
    for (int i = st * per + threadIdx.x; i < hi; i += kThreads)
      cp_async16(chunk + i, x + off0 + static_cast<size_t>(i >> vshift) * c);
    cp_async_commit();
  }
  static_assert(kStages == 4, "one wait a group below");
  float acc[kVec], f[kVec], mean[kVec], rstd[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  cp_async_wait<3>();
  sum_vectors<T>(chunk, 0, min(nvec, per), acc);
  cp_async_wait<2>();
  sum_vectors<T>(chunk, per, min(nvec, 2 * per), acc);
  cp_async_wait<1>();
  sum_vectors<T>(chunk, 2 * per, min(nvec, 3 * per), acc);
  cp_async_wait<0>();
  sum_vectors<T>(chunk, 3 * per, nvec, acc);

  // the chunk's statistics: its mean, then the squared deviations from it
  block_channel_sum<kVec>(acc, vpp, group, warp_part, stat[0]);
  __syncthreads();
  const float cnt = static_cast<float>(np);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    mean[e] = stat[0][v * kVec + e] / cnt;
    acc[e] = 0.f;
  }
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(chunk[i], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = f[e] - mean[e];
      acc[e] += d * d;
    }
  }
  block_channel_sum<kVec>(acc, vpp, group, warp_part, stat[1]);
  const int stride = (chunks + 3) & ~3;  // a channel's row, whole float4s
  if (threadIdx.x < group) {  // thread t wrote channel t's two sums
    const size_t o =
        (static_cast<size_t>(unit) * group + threadIdx.x) * stride + s;
    part_mean[o] = stat[0][threadIdx.x] / cnt;
    part_m2[o] = stat[1][threadIdx.x];
  }

  cg::this_grid().sync();  // every chunk's partials are written

  int ch;
  float mu, rs;
  if (combine_unit(part_mean, part_m2, unit, group, chunks, ppc, hw, eps, &ch,
                   &mu, &rs)) {
    stat[0][ch] = mu;
    stat[1][ch] = rs;
    if (mean_out != nullptr && s == 0) {  // for the backward pass
      const size_t o =
          static_cast<size_t>(n) * c + static_cast<size_t>(g) * group + ch;
      mean_out[o] = mu;
      rstd_out[o] = rs;
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    mean[e] = stat[0][v * kVec + e];
    rstd[e] = stat[1][v * kVec + e];
  }

  // normalize, activate, one rounding, 16-byte stores
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(chunk[i], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      f[e] = activate<kAct>((f[e] - mean[e]) * rstd[e], slope);
    *reinterpret_cast<uint4*>(y + off0 +
                              static_cast<size_t>(i >> vshift) * c) =
        Vec<T>::pack(f);
  }
}

template <typename T, int kAct>
cudaError_t launch_resident_act(const T* x, T* y, float* part_mean,
                                float* part_m2, float* mean, float* rstd,
                                long long grid, int hw, int c, int group,
                                int ppc, int chunks, float slope, float eps,
                                int device, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ppc) * group * sizeof(T);
  return launch_cooperative_kernel(instance_norm_resident_kernel<T, kAct>,
                                   grid, smem, device, stream, x, y,
                                   part_mean, part_m2, mean, rstd, hw, c,
                                   group, ppc, chunks, slope, eps);
}

template <typename T>
cudaError_t launch_resident(const void* x, void* y, float* mean, float* rstd,
                            float* part, int n, int hw, int c, int group,
                            int ppc, int chunks, int act, float slope,
                            float eps, int device, cudaStream_t stream) {
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
  if (static_cast<long long>(ppc) * group * sizeof(T) > kResidentBytes)
    return cudaErrorInvalidValue;  // the chunk does not fit one CTA
  const long long units = static_cast<long long>(n) * (c / group);
  const long long grid = units * chunks;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(part)) % 16)
    return cudaErrorMisalignedAddress;
  float* part_m2 = part + units * group * ((chunks + 3) & ~3);
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (act) {
    case 0:
      return launch_resident_act<T, 0>(xi, yo, part, part_m2, mean, rstd,
                                       grid, hw, c, group, ppc, chunks,
                                       slope, eps, device, stream);
    case 1:
      return launch_resident_act<T, 1>(xi, yo, part, part_m2, mean, rstd,
                                       grid, hw, c, group, ppc, chunks,
                                       slope, eps, device, stream);
    case 2:
      return launch_resident_act<T, 2>(xi, yo, part, part_m2, mean, rstd,
                                       grid, hw, c, group, ppc, chunks,
                                       slope, eps, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16. act: 0 none, 1 relu, 2 leaky_relu. mean and rstd
// are null or (n, c) fp32 outputs; part is a 16-byte aligned workspace of
// 2 * n * c * round_up(chunks, 4) floats. Returns
// cudaErrorCooperativeLaunchTooLarge when the n * (c / group) * chunks CTAs
// cannot all be resident on the device.
extern "C" int ptt_instance_norm_act_resident(const void* x, void* y,
                                              float* mean, float* rstd,
                                              float* part, int n, int hw,
                                              int c, int group, int ppc,
                                              int chunks, int dtype, int act,
                                              float slope, float eps,
                                              int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || part == nullptr ||
      (mean == nullptr) != (rstd == nullptr))
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_resident<float>(x, y, mean, rstd, part, n, hw, c, group,
                                  ppc, chunks, act, slope, eps, device, s);
  if (dtype == 1)
    return launch_resident<__nv_bfloat16>(x, y, mean, rstd, part, n, hw, c,
                                          group, ppc, chunks, act, slope,
                                          eps, device, s);
  return cudaErrorInvalidValue;
}

// A resident CTA's shared-memory budget for its chunk, in bytes.
extern "C" int ptt_instance_norm_resident_bytes() { return kResidentBytes; }
