// Fused InstanceNorm + activation over NHWC, fp32 statistics (kernel B1).
//
// Replaces patch_toon_tpu/ops/pallas_norm.py::instance_norm_act (its Pallas
// body _kernel). For each (sample, channel): mean over H*W, then the biased
// variance as the mean of squared deviations (two passes, not
// E[x^2]-E[x]^2), then y = (x - mean) / sqrt(var + eps), LeakyReLU, ReLU or
// nothing, and one cast back to the input type. fp32 and bf16 in and out.
//
// Bound: bytes. The work is a few operations per element, far below the
// card's operations-per-byte balance, so the least time is one read and one
// write of the tensor at the memory rate. The TPU kernel kept a whole
// sample in VMEM and read it once; a Hopper SM cannot hold one (80*80*32
// fp32 is 800 KB against 227 KB of shared memory). Two variants:
//
// Cluster variant (the main path). The unit of work is one (sample, group
// of G channels). A thread-block cluster of k CTAs (k in 1, 2, 4, 8) takes
// one unit; CTA r holds pixels [r*P, r*P + P) of it, P = ceil(H*W / k),
// in dynamic shared memory, loaded once with 16-byte cp.async copies and
// at most kSliceBytes (110 KB) a CTA, so that two CTAs share an SM and one
// CTA's loads overlap another's stores. Each pass reads shared memory
// only: per-channel partial sums are reduced in the block, published in
// shared memory, and every CTA of the cluster adds the k partials of its
// peers through distributed shared memory in rank order 0..k-1, so all k
// CTAs get a bitwise identical mean, then likewise the sum of squared
// deviations. The third pass normalizes from shared memory and writes with
// 16-byte stores. Each element is read from and written to HBM once. A
// CTA leaves only after its peers have read its partial sums (the split
// cluster barrier at the end).
//
// Streaming variant, for what neither the cluster variant nor the split
// variant (instance_norm_split.cu: a unit larger than 8 CTAs' slices, such
// as a full frame's plane) takes: C times the item size not a multiple of
// 16 bytes, or a pointer not 16-byte aligned. One block per (sample, 32
// channels) reads the input three times (mean, variance, normalize); the
// 32 lanes of a warp take 32 neighbouring channels of one pixel, the 16
// warps every 16th pixel.
//
// Under autograd both variants also write the per-(sample, channel) fp32
// mean and rstd that the backward kernel (instance_norm_bwd.cu) reads; the
// cluster variant writes them from rank 0 of each cluster.
//
// ops/instance_norm.py::plan picks the variant, G and k; the entry points
// check what they are given again and return an error code, never fall
// back.
#include "b1_common.cuh"

namespace {

using namespace b1;

// ---------------------------------------------------------------- cluster

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads, 2)
instance_norm_act_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 float* __restrict__ mean_out,
                                 float* __restrict__ rstd_out, int hw, int c,
                                 int group, int ppc, float slope, float eps) {
  constexpr int kVec = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char slice_raw[];
  uint4* slice = reinterpret_cast<uint4*>(slice_raw);
  __shared__ float warp_part[kWarpsC][kMaxGroup];
  __shared__ float part[2][kMaxGroup];  // this CTA's sums, read by peers
  __shared__ float stat[2][kMaxGroup];  // mean, rstd

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int unit = blockIdx.x / k;
  const int groups = c / group;
  const int n = unit / groups, g = unit - n * groups;
  const int p0 = rank * ppc;
  const int np = max(0, min(ppc, hw - p0));
  const int vpp = group / kVec;  // 16-byte vectors a pixel, divides 32
  const int vshift = __ffs(vpp) - 1;
  const int nvec = np * vpp;
  const size_t off0 = (static_cast<size_t>(n) * hw + p0) * c +
                      static_cast<size_t>(g) * group;
  const T* xs = x + off0;
  T* ys = y + off0;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int p = i >> vshift, v = i & (vpp - 1);
    cp_async16(slice + i, xs + static_cast<size_t>(p) * c + v * kVec);
  }
  cp_async_wait_block();

  const int v = threadIdx.x & (vpp - 1);  // the same slot for every i
  float acc[kVec], f[kVec], mean[kVec], rstd[kVec];

  // pass 1: mean
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(slice[i], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += f[e];
  }
  block_channel_sum<kVec>(acc, vpp, group, warp_part, part[0]);
  cluster.sync();
  if (threadIdx.x < group)
    stat[0][threadIdx.x] =
        cluster_sum(cluster, part[0], k, threadIdx.x) /
        static_cast<float>(hw);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kVec; ++e) mean[e] = stat[0][v * kVec + e];

  // pass 2: biased variance from squared deviations
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(slice[i], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float d = f[e] - mean[e];
      acc[e] += d * d;
    }
  }
  block_channel_sum<kVec>(acc, vpp, group, warp_part, part[1]);
  cluster.sync();
  if (threadIdx.x < group) {
    const float var =
        cluster_sum(cluster, part[1], k, threadIdx.x) /
        static_cast<float>(hw);
    const float r = 1.0f / sqrtf(var + eps);
    stat[1][threadIdx.x] = r;
    if (mean_out != nullptr && rank == 0) {  // for the backward pass
      const size_t o = static_cast<size_t>(n) * c +
                       static_cast<size_t>(g) * group + threadIdx.x;
      mean_out[o] = stat[0][threadIdx.x];
      rstd_out[o] = r;
    }
  }
  cluster_arrive();  // no more reads of the peers' shared memory
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kVec; ++e) rstd[e] = stat[1][v * kVec + e];

  // pass 3: normalize, activate, one rounding, 16-byte stores
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(slice[i], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      f[e] = activate<kAct>((f[e] - mean[e]) * rstd[e], slope);
    const int p = i >> vshift;
    *reinterpret_cast<uint4*>(ys + static_cast<size_t>(p) * c + v * kVec) =
        Vec<T>::pack(f);
  }
  cluster_wait();  // the peers have read this CTA's partial sums
}

template <typename T, int kAct>
cudaError_t launch_cluster_act(const void* x, void* y, float* mean,
                               float* rstd, int n, int hw, int c, int group,
                               int k, float slope, float eps, int device,
                               cudaStream_t stream) {
  const int ppc = (hw + k - 1) / k;
  const size_t smem = static_cast<size_t>(ppc) * group * sizeof(T);
  const long long grid = static_cast<long long>(n) * (c / group) * k;
  return launch_cluster_kernel(instance_norm_act_cluster_kernel<T, kAct>,
                               grid, k, smem, device, stream,
                               static_cast<const T*>(x), static_cast<T*>(y),
                               mean, rstd, hw, c, group, ppc, slope, eps);
}

template <typename T>
cudaError_t launch_cluster(const void* x, void* y, float* mean, float* rstd,
                           int n, int hw, int c, int group, int k, int act,
                           float slope, float eps, int device,
                           cudaStream_t stream) {
  constexpr int kVec = Vec<T>::n;
  if (group <= 0 || group > kMaxGroup || group % kVec != 0 ||
      c % group != 0)
    return cudaErrorInvalidValue;
  const int vpp = group / kVec;
  if ((vpp & (vpp - 1)) != 0) return cudaErrorInvalidValue;
  if (k != 1 && k != 2 && k != 4 && k != 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorMisalignedAddress;
  switch (act) {
    case 0:
      return launch_cluster_act<T, 0>(x, y, mean, rstd, n, hw, c, group, k,
                                      slope, eps, device, stream);
    case 1:
      return launch_cluster_act<T, 1>(x, y, mean, rstd, n, hw, c, group, k,
                                      slope, eps, device, stream);
    case 2:
      return launch_cluster_act<T, 2>(x, y, mean, rstd, n, hw, c, group, k,
                                      slope, eps, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -------------------------------------------------------------- streaming

constexpr int kLanes = 32;  // channels per block
constexpr int kWarps = 16;  // pixel strides per block

// Sum of the kWarps partials of each lane; every thread gets its lane's sum.
__device__ __forceinline__ float block_lane_sum(float v,
                                                float (*red)[kLanes],
                                                float* out) {
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
  return out[threadIdx.x];
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kLanes * kWarps)
instance_norm_act_streaming_kernel(const T* __restrict__ x,
                                   T* __restrict__ y,
                                   float* __restrict__ mean_out,
                                   float* __restrict__ rstd_out, int hw, int c,
                                   float slope, float eps) {
  __shared__ float red[kWarps][kLanes];
  __shared__ float sum_s[kLanes];
  __shared__ float sq_s[kLanes];
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw * c + ch;
  const T* xs = x + base;
  T* ys = y + base;

  float s = 0.f;
  if (active) {
#pragma unroll 4
    for (int p = threadIdx.y; p < hw; p += kWarps)
      s += to_f32(xs[static_cast<size_t>(p) * c]);
  }
  const float mean = block_lane_sum(s, red, sum_s) / static_cast<float>(hw);

  float q = 0.f;
  if (active) {
#pragma unroll 4
    for (int p = threadIdx.y; p < hw; p += kWarps) {
      const float d = to_f32(xs[static_cast<size_t>(p) * c]) - mean;
      q += d * d;
    }
  }
  const float var = block_lane_sum(q, red, sq_s) / static_cast<float>(hw);
  const float rstd = 1.0f / sqrtf(var + eps);
  if (mean_out != nullptr && active && threadIdx.y == 0) {
    const size_t o = static_cast<size_t>(blockIdx.x) * c + ch;
    mean_out[o] = mean;
    rstd_out[o] = rstd;
  }

  if (!active) return;
#pragma unroll 4
  for (int p = threadIdx.y; p < hw; p += kWarps) {
    const size_t o = static_cast<size_t>(p) * c;
    ys[o] = from_f32<T>(activate<kAct>((to_f32(xs[o]) - mean) * rstd, slope));
  }
}

template <typename T>
cudaError_t launch_streaming(const void* x, void* y, float* mean, float* rstd,
                             int n, int hw, int c, int act, float slope,
                             float eps, cudaStream_t stream) {
  const dim3 grid(n, (c + kLanes - 1) / kLanes);
  const dim3 block(kLanes, kWarps);
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (act) {
    case 0:
      instance_norm_act_streaming_kernel<T, 0><<<grid, block, 0, stream>>>(
          xi, yo, mean, rstd, hw, c, slope, eps);
      break;
    case 1:
      instance_norm_act_streaming_kernel<T, 1><<<grid, block, 0, stream>>>(
          xi, yo, mean, rstd, hw, c, slope, eps);
      break;
    case 2:
      instance_norm_act_streaming_kernel<T, 2><<<grid, block, 0, stream>>>(
          xi, yo, mean, rstd, hw, c, slope, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16. act: 0 none, 1 relu, 2 leaky_relu. mean and rstd
// are (n, c) fp32 outputs for the backward pass, or both null.
extern "C" int ptt_instance_norm_act_cluster(const void* x, void* y,
                                             float* mean, float* rstd, int n,
                                             int hw, int c, int group, int k,
                                             int dtype, int act, float slope,
                                             float eps, int device,
                                             void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0) return cudaErrorInvalidValue;
  if ((mean == nullptr) != (rstd == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cluster<float>(x, y, mean, rstd, n, hw, c, group, k, act,
                                 slope, eps, device, s);
  if (dtype == 1)
    return launch_cluster<__nv_bfloat16>(x, y, mean, rstd, n, hw, c, group, k,
                                         act, slope, eps, device, s);
  return cudaErrorInvalidValue;
}

extern "C" int ptt_instance_norm_act_streaming(const void* x, void* y,
                                               float* mean, float* rstd, int n,
                                               int hw, int c, int dtype,
                                               int act, float slope,
                                               float eps, int device,
                                               void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0) return cudaErrorInvalidValue;
  if ((mean == nullptr) != (rstd == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_streaming<float>(x, y, mean, rstd, n, hw, c, act, slope, eps,
                                   s);
  if (dtype == 1)
    return launch_streaming<__nv_bfloat16>(x, y, mean, rstd, n, hw, c, act,
                                           slope, eps, s);
  return cudaErrorInvalidValue;
}

// The cluster variant's shared-memory budget a CTA, for the wrapper to
// check its own copy against.
extern "C" int ptt_instance_norm_slice_bytes() { return kSliceBytes; }
