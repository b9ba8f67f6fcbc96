// Backward pass of the fused InstanceNorm + activation (kernel B1) over NHWC.
//
// The JAX package has no counterpart: its Pallas kernel
// (patch_toon_tpu/ops/pallas_norm.py::instance_norm_act) serves inference
// only, and JAX training differentiates the plain instance_norm
// (patch_toon_tpu/models/layers.py:29-40). This kernel makes the port's B1
// usable under autograd (ops/instance_norm.py::InstanceNormAct).
//
// For each (sample, channel), with the forward pass's fp32 mean and rstd,
// x^ = (x - mean) * rstd and g = dy * act'(x^) (LeakyReLU: 1 where x^ >= 0,
// else slope; ReLU: 1 where x^ > 0, else 0; none: 1), it computes
//   dx = rstd * (g - mean_HW(g) - x^ * mean_HW(g * x^)).
// x^ is recomputed with the forward pass's own arithmetic, so the
// activation's branch is the one the forward pass took.
//
// Bound: bytes. A few operations per element; the least time is one read of
// x and dy and one write of dx. Two variants, as in the forward pass:
//
// Cluster variant (every site of a training step). The unit of work is one
// (sample, group of G channels); a thread-block cluster of k CTAs (k in 1,
// 2, 4, 8) takes one unit, CTA r holding pixels [r*P, r*P + P) of it, P =
// ceil(H*W / k). Each CTA loads its slice of x and of dy into dynamic
// shared memory once, with 16-byte cp.async copies, at most kSliceBytes
// (110 KB) for the two together, so that two CTAs share an SM. One pass
// over shared memory forms per-channel partials of g and g * x^, reduced
// in the block in a fixed order; every CTA adds the k partials of its
// peers through distributed shared memory in rank order 0..k-1, so all k
// CTAs hold bitwise the same sums (one cluster sum, as both come from the
// same pass). A second pass over shared memory writes dx with 16-byte
// stores. x and dy are read from HBM once, dx written once. A CTA leaves
// only after its peers have read its partials (the split cluster barrier).
//
// Streaming variant, for what the cluster variant does not take (C times
// the item size not a multiple of 16 bytes, a pointer not 16-byte aligned,
// a unit larger than 8 CTAs' slices such as a 540x960x128 plane): one block
// per (sample, 32 channels), the 32 lanes of a warp on 32 neighbouring
// channels of one pixel, the 16 warps on every 16th pixel. Pass 1 sums g
// and g * x^ per channel in registers and adds the warps' partials in warp
// order; pass 2 reads x and dy again and writes dx.
//
// Neither variant uses atomics: two runs give bitwise the same dx.
// ops/instance_norm.py::plan_backward picks the variant, G and k; the
// entry points check what they are given again and return an error code,
// never fall back.
#include "b1_common.cuh"

namespace {

using namespace b1;

// ---------------------------------------------------------------- cluster

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads, 2)
instance_norm_act_bwd_cluster_kernel(const T* __restrict__ x,
                                     const T* __restrict__ dy,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ rstd,
                                     T* __restrict__ dx, int hw, int c,
                                     int group, int ppc, float slope) {
  constexpr int kVec = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char slice_raw[];
  __shared__ float warp_part[2][kWarpsC][kMaxGroup];
  __shared__ float part[2][kMaxGroup];  // this CTA's sums, read by peers
  __shared__ float tot[2][kMaxGroup];   // mean(g), mean(g * x^)

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
  uint4* xs_s = reinterpret_cast<uint4*>(slice_raw);
  uint4* dys_s = xs_s + ppc * vpp;
  const size_t off0 = (static_cast<size_t>(n) * hw + p0) * c +
                      static_cast<size_t>(g) * group;
  const T* xs = x + off0;
  const T* ds = dy + off0;
  T* out = dx + off0;

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int p = i >> vshift, v = i & (vpp - 1);
    const size_t o = static_cast<size_t>(p) * c + v * kVec;
    cp_async16(xs_s + i, xs + o);
    cp_async16(dys_s + i, ds + o);
  }

  const int v = threadIdx.x & (vpp - 1);  // the same slot for every i
  const size_t so = static_cast<size_t>(n) * c +
                    static_cast<size_t>(g) * group + v * kVec;
  float m[kVec], r[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {  // while the copies are in flight
    m[e] = mean[so + e];
    r[e] = rstd[so + e];
  }
  cp_async_wait_block();

  // pass 1: per-channel sums of g and g * x^
  float sg[kVec], sgx[kVec], f[kVec], d[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) sg[e] = sgx[e] = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(xs_s[i], f);
    Vec<T>::unpack(dys_s[i], d);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float xh = (f[e] - m[e]) * r[e];
      const float gg = act_grad<kAct>(d[e], xh, slope);
      sg[e] += gg;
      sgx[e] += gg * xh;
    }
  }
  block_channel_sum<kVec>(sg, vpp, group, warp_part[0], part[0]);
  block_channel_sum<kVec>(sgx, vpp, group, warp_part[1], part[1]);
  cluster.sync();
  if (threadIdx.x < 2 * group) {
    const int s = threadIdx.x < group ? 0 : 1;
    const int ch = threadIdx.x - s * group;
    tot[s][ch] = cluster_sum(cluster, part[s], k, ch) /
                 static_cast<float>(hw);
  }
  cluster_arrive();  // no more reads of the peers' shared memory
  __syncthreads();
  float mg[kVec], mgx[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    mg[e] = tot[0][v * kVec + e];
    mgx[e] = tot[1][v * kVec + e];
  }

  // pass 2: dx in x's type, one rounding, 16-byte stores
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    Vec<T>::unpack(xs_s[i], f);
    Vec<T>::unpack(dys_s[i], d);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float xh = (f[e] - m[e]) * r[e];
      const float gg = act_grad<kAct>(d[e], xh, slope);
      f[e] = r[e] * (gg - mg[e] - xh * mgx[e]);
    }
    const int p = i >> vshift;
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * c + v * kVec) =
        Vec<T>::pack(f);
  }
  cluster_wait();  // the peers have read this CTA's partial sums
}

template <typename T, int kAct>
cudaError_t launch_cluster_act(const void* x, const void* dy,
                               const float* mean, const float* rstd, void* dx,
                               int n, int hw, int c, int group, int k,
                               float slope, int device, cudaStream_t stream) {
  const int ppc = (hw + k - 1) / k;
  const size_t smem = 2 * static_cast<size_t>(ppc) * group * sizeof(T);
  const long long grid = static_cast<long long>(n) * (c / group) * k;
  return launch_cluster_kernel(instance_norm_act_bwd_cluster_kernel<T, kAct>,
                               grid, k, smem, device, stream,
                               static_cast<const T*>(x),
                               static_cast<const T*>(dy), mean, rstd,
                               static_cast<T*>(dx), hw, c, group, ppc, slope);
}

template <typename T>
cudaError_t launch_cluster(const void* x, const void* dy, const float* mean,
                           const float* rstd, void* dx, int n, int hw, int c,
                           int group, int k, int act, float slope, int device,
                           cudaStream_t stream) {
  constexpr int kVec = Vec<T>::n;
  if (group <= 0 || group > kMaxGroup || group % kVec != 0 ||
      c % group != 0)
    return cudaErrorInvalidValue;
  const int vpp = group / kVec;
  if ((vpp & (vpp - 1)) != 0) return cudaErrorInvalidValue;
  if (k != 1 && k != 2 && k != 4 && k != 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return cudaErrorMisalignedAddress;
  switch (act) {
    case 0:
      return launch_cluster_act<T, 0>(x, dy, mean, rstd, dx, n, hw, c, group,
                                      k, slope, device, stream);
    case 1:
      return launch_cluster_act<T, 1>(x, dy, mean, rstd, dx, n, hw, c, group,
                                      k, slope, device, stream);
    case 2:
      return launch_cluster_act<T, 2>(x, dy, mean, rstd, dx, n, hw, c, group,
                                      k, slope, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -------------------------------------------------------------- streaming

constexpr int kLanes = 32;  // channels per block
constexpr int kWarps = 16;  // pixel strides per block

template <typename T, int kAct>
__global__ void __launch_bounds__(kLanes * kWarps)
instance_norm_act_bwd_streaming_kernel(const T* __restrict__ x,
                                       const T* __restrict__ dy,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ rstd,
                                       T* __restrict__ dx, int hw, int c,
                                       float slope) {
  __shared__ float red[2][kWarps][kLanes];
  __shared__ float tot[2][kLanes];
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  const bool active = ch < c;
  const size_t base = static_cast<size_t>(blockIdx.x) * hw * c + ch;
  const T* xs = x + base;
  const T* ds = dy + base;
  T* out = dx + base;
  float m = 0.f, r = 0.f;
  if (active) {
    m = mean[static_cast<size_t>(blockIdx.x) * c + ch];
    r = rstd[static_cast<size_t>(blockIdx.x) * c + ch];
  }

  float sg = 0.f, sgx = 0.f;
  if (active) {
#pragma unroll 4
    for (int p = threadIdx.y; p < hw; p += kWarps) {
      const size_t o = static_cast<size_t>(p) * c;
      const float xh = (to_f32(xs[o]) - m) * r;
      const float g = act_grad<kAct>(to_f32(ds[o]), xh, slope);
      sg += g;
      sgx += g * xh;
    }
  }
  red[0][threadIdx.y][threadIdx.x] = sg;
  red[1][threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (threadIdx.y < 2) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[threadIdx.y][w][threadIdx.x];
    tot[threadIdx.y][threadIdx.x] = t;
  }
  __syncthreads();
  if (!active) return;
  const float mg = tot[0][threadIdx.x] / static_cast<float>(hw);
  const float mgx = tot[1][threadIdx.x] / static_cast<float>(hw);

#pragma unroll 4
  for (int p = threadIdx.y; p < hw; p += kWarps) {
    const size_t o = static_cast<size_t>(p) * c;
    const float xh = (to_f32(xs[o]) - m) * r;
    const float g = act_grad<kAct>(to_f32(ds[o]), xh, slope);
    out[o] = from_f32<T>(r * (g - mg - xh * mgx));
  }
}

template <typename T>
cudaError_t launch_streaming(const void* x, const void* dy, const float* mean,
                             const float* rstd, void* dx, int n, int hw,
                             int c, int act, float slope,
                             cudaStream_t stream) {
  const dim3 grid(n, (c + kLanes - 1) / kLanes);
  const dim3 block(kLanes, kWarps);
  const T* xi = static_cast<const T*>(x);
  const T* di = static_cast<const T*>(dy);
  T* o = static_cast<T*>(dx);
  switch (act) {
    case 0:
      instance_norm_act_bwd_streaming_kernel<T, 0><<<grid, block, 0, stream>>>(
          xi, di, mean, rstd, o, hw, c, slope);
      break;
    case 1:
      instance_norm_act_bwd_streaming_kernel<T, 1><<<grid, block, 0, stream>>>(
          xi, di, mean, rstd, o, hw, c, slope);
      break;
    case 2:
      instance_norm_act_bwd_streaming_kernel<T, 2><<<grid, block, 0, stream>>>(
          xi, di, mean, rstd, o, hw, c, slope);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (n, hw, c) NHWC-contiguous in one type (dtype 0 fp32, 1 bf16);
// mean, rstd: (n, c) fp32 from the forward pass. act: 0 none, 1 relu,
// 2 leaky_relu. The cluster variant also takes G (group) and k.
extern "C" int ptt_instance_norm_act_backward_cluster(
    const void* x, const void* dy, const float* mean, const float* rstd,
    void* dx, int n, int hw, int c, int group, int k, int dtype, int act,
    float slope, int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cluster<float>(x, dy, mean, rstd, dx, n, hw, c, group, k,
                                 act, slope, device, s);
  if (dtype == 1)
    return launch_cluster<__nv_bfloat16>(x, dy, mean, rstd, dx, n, hw, c,
                                         group, k, act, slope, device, s);
  return cudaErrorInvalidValue;
}

extern "C" int ptt_instance_norm_act_backward_streaming(
    const void* x, const void* dy, const float* mean, const float* rstd,
    void* dx, int n, int hw, int c, int dtype, int act, float slope,
    int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || (c + kLanes - 1) / kLanes > 65535)
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_streaming<float>(x, dy, mean, rstd, dx, n, hw, c, act,
                                   slope, s);
  if (dtype == 1)
    return launch_streaming<__nv_bfloat16>(x, dy, mean, rstd, dx, n, hw, c,
                                           act, slope, s);
  return cudaErrorInvalidValue;
}
