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
// x and dy and one write of dx. This first design reads x and dy twice: one
// block per (sample, 32 channels), the 32 lanes of a warp on 32
// neighbouring channels of one pixel, the 16 warps on every 16th pixel.
// Pass 1 sums g and g * x^ per channel in registers; the warps' partials
// are added in warp order in shared memory (a fixed order, no atomics, so
// two runs give bitwise the same dx); pass 2 writes dx in x's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kWarps = 16;  // pixel strides per block

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

// dy times the activation's derivative at x^ (JAX's rules at exactly 0:
// jnp.where(x >= 0, ...) passes 1, nn.relu passes 0).
template <int kAct>
__device__ __forceinline__ float act_grad(float dy, float xh, float slope) {
  if (kAct == 1) return xh > 0.f ? dy : 0.f;
  if (kAct == 2) return xh >= 0.f ? dy : dy * slope;
  return dy;
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kLanes * kWarps)
instance_norm_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             T* __restrict__ dx, int hw, int c, float slope) {
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
cudaError_t launch_bwd(const void* x, const void* dy, const float* mean,
                       const float* rstd, void* dx, int n, int hw, int c,
                       int act, float slope, cudaStream_t stream) {
  const dim3 grid(n, (c + kLanes - 1) / kLanes);
  const dim3 block(kLanes, kWarps);
  const T* xi = static_cast<const T*>(x);
  const T* di = static_cast<const T*>(dy);
  T* o = static_cast<T*>(dx);
  switch (act) {
    case 0:
      instance_norm_act_bwd_kernel<T, 0><<<grid, block, 0, stream>>>(
          xi, di, mean, rstd, o, hw, c, slope);
      break;
    case 1:
      instance_norm_act_bwd_kernel<T, 1><<<grid, block, 0, stream>>>(
          xi, di, mean, rstd, o, hw, c, slope);
      break;
    case 2:
      instance_norm_act_bwd_kernel<T, 2><<<grid, block, 0, stream>>>(
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
// 2 leaky_relu.
extern "C" int ptt_instance_norm_act_backward(const void* x, const void* dy,
                                              const float* mean,
                                              const float* rstd, void* dx,
                                              int n, int hw, int c, int dtype,
                                              int act, float slope,
                                              int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || (c + kLanes - 1) / kLanes > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, dy, mean, rstd, dx, n, hw, c, act, slope, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dy, mean, rstd, dx, n, hw, c, act,
                                     slope, s);
  return cudaErrorInvalidValue;
}
