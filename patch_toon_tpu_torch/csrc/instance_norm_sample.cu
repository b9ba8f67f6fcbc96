// Fused InstanceNorm + activation over NHWC, forward and backward, with a
// whole sample in shared memory: the sample variant of kernel B1.
//
// Replaces patch_toon_tpu/ops/pallas_norm.py::instance_norm_act (its Pallas
// body _kernel) at the shapes the cluster variant (instance_norm.cu) cannot
// cut into whole 16-byte vectors of G channels: C times the item size not a
// multiple of 16 bytes (the discriminator's 6- and 12-channel slices under
// tensor parallelism, odd C), or a pointer that is not 16-byte aligned. It
// computes what the other variants compute: for each (sample, channel) the
// fp32 mean over H*W, the biased variance as the mean of squared deviations
// (two passes, never E[x^2]-E[x]^2), y = (x - mean) / sqrt(var + eps),
// LeakyReLU, ReLU or nothing, and one cast back to the input type. The
// backward kernel takes the forward pass's fp32 mean and rstd and gives
//   dx = rstd * (g - mean_HW(g) - x^ * mean_HW(g * x^)),
// x^ = (x - mean) * rstd, g = dy * act'(x^), as instance_norm_bwd.cu does
// (JAX differentiates patch_toon_tpu/models/layers.py:29-40).
//
// Bound: bytes, one read of x (and dy) and one write of y (dx) at the memory
// rate; at the slices this variant exists for (0.35-0.77 MB) that is under a
// microsecond, so a launch is bound by its latency: the streaming kernels it
// replaces ran one thread a channel (26 of a warp's 32 lanes idle at C = 6),
// read x three times (dx: x and dy twice) in chains of 25 dependent scalar
// loads a thread, and needed dy copied when it was a channel slice.
//
// Design. A sample's NHWC plane is one contiguous run of hw*C elements,
// whatever C is. One CTA takes one sample, or a cluster of k <= 8 CTAs one
// sample that exceeds a CTA's budget (ops/instance_norm.py::sample_plan: the
// least k whose CTA fits kSliceBytes, 110 KB, two CTAs an SM); CTA r holds
// pixels [r*P, r*P + P), P = ceil(H*W / k).
//   1. Every thread of the CTA issues its share of the copies at once: the
//      run's 16-byte blocks by cp.async into shared memory at the same
//      offset mod 16, the partial first and last blocks element by element
//      (any element-aligned pointer). The backward pass reads dy through its
//      pixel stride (the rank's channel slice of a gathered gradient): rows
//      of C elements, copied by cp.async in the widest of 16, 8 or 4 bytes
//      that the pointer, the strides and the row allow.
//   2. Per-channel sums in a fixed map: a warp's lanes take C channels of
//      32 / C sub-stripes (C <= 32; channels l, l + 32, ... of one stripe
//      above), its 8 warps further stripes, so every lane but 32 mod C
//      works at any C and a warp reads consecutive elements; each lane sums
//      its stripe's pixels in order, a warp's sub-stripes are added by
//      shuffles in order, then the 8 warps in order: one block barrier a
//      statistic (reduce_channels). The CTAs of a cluster are added in rank
//      order through distributed shared memory (b1_common.cuh cluster_sum):
//      every CTA gets bitwise the same mean, then the same sum of squared
//      deviations from it (the backward pass: sums of g and g * x^ from one
//      pass). A lone CTA (k = 1) is launched without a cluster and skips
//      the cluster barriers: a cluster launch of one CTA took longer on
//      the card.
//   3. y (dx) is written from shared memory in 16-byte stores where the
//      output's offset mod 16 matches the input's (always for an aligned
//      pair), element by element otherwise. Rank 0 writes the fp32 mean and
//      rstd when they are asked for (autograd).
// One launch, one read, one write; no atomics, so two runs are bitwise
// equal. ops/instance_norm.py::plan and plan_backward pick this variant; the
// entry points check what they are given again and return an error code (a
// CTA beyond its budget, a cluster size not in 1, 2, 4, 8, a misaligned
// element), never fall back.
#include "b1_common.cuh"

namespace {

using namespace b1;

// A CTA of the sample variant: 8 warps (ops/instance_norm.py SAMPLE_WARPS;
// 4 were slower at D's slices on the card).
constexpr int kSampleWarps = 8;
constexpr int kSampleThreads = 32 * kSampleWarps;

// The fixed map of a CTA's threads onto (channel, stripe): warp w, lane l.
// For C <= 32 a warp holds per = 32 / C sub-stripes of C lanes (lane l
// takes channel l % C of sub-stripe l / C; the 32 % C lanes left idle), for
// C > 32 one sub-stripe whose lanes take channels l, l + 32, ...; the CTA
// has S = kSampleWarps * per stripes, stripe s = w * per + l / C taking pixels
// s, s + S, ... (ops/instance_norm.py _subs, _stripe_sums).
__host__ __device__ __forceinline__ int subs_of(int c) {
  return c <= 32 ? 32 / c : 1;
}

__host__ __device__ __forceinline__ size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// A CTA's copy of ppc pixels of x (or dy) in shared memory: the run at its
// global offset mod 16, so up to 15 bytes ahead of it and 15 after.
__host__ __device__ __forceinline__ size_t run_bytes(int ppc, int c,
                                                     int item) {
  return round16(static_cast<size_t>(ppc) * c * item) + 16;
}

// Dynamic shared memory of a CTA (ops/instance_norm.py sample_smem): the run
// of x, then fp32 [warps][c] partials, this CTA's published sums [2][c] and
// the statistics [2][c]; the backward pass adds the rows of dy, a second
// partial array and the forward's mean and rstd [2][c].
__host__ __device__ __forceinline__ size_t forward_smem(int ppc, int c,
                                                        int item) {
  return round16(run_bytes(ppc, c, item) + 4 * (kSampleWarps * c + 4 * c));
}
__host__ __device__ __forceinline__ size_t backward_smem(int ppc, int c,
                                                         int item) {
  return round16(2 * run_bytes(ppc, c, item) +
                 4 * (2 * kSampleWarps * c + 6 * c));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Copy the run of `count` elements at src into shared memory at dst +
// (src mod 16): the 16-byte blocks that lie wholly inside the run by
// cp.async, the partial first and last blocks element by element (nothing
// outside the run is read). Returns the byte offset of element 0 in dst.
template <typename T>
__device__ __forceinline__ int load_run(unsigned char* dst, const T* src,
                                        int count) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int lead = static_cast<int>(a & 15);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(a - lead);
  const int end = lead + count * static_cast<int>(sizeof(T));
  const int blocks = (end + 15) >> 4;
  for (int j = threadIdx.x; j < blocks; j += kSampleThreads) {
    const int b0 = j * 16;
    if (b0 >= lead && b0 + 16 <= end) {
      cp_async16(dst + b0, base + b0);
    } else {
      for (int o = max(b0, lead); o < min(b0 + 16, end);
           o += static_cast<int>(sizeof(T)))
        *reinterpret_cast<T*>(dst + o) = *reinterpret_cast<const T*>(base + o);
    }
  }
  return lead;
}

// Copy `rows` rows of c elements, row r at src + r * stride elements, into
// shared memory at dst as a dense [rows][c] array, in pieces of w bytes (16,
// 8 or 4 by cp.async; w = sizeof(T) element by element). w divides src's
// address, the stride's bytes and a row's bytes (the host's row_width).
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src,
                                          int rows, int c, long long stride,
                                          int w) {
  const int row = c * static_cast<int>(sizeof(T));
  const int per = row / w;
  const int total = rows * per;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  const long long sb = stride * static_cast<long long>(sizeof(T));
  for (int i = threadIdx.x; i < total; i += kSampleThreads) {
    const int r = i / per, o = (i - r * per) * w;
    const unsigned char* g = s + r * sb + o;
    unsigned char* d = dst + r * row + o;
    if (w == 16)
      cp_async16(d, g);
    else if (w == 8)
      cp_async8(d, g);
    else if (w == 4)
      cp_async4(d, g);
    else
      *reinterpret_cast<T*>(d) = *reinterpret_cast<const T*>(g);
  }
}

// Per-channel sums over the CTA's pixels in the fixed map above, of kN
// quantities: each lane sums the contributions f(element, channel, v) of
// its stripe's pixels in pixel order, eight pixels' loads in flight at a
// time (one at a time was slower at D's slices on the card); lane ch
// (< C) of each warp adds its warp's
// sub-stripes 1, 2, ... in order by shuffles; then the warps' sums are
// added in warp order and, in a cluster of k > 1 CTAs, the CTAs' in rank
// order through distributed shared memory (b1_common.cuh cluster_sum), so
// that every CTA holds bitwise the same sums: out[q * c + ch] = g(sum).
// part holds [kN][warps][c] floats, pub kN * c (this CTA's sums, read by
// its peers). Ends with a block barrier.
template <int kN, typename F, typename G>
__device__ __forceinline__ void reduce_channels(cg::cluster_group& cluster,
                                                int k, int np, int c,
                                                float* part, float* pub,
                                                float* out, F f, G g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = subs_of(c);
  const int stripes = kSampleWarps * per;
  const int sub = c <= 32 ? lane / c : 0;
  for (int cb = 0; cb < c; cb += 32) {
    const int ch = c <= 32 ? lane % c : cb + lane;
    float a[kN];
#pragma unroll
    for (int q = 0; q < kN; ++q) a[q] = 0.f;
    if (sub < per && ch < c) {
      // kBatch pixels' contributions in flight, added in pixel order
      constexpr int kBatch = 8;
      int p = warp * per + sub;
      for (; p + (kBatch - 1) * stripes < np; p += kBatch * stripes) {
        float v[kBatch][kN];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          f((p + u * stripes) * c + ch, ch, v[u]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int q = 0; q < kN; ++q) a[q] += v[u][q];
      }
      for (; p < np; p += stripes) {
        float v[kN];
        f(p * c + ch, ch, v);
#pragma unroll
        for (int q = 0; q < kN; ++q) a[q] += v[q];
      }
    }
    // lanes ch + j * c, j = 1 .. per - 1, into lane ch, in order
    for (int j = 1; j < per; ++j) {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const float v = __shfl_sync(0xffffffffu, a[q], lane + j * c);
        if (lane < c) a[q] += v;
      }
    }
    if (sub == 0 && ch < c) {
#pragma unroll
      for (int q = 0; q < kN; ++q)
        part[(q * kSampleWarps + warp) * c + ch] = a[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kN * c; i += kSampleThreads) {
    const int q = i / c, ch = i - q * c;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSampleWarps; ++w)
      t += part[(q * kSampleWarps + w) * c + ch];
    if (k == 1)
      out[i] = g(t);
    else
      pub[i] = t;
  }
  if (k > 1) {
    cluster.sync();
    for (int i = threadIdx.x; i < kN * c; i += kSampleThreads)
      out[i] = g(cluster_sum(cluster, pub, k, i));
  }
  __syncthreads();
}

// Write out[0, count) = f(element i, its channel i mod c) from shared
// memory: in 16-byte stores where out's offset mod 16 equals `lead`, the
// offset of element 0 in `run` (the 16-byte blocks of both then line up),
// else element by element. f takes the element's index, its fp32 value from
// `run` and its channel.
template <typename T, typename F>
__device__ __forceinline__ void store_run(T* out, const unsigned char* run,
                                          int lead, int count, int c, F f) {
  constexpr int kVec = Vec<T>::n;
  const T* xs = reinterpret_cast<const T*>(run + lead);
  const int olead =
      static_cast<int>(reinterpret_cast<uintptr_t>(out) & 15);
  if (olead != lead) {
    for (int i = threadIdx.x; i < count; i += kSampleThreads)
      out[i] = from_f32<T>(f(i, to_f32(xs[i]), i % c));
    return;
  }
  unsigned char* base = reinterpret_cast<unsigned char*>(out) - lead;
  const int end = lead + count * static_cast<int>(sizeof(T));
  const int blocks = (end + 15) >> 4;
  for (int j = threadIdx.x; j < blocks; j += kSampleThreads) {
    const int b0 = j * 16;
    if (b0 >= lead && b0 + 16 <= end) {
      const int i0 = (b0 - lead) / static_cast<int>(sizeof(T));
      float v[kVec];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(run + b0), v);
      int ch = i0 % c;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[e] = f(i0 + e, v[e], ch);
        if (++ch == c) ch = 0;
      }
      *reinterpret_cast<uint4*>(base + b0) = Vec<T>::pack(v);
    } else {
      for (int o = max(b0, lead); o < min(b0 + 16, end);
           o += static_cast<int>(sizeof(T))) {
        const int i = (o - lead) / static_cast<int>(sizeof(T));
        out[i] = from_f32<T>(f(i, to_f32(xs[i]), i % c));
      }
    }
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int kAct>
__global__ void __launch_bounds__(kSampleThreads, 2)
instance_norm_act_sample_kernel(const T* __restrict__ x, T* __restrict__ y,
                                float* __restrict__ mean_out,
                                float* __restrict__ rstd_out, int hw, int c,
                                int ppc, float slope, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / k;
  const int p0 = rank * ppc;
  const int np = max(0, min(ppc, hw - p0));
  const int count = np * c;
  float* part = reinterpret_cast<float*>(smem + run_bytes(ppc, c, sizeof(T)));
  float* pub = part + kSampleWarps * c;  // [2][c]: this CTA's sums
  float* stat = pub + 2 * c;             // [2][c]: mean, rstd
  const size_t e0 = (static_cast<size_t>(n) * hw + p0) * c;

  const int lead = load_run(smem, x + e0, count);
  cp_async_wait_block();
  const T* xs = reinterpret_cast<const T*>(smem + lead);

  // pass 1: mean
  const float fhw = static_cast<float>(hw);
  reduce_channels<1>(
      cluster, k, np, c, part, pub, stat,
      [&](int e, int, float* v) { v[0] = to_f32(xs[e]); },
      [&](float t) { return t / fhw; });
  // pass 2: biased variance from squared deviations, then rstd
  reduce_channels<1>(
      cluster, k, np, c, part, pub + c, stat + c,
      [&](int e, int ch, float* v) {
        const float d = to_f32(xs[e]) - stat[ch];
        v[0] = d * d;
      },
      [&](float t) { return 1.0f / sqrtf(t / fhw + eps); });
  if (k > 1) cluster_arrive();  // no more reads of the peers' memory
  if (mean_out != nullptr && rank == 0) {  // for the backward pass
    for (int ch = threadIdx.x; ch < c; ch += kSampleThreads) {
      const size_t o = static_cast<size_t>(n) * c + ch;
      mean_out[o] = stat[ch];
      rstd_out[o] = stat[c + ch];
    }
  }

  // normalize, activate, one rounding
  const float* mean = stat;
  const float* rstd = stat + c;
  store_run(y + e0, smem, lead, count, c,
            [&](int, float v, int ch) {
              return activate<kAct>((v - mean[ch]) * rstd[ch], slope);
            });
  if (k > 1) cluster_wait();  // the peers have read this CTA's sums
}

// --------------------------------------------------------------- backward

// dy_w: 0 when dy is NHWC-contiguous (its run copied as x's), else the
// bytes a cp.async of its rows takes (load_rows).
template <typename T, int kAct>
__global__ void __launch_bounds__(kSampleThreads, 2)
instance_norm_act_bwd_sample_kernel(const T* __restrict__ x,
                                    const T* __restrict__ dy,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ rstd,
                                    T* __restrict__ dx, int hw, int c,
                                    int ppc, long long dy_pixel,
                                    long long dy_sample, int dy_w,
                                    float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / k;
  const int p0 = rank * ppc;
  const int np = max(0, min(ppc, hw - p0));
  const int count = np * c;
  const size_t run = run_bytes(ppc, c, sizeof(T));
  unsigned char* dy_s = smem + run;
  float* part = reinterpret_cast<float*>(smem + 2 * run);  // [2][warps][c]
  float* pub = part + 2 * kSampleWarps * c;  // [2][c]: this CTA's sums
  float* tot = pub + 2 * c;  // [2][c]: mean(g), mean(g * x^)
  float* mr = tot + 2 * c;   // [2][c]: the forward's mean, rstd
  const size_t e0 = (static_cast<size_t>(n) * hw + p0) * c;
  const T* dys = dy + static_cast<long long>(n) * dy_sample +
                 static_cast<long long>(p0) * dy_pixel;

  const int lead = load_run(smem, x + e0, count);
  int dlead = 0;
  if (dy_w == 0)
    dlead = load_run(dy_s, dys, count);
  else
    load_rows(dy_s, dys, np, c, dy_pixel, dy_w);
  for (int ch = threadIdx.x; ch < c; ch += kSampleThreads) {
    mr[ch] = mean[static_cast<size_t>(n) * c + ch];
    mr[c + ch] = rstd[static_cast<size_t>(n) * c + ch];
  }
  cp_async_wait_block();
  const T* xs = reinterpret_cast<const T*>(smem + lead);
  const T* ds = reinterpret_cast<const T*>(dy_s + dlead);

  // one pass: per-channel means over H*W of g and g * x^
  const float fhw = static_cast<float>(hw);
  reduce_channels<2>(
      cluster, k, np, c, part, pub, tot,
      [&](int e, int ch, float* v) {
        const float xh = (to_f32(xs[e]) - mr[ch]) * mr[c + ch];
        const float g = act_grad<kAct>(to_f32(ds[e]), xh, slope);
        v[0] = g;
        v[1] = g * xh;
      },
      [&](float t) { return t / fhw; });
  if (k > 1) cluster_arrive();  // no more reads of the peers' memory

  // dx in x's type, one rounding
  store_run(dx + e0, smem, lead, count, c,
            [&](int i, float v, int ch) {
              const float r = mr[c + ch];
              const float xh = (v - mr[ch]) * r;
              const float g = act_grad<kAct>(to_f32(ds[i]), xh, slope);
              return r * (g - tot[ch] - xh * tot[c + ch]);
            });
  if (k > 1) cluster_wait();  // the peers have read this CTA's sums
}

// ------------------------------------------------------------------- host

bool valid_k(int k) { return k == 1 || k == 2 || k == 4 || k == 8; }

// A cluster launch of k CTAs a sample (b1_common.cuh
// launch_cluster_kernel_of), or for k = 1 a plain launch, whose CTA the
// kernel treats as a cluster of one (a cluster launch of one CTA took
// longer on the card). Either way `smem` at most kSliceBytes.
template <typename... Params, typename... Args>
cudaError_t launch_sample_kernel(void (*kernel)(Params...), long long grid,
                                 int k, size_t smem, int device,
                                 cudaStream_t stream, Args... args) {
  if (k != 1)
    return launch_cluster_kernel_of(kSampleThreads, kernel, grid, k, smem,
                                    device, stream, args...);
  if (smem > static_cast<size_t>(kSliceBytes) || grid <= 0 ||
      grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  static std::mutex mu;
  static std::set<std::tuple<int, const void*>> ready;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(device,
                                     reinterpret_cast<const void*>(kernel));
    if (!ready.count(key)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSliceBytes);
      if (err != cudaSuccess) return err;
      ready.insert(key);
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kSampleThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The widest of 16, 8 and 4 bytes that divides dy's address, its pixel and
// sample strides in bytes and a row of c elements; sizeof(T) where none
// does (bf16 at an odd element).
int row_width(const void* dy, long long pixel, long long sample, int c,
              int item) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dy);
  for (int w = 16; w >= 4; w >>= 1)
    if (a % w == 0 && (pixel * item) % w == 0 && (sample * item) % w == 0 &&
        (static_cast<long long>(c) * item) % w == 0)
      return w;
  return item;
}

template <typename T, int kAct>
cudaError_t launch_forward_act(const void* x, void* y, float* mean,
                               float* rstd, int n, int hw, int c, int k,
                               float slope, float eps, int device,
                               cudaStream_t stream) {
  const int ppc = (hw + k - 1) / k;
  const size_t smem = forward_smem(ppc, c, sizeof(T));
  const long long grid = static_cast<long long>(n) * k;
  return launch_sample_kernel(instance_norm_act_sample_kernel<T, kAct>, grid,
                              k, smem, device, stream,
                              static_cast<const T*>(x), static_cast<T*>(y),
                              mean, rstd, hw, c, ppc, slope, eps);
}

template <typename T>
cudaError_t launch_forward(const void* x, void* y, float* mean, float* rstd,
                           int n, int hw, int c, int k, int act, float slope,
                           float eps, int device, cudaStream_t stream) {
  if (!valid_k(k)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
      sizeof(T))
    return cudaErrorMisalignedAddress;
  switch (act) {
    case 0:
      return launch_forward_act<T, 0>(x, y, mean, rstd, n, hw, c, k, slope,
                                      eps, device, stream);
    case 1:
      return launch_forward_act<T, 1>(x, y, mean, rstd, n, hw, c, k, slope,
                                      eps, device, stream);
    case 2:
      return launch_forward_act<T, 2>(x, y, mean, rstd, n, hw, c, k, slope,
                                      eps, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int kAct>
cudaError_t launch_backward_act(const void* x, const void* dy,
                                const float* mean, const float* rstd,
                                void* dx, int n, int hw, int c,
                                long long dy_pixel, long long dy_sample,
                                int k, float slope, int device,
                                cudaStream_t stream) {
  const int ppc = (hw + k - 1) / k;
  const size_t smem = backward_smem(ppc, c, sizeof(T));
  const long long grid = static_cast<long long>(n) * k;
  const bool dense = dy_pixel == c &&
                     dy_sample == static_cast<long long>(hw) * c;
  const int w = dense ? 0 : row_width(dy, dy_pixel, dy_sample, c, sizeof(T));
  return launch_sample_kernel(
      instance_norm_act_bwd_sample_kernel<T, kAct>, grid, k, smem, device,
      stream, static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd,
      static_cast<T*>(dx), hw, c, ppc, dy_pixel, dy_sample, w, slope);
}

template <typename T>
cudaError_t launch_backward(const void* x, const void* dy, const float* mean,
                            const float* rstd, void* dx, int n, int hw, int c,
                            long long dy_pixel, long long dy_sample, int k,
                            int act, float slope, int device,
                            cudaStream_t stream) {
  if (!valid_k(k) || dy_pixel < c || dy_sample < 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx)) % sizeof(T))
    return cudaErrorMisalignedAddress;
  switch (act) {
    case 0:
      return launch_backward_act<T, 0>(x, dy, mean, rstd, dx, n, hw, c,
                                       dy_pixel, dy_sample, k, slope, device,
                                       stream);
    case 1:
      return launch_backward_act<T, 1>(x, dy, mean, rstd, dx, n, hw, c,
                                       dy_pixel, dy_sample, k, slope, device,
                                       stream);
    case 2:
      return launch_backward_act<T, 2>(x, dy, mean, rstd, dx, n, hw, c,
                                       dy_pixel, dy_sample, k, slope, device,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (n, hw, c) NHWC-contiguous, element-aligned; dtype 0 fp32, 1 bf16;
// act 0 none, 1 relu, 2 leaky_relu; k CTAs a sample (a cluster); mean and
// rstd (n, c) fp32 outputs for the backward pass, or both null.
extern "C" int ptt_instance_norm_act_sample(const void* x, void* y,
                                            float* mean, float* rstd, int n,
                                            int hw, int c, int k, int dtype,
                                            int act, float slope, float eps,
                                            int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0) return cudaErrorInvalidValue;
  if ((mean == nullptr) != (rstd == nullptr)) return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_forward<float>(x, y, mean, rstd, n, hw, c, k, act, slope,
                                 eps, device, s);
  if (dtype == 1)
    return launch_forward<__nv_bfloat16>(x, y, mean, rstd, n, hw, c, k, act,
                                         slope, eps, device, s);
  return cudaErrorInvalidValue;
}

// x, dx: (n, hw, c) NHWC-contiguous; dy: rows of c contiguous elements,
// pixel p of sample i at dy + i * dy_sample + p * dy_pixel (elements);
// mean, rstd: (n, c) fp32 from the forward pass.
extern "C" int ptt_instance_norm_act_backward_sample(
    const void* x, const void* dy, const float* mean, const float* rstd,
    void* dx, int n, int hw, int c, long long dy_pixel, long long dy_sample,
    int k, int dtype, int act, float slope, int device, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || mean == nullptr || rstd == nullptr)
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_backward<float>(x, dy, mean, rstd, dx, n, hw, c, dy_pixel,
                                  dy_sample, k, act, slope, device, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(x, dy, mean, rstd, dx, n, hw, c,
                                          dy_pixel, dy_sample, k, act, slope,
                                          device, s);
  return cudaErrorInvalidValue;
}

// A sample variant's CTA budget and its shared memory for ppc pixels of c
// channels of `item` bytes (backward: x and dy), for the wrapper to check
// its own copy of the layout against.
extern "C" int ptt_instance_norm_sample_smem(int ppc, int c, int item,
                                             int backward) {
  return static_cast<int>(backward ? backward_smem(ppc, c, item)
                                   : forward_smem(ppc, c, item));
}
