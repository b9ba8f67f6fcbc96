// w8a8 int8 convolution of the generator's serving path
// (inference.quantize: int8): activation quantization and an implicit-GEMM
// int8 convolution on Hopper's s8 tensor-core products.
//
// Replaces no Pallas kernel: the JAX package runs QuantConv
// (patch_toon_tpu/models/layers.py:165-251) as XLA's conv_general_dilated
// with int8 operands and an int32 accumulator. No PyTorch call convolves
// int8 on the card, and im2col into torch._int_mm would write conv11's
// 7x7x176 windows for every pixel (26.7 GB a 512-tile call), so both steps
// are kernels of their own.
//
// quantize_act_kernel: NHWC bf16 or fp32 in, NHWC int8 out with the
// channels zero-padded to Cp (a multiple of 16), q = clip(rint(x / s),
// -127, 127). Bound by bytes; one thread writes 4 output channels.
//
// conv_s8_kernel: rows are the N*Ho*Wo output pixels, columns Cout, K the
// window (ky, kx, c) with c over Cp. A CTA of 8 warps owns 128 pixels x 64
// channels; each warp 32 x 32 as 2 x 4 mma.sync m16n8k32 s8 tiles with
// int32 accumulators. K runs in steps of 64 bytes, double-buffered in
// shared memory by cp.async: A is gathered from xq one 16-byte vector at a
// time (Cp % 16 == 0, so a vector never straddles two taps; padding and
// pixels past the end are zero-filled, exact as the quantization is
// symmetric), B from the packed (Cout, Kp) weight. Rows of shared memory
// are 80 bytes apart, so the fragment loads of a warp hit 32 banks. Bound
// by operations at every site of the main path (6.80 T int8 operations a
// 512-tile call); this first version uses neither wgmma nor TMA.
//
// Exactness: the accumulator is exact in int32 (|acc| <= 127^2 * 8624 <
// 2^31 at conv11). The epilogue rounds each step on its own as the plain
// version and JAX do: __int2float_rn(acc), __fmul_rn by s * w_s[n]
// (itself __fmul_rn), __float2bfloat16_rn for bf16, then the bias added as
// one fp32 add of the two values in the output type, rounded once.
// __fdiv_rn and rintf (half to even) quantize, never a reciprocal; nvcc
// contracts none of these into an FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kBM = 128;         // output pixels a CTA
constexpr int kBN = 64;          // output channels a CTA
constexpr int kBK = 64;          // bytes of K a stage
constexpr int kPitch = kBK + 16;  // shared-memory row pitch, bytes
constexpr int kThreads = 256;
constexpr int kQuantThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ int8_t quantize1(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                    const float* __restrict__ s, long long pixels, int c,
                    int cp) {
  const int quads = cp / 4;
  const long long i =
      static_cast<long long>(blockIdx.x) * kQuantThreads + threadIdx.x;
  if (i >= pixels * quads) return;
  const long long p = i / quads;
  const int c0 = static_cast<int>(i - p * quads) * 4;
  const float sv = *s;
  const T* src = x + p * c;
  char4 o;
  o.x = c0 < c ? quantize1(load_f(src + c0), sv) : 0;
  o.y = c0 + 1 < c ? quantize1(load_f(src + c0 + 1), sv) : 0;
  o.z = c0 + 2 < c ? quantize1(load_f(src + c0 + 2), sv) : 0;
  o.w = c0 + 3 < c ? quantize1(load_f(src + c0 + 3), sv) : 0;
  *reinterpret_cast<char4*>(xq + p * cp + c0) = o;
}

// kOut: 0 fp32 out, 1 bf16 out, 2 the int32 accumulator (no epilogue)
template <int kOut>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ s, const float* __restrict__ w_s,
               const void* __restrict__ bias, void* __restrict__ out, int n,
               int h, int w, int cp, int cout, int kp, int k, int stride,
               int pad, int ho, int wo) {
  __shared__ __align__(16) int8_t a_s[2][kBM * kPitch];
  __shared__ __align__(16) int8_t b_s[2][kBN * kPitch];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int wm = warp & 3, wn = warp >> 2;
  const long long hw_out = static_cast<long long>(ho) * wo;
  const long long m_total = static_cast<long long>(n) * hw_out;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kdim = k * k * cp;

  // this thread's two A rows (pixels) and its 16-byte column of a stage
  const int col16 = (tid & 3) * 16;
  const int row = tid >> 2;  // and row + 64
  int iy0[2], ix0[2];
  long long base[2];
  bool ok_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + row + i * 64;
    ok_m[i] = m < m_total;
    const long long mm = ok_m[i] ? m : 0;
    const long long img = mm / hw_out;
    const int rem = static_cast<int>(mm - img * hw_out);
    const int oy = rem / wo, ox = rem - (rem / wo) * wo;
    iy0[i] = oy * stride - pad;
    ix0[i] = ox * stride - pad;
    base[i] = img * h * w * static_cast<long long>(cp);
  }
  // this thread's B row (an output channel) and column
  const bool ok_n = n0 + row < cout;
  const int8_t* b_src = wq + static_cast<long long>(ok_n ? n0 + row : 0) * kp;

  auto load_stage = [&](int kt, int buf) {
    const int kk = kt * kBK + col16;
    const bool in_k = kk < kdim;
    const int tap = in_k ? kk / cp : 0;
    const int c = kk - tap * cp;
    const int ky = tap / k, kx = tap - (tap / k) * k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      const bool ok = in_k && ok_m[i] && iy >= 0 && iy < h && ix >= 0 &&
                      ix < w;
      const int8_t* src =
          ok ? xq + base[i] + (static_cast<long long>(iy) * w + ix) * cp + c
             : xq;
      cp_async16(&a_s[buf][(row + i * 64) * kPitch + col16], src, ok);
    }
    const bool ok_b = ok_n && kk < kp;
    cp_async16(&b_s[buf][row * kPitch + col16], ok_b ? b_src + kk : wq,
               ok_b);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int stages = (kdim + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < stages; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < stages) load_stage(kt + 1, buf ^ 1);
    cp_async_commit();  // an empty group on the last stage
    cp_async_wait_one();
    __syncthreads();
    const int8_t* as = a_s[buf];
    const int8_t* bs = b_s[buf];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = as + (wm * 32 + mt * 16 + g) * kPitch + ks + t * 4;
        af[mt][0] = lds32(p);
        af[mt][1] = lds32(p + 8 * kPitch);
        af[mt][2] = lds32(p + 16);
        af[mt][3] = lds32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = bs + (wn * 32 + nt * 8 + g) * kPitch + ks + t * 4;
        bf[nt][0] = lds32(p);
        bf[nt][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // epilogue: rows g and g + 8 of each m16 tile, columns 2t and 2t + 1
  const float sv = *s;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + t * 2;
    if (col >= cout) continue;  // cout is even: col + 1 < cout too
    float sc0 = 0.f, sc1 = 0.f;
    if (kOut != 2) {
      sc0 = __fmul_rn(sv, w_s[col]);
      sc1 = __fmul_rn(sv, w_s[col + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (m >= m_total) continue;
        const int v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        const long long o = m * cout + col;
        if (kOut == 2) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + o) =
              make_int2(v0, v1);
        } else if (kOut == 0) {
          float y0 = __fmul_rn(__int2float_rn(v0), sc0);
          float y1 = __fmul_rn(__int2float_rn(v1), sc1);
          if (bias != nullptr) {
            const float* b = static_cast<const float*>(bias);
            y0 = __fadd_rn(y0, b[col]);
            y1 = __fadd_rn(y1, b[col + 1]);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(y0, y1);
        } else {
          __nv_bfloat16 y0 =
              __float2bfloat16_rn(__fmul_rn(__int2float_rn(v0), sc0));
          __nv_bfloat16 y1 =
              __float2bfloat16_rn(__fmul_rn(__int2float_rn(v1), sc1));
          if (bias != nullptr) {
            const __nv_bfloat16* b =
                static_cast<const __nv_bfloat16*>(bias);
            y0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y0),
                                               __bfloat162float(b[col])));
            y1 = __float2bfloat16_rn(__fadd_rn(
                __bfloat162float(y1), __bfloat162float(b[col + 1])));
          }
          __nv_bfloat162 pair;
          pair.x = y0;
          pair.y = y1;
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + o) = pair;
        }
      }
    }
  }
}

}  // namespace

// x (pixels, c) NHWC, dtype 0 fp32 / 1 bf16; xq (pixels, cp) int8; s one
// fp32 value on the device.
extern "C" int ptt_quantize_act(const void* x, void* xq, const void* s,
                                int pixels, int c, int cp, int dtype,
                                int device, void* stream) {
  if (pixels < 0 || c <= 0 || cp < c || cp % 16 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (pixels == 0) return cudaSuccess;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const long long total = static_cast<long long>(pixels) * (cp / 4);
  const unsigned blocks =
      static_cast<unsigned>((total + kQuantThreads - 1) / kQuantThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quantize_act_kernel<float><<<blocks, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq),
        static_cast<const float*>(s), pixels, c, cp);
  else
    quantize_act_kernel<__nv_bfloat16><<<blocks, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<const float*>(s), pixels, c, cp);
  return cudaGetLastError();
}

// xq (n, h, w, cp) int8; wq (cout, kp) int8 packed as (ky, kx, c), zeros
// past k * k * cp; s one fp32 value; w_s (cout) fp32; bias (cout) in the
// output type or null; out (n, ho, wo, cout): out_dtype 0 fp32, 1 bf16,
// 2 int32 (the accumulator, no scales or bias).
extern "C" int ptt_conv_s8(const void* xq, const void* wq, const void* s,
                           const void* w_s, const void* bias, void* out,
                           int n, int h, int w, int cp, int cout, int kp,
                           int k, int stride, int pad, int ho, int wo,
                           int out_dtype, int device, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cp <= 0 || cp % 16 || cout <= 0 ||
      cout % 2 || k <= 0 || stride <= 0 || pad < 0 || ho <= 0 || wo <= 0 ||
      kp % 32 || kp < k * k * cp || out_dtype < 0 || out_dtype > 2 ||
      (out_dtype == 2 && bias != nullptr))
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const long long m = static_cast<long long>(n) * ho * wo;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  (cout + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* sp = static_cast<const float*>(s);
  const float* ws = static_cast<const float*>(w_s);
  if (out_dtype == 0)
    conv_s8_kernel<0><<<grid, kThreads, 0, st>>>(x8, w8, sp, ws, bias, out,
                                                 n, h, w, cp, cout, kp, k,
                                                 stride, pad, ho, wo);
  else if (out_dtype == 1)
    conv_s8_kernel<1><<<grid, kThreads, 0, st>>>(x8, w8, sp, ws, bias, out,
                                                 n, h, w, cp, cout, kp, k,
                                                 stride, pad, ho, wo);
  else
    conv_s8_kernel<2><<<grid, kThreads, 0, st>>>(x8, w8, sp, ws, bias, out,
                                                 n, h, w, cp, cout, kp, k,
                                                 stride, pad, ho, wo);
  return cudaGetLastError();
}
