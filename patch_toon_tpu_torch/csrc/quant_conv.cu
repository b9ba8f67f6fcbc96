// w8a8 int8 convolution of the generator's serving path
// (inference.quantize: int8): activation quantization and an implicit-GEMM
// int8 convolution on Hopper's s8 warpgroup products.
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
// conv_s8: rows are the N*Ho*Wo output pixels, columns Cout, K the window
// (ky, kx, c) with c over Cp. Bound by operations at every site of the
// main path (6.80 T int8 operations a 512-tile call, 3.68 ms at the card's
// 1,979 TOPS). Two kernels share the design below; conv_plan (at the end,
// through ptt_conv_s8_plan) picks one a layer and sizes its launch.
// - wgmma.mma_async m64nNk32 .s32.s8.s8 with A and B from shared memory,
//   both K-major in the 128-byte-swizzled layout (row r at r * 128 bytes,
//   its 16-byte chunk j at chunk j ^ (r & 7)). N covers Cout in one tile
//   up to 128, so each A byte is loaded once; rows of B past Cout are
//   zero-filled by TMA and never stored.
// - Warp specialization over mbarrier rings: consumer warpgroups 0 and 1
//   multiply the stages that have arrived (wgmma.wait_group 1: one stage's
//   products in flight while the next is issued) and free them; producer
//   warpgroup 2 keeps the ring full. B, the packed (Cout, Kp) weight, comes
//   by TMA from a 2-D tensor map (the encoder is reached through
//   cudaGetDriverEntryPoint: nothing links libcuda).
// - A persistent grid, one CTA an SM of the kernel's own card, walking
//   tiles: the producer loads the next tile while the consumers run this
//   one's epilogue.
// - The epilogue is staged in shared memory and written along the
//   contiguous NHWC rows with 16-byte stores.
// conv_s8_kernel (the gather kernel, every other layer): 128 output
// pixels x N (16, 32, 64 or 128; Cout past 128 in several tiles) a tile,
// 2-6 stages of 128 bytes of K. The producer gathers A with cp.async,
// 16-byte vectors into the swizzled layout (Cp % 16 == 0, so a vector never
// straddles two taps; padding taps, K past the window and pixels past the
// end are zero-filled, exact as the quantization is symmetric); a thread
// keeps one 16-byte column of K for 8 rows, and its tap and channel
// advance by additions. Each producer thread arrives on the stage's full
// barrier when its copies land (cp.async.mbarrier.arrive), and each
// consumer fences the async proxy before reading them. Where the whole
// weight fits beside the A stages it is loaded once a CTA and stays
// resident (the stem, both downsamples, the smoothers).
// conv_s8_halo_kernel (stride-1 windows of Cout 33-64: conv11 and the
// smoothers): see its section; the input patch of a 16 x 16 tile is loaded
// once a chunk of channels instead of once a tap, and conv11 runs in about
// half the gather kernel's time (tools/conv_s8_plans_torch.py times both). A
// variant that loaded A by TMA's im2col mode was no better than the
// gather at most sites and is not kept (PERF.md).
// A full or empty barrier that does not complete within about 20 s of the
// SM clock traps: a launch that would hang fails instead.
//
// Exactness: the accumulator is exact in int32 in any order of K (|acc| <=
// 127^2 * 8624 < 2^31 at conv11). The epilogue rounds each step on its own
// as the plain version and JAX do: __int2float_rn(acc), __fmul_rn by
// s * w_s[n] (itself __fmul_rn), __float2bfloat16_rn for bf16, then the
// bias added as one fp32 add of the two values in the output type, rounded
// once. __fdiv_rn and rintf (half to even) quantize, never a reciprocal;
// nvcc contracts none of these into an FMA.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kQuantThreads = 256;

constexpr int kBM = 128;            // output pixels a tile
constexpr int kBK = 128;            // bytes of K a stage: one swizzle row
constexpr int kAStage = kBM * kBK;  // bytes of A a stage
constexpr int kThreads = 384;       // consumer warpgroups 0, 1; producer 2
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may have
constexpr int kAlign = 1024;        // a 128-byte swizzle atom: 8 rows
constexpr int kBarBytes = 256;      // 2 * kMaxStages + 1 mbarriers
constexpr int kFactorBytes = 8;     // a column's epilogue factors, fp32 x 2
constexpr int kMaxDevices = 64;
constexpr long long kWatchdogCycles = 1ll << 35;

// Offsets from the 1024-aligned base of dynamic shared memory: the A
// stages, B (the resident weight, or a stage each), the two consumer
// warpgroups' epilogue tiles, the barriers, then the two warpgroups'
// epilogue factors; `bytes` asks for the alignment slack too.
struct ConvLayout {
  int b_off, epi_off, bar_off, bytes;
};

__host__ __device__ inline ConvLayout conv_layout(int bn, int stages,
                                                  int resident, int kblocks,
                                                  int ob) {
  ConvLayout l;
  l.b_off = stages * kAStage;
  l.epi_off = l.b_off + (resident ? kblocks : stages) * bn * kBK;
  l.bar_off = l.epi_off + kBM * bn * ob;
  l.bytes = l.bar_off + kBarBytes + 2 * kFactorBytes * bn + kAlign;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > kWatchdogCycles)
      __trap();
  }
}

// the executing thread's earlier cp.async copies arrive on `bar` when they
// land; the arrival counts toward the barrier's expected count
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes 0: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a K-major operand in the 128-byte-swizzled layout: 8-row groups `sbo`
// bytes apart, the leading offset unused by a swizzled K-major operand; a
// k32 step within the stage adds 32 bytes to the start
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t sbo = 1024) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products: before wgmma.fence and after wgmma.wait_group
template <int R>
__device__ __forceinline__ void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, s32) += A (64 x 32, s8) * B (N x 32, s8)^T, both from shared
// memory; scale_d 0 overwrites D. Thread t of the warpgroup holds, for
// each 8 columns i, d[4i], d[4i+1] at row 16 (t / 32) + (t % 32) / 4,
// columns 8i + 2 (t % 4) + {0, 1}, and d[4i+2], d[4i+3] 8 rows below.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void run(int (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(int (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(int (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(int (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
        " %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

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

// A warpgroup's per-column epilogue factors for channels n0 .. n0 + bn - 1,
// in shared memory: f[c] = s * w_s[n0 + c] (rounded once, as the plain
// version's s * w_s) and f[bn + c] the bias as fp32 (exact from bf16); 0
// past Cout. The warpgroup's 128 threads fill them once a tile, one load
// of each a thread, before the epilogue's first barrier.
__device__ __forceinline__ void fill_factors(float* f, int bn, int n0,
                                             int cout, int out_kind,
                                             float sv,
                                             const float* __restrict__ w_s,
                                             const void* __restrict__ bias) {
  if (out_kind == 2) return;
  for (int c = threadIdx.x & 127; c < bn; c += 128) {
    const int nc = n0 + c;
    float b = 0.f;
    if (nc < cout && bias != nullptr)
      b = out_kind == 0
              ? static_cast<const float*>(bias)[nc]
              : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[nc]);
    f[c] = nc < cout ? __fmul_rn(sv, w_s[nc]) : 0.f;
    f[bn + c] = b;
  }
}

// The epilogue of two neighbouring outputs (columns col, col + 1 of the
// tile; factors f, fill_factors') into the staged tile at p: the
// accumulator itself (out_kind 2), or each step rounded on its own as the
// plain version does, the bias added where there is one.
__device__ __forceinline__ void stage_pair(uint8_t* p, int v0, int v1,
                                           int out_kind, const float* f,
                                           int bn, int col, bool has_bias) {
  if (out_kind == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    return;
  }
  const float2 sc = *reinterpret_cast<const float2*>(f + col);  // col even
  const float2 b = *reinterpret_cast<const float2*>(f + bn + col);
  if (out_kind == 0) {
    float y0 = __fmul_rn(__int2float_rn(v0), sc.x);
    float y1 = __fmul_rn(__int2float_rn(v1), sc.y);
    if (has_bias) {
      y0 = __fadd_rn(y0, b.x);
      y1 = __fadd_rn(y1, b.y);
    }
    *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
  } else {
    __nv_bfloat162 pair;
    pair.x = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v0), sc.x));
    pair.y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(v1), sc.y));
    if (has_bias) {
      pair.x = __float2bfloat16_rn(__fadd_rn(__bfloat162float(pair.x), b.x));
      pair.y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(pair.y), b.y));
    }
    *reinterpret_cast<__nv_bfloat162*>(p) = pair;
  }
}

// The epilogue of a 128-pixel tile's 64 rows held by warpgroup wg (rows
// mrow .. mrow + 63 of the output, channels n0 .. n0 + BN - 1): into its
// staged tile (16-byte chunks swizzled by row against bank conflicts),
// then out along the contiguous NHWC rows, Cout apart, with 16-byte stores
// (4-byte ones where a row's bytes are not a multiple of 16).
template <int BN>
__device__ __forceinline__ void linear_epilogue(
    const int (&acc)[BN / 2], uint8_t* epi, float* f, int wg, int mrow,
    int n0, int m_total, int cout, int out_kind, float sv,
    const float* __restrict__ w_s, const void* __restrict__ bias,
    void* __restrict__ out) {
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5, lane = threadIdx.x & 31;
  const int ob = out_kind == 1 ? 2 : 4;
  const int row_bytes_s = BN * ob;  // a staged row
  const int swz = (row_bytes_s >= 128 ? 8 : row_bytes_s >> 4) - 1;
  fill_factors(f, BN, n0, cout, out_kind, sv, w_s, bias);
  named_bar_sync(1 + wg, 128);  // the last tile's copy-out has read it
  const int r = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    const int off = col * ob;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = r + 8 * half;
      stage_pair(epi + rr * row_bytes_s +
                     ((((off >> 4) ^ (rr & swz)) << 4) | (off & 15)),
                 acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1], out_kind,
                 f, BN, col, bias != nullptr);
    }
  }
  named_bar_sync(1 + wg, 128);
  const int rows = m_total - mrow < 64 ? m_total - mrow : 64;
  if (rows <= 0) return;
  const int ncols = cout - n0 < BN ? cout - n0 : BN;
  const int row_bytes = ncols * ob, gstride = cout * ob;
  uint8_t* const g = static_cast<uint8_t*>(out) +
                     (static_cast<long long>(mrow) * cout + n0) * ob;
  const int cr = row_bytes >> 4;
  if (((row_bytes | gstride) & 15) == 0 && 128 % cr == 0) {
    // a thread's chunk of a row, and every (128 / cr)-th row from its own
    const int jj = wtid % cr, step = 128 / cr;
    for (int rr = wtid / cr; rr < rows; rr += step)
      *reinterpret_cast<uint4*>(g + static_cast<long long>(rr) * gstride +
                                16 * jj) =
          *reinterpret_cast<const uint4*>(epi + rr * row_bytes_s +
                                          ((jj ^ (rr & swz)) << 4));
  } else if (((row_bytes | gstride) & 15) == 0) {
    for (int idx = wtid; idx < rows * cr; idx += 128) {
      const int rr = idx / cr, jj = idx - (idx / cr) * cr;
      *reinterpret_cast<uint4*>(g + static_cast<long long>(rr) * gstride +
                                16 * jj) =
          *reinterpret_cast<const uint4*>(epi + rr * row_bytes_s +
                                          ((jj ^ (rr & swz)) << 4));
    }
  } else {
    const int cw = row_bytes >> 2;
    for (int idx = wtid; idx < rows * cw; idx += 128) {
      const int rr = idx / cw, byte = 4 * (idx - (idx / cw) * cw);
      *reinterpret_cast<uint32_t*>(g + static_cast<long long>(rr) * gstride +
                                   byte) =
          *reinterpret_cast<const uint32_t*>(
              epi + rr * row_bytes_s +
              ((((byte >> 4) ^ (rr & swz)) << 4) | (byte & 15)));
    }
  }
}

// One CTA an SM, tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... of
// (128 pixels) x (BN channels). out_kind: 0 fp32 out, 1 bf16 out, 2 the
// int32 accumulator (no epilogue arithmetic). wmap: the packed weight
// (Cout rows of Kp bytes) as a 2-D tensor map, boxes of 128 bytes x BN
// rows, 128-byte swizzle, zeros outside.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_s8_kernel(const __grid_constant__ CUtensorMap wmap,
               const int8_t* __restrict__ xq, const float* __restrict__ s,
               const float* __restrict__ w_s, const void* __restrict__ bias,
               void* __restrict__ out, int n, int h, int w, int cp,
               int cout, int k, int stride, int pad, int ho, int wo,
               int out_kind, int stages, int resident, int kblocks) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base =
      (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const int ob = out_kind == 1 ? 2 : 4;
  const ConvLayout lay = conv_layout(BN, stages, resident, kblocks, ob);
  const uint32_t a_s = base, b_s = base + lay.b_off;
  const uint32_t full = base + lay.bar_off;  // full[i] at full + 8 i
  const uint32_t empty = full + 8 * kMaxStages;
  const uint32_t b_ready = empty + 8 * kMaxStages;
  const int hw_out = ho * wo;
  const int m_total = n * hw_out;  // < 2^31, checked by the entry point
  const int n_tiles = (cout + BN - 1) / BN;
  const int tiles = (m_total + kBM - 1) / kBM * n_tiles;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, kBM + 1);  // 128 producer threads + 1 (B)
      mbar_init(empty + 8 * i, 8);       // the 8 consumer warps
    }
    mbar_init(b_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kBM) {
    // ---- producer warpgroup: A by cp.async, B by TMA
    const int pt = tid - 2 * kBM;
    const int j = pt & 7;    // this thread's 16-byte column of a stage
    const int r0 = pt >> 3;  // its rows: r0 + 16 i, i < 8
    const uint32_t a_col = ((j ^ (r0 & 7)) << 4) + r0 * kBK;
    if (resident && pt == 0) {
      mbar_arrive_tx(b_ready, kblocks * BN * kBK);
      for (int kb = 0; kb < kblocks; ++kb)
        tma_load_2d(b_s + kb * BN * kBK, &wmap, b_ready, kb * kBK, 0);
    }
    // K offset 16 j as (ky, kx, c) and its offset from a pixel's window
    // corner, toff = (ky * w + kx) * cp + c; advanced by additions
    const int tap0 = (16 * j) / cp;
    const int c0 = 16 * j - tap0 * cp;
    const int ky0 = tap0 / k, kx0 = tap0 - (tap0 / k) * k;
    const int toff0 = (ky0 * w + kx0) * cp + c0;
    int slot = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mt = t / n_tiles;
      const int n0 = (t - mt * n_tiles) * BN;
      // the pixel of row r0, then 16 rows on by additions
      int m = mt * kBM + r0;
      int img = m / hw_out, oy = (m - img * hw_out) / wo;
      int ox = m - img * hw_out - oy * wo;
      int iy0[8], ix0[8];
      long long rb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (m < m_total) {
          iy0[i] = oy * stride - pad;
          ix0[i] = ox * stride - pad;
          rb[i] = ((static_cast<long long>(img) * h + iy0[i]) * w + ix0[i]) *
                  cp;
        } else {  // past the end: every tap out of the image
          iy0[i] = -(1 << 28);
          ix0[i] = 0;
          rb[i] = 0;
        }
        m += 16;
        for (ox += 16; ox >= wo; ox -= wo) {
          if (++oy == ho) {
            oy = 0;
            ++img;
          }
        }
      }
      int c = c0, kx = kx0, ky = ky0, toff = toff0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(empty + 8 * slot, phase ^ 1);
        const uint32_t fb = full + 8 * slot;
        if (pt == 0) {
          if (resident) {
            mbar_arrive(fb);
          } else {
            mbar_arrive_tx(fb, BN * kBK);
            tma_load_2d(b_s + slot * BN * kBK, &wmap, fb, kb * kBK, n0);
          }
        }
        const uint32_t dst = a_s + slot * kAStage + a_col;
        const bool in_k = ky < k;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int iy = iy0[i] + ky, ix = ix0[i] + kx;
          const bool ok =
              in_k && static_cast<unsigned>(iy) < static_cast<unsigned>(h) &&
              static_cast<unsigned>(ix) < static_cast<unsigned>(w);
          cp_async16(dst + i * 16 * kBK, ok ? xq + rb[i] + toff : xq,
                     ok ? 16 : 0);
        }
        cp_async_arrive(fb);
        c += kBK;
        toff += kBK;
        while (c >= cp) {
          c -= cp;
          if (++kx == k) {
            kx = 0;
            ++ky;
            toff += (w - k) * cp;
          }
        }
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- consumer warpgroups: wgmma over the stages, then the epilogue
    const int wg = tid >> 7;  // rows 64 wg .. 64 wg + 63 of a tile
    const int lane = tid & 31;
    uint8_t* const epi = gbase + lay.epi_off + wg * 64 * BN * ob;
    float* const factors = reinterpret_cast<float*>(
        gbase + lay.bar_off + kBarBytes + wg * kFactorBytes * BN);
    const float sv = *s;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int slot = 0, prev = -1;
    uint32_t phase = 0;
    if (resident) mbar_wait(b_ready, 0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mt = t / n_tiles;
      const int n0 = (t - mt * n_tiles) * BN;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full + 8 * slot, phase);
        // order the producer's cp.async writes before the products' reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t a = a_s + slot * kAStage + wg * 64 * kBK;
        const uint32_t b = b_s + (resident ? kb : slot) * BN * kBK;
        acc_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          Wgmma<BN>::run(acc, sw128_desc(a + 32 * kk),
                         sw128_desc(b + 32 * kk), kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        acc_fence(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = slot;
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      acc_fence(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      prev = -1;

      linear_epilogue<BN>(acc, epi, factors, wg, mt * kBM + wg * 64, n0,
                          m_total, cout, out_kind, sv, w_s, bias, out);
    }
  }
}

// ---- the halo variant: stride-1 windows over 16 x 16 output pixels
//
// A tile's input patch, (16 + k - 1)^2 pixels, is loaded once a 128-byte
// chunk of channels (one A stage) into rows of kHaloPitch pixels, 128 bytes
// a pixel, 128-byte swizzled; tap (ky, kx) of an 8 x 8 block of output
// pixels is then the patch at offset (ky, kx): 8 consecutive pixels a core
// matrix, core matrices a patch row apart. So each input byte is written
// to shared memory once a tile instead of once a tap, and wgmma reads A
// straight from the patch (the swizzle follows the absolute address, so an
// offset start needs no base offset). B is one box a (tap, chunk),
// streamed through its own ring. Consumer warpgroup g owns output rows
// 8g .. 8g + 7 as two blocks of 64 pixels (columns 0-7 and 8-15) sharing
// B, N = 64. Producer warp 8 lane 0 loads B by TMA; warps 9-11 gather the
// patches.
constexpr int kHaloTile = 16;
constexpr int kHaloPitch = 24;  // patch row pitch, pixels: >= 16 + k - 1, % 8
constexpr int kHaloBN = 64;
constexpr int kHaloAStages = 2;
constexpr int kHaloGather = 96;  // threads that gather the patches

struct HaloLayout {
  int a_bytes, b_off, epi_off, bar_off, bytes;
};

__host__ __device__ inline HaloLayout halo_layout(int k, int b_stages,
                                                  int ob) {
  HaloLayout l;
  l.a_bytes = (kHaloTile + k - 1) * kHaloPitch * kBK;
  l.b_off = kHaloAStages * l.a_bytes;
  l.epi_off = l.b_off + b_stages * kHaloBN * kBK;
  l.bar_off = l.epi_off + kHaloTile * kHaloTile * kHaloBN * ob;
  l.bytes = l.bar_off + kBarBytes + 2 * kFactorBytes * kHaloBN + kAlign;
  return l;
}

// A consumer warpgroup's walk over the halo kernel's two rings: one A
// stage (a chunk of the patch) at a time, one B stage (a tap's box) at a
// time within it.
struct HaloRing {
  uint32_t full_a, empty_a, full_b, empty_b, a_s, b_s;
  int a_bytes, b_stages, k, wg, lane;
  int as = 0, bs = 0;
  uint32_t aph = 0, bph = 0;

  // KS k32 steps of every tap over the next patch chunk; `first`: the
  // tile's first chunk, whose first product overwrites the accumulators
  template <int KS>
  __device__ __forceinline__ void chunk(int (&acc)[2][kHaloBN / 2],
                                        bool first) {
    mbar_wait(full_a + 8 * as, aph);
    // order the producer's cp.async writes before the products' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t patch = a_s + as * a_bytes;
    int prev = -1;
    for (int ky = 0; ky < k; ++ky) {
      for (int kx = 0; kx < k; ++kx) {
        mbar_wait(full_b + 8 * bs, bph);
        const uint32_t bst = b_s + bs * kHaloBN * kBK;
        const uint32_t a0 = patch + ((8 * wg + ky) * kHaloPitch + kx) * kBK;
        const int keep = !first || ky > 0 || kx > 0;
        acc_fence(acc[0]);
        acc_fence(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int b = 0; b < 2; ++b)
            Wgmma<kHaloBN>::run(acc[b],
                                sw128_desc(a0 + 8 * b * kBK + 32 * ks,
                                           kHaloPitch * kBK),
                                sw128_desc(bst + 32 * ks), keep || ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        acc_fence(acc[0]);
        acc_fence(acc[1]);
        if (prev >= 0 && lane == 0) mbar_arrive(empty_b + 8 * prev);
        prev = bs;
        if (++bs == b_stages) {
          bs = 0;
          bph ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    acc_fence(acc[0]);
    acc_fence(acc[1]);
    if (lane == 0) {
      mbar_arrive(empty_b + 8 * prev);
      mbar_arrive(empty_a + 8 * as);
    }
    if (++as == kHaloAStages) {
      as = 0;
      aph ^= 1;
    }
  }
};

// KL: k32 steps of the last chunk of channels (Cp % 128, rounded up to 32;
// 4 where it is whole)
template <int KL>
__global__ void __launch_bounds__(kThreads, 1)
conv_s8_halo_kernel(const __grid_constant__ CUtensorMap wmap,
                    const int8_t* __restrict__ xq,
                    const float* __restrict__ s,
                    const float* __restrict__ w_s,
                    const void* __restrict__ bias, void* __restrict__ out,
                    int n, int h, int w, int cp, int cout, int k, int pad,
                    int ho, int wo, int out_kind, int b_stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base =
      (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  uint8_t* const gbase = smem_raw + (base - raw);
  const int ob = out_kind == 1 ? 2 : 4;
  const HaloLayout lay = halo_layout(k, b_stages, ob);
  const uint32_t a_s = base, b_s = base + lay.b_off;
  const uint32_t full_a = base + lay.bar_off;
  const uint32_t empty_a = full_a + 8 * kHaloAStages;
  const uint32_t full_b = empty_a + 8 * kHaloAStages;
  const uint32_t empty_b = full_b + 8 * kMaxStages;
  const int span = kHaloTile + k - 1;  // patch pixels across and down
  const int tiles_x = (wo + kHaloTile - 1) / kHaloTile;
  const int tiles_img = (ho + kHaloTile - 1) / kHaloTile * tiles_x;
  const int tiles = n * tiles_img;
  const int chunks = (cp + kBK - 1) / kBK;
  const int taps = k * k;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kHaloAStages; ++i) {
      mbar_init(full_a + 8 * i, kHaloGather);
      mbar_init(empty_a + 8 * i, 8);
    }
    for (int i = 0; i < b_stages; ++i) {
      mbar_init(full_b + 8 * i, 1);
      mbar_init(empty_b + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kBM) {
    const int pt = tid - 2 * kBM;
    if (pt == 0) {
      // ---- B: one box of 128 bytes x 64 rows a (tap, chunk)
      int bs = 0;
      uint32_t bph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int c = 0; c < chunks; ++c) {
          for (int tap = 0; tap < taps; ++tap) {
            mbar_wait(empty_b + 8 * bs, bph ^ 1);
            mbar_arrive_tx(full_b + 8 * bs, kHaloBN * kBK);
            tma_load_2d(b_s + bs * kHaloBN * kBK, &wmap, full_b + 8 * bs,
                        tap * cp + c * kBK, 0);
            if (++bs == b_stages) {
              bs = 0;
              bph ^= 1;
            }
          }
        }
      }
    } else if (pt >= 32) {
      // ---- A: the tile's patch, a chunk of 128 channel bytes a stage
      const int at = pt - 32;
      int as = 0;
      uint32_t aph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int img = t / tiles_img;
        const int rem = t - img * tiles_img;
        const int ty = rem / tiles_x;
        const int y0 = ty * kHaloTile - pad;
        const int x0 = (rem - ty * tiles_x) * kHaloTile - pad;
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(empty_a + 8 * as, aph ^ 1);
          const uint32_t dst = a_s + as * lay.a_bytes;
          for (int py = 0; py < span; ++py) {
            const int iy = y0 + py;
            const bool row_ok = static_cast<unsigned>(iy) <
                                static_cast<unsigned>(h);
            const long long row = (static_cast<long long>(img) * h + iy) * w;
            for (int q = at; q < span * 8; q += kHaloGather) {
              const int px = q >> 3, j = q & 7;
              const int ix = x0 + px, ch = c * kBK + 16 * j;
              const bool ok = row_ok &&
                              static_cast<unsigned>(ix) <
                                  static_cast<unsigned>(w) &&
                              ch < cp;
              cp_async16(
                  dst + (py * kHaloPitch + px) * kBK + ((j ^ (px & 7)) << 4),
                  ok ? xq + (row + ix) * cp + ch : xq, ok ? 16 : 0);
            }
          }
          cp_async_arrive(full_a + 8 * as);
          if (++as == kHaloAStages) {
            as = 0;
            aph ^= 1;
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---- consumers: 8 output rows x 16 columns a warpgroup
    const int wg = tid >> 7;
    const int wtid = tid & 127;
    const int warp = wtid >> 5, lane = tid & 31;
    const int row_bytes_s = kHaloBN * ob;  // a staged pixel
    const int swz = (row_bytes_s >= 128 ? 8 : row_bytes_s >> 4) - 1;
    uint8_t* const epi =
        gbase + lay.epi_off + wg * 8 * kHaloTile * row_bytes_s;
    float* const factors = reinterpret_cast<float*>(
        gbase + lay.bar_off + kBarBytes + wg * kFactorBytes * kHaloBN);
    const float sv = *s;
    int acc[2][kHaloBN / 2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < kHaloBN / 2; ++i) acc[b][i] = 0;
    HaloRing ring{full_a,      empty_a,  full_b, empty_b, a_s, b_s,
                  lay.a_bytes, b_stages, k,      wg,      lane};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      // every chunk of 128 channel bytes but the last in 4 k32 steps, the
      // last in KL: compile-time counts keep the products unserialized
      for (int c = 0; c + 1 < chunks; ++c) ring.chunk<4>(acc, c == 0);
      ring.chunk<KL>(acc, chunks == 1);

      // epilogue: staged pixel (row g, column x) of this warpgroup's 8 x 16
      fill_factors(factors, kHaloBN, 0, cout, out_kind, sv, w_s, bias);
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int i = 0; i < kHaloBN / 8; ++i) {
          const int col = 8 * i + 2 * (lane & 3);
          const int off = col * ob;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + (lane >> 2) + 8 * half;  // of 64
            const int px = (r >> 3) * kHaloTile + 8 * b + (r & 7);
            stage_pair(epi + px * row_bytes_s +
                           ((((off >> 4) ^ (px & swz)) << 4) | (off & 15)),
                       acc[b][4 * i + 2 * half],
                       acc[b][4 * i + 2 * half + 1], out_kind, factors,
                       kHaloBN, col, bias != nullptr);
          }
        }
      }
      named_bar_sync(1 + wg, 128);

      // copy-out: each output row's up to 16 pixels are contiguous
      const int img = t / tiles_img;
      const int rem = t - img * tiles_img;
      const int ty = rem / tiles_x;
      const int oy0 = ty * kHaloTile + 8 * wg;
      const int ox0 = (rem - ty * tiles_x) * kHaloTile;
      const int cols = wo - ox0 < kHaloTile ? wo - ox0 : kHaloTile;
      const int px_bytes = cout * ob;
      const int unit = (px_bytes & 15) == 0 ? 16 : 4;
      const int per_px = px_bytes / unit;
      const int per_row = kHaloTile * per_px;
      for (int idx = wtid; idx < 8 * per_row; idx += 128) {
        const int g = idx / per_row;
        const int rem2 = idx - g * per_row;
        const int x = rem2 / per_px;
        const int byte = (rem2 - x * per_px) * unit;
        const int oy = oy0 + g;
        if (x >= cols || oy >= ho) continue;
        const int px = g * kHaloTile + x;
        const uint8_t* src = epi + px * row_bytes_s +
                             ((((byte >> 4) ^ (px & swz)) << 4) | (byte & 15));
        uint8_t* dst =
            static_cast<uint8_t*>(out) +
            ((static_cast<long long>(img) * ho + oy) * wo + ox0 + x) *
                px_bytes +
            byte;
        if (unit == 16)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint32_t*>(dst) =
              *reinterpret_cast<const uint32_t*>(src);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, reached through the runtime
EncodeTiledFn encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                              cudaEnableDefault, &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(p);
}

int bn_index(int bn) {
  return bn == 16 ? 0 : bn == 32 ? 1 : bn == 64 ? 2 : bn == 128 ? 3 : -1;
}

// Dynamic shared memory of one CTA: the gather kernel (variant 0) with N
// bn, `stages` A stages and the weight resident over kblocks stages of K
// or streamed a stage each; the halo kernel (1) with `stages` B stages at
// a k x k window. ob: bytes of an output value.
int conv_bytes(int variant, int bn, int stages, int resident, int kblocks,
               int k, int ob) {
  return variant == 1 ? halo_layout(k, stages, ob).bytes
                      : conv_layout(bn, stages, resident, kblocks, ob).bytes;
}

// A layer's launch: the kernel, N (the tile's channels), the tiles across
// Cout, the ring's depth, whether the whole weight stays in shared memory,
// and the dynamic shared memory of a CTA.
struct ConvPlan {
  int variant, bn, n_tiles, stages, resident, bytes;
};

constexpr int kMinStages = 3;
// The rings aim at this much shared memory: on the card, rings that filled
// the rest of the 227 KB ran slower than one stage fewer (the L1 cache
// shrinks as shared memory grows; tools/conv_s8_plans_torch.py).
constexpr int kSmemTarget = 200 * 1024;

// One kernel's plan for a layer, or false where that kernel does not take
// it: N the least tile width that covers Cout (64 for the halo kernel, at
// stride 1; 128 past it, in several tiles, for the gather kernel); the
// ring `stages` deep, or as deep as fits (the gather's A stages within
// kSmemTarget where at least kMinStages do) where `stages` is 0.
bool variant_plan(int variant, int cout, int kp, int k, int stride, int ob,
                  int resident, int stages, ConvPlan* p) {
  const int kblocks = (kp + kBK - 1) / kBK;
  const int bn = variant == 1    ? kHaloBN
                 : cout <= 16    ? 16
                 : cout <= 32    ? 32
                 : cout <= 64    ? 64
                                 : 128;
  if (variant == 1 ? stride != 1 || cout > bn || resident ||
                         k + kHaloTile > kHaloPitch
                   : resident && cout > bn)
    return false;
  if (stages == 0) {
    const int fixed = conv_bytes(variant, bn, 0, resident, kblocks, k, ob);
    if (variant == 1) {
      stages = (kSmemLimit - fixed) / (bn * kBK);
    } else {
      const int stage = kAStage + (resident ? 0 : bn * kBK);
      stages = (kSmemTarget - fixed) / stage;
      if (stages < kMinStages) {
        const int fit = (kSmemLimit - fixed) / stage;
        stages = fit < kMinStages ? fit : kMinStages;
      }
    }
    if (stages > kMaxStages) stages = kMaxStages;
  }
  const int bytes =
      conv_bytes(variant, bn, stages, resident, kblocks, k, ob);
  if (stages < 2 || stages > kMaxStages || bytes > kSmemLimit) return false;
  *p = ConvPlan{variant, bn, (cout + bn - 1) / bn, stages, resident, bytes};
  return true;
}

// The kernel and its tiling for a layer, chosen from times on the card
// (tools/conv_s8_plans_torch.py; PERF.md has them):
// - the halo kernel for a stride-1 window of Cout 33-64 (conv11 and the
//   smoothers): the input patch is loaded once a tile, not once a tap, and
//   conv11 runs in about half the gather kernel's time;
// - else the gather kernel, its weight resident where it fits beside the
//   epilogue and kMinStages A stages within kSmemTarget, else streamed
//   through the ring beside A.
bool conv_plan(int cout, int kp, int k, int stride, int ob, ConvPlan* p) {
  if (cout > 32 && variant_plan(1, cout, kp, k, stride, ob, 0, 0, p))
    return true;
  const int bn = cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  const int resident =
      cout <= bn && conv_bytes(0, bn, kMinStages, 1, (kp + kBK - 1) / kBK, k,
                               ob) <= kSmemTarget;
  return variant_plan(0, cout, kp, k, stride, ob, resident, 0, p);
}

// the opt-in above 48 KB is a property of the card: set it on each one
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, bool (&opted)[kMaxDevices], int device) {
  if (opted[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess) opted[device] = true;
  return e;
}

struct Launch {
  const CUtensorMap* wmap;
  int device, blocks, bytes;
  cudaStream_t st;
  const int8_t* xq;
  const float *s, *w_s;
  const void* bias;
  void* out;
  int n, h, w, cp, cout, k, stride, pad, ho, wo, out_kind, stages, resident,
      kblocks;
};

template <int BN>
cudaError_t launch_gather(const Launch& l) {
  static bool opted[kMaxDevices];
  const cudaError_t e = opt_in(conv_s8_kernel<BN>, opted, l.device);
  if (e != cudaSuccess) return e;
  conv_s8_kernel<BN><<<l.blocks, kThreads, l.bytes, l.st>>>(
      *l.wmap, l.xq, l.s, l.w_s, l.bias, l.out, l.n, l.h, l.w, l.cp, l.cout,
      l.k, l.stride, l.pad, l.ho, l.wo, l.out_kind, l.stages, l.resident,
      l.kblocks);
  return cudaGetLastError();
}

template <int KL>
cudaError_t launch_halo(const Launch& l) {
  static bool opted[kMaxDevices];
  const cudaError_t e = opt_in(conv_s8_halo_kernel<KL>, opted, l.device);
  if (e != cudaSuccess) return e;
  conv_s8_halo_kernel<KL><<<l.blocks, kThreads, l.bytes, l.st>>>(
      *l.wmap, l.xq, l.s, l.w_s, l.bias, l.out, l.n, l.h, l.w, l.cp, l.cout,
      l.k, l.pad, l.ho, l.wo, l.out_kind, l.stages);
  return cudaGetLastError();
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

// The launch plan of a conv_s8 layer (Cout, Kp, a k x k window at
// `stride`, out_dtype 0 fp32, 1 bf16, 2 int32) into plan[6]: variant (0
// the gather kernel, 1 the halo kernel), bn, tiles across Cout, stages,
// resident, dynamic shared memory in bytes. variant -1 asks for the plan
// that conv_s8 takes (conv_plan); 0 or 1 for that kernel's, with the
// weight resident or not and the ring `stages` deep (0: as deep as fits),
// and cudaErrorInvalidValue where that kernel does not take the layer.
extern "C" int ptt_conv_s8_plan(int cout, int kp, int k, int stride,
                                int out_dtype, int variant, int resident,
                                int stages, int* plan) {
  if (cout <= 0 || kp <= 0 || k <= 0 || out_dtype < 0 || out_dtype > 2 ||
      variant < -1 || variant > 1 || stages < 0 || plan == nullptr)
    return cudaErrorInvalidValue;
  const int ob = out_dtype == 1 ? 2 : 4;
  ConvPlan p;
  if (!(variant < 0 ? conv_plan(cout, kp, k, stride, ob, &p)
                    : variant_plan(variant, cout, kp, k, stride, ob,
                                   resident != 0, stages, &p)))
    return cudaErrorInvalidValue;
  const int out[6] = {p.variant, p.bn,       p.n_tiles,
                      p.stages,  p.resident, p.bytes};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return cudaSuccess;
}

// xq (n, h, w, cp) int8; wq (cout, kp) int8 packed as (ky, kx, c), zeros
// past k * k * cp; s one fp32 value; w_s (cout) fp32; bias (cout) in the
// output type or null; out (n, ho, wo, cout): out_dtype 0 fp32, 1 bf16,
// 2 int32 (the accumulator, no scales or bias). The plan (ptt_conv_s8_plan):
// variant 0 the gather kernel (bn the tile's channels: 16, 32,
// 64 or 128; stages of the ring, 2-6; resident 1 keeps the whole weight in
// shared memory, cout <= bn), 1 the halo kernel (stride 1, bn 64 >= cout,
// k <= 9; stages of B).
extern "C" int ptt_conv_s8(const void* xq, const void* wq, const void* s,
                           const void* w_s, const void* bias, void* out,
                           int n, int h, int w, int cp, int cout, int kp,
                           int k, int stride, int pad, int ho, int wo,
                           int out_dtype, int variant, int bn, int stages,
                           int resident, int device, void* stream) {
  const int kblocks = (kp + kBK - 1) / kBK;
  if (n <= 0 || h <= 0 || w <= 0 || cp <= 0 || cp % 16 || cout <= 0 ||
      cout % 2 || k <= 0 || stride <= 0 || pad < 0 || ho <= 0 || wo <= 0 ||
      kp % 32 || kp < k * k * cp || out_dtype < 0 || out_dtype > 2 ||
      (out_dtype == 2 && bias != nullptr) || variant < 0 || variant > 1 ||
      bn_index(bn) < 0 || stages < 2 || stages > kMaxStages ||
      (resident != 0 && resident != 1) || (resident && cout > bn) ||
      (variant == 1 && (stride != 1 || bn != kHaloBN || cout > bn ||
                        resident || k + kHaloTile > kHaloPitch)) ||
      static_cast<long long>(n) * ho * wo >= (1ll << 31) || device < 0 ||
      device >= kMaxDevices ||
      conv_bytes(variant, bn, stages, resident, kblocks, k,
                 out_dtype == 1 ? 2 : 4) > kSmemLimit)
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  static const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // B: the packed weight, boxes of 128 bytes of K x bn rows
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wq),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  static int sms[kMaxDevices];
  if (sms[device] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  const int tiles =
      variant == 1 ? n * ((ho + kHaloTile - 1) / kHaloTile) *
                         ((wo + kHaloTile - 1) / kHaloTile)
                   : (n * ho * wo + kBM - 1) / kBM * ((cout + bn - 1) / bn);
  const Launch l{&wmap,
                 device,
                 tiles < sms[device] ? tiles : sms[device],
                 conv_bytes(variant, bn, stages, resident, kblocks, k,
                            out_dtype == 1 ? 2 : 4),
                 static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(xq),
                 static_cast<const float*>(s),
                 static_cast<const float*>(w_s),
                 bias,
                 out,
                 n, h, w, cp, cout, k, stride, pad, ho, wo, out_dtype, stages,
                 resident, kblocks};
  if (variant == 1) {
    switch ((cp % kBK + 31) / 32) {  // k32 steps of the last channel chunk
      case 1:
        return launch_halo<1>(l);
      case 2:
        return launch_halo<2>(l);
      case 3:
        return launch_halo<3>(l);
      default:
        return launch_halo<4>(l);
    }
  }
  switch (bn) {
    case 16:
      return launch_gather<16>(l);
    case 32:
      return launch_gather<32>(l);
    case 64:
      return launch_gather<64>(l);
    default:
      return launch_gather<128>(l);
  }
}
