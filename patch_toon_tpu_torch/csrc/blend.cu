// Gaussian-weighted tile compositor: the tiled program's blend step.
//
// Replaces patch_toon_tpu/ops/pallas_blend.py::blend_tiles (its Pallas body
// _kernel; the engine itself ran the same sum as a lax.scan,
// patch_toon_tpu/infer/programs.py:213-227). For every canvas pixel:
//   canvas  += gen_t * w_t   and   wcanvas += w_t
// over the tiles t that cover it, in ascending tile id. Tiles are anchored
// at their top-left (flat_y0, x0); a padding tile (flat_y0 < 0) is binned
// nowhere and adds nothing.
//
// Bound: bytes. Each tile pixel is read once (its canvas block is the only
// one that holds it) and each canvas pixel written once, with two flops per
// read value. The host bins tiles into 32x32 canvas blocks as CSR lists
// (ops/blend.py::bin_tiles). One CUDA block owns one canvas block, keeps
// its 4 channels of 1024 pixels in registers (4 pixels a thread) and walks
// the block's tile list in ascending id, so the sum needs no atomics and is
// the same on every run. Products and sums are rounded one at a time
// (__fmul_rn, __fadd_rn, never a contracted FMA), which makes the result
// bit-identical to the ordered per-tile sum of the plain version.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kBlock = 32;     // canvas block edge, = ops/blend.py BLOCK
constexpr int kThreads = 256;
constexpr int kPx = kBlock * kBlock / kThreads;  // pixels per thread
constexpr int kChunk = 128;    // tile-list entries staged in shared memory

__global__ void __launch_bounds__(kThreads)
blend_tiles_kernel(const float* __restrict__ gen,
                   const float* __restrict__ wts,
                   const int* __restrict__ pos,
                   const int* __restrict__ offs,
                   const int* __restrict__ ids, float* __restrict__ canvas,
                   float* __restrict__ wcanvas, int ps, int h, int w,
                   int nbx) {
  __shared__ int s_t[kChunk];
  __shared__ int s_y[kChunk];
  __shared__ int s_x[kChunk];
  const int b = blockIdx.x;
  const int by0 = (b / nbx) * kBlock;
  const int bx0 = (b % nbx) * kBlock;

  int py[kPx], px[kPx];
  float acc[kPx][4];
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int l = threadIdx.x + j * kThreads;  // a warp takes one row
    py[j] = by0 + l / kBlock;
    px[j] = bx0 + l % kBlock;
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  const int begin = offs[b], end = offs[b + 1];
  for (int k0 = begin; k0 < end; k0 += kChunk) {
    const int n = min(kChunk, end - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int t = ids[k0 + i];
      s_t[i] = t;
      s_y[i] = pos[2 * t];
      s_x[i] = pos[2 * t + 1];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int t = s_t[i], y0 = s_y[i], x0 = s_x[i];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int dy = py[j] - y0, dx = px[j] - x0;
        if (static_cast<unsigned>(dy) < static_cast<unsigned>(ps) &&
            static_cast<unsigned>(dx) < static_cast<unsigned>(ps)) {
          const size_t q = (static_cast<size_t>(t) * ps + dy) * ps + dx;
          const float wt = wts[q];
          acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(gen[3 * q], wt));
          acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(gen[3 * q + 1], wt));
          acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(gen[3 * q + 2], wt));
          acc[j][3] = __fadd_rn(acc[j][3], wt);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    if (py[j] < h && px[j] < w) {
      const size_t o = static_cast<size_t>(py[j]) * w + px[j];
      canvas[3 * o] = acc[j][0];
      canvas[3 * o + 1] = acc[j][1];
      canvas[3 * o + 2] = acc[j][2];
      wcanvas[o] = acc[j][3];
    }
  }
}

}  // namespace

// gen (n_tiles, ps, ps, 3) f32, weights (n_tiles, ps, ps) f32, positions
// (n_tiles, 2) i32 (flat_y0, x0), offsets (nblocks + 1) i32 and ids i32 as
// bin_tiles builds them for `block`; canvas (h, w, 3) and wcanvas (h, w, 1)
// f32 are written whole.
extern "C" int ptt_blend_tiles(const void* gen, const void* wts,
                               const void* pos, const void* offs,
                               const void* ids, void* canvas, void* wcanvas,
                               int n_tiles, int ps, int h, int w, int block,
                               int device, void* stream) {
  if (block != kBlock || ps <= 0 || h <= 0 || w <= 0 || n_tiles < 0)
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const int nby = (h + kBlock - 1) / kBlock;
  const int nbx = (w + kBlock - 1) / kBlock;
  blend_tiles_kernel<<<nby * nbx, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gen), static_cast<const float*>(wts),
      static_cast<const int*>(pos), static_cast<const int*>(offs),
      static_cast<const int*>(ids), static_cast<float*>(canvas),
      static_cast<float*>(wcanvas), ps, h, w, nbx);
  return cudaGetLastError();
}
