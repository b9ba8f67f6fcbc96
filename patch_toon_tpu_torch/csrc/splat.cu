// Gaussian point splat of the guide-channel tool: each valid point
// alpha-composites a Gaussian blob of its colour over the canvas,
//   out = out * (1 - wt) + color * wt,
//   wt  = expf(-((xi - x)^2 + (yi - y)^2) / sigma^2),
// in ascending point order, over a window per axis that is the intersection
// of [floor(c) - r, floor(c) + r + 1] and [trunc(c - r), trunc(c + r)],
// r = int(3 sigma).
//
// Replaces patch_toon_tpu/ops/splat.py::splat_points, a sequential lax.scan
// on the device (not a Pallas kernel): each scan step read and wrote one
// point's (2r + 2)^2 window of the canvas. The scan's result is, per pixel,
// the blobs that cover it applied in point order, so here each thread owns
// kRows pixels of a column of its block and walks the points in order:
// nothing synchronizes between points and nothing races. An invalid point
// gets an empty window and leaves the canvas bitwise as it was.
//
// Per-block point lists. A block stages the points in chunks of kChunk,
// one point a thread: the thread computes the point's window and tests it
// against the block's pixel rectangle. A warp's passing points are counted
// by __ballot_sync / __popc, the warps' counts summed in warp order, and
// each passing point written at its rank into a list in shared memory, so
// the list keeps ascending point order. The pixel loop walks only that
// list: at r = 45 a 32x16 block meets about 30 of a frame's 1,000 points,
// not 1,000. A point left out covers no pixel of the block, so every pixel
// sees the same blobs in the same order as the full walk.
//
// Bound: bytes. The canvas is read once and written once (12 bytes a pixel
// each way); the window arithmetic is some 20 flops and one expf a covered
// (pixel, point) pair, below the bytes' time at the tool's sizes. Every
// product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: nvcc never contracts them into an FMA), so the
// result is bit-identical to the plain version's separate PyTorch ops on the
// card, which call the same expf.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kTileX = 32;  // a warp takes one row of 32 pixels
constexpr int kWarps = 8;
constexpr int kRows = 2;    // pixels a thread, kWarps rows apart
constexpr int kTileY = kWarps * kRows;
constexpr int kThreads = kTileX * kWarps;
constexpr int kChunk = kThreads;  // points staged at a time, one a thread

__global__ void __launch_bounds__(kThreads)
splat_points_kernel(const float* __restrict__ image, float* __restrict__ out,
                    const float* __restrict__ pts,
                    const float* __restrict__ cols,
                    const unsigned char* __restrict__ valid, int n, int h,
                    int w, int r, float s2) {
  // the block's list of the chunk's points that meet it, in point order
  __shared__ float s_x[kChunk], s_y[kChunk];
  __shared__ float s_c[kChunk][3];
  __shared__ int s_win[kChunk][4];  // y_lo, y_hi, x_lo, x_hi (inclusive)
  __shared__ int s_count[kWarps];
  const int lane = threadIdx.x % kTileX, warp = threadIdx.x / kTileX;
  const int bx0 = blockIdx.x * kTileX, by0 = blockIdx.y * kTileY;
  const int px = bx0 + lane;
  const float xi = static_cast<float>(px);
  const float fr = static_cast<float>(r);
  int py[kRows];
  bool inside[kRows];
  size_t o[kRows];
  float c0[kRows], c1[kRows], c2[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    py[k] = by0 + warp + k * kWarps;
    inside[k] = px < w && py[k] < h;
    o[k] = inside[k] ? (static_cast<size_t>(py[k]) * w + px) * 3 : 0;
    c0[k] = c1[k] = c2[k] = 0.f;
    if (inside[k]) {
      c0[k] = image[o[k]];
      c1[k] = image[o[k] + 1];
      c2[k] = image[o[k] + 2];
    }
  }

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    // this thread's point: its window, and whether it meets the block
    const int p = k0 + threadIdx.x;
    float x = 0.f, y = 0.f;
    int ylo = 1, yhi = 0, xlo = 1, xhi = 0;  // empty
    if (p < n && valid[p]) {
      x = pts[2 * p];
      y = pts[2 * p + 1];
      const int fy = static_cast<int>(floorf(y));
      const int fx = static_cast<int>(floorf(x));
      // C truncation toward zero of the fp32 sums, as the reference
      ylo = max(fy - r, static_cast<int>(__fsub_rn(y, fr)));
      yhi = min(fy + r + 1, static_cast<int>(__fadd_rn(y, fr)));
      xlo = max(fx - r, static_cast<int>(__fsub_rn(x, fr)));
      xhi = min(fx + r + 1, static_cast<int>(__fadd_rn(x, fr)));
    }
    const bool meets = ylo <= yhi && xlo <= xhi && ylo < by0 + kTileY &&
                       yhi >= by0 && xlo < bx0 + kTileX && xhi >= bx0;
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    __syncthreads();  // the previous chunk's list has been consumed
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, m = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      base += wi < warp ? s_count[wi] : 0;
      m += s_count[wi];
    }
    if (meets) {
      const int i = base + __popc(ballot & ((1u << lane) - 1u));
      s_x[i] = x;
      s_y[i] = y;
      s_c[i][0] = cols[3 * p];
      s_c[i][1] = cols[3 * p + 1];
      s_c[i][2] = cols[3 * p + 2];
      s_win[i][0] = ylo;
      s_win[i][1] = yhi;
      s_win[i][2] = xlo;
      s_win[i][3] = xhi;
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      if (px < s_win[i][2] || px > s_win[i][3]) continue;
      const float dx = __fsub_rn(xi, s_x[i]);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!inside[k] || py[k] < s_win[i][0] || py[k] > s_win[i][1])
          continue;
        const float dy = __fsub_rn(static_cast<float>(py[k]), s_y[i]);
        const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float wt = expf(__fdiv_rn(-d, s2));
        const float keep = __fsub_rn(1.f, wt);
        c0[k] = __fadd_rn(__fmul_rn(c0[k], keep), __fmul_rn(s_c[i][0], wt));
        c1[k] = __fadd_rn(__fmul_rn(c1[k], keep), __fmul_rn(s_c[i][1], wt));
        c2[k] = __fadd_rn(__fmul_rn(c2[k], keep), __fmul_rn(s_c[i][2], wt));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (inside[k]) {
      out[o[k]] = c0[k];
      out[o[k] + 1] = c1[k];
      out[o[k] + 2] = c2[k];
    }
  }
}

}  // namespace

// image and out (h, w, 3) f32 (out written whole, never image), points
// (n, 2) f32 (x, y), colors (n, 3) f32, valid (n) u8, r = int(3 sigma),
// s2 = fp32(sigma * sigma).
extern "C" int ptt_splat_points(const void* image, void* out,
                                const void* pts, const void* cols,
                                const void* valid, int n, int h, int w, int r,
                                float s2, int device, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || r < 0 || !(s2 > 0.f))
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  splat_points_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<float*>(out),
      static_cast<const float*>(pts), static_cast<const float*>(cols),
      static_cast<const unsigned char*>(valid), n, h, w, r, s2);
  return cudaGetLastError();
}
