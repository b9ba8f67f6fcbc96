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
// the blobs that cover it applied in point order, so here one thread owns a
// pixel and walks the points: nothing synchronizes between points and
// nothing races. A block stages the points in chunks in shared memory, with
// each point's window computed once a block (an invalid point gets an empty
// window and leaves the canvas bitwise as it was).
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
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;
constexpr int kChunk = 256;  // points staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
splat_points_kernel(const float* __restrict__ image, float* __restrict__ out,
                    const float* __restrict__ pts,
                    const float* __restrict__ cols,
                    const unsigned char* __restrict__ valid, int n, int h,
                    int w, int r, float s2) {
  __shared__ float s_x[kChunk], s_y[kChunk];
  __shared__ float s_c[kChunk][3];
  __shared__ int s_win[kChunk][4];  // y_lo, y_hi, x_lo, x_hi (inclusive)
  const int px = blockIdx.x * kTileX + threadIdx.x % kTileX;
  const int py = blockIdx.y * kTileY + threadIdx.x / kTileX;
  const bool inside = px < w && py < h;
  const size_t o = inside ? (static_cast<size_t>(py) * w + px) * 3 : 0;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  if (inside) {
    c0 = image[o];
    c1 = image[o + 1];
    c2 = image[o + 2];
  }
  const float xi = static_cast<float>(px), yi = static_cast<float>(py);
  const float fr = static_cast<float>(r);

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int m = min(kChunk, n - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int p = k0 + i;
      const float x = pts[2 * p], y = pts[2 * p + 1];
      int ylo = 1, yhi = 0, xlo = 1, xhi = 0;  // empty
      if (valid[p]) {
        const int fy = static_cast<int>(floorf(y));
        const int fx = static_cast<int>(floorf(x));
        // C truncation toward zero of the fp32 sums, as the reference
        ylo = max(fy - r, static_cast<int>(__fsub_rn(y, fr)));
        yhi = min(fy + r + 1, static_cast<int>(__fadd_rn(y, fr)));
        xlo = max(fx - r, static_cast<int>(__fsub_rn(x, fr)));
        xhi = min(fx + r + 1, static_cast<int>(__fadd_rn(x, fr)));
      }
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
    if (!inside) continue;
    for (int i = 0; i < m; ++i) {
      if (py < s_win[i][0] || py > s_win[i][1] || px < s_win[i][2] ||
          px > s_win[i][3])
        continue;
      const float dx = __fsub_rn(xi, s_x[i]);
      const float dy = __fsub_rn(yi, s_y[i]);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float wt = expf(__fdiv_rn(-d, s2));
      const float keep = __fsub_rn(1.f, wt);
      c0 = __fadd_rn(__fmul_rn(c0, keep), __fmul_rn(s_c[i][0], wt));
      c1 = __fadd_rn(__fmul_rn(c1, keep), __fmul_rn(s_c[i][1], wt));
      c2 = __fadd_rn(__fmul_rn(c2, keep), __fmul_rn(s_c[i][2], wt));
    }
  }
  if (inside) {
    out[o] = c0;
    out[o + 1] = c1;
    out[o + 2] = c2;
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
