// The caller's current device, kept across a C entry point: each entry
// launches on the device it is given and puts the calling thread's current
// device back on return, so a launch on card 1 does not leave a caller
// that works on card 0 (PyTorch's index-free allocations, its current
// stream) on card 1.
#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) err_ = cudaSetDevice(device);
    if (err_ != cudaSuccess) prev_ = -1;
  }
  ~DeviceGuard() {
    int now = -1;
    if (prev_ >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev_)
      cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};
