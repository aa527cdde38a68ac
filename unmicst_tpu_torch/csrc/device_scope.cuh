// The current device set to `device` for a host-side launch, and the
// previous one restored at the end of the scope.  When `device` already is
// current, no runtime call is made beyond one cudaGetDevice.
#pragma once
#include <cuda_runtime.h>

struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};
