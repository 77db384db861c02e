// The current device of a kernel entry, restored on every return.
//
// A C entry runs on the device its tensors live on and is called from any host
// thread, whose current device is its own state (a serving engine issuing to
// several cards makes each current in turn). DeviceGuard makes `device` current for the
// entry's launches and gives the caller's device back when it goes out of
// scope, so that an entry leaves the thread as it found it.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;

  // Makes `device` current; returns the runtime's error, if any.
  cudaError_t set(int device) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return err;
    err = cudaSetDevice(device);
    if (err == cudaSuccess) prev = cur;
    return err;
  }

  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};
