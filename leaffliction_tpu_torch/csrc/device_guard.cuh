// Launching on a given device from the C entry points.
//
// Every launching entry point takes the device index of its tensors, and the
// Python wrappers pass it instead of entering `torch.cuda.device(...)` on
// every call (several microseconds of host time each): the entry point makes
// that device current only when it is not already, and restores the
// caller's device after the launch.

#pragma once

#include <cuda_runtime.h>

// Runs launch() (which returns a cudaError_t) with `device` current.
template <typename Launch>
inline int on_device(int device, Launch launch) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current == device) return (int)launch();
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaError_t launched = launch();
  err = cudaSetDevice(current);
  return (int)(launched != cudaSuccess ? launched : err);
}
