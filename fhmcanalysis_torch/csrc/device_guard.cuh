// The calling thread's current CUDA device, set for one launch and put back.
//
// Each kernel's C entry point makes the tensors' device current before it
// launches (cudaSetDevice), so that the launch lands where its pointers
// live.  Left there, a launch on card k would make k the thread's current
// device for whatever the caller does next: a tensor made with an
// unindexed torch.device("cuda") after a shard of a mesh ran on card 1
// would land on card 1.  DeviceGuard reads the current device first and
// restores it when the entry point returns, on every return path.
#pragma once

#include <cuda_runtime.h>

namespace fhmc {

class DeviceGuard {
 public:
  // Makes `device` current; status() is the first error met, cudaSuccess if none.
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess) {
      restore_ = true;
      status_ = cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t status() const { return status_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t status_ = cudaSuccess;
};

}  // namespace fhmc
