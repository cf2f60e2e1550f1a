// The per-device shared-memory attribute of a kernel, shared by the sources
// whose kernels need more than 48 KB of dynamic shared memory.
//
// cudaFuncSetAttribute acts on the current device: a kernel's shared-memory
// attribute is set once per device, by the first launch there (so a launch
// inside a CUDA graph capture makes no such call). The launcher keeps one
// flag per device and makes the device current before it calls in.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

// Returns the error of cudaGetDevice or of the attribute call.
template <typename Kernel>
cudaError_t set_smem_once(bool (&configured)[kMaxDevices], Kernel kern,
                          int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (configured[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) configured[dev] = true;
    return err;
}
