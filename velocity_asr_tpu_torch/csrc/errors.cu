// Error text for the codes the kernel launchers return (see ops/cuda_lib.py).

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
