// The name of a CUDA error code, for the ctypes loader: every library built
// from csrc/ exports it, and a launch entry point's non-zero return is
// reported through it (kernels/_build.py::check).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* usec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
