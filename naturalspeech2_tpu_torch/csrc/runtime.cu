// Error names for the Python wrappers, which receive bare cudaError_t codes.
#include "common.cuh"

NS2_API const char* ns2_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
