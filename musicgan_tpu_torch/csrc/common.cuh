// Shared by every kernel library of the package.
#pragma once

#include <cuda_runtime.h>

// Asynchronous 4-byte copy from device memory to shared memory (cp.async):
// a thread issues all its copies of a tile without waiting on each load.
// With valid == false nothing is read and the shared word is set to 0, which
// is how the kernels mask halos and ragged edges.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The same for 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// The same, caching in L2 only (data that a block reads once).
__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Close the group of this thread's cp.async issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until every cp.async of this thread has landed (then __syncthreads()
// for the whole block's copies).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Each C entry point returns cudaGetLastError() after its launch, and the
// Python wrapper turns a non-zero code into an exception carrying this string.
extern "C" const char* mg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The same for 8 bytes (both addresses 8-byte aligned): four bf16 values.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
