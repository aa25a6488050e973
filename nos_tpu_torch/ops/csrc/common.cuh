// Device helpers and the error-string export shared by the port's kernel
// sources (paged_attention.cu, flash_attention.cu, decode_attention.cu).
// Each source includes it and builds into its own library; ops/_build.py
// hashes this header with every source, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nos {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr int kMaxDevices = 64;

// The dtype codes of the launchers' interface (the wrappers' _DTYPE_CODE).
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// Eight consecutive elements (16 bytes of f32 or bf16, 8 of int8) as f32.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Opt `kernel` in to `smem` bytes of dynamic shared memory on the current
// device when that is more than it was last granted there (the attribute is
// per device; `granted` is the caller's per-kernel record). A size beyond
// the card's opt-in limit fails here, and the error is cleared so the next
// launch does not report it.
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t smem, size_t (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    granted[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace nos

extern "C" const char* nos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
