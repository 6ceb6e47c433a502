// Shared helpers for the hiprfish_tpu_torch CUDA kernels (plain C ABI,
// loaded with ctypes; see kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

#define HF_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int hf_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
