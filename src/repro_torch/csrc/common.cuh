// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library built from this directory has a plain C interface:
// pointers and the CUDA stream arrive as void*, and each entry point returns
// cudaGetLastError() right after its launch so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One signed 4-bit nibble of a weight byte (two's complement, [-8, 7]).
// ``v`` is the byte sign-extended to int: the low nibble sign-extends with
// xor/sub, the high nibble with an arithmetic right shift.
__device__ __forceinline__ int nib_lo(int v) { return ((v & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int nib_hi(int v) { return v >> 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Eight consecutive quantized weights along K, starting at element ``k0``
// (a multiple of 8) of one weight row. int8 and ternary rows hold one byte
// per element; packed int4 rows hold two elements per byte, low nibble =
// even element (quant/quantize.py). Returns the raw integer levels.
template <bool PACKED>
__device__ __forceinline__ void load8(const int8_t* __restrict__ row, int k0,
                                      float (&q)[8]) {
  if (PACKED) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row + k0 / 2));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = (int)(int8_t)((w >> (8 * j)) & 0xFF);
      q[2 * j] = (float)nib_lo(v);
      q[2 * j + 1] = (float)nib_hi(v);
    }
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + k0));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = (float)(int8_t)((w.x >> (8 * j)) & 0xFF);
      q[4 + j] = (float)(int8_t)((w.y >> (8 * j)) & 0xFF);
    }
  }
}
