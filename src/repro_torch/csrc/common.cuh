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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The tensor-core weight path of qmatmul.cu and qmlp.cu: quantized weights
// streamed in 16-byte loads, dequantized exactly to bf16 integer levels and
// multiplied with mma.sync m16n8k16 (bf16 in, f32 accumulate).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// D += A * B for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 f32. A's rows 8-15 (registers a1, a3) are zero here.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// The same product with all 16 rows of A: a0, a2 row g, a1, a3 row g + 8.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 weight bytes (an L1 no-allocate load measured the same).
__device__ __forceinline__ uint4 ldg16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element j of a 16-byte vector of T (4 f32 or 8 bf16), as f32.
template <typename T>
__device__ __forceinline__ float vec_elem(const uint4& u, int j);
template <>
__device__ __forceinline__ float vec_elem<float>(const uint4& u, int j) {
  return __uint_as_float(word(u, j));
}
template <>
__device__ __forceinline__ float vec_elem<__nv_bfloat16>(const uint4& u,
                                                         int j) {
  const uint32_t w = word(u, j >> 1);
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Byte b of ``u`` (an unsigned level) as the float 2^23 + u[b].
__device__ __forceinline__ float magic(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The MMA registers of step i (0..7) of a 128-element group: elements
// 4i .. 4i + 3 of a lane's 32 weight elements of one row (int8: two
// 16-byte chunks, the group's bytes 16q and 64 + 16q; int4: one, bytes 16q
// of the group's 64), as two bf16x2 words of exact levels (elements
// 4i, 4i + 1 and 4i + 2, 4i + 3). int4: low nibble = even element. Without
// integer-to-float conversions: a byte (or nibble) is permuted into the
// float 2^23 + u, one subtraction gives the level exactly (int8, int4 and
// ternary levels all fit bf16's 8-bit significand).
template <bool PACKED>
__device__ __forceinline__ void weights_of(const uint4 (&w)[2], int i,
                                           uint32_t& b0, uint32_t& b1) {
  if (PACKED) {
    const uint32_t u = word(w[0], i >> 1) ^ 0x88888888u;  // n -> n + 8
    const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
    const int b = 2 * (i & 1);
    b0 = pack_bf16(magic(lo, b) - 8388616.0f, magic(hi, b) - 8388616.0f);
    b1 = pack_bf16(magic(lo, b + 1) - 8388616.0f,
                   magic(hi, b + 1) - 8388616.0f);
  } else {
    const uint32_t u = word(w[i >> 2], i & 3) ^ 0x80808080u;  // b -> b + 128
    b0 = pack_bf16(magic(u, 0) - 8388736.0f, magic(u, 1) - 8388736.0f);
    b1 = pack_bf16(magic(u, 2) - 8388736.0f, magic(u, 3) - 8388736.0f);
  }
}

// Where logical 16-byte slot s of a staged row lies: bit 1 of the slot
// flipped in every other run of 8, so that the 8 lanes of a phase (two
// rows, four lanes each, rows padded by one slot) hit 8 different bank
// quads.
__device__ __forceinline__ int swz(int s) { return s ^ (((s >> 3) & 1) << 1); }
