// Group-wise absmax int8 quantization of a weight matrix, for Hopper:
//
//     scale[n, g] = max_{k in group g} |w[n, k]| / 127          (f32)
//     q[n, k]     = clamp(rint(w[n, k] / safe), -127, 127)      (int8)
//     safe        = scale == 0 ? 1 : scale
//
// Replaces the TPU kernel ``quantize_int8_pallas`` (src/repro/kernels/
// quantize/kernel.py:35). The payload and the f32 scales are bit-identical
// to the reference (``quantize_int8_ref``) and to the plain PyTorch
// version: every step is one correctly rounded f32 operation (true
// divisions, not multiplies by a reciprocal; no fast-math), and ``rintf``
// rounds half to even, as ``jnp.round`` does. The scales are f32, unlike
// the bf16 scales of the serve path's QTensor (quant/quantize.py), so this
// kernel replaces nothing on the serve path.
//
// What bounds it on the H100: one read of w (2 or 4 bytes an element) and
// one write of the payload (1 byte) and scales over 3.35 TB/s.
//
// Design: the TPU kernel tiled (BN, BK) blocks into VMEM. Here the matrix
// is read as a flat run of 16-byte vectors (8 bf16 or 4 f32); since
// K % group == 0, every group is a run of whole vectors. Each lane loads
// one vector once and keeps it in registers; a group of G vectors
// (G = 1 .. 32, a power of two: 16 lanes for a bf16 group of 128, 32 for
// f32) is owned by G neighbouring lanes, which reduce its absmax by
// shuffles, quantize from their registers and store each vector's 8 (or
// 4) int8 in one store; the group's first lane writes the scale. The
// kernel needs about 24 registers, so an SM holds 8 blocks (2048 lanes,
// each with its vector in flight); on an H100 this read faster than 2
// or 4 vectors a lane (PERF.md section 6). What this path cannot take (a
// group that is not a whole number of vectors, a G that is not a power of
// two or is over 32, or a w or q base that is not aligned) goes to the
// warp-per-group kernel: one warp strides one (row, group) twice, for the
// absmax and to quantize.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t level(float x, float safe) {
  const float v = rintf(x / safe);
  return (int8_t)fminf(fmaxf(v, -127.f), 127.f);
}

// One 16-byte vector a lane; a group is ``lanes`` neighbouring lanes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_vec_kernel(const T* __restrict__ w, size_t nvec, int lanes,
                    int group, int8_t* __restrict__ q,
                    float* __restrict__ scale) {
  constexpr int kPer = 16 / sizeof(T);
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  uint4 u = make_uint4(0, 0, 0, 0);
  float amax = 0.f;
  if (i < nvec) {
    u = __ldg(reinterpret_cast<const uint4*>(w) + i);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      amax = fmaxf(amax, fabsf(vec_elem<T>(u, j)));
  }
  for (int o = lanes >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (i >= nvec) return;
  const float s = amax / 127.0f;
  const float safe = s == 0.f ? 1.f : s;
  uint32_t b[kPer / 4];
#pragma unroll
  for (int j = 0; j < kPer / 4; ++j)
    b[j] = (uint32_t)(uint8_t)level(vec_elem<T>(u, 4 * j), safe) |
           (uint32_t)(uint8_t)level(vec_elem<T>(u, 4 * j + 1), safe) << 8 |
           (uint32_t)(uint8_t)level(vec_elem<T>(u, 4 * j + 2), safe) << 16 |
           (uint32_t)(uint8_t)level(vec_elem<T>(u, 4 * j + 3), safe) << 24;
  if constexpr (kPer == 8)
    *reinterpret_cast<uint2*>(q + i * kPer) = make_uint2(b[0], b[1]);
  else
    *reinterpret_cast<uint32_t*>(q + i * kPer) = b[0];
  if (threadIdx.x % lanes == 0) scale[i * kPer / group] = s;
}

// The fallback: one warp owns one (row, group).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_group_kernel(const T* __restrict__ w, int N, int K, int group,
                      int8_t* __restrict__ q, float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x;
  const int n = blockIdx.y * (kThreads / 32) + warp;
  if (n >= N) return;
  const size_t base = (size_t)n * K + (size_t)g * group;
  float amax = 0.f;
  for (int e = lane; e < group; e += 32)
    amax = fmaxf(amax, fabsf(to_f32(w[base + e])));
  amax = warp_max(amax);
  const float s = amax / 127.0f;
  const float safe = s == 0.f ? 1.f : s;
  for (int e = lane; e < group; e += 32)
    q[base + e] = level(to_f32(w[base + e]), safe);
  if (lane == 0) scale[(size_t)n * (K / group) + g] = s;
}

template <typename T>
int launch(const void* w, int N, int K, int group, int8_t* q, float* s,
           cudaStream_t st) {
  constexpr int kPer = 16 / sizeof(T);
  const int lanes = group / kPer;  // vectors (lanes) a group
  const bool aligned = (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(q) & (kPer - 1)) == 0;
  if (aligned && group % kPer == 0 && lanes <= 32 &&
      (lanes & (lanes - 1)) == 0) {
    const size_t nvec = (size_t)N * K / kPer;
    const size_t blocks = (nvec + kThreads - 1) / kThreads;
    quantize_vec_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(w), nvec, lanes, group, q, s);
  } else {
    const dim3 grid(K / group, (N + kThreads / 32 - 1) / (kThreads / 32));
    quantize_group_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(w), N, K, group, q, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// w: (N, K) bf16 (w_bf16 = 1) or f32, row-major; K % group == 0.
// q: (N, K) int8; scale: (N, K / group) f32.
REPRO_API int repro_quantize_int8(const void* w, int w_bf16, int N, int K,
                                  int group, void* q, void* scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  if (w_bf16) return launch<__nv_bfloat16>(w, N, K, group, qp, sp, st);
  return launch<float>(w, N, K, group, qp, sp, st);
}
