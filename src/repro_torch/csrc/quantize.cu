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
// Design: the TPU kernel tiled (BN, BK) blocks into VMEM. Here one warp
// owns one (row, group): its lanes stride the group for the absmax (warp
// reduction), then stride it again to quantize (the second read hits L1).
// A block of kWarps warps covers kWarps rows of one group column; the grid
// is (groups, row tiles).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
quantize_int8_kernel(const T* __restrict__ w, int N, int K, int group,
                     int8_t* __restrict__ q, float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x;
  const int n = blockIdx.y * kWarps + warp;
  if (n >= N) return;
  const size_t base = (size_t)n * K + (size_t)g * group;
  float amax = 0.f;
  for (int e = lane; e < group; e += 32)
    amax = fmaxf(amax, fabsf(to_f32(w[base + e])));
  amax = warp_max(amax);
  const float s = amax / 127.0f;
  const float safe = s == 0.f ? 1.f : s;
  for (int e = lane; e < group; e += 32) {
    const float v = rintf(to_f32(w[base + e]) / safe);
    q[base + e] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (lane == 0) scale[(size_t)n * (K / group) + g] = s;
}

template <typename T>
int launch(const void* w, int N, int K, int group, int8_t* q, float* s,
           cudaStream_t st) {
  const dim3 grid(K / group, (N + kWarps - 1) / kWarps);
  quantize_int8_kernel<T><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(w), N, K, group, q, s);
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
