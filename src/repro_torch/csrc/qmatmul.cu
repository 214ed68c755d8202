// Fused weight-dequant matmul for Hopper (W8A16 / W4A16 / ternary), and the
// fused QKV projection built on the same kernel.
//
// Replaces the TPU kernels ``qmatmul_pallas`` (src/repro/kernels/qmatmul/
// kernel.py:75) and ``qkv_pallas`` (kernel.py:223):
//
//     y[m, n] = sum_k x[m, k] * q[n, k] * s[n, k / G]      (f32 out)
//
// What bounds it on the H100: at decode M is the number of serving slots
// (1..16), so each weight byte feeds at most a handful of multiply-adds and
// the kernel is bound by the weight bytes over 3.35 TB/s. The TPU kernel ran
// only for M % 128 == 0 and never at decode.
//
// Design: weight streaming, GEMV-like. Each warp owns kRows output rows and
// walks K with 8-element steps per lane (8 bytes of int8 or 4 bytes of packed
// int4 per row), so a warp reads 256 contiguous K elements of each row per
// step and every weight byte is read from device memory exactly once per M
// tile. The (MT, K) activation tile is staged in shared memory as f32 one
// kChunk slice at a time and reused across the warp's rows. Dequantization
// happens in registers: the per-group partial dot of integer levels is
// scaled once by the bf16 group scale (G % 8 == 0, so a lane's 8 elements
// share one scale). M above 8 tiles into grid.y, re-reading the weights
// once per 8 rows (from L2 for all but the largest matrices): correct for
// prefill, and far from the tensor-core rate there. wgmma/TMA are later work.
//
// The fused QKV launch (repro_qkv) runs the same kernel over the
// concatenated Nq + Nk + Nv output rows; each row resolves which of the
// three weights and outputs it belongs to, so x is staged once per block
// for all three projections.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;      // output rows per warp
constexpr int kChunk = 1024;  // K elements of x staged per pass

struct Segs {
  const int8_t* w0; const int8_t* w1; const int8_t* w2;
  const __nv_bfloat16* s0; const __nv_bfloat16* s1; const __nv_bfloat16* s2;
  float* y0; float* y1; float* y2;
  int n0, n1, n2;
};

template <typename XT, bool PACKED, int MT>
__global__ void __launch_bounds__(kWarps * 32)
qgemv_kernel(const XT* __restrict__ x, int M, int K, int group, Segs seg) {
  __shared__ __align__(16) float xs[MT * kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int n_total = seg.n0 + seg.n1 + seg.n2;
  const int kbytes = PACKED ? K / 2 : K;
  const int ngroups = K / group;

  const int8_t* wrow[kRows];
  const __nv_bfloat16* srow[kRows];
  float* yout[kRows];
  int ystride[kRows];
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int n = (blockIdx.x * kWarps + warp) * kRows + r;
    live[r] = n < n_total;
    if (!live[r]) n = 0;  // read a valid row, never write it
    const int8_t* w = seg.w0; const __nv_bfloat16* s = seg.s0;
    float* y = seg.y0; int stride = seg.n0;
    if (n >= seg.n0 + seg.n1) {
      n -= seg.n0 + seg.n1; w = seg.w2; s = seg.s2; y = seg.y2; stride = seg.n2;
    } else if (n >= seg.n0) {
      n -= seg.n0; w = seg.w1; s = seg.s1; y = seg.y1; stride = seg.n1;
    }
    wrow[r] = w + (size_t)n * kbytes;
    srow[r] = s + (size_t)n * ngroups;
    yout[r] = y + n;
    ystride[r] = stride;
  }

  float acc[kRows][MT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int kc = 0; kc < K; kc += kChunk) {
    const int len = min(kChunk, K - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kChunk; i += blockDim.x) {
      const int m = i / kChunk, k = i - m * kChunk;
      xs[i] = (m < mt && k < len)
                  ? to_f32(x[(size_t)(m0 + m) * K + kc + k]) : 0.f;
    }
    __syncthreads();
    for (int k0 = lane * 8; k0 < len; k0 += 256) {
      const int kg = kc + k0;
      float q[kRows][8];
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        load8<PACKED>(wrow[r], kg, q[r]);
        s[r] = __bfloat162float(srow[r][kg / group]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[m * kChunk + k0]);
        const float4 b = *reinterpret_cast<const float4*>(&xs[m * kChunk + k0 + 4]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float p = q[r][0] * a.x;
          p = fmaf(q[r][1], a.y, p);
          p = fmaf(q[r][2], a.z, p);
          p = fmaf(q[r][3], a.w, p);
          p = fmaf(q[r][4], b.x, p);
          p = fmaf(q[r][5], b.y, p);
          p = fmaf(q[r][6], b.z, p);
          p = fmaf(q[r][7], b.w, p);
          acc[r][m] = fmaf(s[r], p, acc[r][m]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float v = warp_sum(acc[r][m]);
      if (lane == 0 && live[r] && m < mt)
        yout[r][(size_t)(m0 + m) * ystride[r]] = v;
    }
}

template <typename XT, bool PACKED>
void launch_mt(const void* x, int M, int K, int group, const Segs& seg,
               cudaStream_t stream) {
  const int n_total = seg.n0 + seg.n1 + seg.n2;
  const int rows_per_block = kWarps * kRows;
  const int gx = (n_total + rows_per_block - 1) / rows_per_block;
  const XT* xp = static_cast<const XT*>(x);
  const dim3 block(kWarps * 32);
  if (M <= 1) {
    qgemv_kernel<XT, PACKED, 1><<<dim3(gx, 1), block, 0, stream>>>(xp, M, K, group, seg);
  } else if (M <= 2) {
    qgemv_kernel<XT, PACKED, 2><<<dim3(gx, 1), block, 0, stream>>>(xp, M, K, group, seg);
  } else if (M <= 4) {
    qgemv_kernel<XT, PACKED, 4><<<dim3(gx, 1), block, 0, stream>>>(xp, M, K, group, seg);
  } else {
    qgemv_kernel<XT, PACKED, 8><<<dim3(gx, (M + 7) / 8), block, 0, stream>>>(xp, M, K, group, seg);
  }
}

int launch(const void* x, int x_bf16, int M, int K, int group, int packed,
           const Segs& seg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (packed) launch_mt<__nv_bfloat16, true>(x, M, K, group, seg, st);
    else launch_mt<__nv_bfloat16, false>(x, M, K, group, seg, st);
  } else {
    if (packed) launch_mt<float, true>(x, M, K, group, seg, st);
    else launch_mt<float, false>(x, M, K, group, seg, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y (M, N) f32 = x (M, K) . dequant(w (N, K_store), s (N, K / group))^T
REPRO_API int repro_qmatmul(const void* x, int x_bf16, int M, int K,
                            int group, int packed, const void* w,
                            const void* s, void* y, int N, void* stream) {
  Segs seg;
  seg.w0 = seg.w1 = seg.w2 = static_cast<const int8_t*>(w);
  seg.s0 = seg.s1 = seg.s2 = static_cast<const __nv_bfloat16*>(s);
  seg.y0 = seg.y1 = seg.y2 = static_cast<float*>(y);
  seg.n0 = N; seg.n1 = 0; seg.n2 = 0;
  return launch(x, x_bf16, M, K, group, packed, seg, stream);
}

// Three projections of one x in one launch: yq (M, Nq), yk (M, Nk),
// yv (M, Nv), all f32.
REPRO_API int repro_qkv(const void* x, int x_bf16, int M, int K, int group,
                        int packed, const void* wq, const void* sq, void* yq,
                        int nq, const void* wk, const void* sk, void* yk,
                        int nk, const void* wv, const void* sv, void* yv,
                        int nv, void* stream) {
  Segs seg;
  seg.w0 = static_cast<const int8_t*>(wq);
  seg.w1 = static_cast<const int8_t*>(wk);
  seg.w2 = static_cast<const int8_t*>(wv);
  seg.s0 = static_cast<const __nv_bfloat16*>(sq);
  seg.s1 = static_cast<const __nv_bfloat16*>(sk);
  seg.s2 = static_cast<const __nv_bfloat16*>(sv);
  seg.y0 = static_cast<float*>(yq);
  seg.y1 = static_cast<float*>(yk);
  seg.y2 = static_cast<float*>(yv);
  seg.n0 = nq; seg.n1 = nk; seg.n2 = nv;
  return launch(x, x_bf16, M, K, group, packed, seg, stream);
}
