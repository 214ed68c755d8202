// Fused quantized MLP for Hopper, in its two forms:
//
//     swiglu:  y = (silu(x . Wg^T) * (x . Wu^T)) . Wd^T         (f32 out)
//     gelu:    y = gelu(x . Wu^T) . Wd^T                        (f32 out)
//
// Replaces the TPU kernel ``qmlp_pallas`` (src/repro/kernels/qmatmul/
// kernel.py:143) in both forms (``act``, kernel.py:132): the llama family's
// SwiGLU and whisper's GeLU (tanh form, ``jax.nn.gelu``'s default). All
// weights share one (precision, group) per launch, as on the TPU; the gelu
// form has no gate weight (kernel.py:165-166) and reads only up and down.
//
// What bounds it on the H100: at decode the weight matrices (3 * D * FF
// elements for swiglu, 2 * D * FF for gelu; int8 or packed int4) over
// 3.35 TB/s. The (M, FF) hidden activation must not reach device memory.
//
// Design: the TPU kernel carried one (BM, D) accumulator across FF grid
// steps in order. Hopper blocks run in no fixed order, so instead:
//   * each block owns one kBF-row tile of FF (and up to 8 rows of x); it
//     streams its gate and up rows (up rows only for gelu) GEMV-style (as
//     qmatmul.cu does), forms h = silu(g) * u or gelu(u) for its tile in
//     shared memory (f32), and
//   * multiplies that h tile by the matching kBF columns of Wd into an f32
//     partial buffer (n_tiles, M, D);
//   * a second small kernel sums the partials over tiles in a fixed order.
// No atomics: the result does not depend on block scheduling, so greedy
// serving output is the same from run to run. Only the (n_tiles, M, D)
// partials reach memory, never the (M, FF) hidden. h stays f32 between the
// two products, as on the TPU (the plain PyTorch version rounds the
// activation to x's dtype, as the JAX fallback does; the difference is
// inside the stated tolerance). The up product contracts over K (x staged
// kChunk elements at a time) and the down product over FF, one kBF tile per
// block, so K and FF need not match (whisper: K = 1024, FF = 4096). M above
// 8 tiles into grid.y and re-reads the weights once per 8 rows (the
// encoder's M = 1500: 188 tiles), and the partials grow with M: correct for
// prefill, far from the tensor-core rate there (later work).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBF = 64;      // FF rows per block
constexpr int kFR = 2;       // FF rows per warp per pass (gate + up rows)
constexpr int kChunk = 1024; // K elements of x staged per pass

// 0.5 u (1 + tanh(sqrt(2 / pi) (u + 0.044715 u^3))), jax.nn.gelu's default
__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
}

template <typename XT, bool PACKED, bool GELU, int MT>
__global__ void __launch_bounds__(kWarps * 32)
qmlp_tile_kernel(const XT* __restrict__ x, int M, int K, int FF, int D,
                 int group, const int8_t* __restrict__ gw,
                 const __nv_bfloat16* __restrict__ gs,
                 const int8_t* __restrict__ uw,
                 const __nv_bfloat16* __restrict__ us,
                 const int8_t* __restrict__ dw,
                 const __nv_bfloat16* __restrict__ ds,
                 float* __restrict__ partial) {
  __shared__ __align__(16) float xs[MT * kChunk];
  __shared__ __align__(16) float hs[MT * kBF];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x;
  const int f_base = tile * kBF;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int kbytes = PACKED ? K / 2 : K;
  const int ngk = K / group;
  // weight rows per warp per pass: kFR up rows, and as many gate rows for
  // swiglu (rows [0, kFR) gate, [kFR, 2 kFR) up; gelu: [0, kFR) up)
  constexpr int NR = (GELU ? 1 : 2) * kFR;
  constexpr int UP = GELU ? 0 : kFR;

  // ---- phase 1: h = silu(x Wg^T) * (x Wu^T) or gelu(x Wu^T), this tile ---
  for (int it = 0; it < kBF / (kWarps * kFR); ++it) {
    int fl[kFR];
    bool live[kFR];
    const int8_t* wr[NR];
    const __nv_bfloat16* sr[NR];
#pragma unroll
    for (int j = 0; j < kFR; ++j) {
      fl[j] = it * kWarps * kFR + warp * kFR + j;
      int f = f_base + fl[j];
      live[j] = f < FF;
      if (!live[j]) f = 0;
      if (!GELU) {
        wr[j] = gw + (size_t)f * kbytes;
        sr[j] = gs + (size_t)f * ngk;
      }
      wr[UP + j] = uw + (size_t)f * kbytes;
      sr[UP + j] = us + (size_t)f * ngk;
    }
    float acc[NR][MT];
#pragma unroll
    for (int r = 0; r < NR; ++r)
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
        float q[NR][8];
        float s[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          load8<PACKED>(wr[r], kg, q[r]);
          s[r] = __bfloat162float(sr[r][kg / group]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 a = *reinterpret_cast<const float4*>(&xs[m * kChunk + k0]);
          const float4 b = *reinterpret_cast<const float4*>(&xs[m * kChunk + k0 + 4]);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
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
    for (int j = 0; j < kFR; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float u = warp_sum(acc[UP + j][m]);
        float h;
        if (GELU) {
          h = gelu_tanh(u);
        } else {
          const float g = warp_sum(acc[j][m]);
          h = g / (1.f + expf(-g)) * u;
        }
        if (lane == 0) hs[m * kBF + fl[j]] = (live[j] && m < mt) ? h : 0.f;
      }
  }
  __syncthreads();

  // ---- phase 2: partial[tile, m, d] = sum_f h[m, f] * Wd[d, f] ----------
  const int sub = lane & 7;    // 8 lanes per down row, 8 FF elements each
  const int dsel = lane >> 3;  // 4 down rows per warp step
  const int fl0 = sub * 8;
  const int f0 = f_base + fl0;
  const bool flive = f0 < FF;
  float h[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) h[m][i] = hs[m * kBF + fl0 + i];
  const int fbytes = PACKED ? FF / 2 : FF;
  const int ngf = FF / group;
  for (int dd = warp * 4; dd < D; dd += kWarps * 4) {
    const int d = dd + dsel;
    float val[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) val[m] = 0.f;
    if (d < D && flive) {
      float q[8];
      load8<PACKED>(dw + (size_t)d * fbytes, f0, q);
      const float s = __bfloat162float(ds[(size_t)d * ngf + f0 / group]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float p = q[0] * h[m][0];
#pragma unroll
        for (int i = 1; i < 8; ++i) p = fmaf(q[i], h[m][i], p);
        val[m] = s * p;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v = val[m];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (sub == 0 && d < D && m < mt)
        partial[((size_t)tile * M + m0 + m) * D + d] = v;
    }
  }
}

// out[i] = sum over tiles of partial[t, i], in tile order (deterministic).
__global__ void qmlp_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int n_tiles,
                                   long long md) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= md) return;
  float a = 0.f;
  for (int t = 0; t < n_tiles; ++t) a += partial[(size_t)t * md + i];
  out[i] = a;
}

template <typename XT, bool PACKED, bool GELU>
void launch_tiles(const void* x, int M, int K, int FF, int D, int group,
                  const int8_t* gw, const __nv_bfloat16* gs, const int8_t* uw,
                  const __nv_bfloat16* us, const int8_t* dw,
                  const __nv_bfloat16* ds, float* partial, cudaStream_t st) {
  const int n_tiles = (FF + kBF - 1) / kBF;
  const XT* xp = static_cast<const XT*>(x);
  const dim3 block(kWarps * 32);
  if (M <= 1) {
    qmlp_tile_kernel<XT, PACKED, GELU, 1><<<dim3(n_tiles, 1), block, 0, st>>>(
        xp, M, K, FF, D, group, gw, gs, uw, us, dw, ds, partial);
  } else if (M <= 2) {
    qmlp_tile_kernel<XT, PACKED, GELU, 2><<<dim3(n_tiles, 1), block, 0, st>>>(
        xp, M, K, FF, D, group, gw, gs, uw, us, dw, ds, partial);
  } else if (M <= 4) {
    qmlp_tile_kernel<XT, PACKED, GELU, 4><<<dim3(n_tiles, 1), block, 0, st>>>(
        xp, M, K, FF, D, group, gw, gs, uw, us, dw, ds, partial);
  } else {
    qmlp_tile_kernel<XT, PACKED, GELU, 8><<<dim3(n_tiles, (M + 7) / 8), block, 0, st>>>(
        xp, M, K, FF, D, group, gw, gs, uw, us, dw, ds, partial);
  }
}

}  // namespace

// Number of FF tiles, i.e. the leading dimension of the partial buffer the
// caller allocates as (n_tiles, M, D) f32.
REPRO_API int repro_qmlp_tiles(int FF) { return (FF + kBF - 1) / kBF; }

// gelu = 1: the gelu form (gw, gs ignored, may be null); 0: swiglu.
REPRO_API int repro_qmlp(const void* x, int x_bf16, int M, int K, int FF,
                         int D, int group, int packed, int gelu, const void* gw,
                         const void* gs, const void* uw, const void* us,
                         const void* dw, const void* ds, void* partial,
                         void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* g = static_cast<const int8_t*>(gw);
  const int8_t* u = static_cast<const int8_t*>(uw);
  const int8_t* d = static_cast<const int8_t*>(dw);
  const __nv_bfloat16* gsc = static_cast<const __nv_bfloat16*>(gs);
  const __nv_bfloat16* usc = static_cast<const __nv_bfloat16*>(us);
  const __nv_bfloat16* dsc = static_cast<const __nv_bfloat16*>(ds);
  float* part = static_cast<float*>(partial);
  auto tiles = gelu ? (x_bf16 ? (packed ? launch_tiles<__nv_bfloat16, true, true>
                                          : launch_tiles<__nv_bfloat16, false, true>)
                             : (packed ? launch_tiles<float, true, true>
                                       : launch_tiles<float, false, true>))
                    : (x_bf16 ? (packed ? launch_tiles<__nv_bfloat16, true, false>
                                        : launch_tiles<__nv_bfloat16, false, false>)
                              : (packed ? launch_tiles<float, true, false>
                                        : launch_tiles<float, false, false>));
  tiles(x, M, K, FF, D, group, g, gsc, u, usc, d, dsc, part, st);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long md = (long long)M * D;
  const int threads = 256;
  const unsigned blocks = (unsigned)((md + threads - 1) / threads);
  qmlp_reduce_kernel<<<blocks, threads, 0, st>>>(part, static_cast<float*>(out),
                                                 (FF + kBF - 1) / kBF, md);
  return (int)cudaGetLastError();
}
