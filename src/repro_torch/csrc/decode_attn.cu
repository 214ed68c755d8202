// Single-query GQA decode attention over a quantized KV cache, for Hopper.
//
// Replaces the dense, single-query, causal form of the TPU kernel
// ``decode_attn_pallas`` (src/repro/kernels/decode_attn/kernel.py:162):
//
//   out[b, h, r] = softmax_t(q[b, h, r] . K[b, t, h] / sqrt(hd)) . V[b, t, h]
//
// over the rows t < valid_len[b]. K/V pages hold int8, split-half packed
// int4 (byte j of a row holds flat elements j and j + F/2, F = Hkv * hd;
// src/repro/quant/kvcache.py:236-253) with one bf16 scale per ``group``
// elements of the flat F axis, or bf16 with no scale.
//
// What bounds it on the H100: the cache bytes of the valid rows over
// 3.35 TB/s (each K/V byte feeds a few multiply-adds per query row).
//
// Design: one block per (slot, KV head) holds that head's ``rep`` query rows
// in shared memory and loops only over the slot's valid rows, kTile at a
// time: dequantize the K and V tile of its head into shared memory (f32),
// score the rep x kTile block, run an online softmax in f32 (one warp per
// query row, kTile == warp size), and accumulate P.V. Rows past valid_len
// are never read, so a slot with valid_len 0 writes 0 (acc 0 over
// max(l, 1e-30), as the TPU kernel gives with its V rows zeroed). B x Hkv
// is only 64 blocks at 8 slots and 8 KV heads on 132 SMs; splitting the KV
// range across blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;   // KV rows per step == warp size (softmax lanes)
constexpr float kNegInf = -1e30f;

template <int PREC>  // 0: int8, 1: split-half int4, 2: bf16
__device__ __forceinline__ float kv_elem(const void* data,
                                         const __nv_bfloat16* scale,
                                         size_t row, int F, int group, int e) {
  if (PREC == 2) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(data)[row * F + e]);
  }
  const float s = __bfloat162float(scale[row * (F / group) + e / group]);
  const int8_t* d = static_cast<const int8_t*>(data);
  if (PREC == 0) return (float)d[row * F + e] * s;
  const int half = F / 2;
  const int v = (int)d[row * half + (e < half ? e : e - half)];
  return (float)(e < half ? nib_lo(v) : nib_hi(v)) * s;
}

template <int PREC>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ kd,
                   const __nv_bfloat16* __restrict__ ks,
                   const void* __restrict__ vd,
                   const __nv_bfloat16* __restrict__ vs,
                   const int* __restrict__ valid, float* __restrict__ out,
                   int S, int Hkv, int rep, int hd, int group,
                   float inv_sqrt) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // rep * hd
  float* Ks = qs + rep * hd;                 // kTile * (hd + 1), padded rows
  float* Vs = Ks + kTile * (hd + 1);         // kTile * hd
  float* ps = Vs + kTile * hd;               // rep * kTile
  float* acc = ps + rep * kTile;             // rep * hd
  float* m_s = acc + rep * hd;               // rep
  float* l_s = m_s + rep;                    // rep
  float* c_s = l_s + rep;                    // rep

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = kThreads / 32;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int F = Hkv * hd;
  int vl = valid[b];
  vl = vl < 0 ? 0 : (vl > S ? S : vl);
  const size_t qbase = ((size_t)b * Hkv + h) * rep * hd;

  for (int i = tid; i < rep * hd; i += kThreads) {
    qs[i] = q[qbase + i];
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int t0 = 0; t0 < vl; t0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      const int row = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (row < vl) {
        const size_t grow = (size_t)b * S + row;
        const int e = h * hd + d;
        kv = kv_elem<PREC>(kd, ks, grow, F, group, e);
        vv = kv_elem<PREC>(vd, vs, grow, F, group, e);
      }
      Ks[t * (hd + 1) + d] = kv;
      Vs[t * hd + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < rep * kTile; i += kThreads) {
      const int r = i / kTile, t = i - r * kTile;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qs[r * hd + d], Ks[t * (hd + 1) + d], s);
      ps[i] = (t0 + t < vl) ? s * inv_sqrt : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += nwarps) {
      const float s = ps[r * kTile + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      ps[r * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float a = acc[i] * c_s[r];
      for (int t = 0; t < kTile; ++t) a = fmaf(ps[r * kTile + t], Vs[t * hd + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd;
    out[qbase + i] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

}  // namespace

REPRO_API int repro_decode_attn_smem(int rep, int hd) {
  return (int)sizeof(float) *
         (rep * hd + kTile * (hd + 1) + kTile * hd + rep * kTile + rep * hd +
          3 * rep);
}

// q (B, Hkv, rep, hd) f32; K/V data (B, S, F_store) with scales
// (B, S, F / group) bf16 (ignored for bf16 pages); valid (B,) int32;
// out (B, Hkv, rep, hd) f32. prec: 0 int8, 1 int4, 2 bf16.
REPRO_API int repro_decode_attn(const void* q, const void* kd, const void* ks,
                                const void* vd, const void* vs,
                                const void* valid, void* out, int B, int S,
                                int Hkv, int rep, int hd, int group, int prec,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = repro_decode_attn_smem(rep, hd);
  const float inv_sqrt = 1.0f / sqrtf((float)hd);
  const dim3 grid(B * Hkv);
  const float* qp = static_cast<const float*>(q);
  const __nv_bfloat16* ksp = static_cast<const __nv_bfloat16*>(ks);
  const __nv_bfloat16* vsp = static_cast<const __nv_bfloat16*>(vs);
  const int* vp = static_cast<const int*>(valid);
  float* op = static_cast<float*>(out);
  if (prec == 0) {
    decode_attn_kernel<0><<<grid, kThreads, smem, st>>>(
        qp, kd, ksp, vd, vsp, vp, op, S, Hkv, rep, hd, group, inv_sqrt);
  } else if (prec == 1) {
    decode_attn_kernel<1><<<grid, kThreads, smem, st>>>(
        qp, kd, ksp, vd, vsp, vp, op, S, Hkv, rep, hd, group, inv_sqrt);
  } else {
    decode_attn_kernel<2><<<grid, kThreads, smem, st>>>(
        qp, kd, ksp, vd, vsp, vp, op, S, Hkv, rep, hd, group, inv_sqrt);
  }
  return (int)cudaGetLastError();
}
