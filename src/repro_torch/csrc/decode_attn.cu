// Multi-query GQA decode attention over a quantized KV cache, for Hopper.
//
// Replaces the TPU kernel ``decode_attn_pallas``
// (src/repro/kernels/decode_attn/kernel.py:162) in all its forms: the
// single-query decode step, the multi-query window of a speculative verify
// (qs = K+1 queries per slot, causal offsets or causal=False;
// kernel.py:94-99), the fresh-row epilogue of the fused draft propose
// (kernel.py:129-151), and the paged cache (kernel.py:203-260), each of the
// first three over a dense or a paged cache:
//
//   out[b, h, r, i] = softmax_t(q[b, h, r, i] . K[b, t, h] / sqrt(hd))
//                     . V[b, t, h]
//
// Query i of the qs queries of a slot sees ``limit_i = valid - qs + 1 + i``
// rows when causal, ``valid`` rows when not. With fresh rows, cache rows at
// positions >= base are stale: the cache part ends at ``min(limit_i,
// base)``, and fresh row j, at logical position base + j, is seen when
// base + j < limit_i. K/V pages (and the fresh rows, already quantized with
// the page's write math) hold int8, split-half packed int4 (byte j of a
// row holds flat elements j and j + F/2, F = Hkv * hd;
// src/repro/quant/kvcache.py:236-253) with one bf16 scale per ``group``
// elements of the flat F axis, or bf16 with no scale.
//
// Dense and paged caches differ only in where logical row t of slot b lives:
// row b * S + t of the dense (B, S, F_store) page, or row
// table[b, t / P] * P + t % P of the (N, P, F_store) pool, where the slot's
// (n_log,) int32 table maps logical pages to physical ones (page 0 is the
// dump page, never read below valid) and S = n_log * P. Each tile looks its
// rows up once (K and V through their own tables) into shared memory; P
// need not divide the tile. A page is not a grid step, as it is on the TPU:
// the block keeps walking rows, so the arithmetic, and the result, is the
// dense kernel's to the bit on the same rows.
//
// What bounds it on the H100: the cache bytes of the rows the queries see
// (plus the tables) over 3.35 TB/s. A window reuses each K/V row for
// rep * qs query rows (15 at rep 3, qs 5), still far below the point where
// arithmetic would bound.
//
// Design: one block per (slot, KV head) holds that head's rep * qs query
// rows in shared memory and loops over the cache rows any of its queries
// sees, kTile at a time: dequantize the K and V tile of its head into
// shared memory (f32), score the (rep * qs) x kTile block, run an online
// softmax in f32 (one warp per query row, kTile == warp size), and
// accumulate P.V. The fresh rows (at most kTile) are one more tile of the
// same online softmax. A masked score contributes probability exactly 0,
// so a query that sees no row writes 0 (acc 0 over max(l, 1e-30)), as the
// TPU kernel does for a slot with valid_len 0. Past 48 KB the launcher opts
// the instantiation into more dynamic shared memory. B x Hkv is only 64
// blocks at 8 slots and 8 KV heads on 132 SMs; splitting the KV range
// across blocks (flash-decoding) is later work.
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

struct Smem {
  long long* krow;  // kTile     K row of each tile row in the flat source
  long long* vrow;  // kTile     V row of each tile row in the flat source
  float* q;     // R * hd        query rows
  float* K;     // kTile * (hd + 1), padded rows
  float* V;     // kTile * hd
  float* p;     // R * kTile     scores, then probabilities
  float* acc;   // R * hd
  float* m;     // R
  float* l;     // R
  float* c;     // R             rescale of this tile
  int* lim;     // R             rows a query row sees in the current tile source
};

// One tile of the online softmax: rows j < nrows of a K/V source at
// logical position pos0 + j, stored at flat row grow0 + j of a dense
// source, or, when ``ktab`` is given (the slot's K and V page tables),
// at row tab[pos / P] * P + pos % P of a pool. A row is read when its
// position is < valid (else K = V = 0) and seen by query row r when its
// position is < sm.lim[r].
template <int PREC>
__device__ __forceinline__ void attend_tile(
    const Smem& sm, const void* kd, const __nv_bfloat16* ks, const void* vd,
    const __nv_bfloat16* vs, const int* ktab, const int* vtab, int P,
    size_t grow0, int nrows, int pos0, int valid, int F, int h, int R, int hd,
    int group, float inv_sqrt) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = kThreads / 32;
  __syncthreads();
  if (tid < nrows) {
    const int pos = pos0 + tid;
    if (ktab != nullptr) {
      sm.krow[tid] = (long long)ktab[pos / P] * P + pos % P;
      sm.vrow[tid] = (long long)vtab[pos / P] * P + pos % P;
    } else {
      sm.krow[tid] = sm.vrow[tid] = (long long)(grow0 + tid);
    }
  }
  __syncthreads();
  for (int i = tid; i < kTile * hd; i += kThreads) {
    const int t = i / hd, d = i - t * hd;
    float kv = 0.f, vv = 0.f;
    if (t < nrows && pos0 + t < valid) {
      const int e = h * hd + d;
      kv = kv_elem<PREC>(kd, ks, (size_t)sm.krow[t], F, group, e);
      vv = kv_elem<PREC>(vd, vs, (size_t)sm.vrow[t], F, group, e);
    }
    sm.K[t * (hd + 1) + d] = kv;
    sm.V[t * hd + d] = vv;
  }
  __syncthreads();
  for (int i = tid; i < R * kTile; i += kThreads) {
    const int r = i / kTile, t = i - r * kTile;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(sm.q[r * hd + d], sm.K[t * (hd + 1) + d], s);
    sm.p[i] = (t < nrows && pos0 + t < sm.lim[r]) ? s * inv_sqrt : kNegInf;
  }
  __syncthreads();
  for (int r = warp; r < R; r += nwarps) {
    const float s = sm.p[r * kTile + lane];
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, warp_max(s));
    const float p = (lane < nrows && pos0 + lane < sm.lim[r]) ? expf(s - m_new) : 0.f;
    const float sum = warp_sum(p);
    sm.p[r * kTile + lane] = p;
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      sm.c[r] = corr;
      sm.l[r] = sm.l[r] * corr + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float a = sm.acc[i] * sm.c[r];
    for (int t = 0; t < kTile; ++t) a = fmaf(sm.p[r * kTile + t], sm.V[t * hd + d], a);
    sm.acc[i] = a;
  }
}

template <int PREC>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ kd,
                   const __nv_bfloat16* __restrict__ ks,
                   const void* __restrict__ vd,
                   const __nv_bfloat16* __restrict__ vs,
                   const int* __restrict__ valid_len,
                   const int* __restrict__ ktable,
                   const int* __restrict__ vtable,
                   const void* __restrict__ fkd,
                   const __nv_bfloat16* __restrict__ fks,
                   const void* __restrict__ fvd,
                   const __nv_bfloat16* __restrict__ fvs,
                   const int* __restrict__ base_pos, float* __restrict__ out,
                   int S, int P, int n_log, int Hkv, int rep, int qs,
                   int hd, int group, int causal, int Sf, float inv_sqrt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = rep * qs;
  Smem sm;
  sm.krow = reinterpret_cast<long long*>(smem_raw);
  sm.vrow = sm.krow + kTile;
  sm.q = reinterpret_cast<float*>(sm.vrow + kTile);
  sm.K = sm.q + R * hd;
  sm.V = sm.K + kTile * (hd + 1);
  sm.p = sm.V + kTile * hd;
  sm.acc = sm.p + R * kTile;
  sm.m = sm.acc + R * hd;
  sm.l = sm.m + R;
  sm.c = sm.l + R;
  sm.lim = reinterpret_cast<int*>(sm.c + R);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int F = Hkv * hd;
  const int valid = valid_len[b];
  const int base = Sf > 0 ? base_pos[b] : valid;
  // a pool's logical rows go through the slot's page tables
  const int* ktab = ktable != nullptr ? ktable + (size_t)b * n_log : nullptr;
  const int* vtab = vtable != nullptr ? vtable + (size_t)b * n_log : nullptr;
  const size_t qbase = ((size_t)b * Hkv + h) * R * hd;

  // query row r is query i = r % qs of head-group row r / qs
  for (int i = tid; i < R * hd; i += kThreads) {
    sm.q[i] = q[qbase + i];
    sm.acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    const int limit = causal ? valid - qs + 1 + r % qs : valid;
    sm.lim[r] = limit < base ? limit : base;   // cache rows past base are stale
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
  int end = valid < base ? valid : base;
  end = end < 0 ? 0 : (end > S ? S : end);
  for (int t0 = 0; t0 < end; t0 += kTile) {
    const int n = end - t0 < kTile ? end - t0 : kTile;
    attend_tile<PREC>(sm, kd, ks, vd, vs, ktab, vtab, P, (size_t)b * S + t0,
                      n, t0, valid, F, h, R, hd, group, inv_sqrt);
  }
  if (Sf > 0) {
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      sm.lim[r] = causal ? valid - qs + 1 + r % qs : valid;
    }
    attend_tile<PREC>(sm, fkd, fks, fvd, fvs, nullptr, nullptr, 1,
                      (size_t)b * Sf, Sf, base, valid, F, h, R, hd, group,
                      inv_sqrt);
  }
  __syncthreads();
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd;
    out[qbase + i] = sm.acc[i] / fmaxf(sm.l[r], 1e-30f);
  }
}

template <int PREC>
int launch(const dim3 grid, int smem, cudaStream_t st, const float* q,
           const void* kd, const __nv_bfloat16* ks, const void* vd,
           const __nv_bfloat16* vs, const int* valid, const int* ktable,
           const int* vtable, const void* fkd, const __nv_bfloat16* fks,
           const void* fvd, const __nv_bfloat16* fvs, const int* base,
           float* out, int S, int P, int n_log, int Hkv, int rep, int qs,
           int hd, int group, int causal, int Sf, float inv_sqrt) {
  // past 48 KB a block needs the instantiation's opt-in, set once (not per
  // launch, so a launch can be captured in a CUDA graph)
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<PREC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  decode_attn_kernel<PREC><<<grid, kThreads, smem, st>>>(
      q, kd, ks, vd, vs, valid, ktable, vtable, fkd, fks, fvd, fvs, base, out,
      S, P, n_log, Hkv, rep, qs, hd, group, causal, Sf, inv_sqrt);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for ``rows`` = rep * qs query rows.
REPRO_API int repro_decode_attn_smem(int rows, int hd) {
  return (int)sizeof(long long) * 2 * kTile +
         (int)sizeof(float) *
             (rows * hd + kTile * (hd + 1) + kTile * hd + rows * kTile +
              rows * hd + 4 * rows);
}

// q (B, Hkv, rep, qs, hd) f32; a dense cache (n_log == 0): K/V data
// (B, S, F_store) with scales (B, S, F / group) bf16 (ignored for bf16
// pages), tables ignored; a paged cache (n_log > 0): K/V pools
// (N, P, F_store) with scales (N, P, F / group) and K/V tables (B, n_log)
// int32, S ignored (it is n_log * P); valid (B,) int32 counts the valid rows
// including the fresh ones; fresh K/V (B, Sf, F_store) and scales
// (B, Sf, F / group) at positions base (B,) int32 + j (all ignored when
// Sf == 0); out (B, Hkv, rep, qs, hd) f32. prec: 0 int8, 1 int4, 2 bf16.
REPRO_API int repro_decode_attn(const void* q, const void* kd, const void* ks,
                                const void* vd, const void* vs,
                                const void* valid, const void* ktable,
                                const void* vtable, const void* fkd,
                                const void* fks, const void* fvd,
                                const void* fvs, const void* base, void* out,
                                int B, int S, int P, int n_log, int Hkv,
                                int rep, int qs, int hd, int group, int prec,
                                int causal, int Sf, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = repro_decode_attn_smem(rep * qs, hd);
  const int* ktp = n_log > 0 ? static_cast<const int*>(ktable) : nullptr;
  const int* vtp = n_log > 0 ? static_cast<const int*>(vtable) : nullptr;
  if (n_log > 0) S = n_log * P;
  const float inv_sqrt = 1.0f / sqrtf((float)hd);
  const dim3 grid(B * Hkv);
  const float* qp = static_cast<const float*>(q);
  const auto* ksp = static_cast<const __nv_bfloat16*>(ks);
  const auto* vsp = static_cast<const __nv_bfloat16*>(vs);
  const auto* fksp = static_cast<const __nv_bfloat16*>(fks);
  const auto* fvsp = static_cast<const __nv_bfloat16*>(fvs);
  const int* vp = static_cast<const int*>(valid);
  const int* bp = static_cast<const int*>(base);
  float* op = static_cast<float*>(out);
  if (prec == 0) {
    return launch<0>(grid, smem, st, qp, kd, ksp, vd, vsp, vp, ktp, vtp, fkd,
                     fksp, fvd, fvsp, bp, op, S, P, n_log, Hkv, rep, qs, hd,
                     group, causal, Sf, inv_sqrt);
  }
  if (prec == 1) {
    return launch<1>(grid, smem, st, qp, kd, ksp, vd, vsp, vp, ktp, vtp, fkd,
                     fksp, fvd, fvsp, bp, op, S, P, n_log, Hkv, rep, qs, hd,
                     group, causal, Sf, inv_sqrt);
  }
  return launch<2>(grid, smem, st, qp, kd, ksp, vd, vsp, vp, ktp, vtp, fkd,
                   fksp, fvd, fvsp, bp, op, S, P, n_log, Hkv, rep, qs, hd,
                   group, causal, Sf, inv_sqrt);
}
