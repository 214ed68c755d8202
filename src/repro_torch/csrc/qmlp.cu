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
// What bounds it on the H100: at decode M (1-8 rows of x) the weight bytes
// (3 * D * FF elements for swiglu, 2 * D * FF for gelu; int8 or packed
// int4, bf16 scales per 128) over 3.35 TB/s; at prompt M (236-1500 rows)
// the tensor cores. The (M, FF) hidden activation never reaches device
// memory.
//
// Design:
// * Clusters of 8 blocks of 8 warps. A block owns 64 FF rows (4 tiles of
//   16), a cluster 512 (a part). Warp w multiplies tile w % 4: swiglu,
//   warps 0-3 its gate rows and warps 4-7 its up rows over all of K; gelu,
//   its up rows, warps 0-3 the even K groups and warps 4-7 the odd ones.
//   Warps 4-7 hand their sums to warps 0-3 through shared memory, which
//   form h = silu(g) * u, or the tanh gelu of u (the two halves added in
//   that order), in f32.
// * h stays in shared memory: each block writes its 64 h columns into its
//   own h and copies them, 16 bytes a lane, into the 7 other blocks of its
//   cluster (distributed shared memory), and a cluster barrier makes them
//   visible. So every block holds the cluster's 512 h columns, and the
//   down product splits D, not FF: block r of a cluster multiplies rows
//   [r D / 8, (r + 1) D / 8) of Wd, 512 contiguous columns each, into the
//   cluster's partial. The barrier runs arrive, wait in turn: a chunk's h
//   is written after every block has read the previous one.
// * Both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate): A holds 16 weight rows dequantized exactly to bf16 integer
//   levels (common.cuh ``weights_of``), B up to 8 rows of x or h. Each K
//   group's partial (8 MMAs over its 128 elements) is scaled by its rows'
//   bf16 scales in f32. f32 x is split into three bf16 parts whose sum is x
//   exactly. h goes in as two bf16 parts, hi = bf16(h) and lo = bf16(h -
//   hi): hi + lo is within 2^-16 of h relative, so the down product is an
//   f32 one's up to that and to the order of the f32 sums (chip_smoke.py
//   holds it to QMLP_F32 of an f32 dequantization with h in f32). The
//   plain version instead rounds h to x's dtype, as the JAX fallback does.
// * Weights stream at full width: lane (g, q) copies 16-byte chunks of rows
//   g and g + 8 of a tile (the 4 lanes of a row 64 contiguous bytes) with
//   cp.async into its own slots of a ring in shared memory, 3 K groups in
//   flight: two ahead of the one it multiplies. A lane reads back only what
//   it copied, so it waits for its own copies alone. The ring, not
//   registers, holds the bytes in flight, so a block needs at most 128
//   registers a thread and, at M <= 8, two blocks fit an SM: a cluster
//   then needs 4-8 SMs of one GPC, and llama's 16 clusters (zamba2's 20)
//   are all resident at once (at one block an SM the GPCs hold fewer
//   clusters of 8 than that, and the rest would wait for a second wave).
//   x rows are staged in shared memory with cp.async while the first
//   weights load; the first Wd loads are issued before the cluster barrier.
// * Deterministic: no atomics. Each (part, m, d) of the partial buffer
//   (parts = FF / 512, M, D) is written once, and a second kernel sums the
//   parts in part order, so a result is the same to the bit on every run.
// * M above 8: a block takes chunks of NS 8-row slices of bf16 x (NS = 2
//   up to 16 rows, else 4, or 2 where 32 rows of K do not fit; f32 x, off
//   the serve path, 8 rows a chunk), each A fragment
//   reused from registers across the chunk's slices; the weights are
//   re-read once per chunk. Blocks over y take chunks y, y + gridDim.y,
//   ..., gridDim.y as many as the device holds clusters beyond the parts
//   (cudaOccupancyMaxActiveClusters). Not a wgmma/TMA prefill tile (later
//   work).
#include "common.cuh"

namespace {

constexpr int kGroup = 128;              // the weight group the kernel takes
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCluster = 8;              // blocks of a cluster
constexpr int kBF = 64;                  // FF rows of a block
constexpr int kFC = kCluster * kBF;      // FF rows of a cluster (a part)
constexpr int kHSlots = kFC / 8 + 1;     // 16-byte slots of an h row, padded
constexpr int kDepth = 3;                // weight items a warp has in flight

struct Args {
  const void* x;
  const int8_t* gw; const __nv_bfloat16* gs;
  const int8_t* uw; const __nv_bfloat16* us;
  const int8_t* dw; const __nv_bfloat16* ds;
  float* partial;
  int M, K, FF, D;
};

// 0.5 u (1 + tanh(sqrt(2 / pi) (u + 0.044715 u^3))), jax.nn.gelu's default
__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

template <bool GELU>
__device__ __forceinline__ float act(float g, float u) {
  return GELU ? gelu_tanh(u) : silu(g) * u;
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier: arrive releases this thread's writes (local and
// remote shared memory), wait acquires every block's. Every thread of
// every block of the cluster runs both, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared-memory address ``a`` of this block as seen in block ``rank``
// of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(o) : "r"(a), "r"(rank));
  return o;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t a, const uint4& v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The weight ring: 16-byte copies into a lane's own slots, one commit
// group per item; a lane reads back only what it copied, so waiting for
// its own groups is enough (no barrier).
__device__ __forceinline__ void ring_copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane's two rows of a 16-row weight tile (g and g + 8): payload and
// scales from the first column the tile reads, and whether each is a row.
struct Rows {
  const int8_t* w[2];
  const __nv_bfloat16* s[2];
  bool live[2];
};

__device__ __forceinline__ Rows rows_of(const int8_t* w,
                                        const __nv_bfloat16* s, int row0,
                                        int nrows, int row_bytes,
                                        int row_groups, int g, int col_bytes,
                                        int col_groups) {
  Rows r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    r.live[h] = row < nrows;
    const size_t at = r.live[h] ? (size_t)row : 0;
    r.w[h] = w + at * row_bytes + col_bytes;
    r.s[h] = s + at * row_groups + col_groups;
  }
  return r;
}

// One K group of a 16-row weight tile, as one lane uses it: the chunks of
// its rows g and g + 8 (int8: the group's bytes 16q and 64 + 16q; int4:
// 16q of its 64) and the two rows' scales.
struct Frag {
  uint4 w[2][2];
  float s[2];
};

// A lane's ring slot u: chunk c (row g: 0, 1; row g + 8: 2, 3; int4 rows
// have chunk 0 alone) at slot[c * 32].
template <bool PACKED>
__device__ __forceinline__ uint4* ring_slot(uint4* ring, int warp, int u,
                                            int lane) {
  constexpr int CH = PACKED ? 2 : 4;
  return ring + ((size_t)(warp * kDepth + u) * CH) * 32 + lane;
}

// Copies group ``wk`` of a lane's rows into its ring slot (zeros for a
// row past the matrix), and reads the rows' scales of group ``sk`` (the
// same group; the planted faults of scripts/qmlp_gate_mutants.py change
// that).
template <bool PACKED>
__device__ __forceinline__ void issue(uint4* slot, float (&sc)[2],
                                      const Rows& r, int wk, int sk, int q) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int8_t* base = r.w[h] + (size_t)wk * (PACKED ? 64 : 128) + 16 * q;
    uint4* dst = slot + (PACKED ? h : 2 * h) * 32;
    if (r.live[h]) {
      ring_copy16(dst, base);
      if (!PACKED) ring_copy16(dst + 32, base + 64);
    } else {
      dst[0] = zero;
      if (!PACKED) dst[32] = zero;
    }
    sc[h] = r.live[h] ? __bfloat162float(r.s[h][sk]) : 0.f;
  }
}

template <bool PACKED>
__device__ __forceinline__ Frag take(const uint4* slot, const float (&sc)[2]) {
  Frag f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f.w[h][0] = slot[(PACKED ? h : 2 * h) * 32];
    f.w[h][1] = PACKED ? make_uint4(0, 0, 0, 0) : slot[(2 * h + 1) * 32];
    f.s[h] = sc[h];
  }
  return f;
}

// The logical 16-byte slot of a staged row that holds a lane's elements
// 4i .. 4i + 3 of group kk (bf16 rows: with i even, also 4i + 4 .. 4i + 7,
// the elements of MMA step i + 1; f32 rows: those four alone), in the k
// order ``weights_of`` gives the MMA.
template <bool PACKED>
__device__ __forceinline__ int slot_bf16(int kk, int i, int q) {
  return PACKED ? kk * 16 + 4 * q + (i >> 1)
                : kk * 16 + (i >> 2) * 8 + 2 * q + ((i >> 1) & 1);
}

template <bool PACKED>
__device__ __forceinline__ int slot_f32(int kk, int i, int q) {
  return PACKED ? kk * 32 + 8 * q + i
                : kk * 32 + (i >> 2) * 16 + 4 * q + (i & 3);
}

// The A registers of MMA step i of a fragment: rows g (a0, a2), g + 8.
template <bool PACKED>
__device__ __forceinline__ void a_regs(const Frag& f, int i,
                                       uint32_t (&a)[4]) {
  weights_of<PACKED>(f.w[0], i, a[0], a[2]);
  weights_of<PACKED>(f.w[1], i, a[1], a[3]);
}

// One group of the gate or up product: the fragment's tile against x rows
// s * 8 + g of the chunk (zero from row mt on), scaled into acc[s] (c0,
// c1: row g, x rows 2q, 2q + 1; c2, c3: row g + 8).
template <typename XT, bool PACKED, int NS>
__device__ __forceinline__ void mma_up(const Frag& f, int kk, const uint4* xs,
                                       int xstride, int mt, int g, int q,
                                       float (&acc)[NS][4]) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float d[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[s][c] = 0.f;
  uint4 xv[NS];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t a[4];
    a_regs<PACKED>(f, i, a);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool live = s * 8 + g < mt;
      const uint4* row = xs + (size_t)(live ? s * 8 + g : 0) * xstride;
      if constexpr (sizeof(XT) == 2) {
        if ((i & 1) == 0) xv[s] = live ? row[swz(slot_bf16<PACKED>(kk, i, q))]
                                       : zero;
        mma16(d[s], a, word(xv[s], 2 * (i & 1)), word(xv[s], 2 * (i & 1) + 1));
      } else {
        // f32 x: x = hi + mid + lo exactly, each part a bf16
        const uint4 v = live ? row[swz(slot_f32<PACKED>(kk, i, q))] : zero;
        float r[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w)};
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          __nv_bfloat16 h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[e] = __float2bfloat16_rn(r[e]);
            r[e] -= __bfloat162float(h[e]);
          }
          const __nv_bfloat162 b0 = __halves2bfloat162(h[0], h[1]);
          const __nv_bfloat162 b1 = __halves2bfloat162(h[2], h[3]);
          mma16(d[s], a, *reinterpret_cast<const uint32_t*>(&b0),
                *reinterpret_cast<const uint32_t*>(&b1));
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[s][c] = fmaf(f.s[c >> 1], d[s][c], acc[s][c]);
}

// One group of the down product: the fragment's Wd tile against h rows
// s * 8 + g (hi and lo parts), scaled into acc[s].
template <bool PACKED, int NS>
__device__ __forceinline__ void mma_down(const Frag& f, int kk,
                                         const uint4* hh, const uint4* hl,
                                         int g, int q, float (&acc)[NS][4]) {
  float d[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[s][c] = 0.f;
  uint4 vh[NS], vl[NS];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t a[4];
    a_regs<PACKED>(f, i, a);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if ((i & 1) == 0) {
        const int at = (s * 8 + g) * kHSlots + swz(slot_bf16<PACKED>(kk, i, q));
        vh[s] = hh[at];
        vl[s] = hl[at];
      }
      const int w = 2 * (i & 1);
      mma16(d[s], a, word(vh[s], w), word(vh[s], w + 1));
      mma16(d[s], a, word(vl[s], w), word(vl[s], w + 1));
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[s][c] = fmaf(f.s[c >> 1], d[s][c], acc[s][c]);
}

// Dynamic shared memory of a block: its x rows (rows_x of K, each padded
// by a slot; once the gate/up product is done, the same bytes hold the
// handover from warps 4-7 to warps 0-3, 4 tiles x NS float4 a lane), the
// cluster's h (hi and lo parts, NS * 8 rows of kHSlots slots each), and
// the weight ring (kDepth slots a lane). At M <= 8 two blocks fit an SM.
size_t xs_bytes(int NS, int M, int K, int x_bf16) {
  const size_t rows_x = (size_t)(M < NS * 8 ? M : NS * 8);
  const size_t xs = rows_x * ((size_t)K * (x_bf16 ? 2 : 4) / 16 + 1) * 16;
  const size_t red = (size_t)4 * NS * 32 * 16;
  return xs > red ? xs : red;
}

size_t smem_of(int NS, int M, int K, int x_bf16, int packed) {
  const size_t h = (size_t)2 * NS * 8 * kHSlots * 16;
  const size_t ring = (size_t)kWarps * kDepth * (packed ? 2 : 4) * 32 * 16;
  return xs_bytes(NS, M, K, x_bf16) + h + ring;
}

template <typename XT, bool PACKED, bool GELU, int NS>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, NS == 1 ? 2 : 1)
qmlp_kernel(Args a) {
  constexpr int kV = 16 / sizeof(XT);    // x elements a slot
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int M = a.M, K = a.K, FF = a.FF, D = a.D;
  const int rank = cluster_rank();
  const int part = blockIdx.x / kCluster;  // the cluster's 512 FF rows
  const int ff0 = part * kFC;
  const int SR = K / kV;                   // slots of an x row
  const int ngk = K / kGroup;
  const int rows_x = M < NS * 8 ? M : NS * 8;
  const int xs_slots = max(rows_x * (SR + 1), 4 * NS * 32);
  uint4* xs = reinterpret_cast<uint4*>(smem);
  float4* red = reinterpret_cast<float4*>(smem);      // over xs, see smem_of
  uint4* hh = xs + xs_slots;                          // h, hi parts
  uint4* hl = hh + NS * 8 * kHSlots;                  // h, lo parts
  uint4* ring = hl + NS * 8 * kHSlots;
  const XT* x = static_cast<const XT*>(a.x);

  // gate/up: warp w takes tile t = w % 4 of the block's 64 FF rows; swiglu:
  // warps 0-3 the gate rows, 4-7 the up rows, over all K groups; gelu: the
  // up rows, warps 0-3 the K groups 0, 2, ..., warps 4-7 1, 3, ...
  const int t = warp & 3, half = warp >> 2;
  const int kp = GELU ? 2 : 1, p = GELU ? half : 0;
  const int items_a = (ngk - p + kp - 1) / kp;
  const Rows ra = rows_of(GELU || half ? a.uw : a.gw,
                          GELU || half ? a.us : a.gs,
                          ff0 + rank * kBF + 16 * t, FF, PACKED ? K / 2 : K,
                          ngk, g, 0, 0);
  // down: the block's D rows [d0, d1), its tiles warp, warp + 8, ..., over
  // the cluster's gc groups of FF
  const int rrows = ((D + kCluster - 1) / kCluster + 15) / 16 * 16;
  const int d0 = rank * rrows;
  const int d1 = min(D, d0 + rrows);
  const int ntiles_b = d1 > d0 ? (d1 - d0 + 15) / 16 : 0;
  const int gc = min(kFC, FF - ff0) / kGroup;
  const int items_b =
      (warp < ntiles_b ? (ntiles_b - warp + kWarps - 1) / kWarps : 0) * gc;

  // the cluster barrier runs arrive, wait, arrive, ... in turn: this
  // arrive (every block has started) and each chunk's last (its h is read)
  // are waited for before the next h is written
  cluster_arrive();
  for (int c = blockIdx.y; c * NS * 8 < M; c += gridDim.y) {
    const int m0 = c * NS * 8;
    const int mt = min(NS * 8, M - m0);
    for (int i = threadIdx.x; i < mt * SR; i += kThreads) {
      const int r = i / SR, s = i - r * SR;
      cp_async16(xs + (size_t)r * (SR + 1) + swz(s),
                 x + (size_t)(m0 + r) * K + (size_t)s * kV);
    }
    ring_commit();

    // ---- gate or up: kDepth items in flight -----------------------------
    float sca[kDepth][2];
    float acc[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;
    auto load_a = [&](int u, int j) {
      if (j < items_a) {
        const int kg = p + kp * j;
        uint4* slot = ring_slot<PACKED>(ring, warp, u, lane);
        issue<PACKED>(slot, sca[u], ra, kg, kg, q);
      }
      ring_commit();
    };
#pragma unroll
    for (int u = 0; u < kDepth; ++u) load_a(u, u);
    ring_wait<kDepth>();                 // x (each thread's part)
    __syncthreads();
    for (int j = 0; j < items_a; j += kDepth) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (j + u < items_a) {
          ring_wait<kDepth - 1>();
          const Frag f = take<PACKED>(ring_slot<PACKED>(ring, warp, u, lane),
                                      sca[u]);
          mma_up<XT, PACKED, NS>(f, p + kp * (j + u), xs, SR + 1, mt, g, q,
                                 acc);
          load_a(u, j + u + kDepth);
        }
      }
    }

    // ---- warps 4-7 hand their sums to warps 0-3 (swiglu: u; gelu: the odd
    // K groups' part of u), which form h into every block of the cluster --
    __syncthreads();                     // x is read: red goes over it
    if (half) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        red[(t * NS + s) * 32 + lane] =
            make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
    }
    __syncthreads();
    cluster_wait();
    if (!half) {
      // each value into this block's h, then each lane copies one 16-byte
      // slot (row m, 8 columns, one part) into the other blocks
      unsigned short* h16 = reinterpret_cast<unsigned short*>(hh);
      unsigned short* l16 = reinterpret_cast<unsigned short*>(hl);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 o4 = red[(t * NS + s) * 32 + lane];
        const float o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gate_v = GELU ? acc[s][e] + o[e] : acc[s][e];
          const float up_v = GELU ? gate_v : o[e];
          const float h = act<GELU>(gate_v, up_v);
          const __nv_bfloat16 hi = __float2bfloat16_rn(h);
          const __nv_bfloat16 lo =
              __float2bfloat16_rn(h - __bfloat162float(hi));
          // h row s * 8 + 2q + (e & 1), column rank * 64 + 16t + g + 8 (e / 2)
          const int f = rank * kBF + 16 * t + g + 8 * (e >> 1);
          const int row = s * 8 + 2 * q + (e & 1);
          const int at = (row * kHSlots + swz(f >> 3)) * 8 + (f & 7);
          h16[at] = __bfloat16_as_ushort(hi);
          l16[at] = __bfloat16_as_ushort(lo);
        }
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int row = s * 8 + (lane & 7);
        const int slot = swz(rank * (kBF / 8) + 2 * t + ((lane >> 3) & 1));
        const uint4* src = (lane >> 4 ? hl : hh) + row * kHSlots + slot;
        const uint4 v = *src;
        const uint32_t at = (uint32_t)__cvta_generic_to_shared(src);
#pragma unroll
        for (int r = 1; r < kCluster; ++r)
          st_cluster_v4(map_rank(at, (rank + r) % kCluster), v);
      }
    }
    cluster_arrive();

    // ---- down: the first items load across the barrier ------------------
    float scb[kDepth][2];
    Rows rb;
    int rb_tile = -1;
    float accb[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) accb[s][e] = 0.f;
    auto load_b = [&](int u, int j) {
      if (j < items_b) {
        const int jt = j / gc, kk = j - jt * gc;
        if (jt != rb_tile) {
          rb = rows_of(a.dw, a.ds, d0 + 16 * (warp + jt * kWarps), d1,
                       PACKED ? FF / 2 : FF, FF / kGroup, g,
                       PACKED ? ff0 / 2 : ff0, ff0 / kGroup);
          rb_tile = jt;
        }
        issue<PACKED>(ring_slot<PACKED>(ring, warp, u, lane), scb[u], rb, kk,
                      kk, q);
      }
      ring_commit();
    };
#pragma unroll
    for (int u = 0; u < kDepth; ++u) load_b(u, u);
    cluster_wait();
    for (int j = 0; j < items_b; j += kDepth) {
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (j + u < items_b) {
          ring_wait<kDepth - 1>();
          const Frag f = take<PACKED>(ring_slot<PACKED>(ring, warp, u, lane),
                                      scb[u]);
          const int jt = (j + u) / gc, kk = j + u - jt * gc;
          mma_down<PACKED, NS>(f, kk, hh, hl, g, q, accb);
          load_b(u, j + u + kDepth);
          if (kk == gc - 1) {
            const int row = d0 + 16 * (warp + jt * kWarps) + g;
#pragma unroll
            for (int s = 0; s < NS; ++s)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = m0 + s * 8 + 2 * q + (e & 1);
                const int d = row + 8 * (e >> 1);
                if (m < M && d < d1)
                  a.partial[((size_t)part * M + m) * D + d] = accb[s][e];
                accb[s][e] = 0.f;
              }
          }
        }
      }
    }
    cluster_arrive();
  }
  cluster_wait();
}

// out[i] = the sum over parts of partial[part, i], in part order.
__global__ void qmlp_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int parts,
                                long long md) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= md) return;
  float v = 0.f;
  for (int c = 0; c < parts; ++c) v += partial[(size_t)c * md + i];
  out[i] = v;
}

template <bool PACKED, bool GELU>
const void* kernel_ns(int NS) {
  return NS == 4 ? (const void*)qmlp_kernel<__nv_bfloat16, PACKED, GELU, 4>
       : NS == 2 ? (const void*)qmlp_kernel<__nv_bfloat16, PACKED, GELU, 2>
                 : (const void*)qmlp_kernel<__nv_bfloat16, PACKED, GELU, 1>;
}

// bf16 x in chunks of NS slices; f32 x (off the serve path) in 8-row
// chunks only.
const void* kernel_for(int x_bf16, int packed, int gelu, int NS) {
  if (x_bf16)
    return packed ? (gelu ? kernel_ns<true, true>(NS)
                          : kernel_ns<true, false>(NS))
                  : (gelu ? kernel_ns<false, true>(NS)
                          : kernel_ns<false, false>(NS));
  return packed ? (gelu ? (const void*)qmlp_kernel<float, true, true, 1>
                        : (const void*)qmlp_kernel<float, true, false, 1>)
                : (gelu ? (const void*)qmlp_kernel<float, false, true, 1>
                        : (const void*)qmlp_kernel<float, false, false, 1>);
}

// The kernel's place among the 16 (12 bf16 x: form, precision, NS; 4 f32).
int kernel_index(int x_bf16, int packed, int gelu, int NS) {
  const int form = packed * 2 + gelu;
  return x_bf16 ? form * 3 + (NS == 4 ? 2 : NS == 2 ? 1 : 0) : 12 + form;
}

// The device's SMs and shared-memory opt-in.
struct Device {
  int dev, sms, smem_optin;
};

int device_of(Device* dv) {
  cudaError_t e = cudaGetDevice(&dv->dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&dv->sms, cudaDevAttrMultiProcessorCount,
                               dv->dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&dv->smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dv->dev);
  return (int)e;
}

// Sets kernel ``index``'s shared-memory opt-in to the device's on its first
// use on that device in the process (a table over the 16 kernels and the
// first 64 devices; past those on every use).
int opt_in(const Device& dv, int index, const void* kern) {
  static bool set[64][16];
  if (dv.dev < 64 && set[dv.dev][index]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dv.smem_optin);
  if (e == cudaSuccess && dv.dev < 64) set[dv.dev][index] = true;
  return (int)e;
}

// What the device offers a launch of ``kern`` at ``smem`` bytes: blocks an
// SM holds, clusters it holds at once.
int capacity(const void* kern, size_t smem, int gx, int* per_sm,
             int* clusters) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kern, kThreads, smem);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(gx, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    e = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  }
  return (int)e;
}

// The launch of a shape: NS (8-row slices a chunk: 1 up to M = 8 or for
// f32 x, then 2 up to 16 rows and 4 past, fewer where the shared memory
// does not hold them), grid (8 blocks per 512 FF rows, times the chunk
// groups over y), dynamic shared memory, and the device's capacity for it.
// The occupancy queries run where the grid needs them (more than one chunk
// of x rows) or ``report`` asks for them; per_sm and clusters are 0 else.
struct Plan {
  int NS, gx, gy, per_sm, clusters, sms, parts;
  size_t smem;
  const void* kern;
};

int plan_of(int M, int K, int FF, int x_bf16, int packed, int gelu,
            bool report, Plan* p) {
  Device dv;
  int err = device_of(&dv);
  if (err) return err;
  p->NS = 1;
  if (M > 8 && x_bf16) {
    const int want = M > 16 ? 4 : 2;
    for (int ns = want; ns >= 1; ns /= 2)
      if (ns == 1 ||
          smem_of(ns, M, K, x_bf16, packed) <= (size_t)dv.smem_optin) {
        p->NS = ns;
        break;
      }
  }
  p->smem = smem_of(p->NS, M, K, x_bf16, packed);
  if (p->smem > (size_t)dv.smem_optin) return (int)cudaErrorInvalidValue;
  p->parts = (FF + kFC - 1) / kFC;
  p->gx = p->parts * kCluster;
  p->sms = dv.sms;
  p->kern = kernel_for(x_bf16, packed, gelu, p->NS);
  err = opt_in(dv, kernel_index(x_bf16, packed, gelu, p->NS), p->kern);
  if (err) return err;
  const int chunks = (M + p->NS * 8 - 1) / (p->NS * 8);
  p->per_sm = p->clusters = 0;
  p->gy = 1;
  if (chunks > 1 || report) {
    err = capacity(p->kern, p->smem, p->gx, &p->per_sm, &p->clusters);
    if (err) return err;
    const int ways = p->clusters / p->parts;
    p->gy = ways < 1 ? 1 : ways < chunks ? ways : chunks;
  }
  return 0;
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

}  // namespace

// The leading dimension of the partial buffer the caller allocates as
// (parts, M, D) f32: one part per 512 FF rows.
REPRO_API int repro_qmlp_parts(int FF) { return (FF + kFC - 1) / kFC; }

// The launch of a shape: out = {blocks in x, blocks in y, cluster size,
// threads a block, dynamic shared memory bytes, blocks an SM holds,
// clusters the device holds at once, SMs, x rows a chunk, parts}.
// Returns a CUDA error code.
REPRO_API int repro_qmlp_plan(int M, int K, int FF, int x_bf16, int packed,
                              int gelu, int* out) {
  Plan p;
  const int err = plan_of(M, K, FF, x_bf16, packed, gelu, true, &p);
  if (err) return err;
  out[0] = p.gx; out[1] = p.gy; out[2] = kCluster; out[3] = kThreads;
  out[4] = (int)p.smem; out[5] = p.per_sm; out[6] = p.clusters;
  out[7] = p.sms; out[8] = p.NS * 8; out[9] = p.parts;
  return 0;
}

// y (M, D) f32 = the MLP of x (M, K); gelu = 1: the gelu form (gw, gs
// ignored, may be null), 0: swiglu. ``partial`` holds (parts, M, D) f32.
// Returns cudaErrorInvalidValue, with no launch, for a group other than
// 128, K or FF not a multiple of it, x or a weight not 16-byte aligned, or
// x rows past the shared memory.
REPRO_API int repro_qmlp(const void* x, int x_bf16, int M, int K, int FF,
                         int D, int group, int packed, int gelu, const void* gw,
                         const void* gs, const void* uw, const void* us,
                         const void* dw, const void* ds, void* partial,
                         void* out, void* stream) {
  if (group != kGroup || K <= 0 || K % kGroup || FF <= 0 || FF % kGroup ||
      M < 1 || D < 1 || (packed != 0 && packed != 1) ||
      (gelu != 0 && gelu != 1) || misaligned(x) || misaligned(uw) ||
      misaligned(dw) || (!gelu && misaligned(gw)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  int err = plan_of(M, K, FF, x_bf16, packed, gelu, false, &p);
  if (err) return err;
  Args a;
  a.x = x;
  a.gw = static_cast<const int8_t*>(gelu ? uw : gw);
  a.gs = static_cast<const __nv_bfloat16*>(gelu ? us : gs);
  a.uw = static_cast<const int8_t*>(uw);
  a.us = static_cast<const __nv_bfloat16*>(us);
  a.dw = static_cast<const int8_t*>(dw);
  a.ds = static_cast<const __nv_bfloat16*>(ds);
  a.partial = static_cast<float*>(partial);
  a.M = M; a.K = K; a.FF = FF; a.D = D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.gx, p.gy, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  void* args[] = {&a};
  err = (int)cudaLaunchKernelExC(&cfg, p.kern, args);
  if (err) return err;
  const long long md = (long long)M * D;
  const int threads = 256;
  qmlp_sum_kernel<<<(unsigned)((md + threads - 1) / threads), threads, 0,
                    st>>>(static_cast<const float*>(partial),
                          static_cast<float*>(out), p.parts, md);
  return (int)cudaGetLastError();
}
