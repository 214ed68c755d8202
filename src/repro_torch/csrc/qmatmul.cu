// Fused weight-dequant matmul for Hopper (W8A16 / W4A16 / ternary), and the
// fused QKV projection built on the same kernel.
//
// Replaces the TPU kernels ``qmatmul_pallas`` (src/repro/kernels/qmatmul/
// kernel.py:75) and ``qkv_pallas`` (kernel.py:223):
//
//     y[m, n] = sum_k x[m, k] * q[n, k] * s[n, k / 128]      (f32 out)
//
// What bounds it on the H100: at decode M is the number of serving slots
// (1..8), so each weight byte feeds at most a handful of multiply-adds and
// the kernel is bound by the weight bytes over 3.35 TB/s. The TPU kernel ran
// only for M % 128 == 0 and never at decode.
//
// Design (what each choice is for; the choices between sizes were timed on
// the card, PERF.md):
//
// * The products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate): A holds a block's x rows (up to 8; rows 8-15 zero), B 8
//   weight rows dequantized exactly to bf16 integer levels (int8, int4 and
//   ternary levels all fit bf16's 8-bit significand). With f32 SIMT
//   multiply-adds the time grew with M and int4 was no faster than int8.
//   Each group's partial (8 products over its 128 k) is scaled by the
//   group's bf16 scale in f32, so the result is an f32 dequantization's up
//   to the order of the f32 sums. f32 x (off the serve path) is split into
//   three bf16 parts whose sum is x exactly, and each part is multiplied.
// * Tiles and blocks. A tile is 8 weight rows (16 for N >= 16384: two
//   8-row slices share each x fragment). A block's S warps split K by
//   groups of 128 (warp w takes groups w, w + S, ...; S = 8, or 4 for
//   N > 4096), and the block loops over tiles blockIdx.x, + gridDim.x, ...
//   with gridDim.x = the blocks the SMs hold at once, or the tiles if
//   fewer. So x is staged once per block, not once per tile (each block
//   needs all of K of x: smaller tiles, such as 2-row tiles for two blocks
//   per SM on 1024 x 1024, were slower for that), and lm_head runs 528
//   blocks, not 16032.
// * Stream the weights at full width. Lane (g, q) of a warp loads 16-byte
//   chunks of weight row g of each slice (16 int8 or 32 int4 elements
//   inside one group), the 4 lanes of a row 64 contiguous bytes, in a ring
//   of kDepth register fragments: two groups ahead of the one it
//   multiplies, 16-32 KB in flight per SM (a deeper ring cost occupancy and
//   was slower). The k order this gives the MMA is applied to x alike.
// * Stage x once per block: its x rows over the whole K go to dynamic
//   shared memory with 16-byte cp.async at the start (bf16 stays bf16, f32
//   stays f32; rows padded by 16 bytes and 16-byte slots swizzled so that
//   the lanes of a shared-memory phase hit 8 different bank quads), while
//   the first weight loads are in flight.
// * Dequantization without integer-to-float conversions: a byte (or
//   nibble) is permuted into the float 2^23 + u, one subtraction gives the
//   level exactly, and one cvt packs two levels into bf16x2.
// * No atomics: each warp sums its groups in a fixed order, and warp 0
//   adds the warps' partials of a tile in warp order through shared
//   memory, so a result is bit-identical from run to run.
//
// M above 8 tiles into grid.y, 8 x rows a block (fewer for f32 x past K =
// 6144), re-reading the weights once per 8 rows (from L2 for all but the
// largest matrices): correct for prefill, not tuned for it (a wgmma/TMA
// prefill tile is later work).
//
// The fused QKV launch (repro_qkv) runs the same kernel over the
// concatenated Nq + Nk + Nv output rows; each row resolves which of the
// three weights and outputs it belongs to, so x is staged once per block
// for all three projections.
#include "common.cuh"

namespace {

constexpr int kGroup = 128;        // the weight group the kernel takes
constexpr int kWarps = 8;          // warps of a block (at most), splitting K
constexpr int kRowsX = 8;          // x rows an MMA tile holds
constexpr int kSMs = 132;          // SMs of an H100 SXM
constexpr int kSmemMax = 200 * 1024;
constexpr int kDepth = 3;          // items a warp has loaded: 1 used + 2 ahead

struct Segs {
  const int8_t* w0; const int8_t* w1; const int8_t* w2;
  const __nv_bfloat16* s0; const __nv_bfloat16* s1; const __nv_bfloat16* s2;
  float* y0; float* y1; float* y2;
  int n0, n1, n2;
};

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

// 16 weight bytes (an L1 no-allocate load measured the same).
__device__ __forceinline__ uint4 ldg16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Byte b of ``u`` (an unsigned level) as the float 2^23 + u[b].
__device__ __forceinline__ float magic(uint32_t u, int b) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The B registers of MMA i (0..7) of a group: elements 4i .. 4i + 3 of the
// lane's 32 weight elements (int8: two 16-byte chunks; int4: one), as two
// bf16x2 words of exact levels. int4: low nibble = even element.
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

// Where logical 16-byte slot s of a staged x row lies: bit 1 of the slot
// flipped in every other run of 8, so that the 8 lanes of a phase (two x
// rows, four lanes each) hit 8 different bank quads.
__device__ __forceinline__ int swz(int s) { return s ^ (((s >> 3) & 1) << 1); }

// Row n of the concatenated outputs: its weight row, scales, output
// column and output row stride.
struct Row {
  const int8_t* w; const __nv_bfloat16* s; float* y; int stride;
};

__device__ __forceinline__ Row resolve(const Segs& seg, int n, int kbytes,
                                       int ngroups) {
  const int8_t* w = seg.w0; const __nv_bfloat16* s = seg.s0;
  float* y = seg.y0; int stride = seg.n0;
  if (n >= seg.n0 + seg.n1) {
    n -= seg.n0 + seg.n1; w = seg.w2; s = seg.s2; y = seg.y2; stride = seg.n2;
  } else if (n >= seg.n0) {
    n -= seg.n0; w = seg.w1; s = seg.s1; y = seg.y1; stride = seg.n1;
  }
  return Row{w + (size_t)n * kbytes, s + (size_t)n * ngroups, y + n, stride};
}

// One group's loads for a lane: its weight chunk(s) in each of the NT
// 8-row slices of the tile, and the scales of its two output rows in each.
template <int NT>
struct Frag {
  uint4 w[NT][2];
  float s[NT][2];
};

// Where a tile's rows are for one lane's loads: the weight row it loads in
// each slice (B operand row g), and the scale rows of its output rows 2q,
// 2q + 1 in each slice.
template <int NT>
struct TileRows {
  const int8_t* w[NT];
  bool wlive[NT];
  const __nv_bfloat16* s[NT][2];
};

template <int NT>
__device__ __forceinline__ void tile_rows(TileRows<NT>& tr, const Segs& seg,
                                          int row0, int RB, int n_total,
                                          int g, int q, int kbytes,
                                          int ngroups) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int rg = row0 + 8 * t + g;
    tr.wlive[t] = 8 * t + g < RB && rg < n_total;
    tr.w[t] = resolve(seg, tr.wlive[t] ? rg : 0, kbytes, ngroups).w;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ro = row0 + 8 * t + 2 * q + c;
      tr.s[t][c] = resolve(seg, ro < n_total ? ro : 0, kbytes, ngroups).s;
    }
  }
}

template <bool PACKED, int NT>
__device__ __forceinline__ void load_group(Frag<NT>& f,
                                           const TileRows<NT>& tr, int k,
                                           int q) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (PACKED) {
      f.w[t][0] = tr.wlive[t] ? ldg16(tr.w[t] + (size_t)k * 64 + 16 * q)
                              : zero;
      f.w[t][1] = zero;
    } else {
      const int8_t* base = tr.w[t] + (size_t)k * 128 + 16 * q;
      f.w[t][0] = tr.wlive[t] ? ldg16(base) : zero;
      f.w[t][1] = tr.wlive[t] ? ldg16(base + 64) : zero;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      f.s[t][c] = __bfloat162float(tr.s[t][c][k]);
  }
}

// One group of a lane: 8 MMAs per slice over its 32 weight elements
// against the matching 32 x elements of x row g (zero past the block's
// rows; the same A registers serve every slice), then each slice's group
// partial of the lane's two output columns, scaled, into acc.
template <typename XT, bool PACKED, int NT>
__device__ __forceinline__ void mma_group(const Frag<NT>& f, int k,
                                          const uint4* xrow, bool xlive,
                                          int q, float (&acc)[NT][2]) {
  // the lane's x elements: int8 at 16q and 64 + 16q of the group (16
  // each), int4 at 32q (32)
  constexpr int kV = 16 / sizeof(XT);        // x elements in a slot
  constexpr int kHalf = 16 / kV;             // slots of 16 elements
  uint4 xv[32 / kV];
#pragma unroll
  for (int j = 0; j < 32 / kV; ++j) {
    const int e = PACKED ? 32 * q + j * kV
                         : (j < kHalf ? 16 * q + j * kV
                                      : 64 + 16 * q + (j - kHalf) * kV);
    xv[j] = xlive ? xrow[swz((k * kGroup + e) / kV)] : make_uint4(0, 0, 0, 0);
  }
  float d[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[t][c] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t b0[NT], b1[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) weights_of<PACKED>(f.w[t], i, b0[t], b1[t]);
    if constexpr (sizeof(XT) == 2) {
      // x elements 4i .. 4i + 3: words 2i, 2i + 1 of the lane's run
      const uint4& v = xv[i >> 1];
      const uint32_t a0 = word(v, 2 * (i & 1)), a2 = word(v, 2 * (i & 1) + 1);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma(d[t], a0, a2, b0[t], b1[t]);
    } else {
      // f32 x: x = hi + mid + lo exactly, each part a bf16
      const uint4& v = xv[i];
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
        const __nv_bfloat162 a0 = __halves2bfloat162(h[0], h[1]);
        const __nv_bfloat162 a2 = __halves2bfloat162(h[2], h[3]);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mma(d[t], *reinterpret_cast<const uint32_t*>(&a0),
              *reinterpret_cast<const uint32_t*>(&a2), b0[t], b1[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    acc[t][0] = fmaf(f.s[t][0], d[t][0], acc[t][0]);
    acc[t][1] = fmaf(f.s[t][1], d[t][1], acc[t][1]);
  }
}

template <typename XT, bool PACKED, int NT>
__global__ void __launch_bounds__(kWarps * 32)
qmma_kernel(const XT* __restrict__ x, int M, int K, int RB, int TT,
            Segs seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = blockDim.x >> 5;               // warps splitting K
  const int g = lane >> 2, q = lane & 3;       // MMA group, thread in it
  const int n_total = seg.n0 + seg.n1 + seg.n2;
  const int kbytes = PACKED ? K / 2 : K;
  const int ngroups = K / kGroup;
  const int per_warp = ngroups / S;            // groups of a warp per tile
  const int ntiles = (n_total + RB - 1) / RB;
  const int m0 = blockIdx.y * TT;              // this block's TT x rows
  const int mt = min(TT, M - m0);
  constexpr int kV = 16 / sizeof(XT);
  const int SR = K / kV;                       // 16-byte slots of an x row
  uint4* xs = reinterpret_cast<uint4*>(smem);
  float* red = reinterpret_cast<float*>(xs + (size_t)mt * (SR + 1));

  // x rows m0 .. m0 + mt over the whole K, each padded by one slot
  for (int i = threadIdx.x; i < mt * SR; i += blockDim.x) {
    const int t = i / SR, s = i - t * SR;
    cp_async16(xs + (size_t)t * (SR + 1) + swz(s),
               x + (size_t)(m0 + t) * K + (size_t)s * kV);
  }

  // the block's row tiles blockIdx.x, + gridDim.x, ...; a warp's items are
  // (tile, group) in that order, its groups warp, warp + S, ... of each
  const int tiles = blockIdx.x < ntiles
                        ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;
  const int items = tiles * per_warp;
  TileRows<NT> ld;                             // rows being loaded
  int ld_tile = -1;
  auto load_item = [&](Frag<NT>& f, int j) {
    if (j >= items) return;
    const int tile = blockIdx.x + (j / per_warp) * gridDim.x;
    if (tile != ld_tile) {
      tile_rows<NT>(ld, seg, tile * RB, RB, n_total, g, q, kbytes, ngroups);
      ld_tile = tile;
    }
    load_group<PACKED, NT>(f, ld, warp + (j % per_warp) * S, q);
  };

  // items loaded kDepth - 1 ahead of the one being multiplied (the first
  // ones while x lands), in a ring of register fragments
  Frag<NT> f[kDepth];
#pragma unroll
  for (int u = 0; u + 1 < kDepth; ++u) load_item(f[u], u);
  cp_async_wait_all();
  __syncthreads();
  const bool xlive = g < mt;
  const uint4* xrow = xs + (size_t)(xlive ? g : 0) * (SR + 1);
  float acc[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = 0.f;
  auto use_item = [&](const Frag<NT>& fr, int j) {
    if (j >= items) return;
    const int ti = j / per_warp, kk = j - ti * per_warp;
    mma_group<XT, PACKED, NT>(fr, warp + kk * S, xrow, xlive, q, acc);
    if (kk != per_warp - 1) return;
    // the tile's last group: the warps' partials, added in warp order by
    // warp 0 (two buffers, so one barrier a tile suffices)
    float* r = red + (size_t)(ti & 1) * S * 32 * NT * 2;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        r[((warp * 32 + lane) * NT + t) * 2 + c] = acc[t][c];
        acc[t][c] = 0.f;
      }
    __syncthreads();
    if (warp != 0 || !xlive) return;
    const int row0 = (blockIdx.x + ti * gridDim.x) * RB;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = 0.f;
        for (int w = 0; w < S; ++w) v += r[((w * 32 + lane) * NT + t) * 2 + c];
        const int n = row0 + 8 * t + 2 * q + c;
        if (8 * t + 2 * q + c < RB && n < n_total) {
          const Row out = resolve(seg, n, kbytes, ngroups);
          out.y[(size_t)(m0 + g) * out.stride] = v;
        }
      }
  };
  for (int j = 0; j < items; j += kDepth) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      load_item(f[(u + kDepth - 1) % kDepth], j + u + kDepth - 1);
      use_item(f[u], j + u);
    }
  }
}

// The launch a shape gets: weight rows a tile (RB), 8-row slices a warp
// multiplies at once (NT), warps a block (S, dividing the groups), x rows a
// block (TT: 8, fewer when 8 rows of K do not fit), grid and dynamic
// shared memory (the block's x rows, then two buffers of the warps'
// partials). Blocks are as many as the SMs hold at once (``per_sm`` each),
// fewer when the tiles are fewer; each loops over its tiles.
struct Plan {
  int RB, NT, S, TT, ntiles, gx, gy;
  size_t smem;
};

Plan plan_of(int N, int M, int K, int x_bf16, int per_sm) {
  Plan p;
  p.NT = N >= 16384 ? 2 : 1;
  p.RB = 8 * p.NT;
  const int ngroups = K / kGroup;
  p.S = N > 4096 ? kWarps / 2 : kWarps;
  while (ngroups % p.S) --p.S;
  p.ntiles = (N + p.RB - 1) / p.RB;
  p.gx = per_sm > 0 && p.ntiles > per_sm * kSMs ? per_sm * kSMs : p.ntiles;
  const size_t slots = (size_t)K * (x_bf16 ? 2 : 4) / 16 + 1;
  const size_t red = 2 * (size_t)p.S * 32 * p.NT * 2 * 4;
  p.TT = kRowsX;
  while (p.TT > 1 && (size_t)p.TT * slots * 16 + red > (size_t)kSmemMax)
    p.TT /= 2;
  p.gy = (M + p.TT - 1) / p.TT;
  const int rows_x = M < p.TT ? M : p.TT;
  p.smem = (size_t)rows_x * slots * 16 + red;
  return p;
}

template <typename XT, bool PACKED, int NT>
const void* kernel_of() {
  return (const void*)qmma_kernel<XT, PACKED, NT>;
}

const void* kernel_for(int x_bf16, int packed, int NT) {
  if (x_bf16)
    return packed ? (NT == 2 ? kernel_of<__nv_bfloat16, true, 2>()
                             : kernel_of<__nv_bfloat16, true, 1>())
                  : (NT == 2 ? kernel_of<__nv_bfloat16, false, 2>()
                             : kernel_of<__nv_bfloat16, false, 1>());
  return packed ? (NT == 2 ? kernel_of<float, true, 2>()
                           : kernel_of<float, true, 1>())
                : (NT == 2 ? kernel_of<float, false, 2>()
                           : kernel_of<float, false, 1>());
}

// Blocks of ``kern`` an SM holds at ``threads`` and ``smem`` bytes each
// (dynamic shared memory past 48 KB opted in first), remembered.
int blocks_per_sm(const void* kern, int threads, size_t smem, int* per_sm) {
  struct Known { const void* kern; int threads; size_t smem; int per_sm; };
  static Known known[32];
  static int n_known = 0, next = 0;
  for (int i = 0; i < n_known; ++i)
    if (known[i].kern == kern && known[i].threads == threads &&
        known[i].smem == smem) {
      *per_sm = known[i].per_sm;
      return 0;
    }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  known[next] = Known{kern, threads, smem, *per_sm};
  next = (next + 1) % 32;
  if (n_known < 32) ++n_known;
  return 0;
}

// The plan of a launch, with the SMs' capacity for its kernel.
int full_plan(int N, int M, int K, int x_bf16, int packed, Plan* p) {
  *p = plan_of(N, M, K, x_bf16, 0);
  int per_sm = 0;
  const int err = blocks_per_sm(kernel_for(x_bf16, packed, p->NT),
                                p->S * 32, p->smem, &per_sm);
  if (err) return err;
  *p = plan_of(N, M, K, x_bf16, per_sm);
  return 0;
}

template <typename XT, bool PACKED, int NT>
void launch_plan(const void* x, int M, int K, const Segs& seg, const Plan& p,
                 cudaStream_t stream) {
  qmma_kernel<XT, PACKED, NT><<<dim3(p.gx, p.gy), p.S * 32, p.smem, stream>>>(
      static_cast<const XT*>(x), M, K, p.RB, p.TT, seg);
}

template <typename XT, bool PACKED>
void launch_nt(const void* x, int M, int K, const Segs& seg, const Plan& p,
               cudaStream_t st) {
  if (p.NT == 2) launch_plan<XT, PACKED, 2>(x, M, K, seg, p, st);
  else launch_plan<XT, PACKED, 1>(x, M, K, seg, p, st);
}

bool misaligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

int launch(const void* x, int x_bf16, int M, int K, int group, int packed,
           const Segs& seg, void* stream) {
  // refuse, launching nothing, what the kernel has no form for
  const int n_total = seg.n0 + seg.n1 + seg.n2;
  if (group != kGroup || K <= 0 || K % kGroup || M < 1 || n_total < 1 ||
      (packed != 0 && packed != 1) || misaligned(x) || misaligned(seg.w0) ||
      (seg.n1 && misaligned(seg.w1)) || (seg.n2 && misaligned(seg.w2)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int err = full_plan(n_total, M, K, x_bf16, packed, &p);
  if (err) return err;
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (packed) launch_nt<__nv_bfloat16, true>(x, M, K, seg, p, st);
    else launch_nt<__nv_bfloat16, false>(x, M, K, seg, p, st);
  } else {
    if (packed) launch_nt<float, true>(x, M, K, seg, p, st);
    else launch_nt<float, false>(x, M, K, seg, p, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y (M, N) f32 = x (M, K) . dequant(w (N, K_store), s (N, K / 128))^T.
// Returns cudaErrorInvalidValue, with no launch, for a group other than
// 128, a K that is not a multiple of it, x or w not 16-byte aligned, or
// one x row over the whole K past 200 KB of shared memory.
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
// yv (M, Nv), all f32; the same refusals.
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

// The launch of an (N, K) weight at M rows: out = {blocks in x, blocks in
// y, threads a block, dynamic shared memory bytes, blocks an SM holds at
// once (occupancy), weight rows a block}. Returns a CUDA error code.
REPRO_API int repro_qmatmul_plan(int N, int M, int K, int packed, int x_bf16,
                                 int* out) {
  Plan p;
  const int err = full_plan(N, M, K, x_bf16, packed, &p);
  int per_sm = 0;
  blocks_per_sm(kernel_for(x_bf16, packed, p.NT), p.S * 32, p.smem, &per_sm);
  out[0] = p.gx; out[1] = p.gy; out[2] = p.S * 32; out[3] = (int)p.smem;
  out[4] = per_sm; out[5] = p.RB;
  return err;
}
