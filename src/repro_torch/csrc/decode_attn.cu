// Split-KV (flash-decoding) GQA decode attention over a quantized KV cache,
// for Hopper.
//
// Replaces the TPU kernel ``decode_attn_pallas``
// (src/repro/kernels/decode_attn/kernel.py:162) in all its forms: the
// single-query decode step, the multi-query window of a speculative verify
// (qs = K+1 queries per slot, causal offsets or causal=False;
// kernel.py:94-99), the fresh-row epilogue of the fused draft propose
// (kernel.py:129-151), and the paged cache (kernel.py:203-260), each of the
// first three over a dense or a paged cache:
//
//   out[b, i, h * rep + r] = softmax_t(q[b, i, h * rep + r] . K[b, t, h]
//                                      / sqrt(hd)) . V[b, t, h]
//
// Query i of the qs queries of a slot sees ``limit_i = valid - qs + 1 + i``
// rows when causal, ``valid`` rows when not. With fresh rows, cache rows at
// positions >= base are stale: the cache part ends at ``min(limit_i,
// base)``, and fresh row j, at logical position base + j, is seen when
// base + j < limit_i. K/V pages (and the fresh rows, already quantized with
// the page's write math) hold int8, split-half packed int4 (byte j of a
// row holds flat elements j and j + F/2, F = Hkv * hd;
// src/repro/quant/kvcache.py:236-253) with one bf16 scale per ``group``
// elements of the flat F axis, or bf16 with no scale. A query that sees no
// row gives 0, as the TPU kernel does for a slot with valid_len 0.
//
// Dense and paged caches differ only in where logical row t of slot b lives:
// row b * S + t of the dense (B, S, F_store) page, or row
// table[b, t / P] * P + t % P of the (N, P, F_store) pool, where the slot's
// (n_log,) int32 table maps logical pages to physical ones (page 0 is the
// dump page, never read below valid) and S = n_log * P.
//
// What bounds it on the H100: the cache bytes of the rows the queries see
// (plus the tables) over 3.35 TB/s; the arithmetic stays f32 FMA, the
// numbers of the plain version. In practice a block's serial chain sets the
// time at decode shapes (a few live blocks per SM, each a dependent chain of
// loads, dots, shuffles and barriers), so the design spreads the work over
// many short blocks and keeps each chain short:
//
// * Split the KV range across blocks (flash-decoding). Block (h * ng + g, j,
//   b) takes logical rows [j * L, (j + 1) * L) of KV head h of slot
//   b, clipped to the slot's min(valid, base), for query rows g * RG .. of
//   the head's rep * qs (at most kMaxRows a block: ng = ceil(rep * qs /
//   kMaxRows) blocks share a split's rows, each re-reading them, mostly from
//   L2); one more block per (head, slot, row group) takes the fresh rows.
//   Boundaries depend on logical positions only (never on S, P or
//   valid_len), and the number of splits on the shapes only (ceil(S /
//   L), at least 1), so the launch can be captured in a CUDA graph and a
//   pool, the dense page gathered from it and a dense cache of another length
//   give the same partials, and the same result, to the bit. A block whose
//   range is empty writes the empty state (m = -inf, l = 0, acc = 0).
// * Each block runs an online softmax over its rows kTile at a time and
//   writes its query rows' partials (m, l, acc[hd]) to f32 scratch; a second
//   kernel (one thread per output element) merges them in split order, the
//   fresh part last, with weights exp(m_j - m), a state with m = -inf
//   weighing 0: empty splits merge to nothing, a query that sees no row
//   writes exactly 0, and there are no float atomics.
// * Loads: the block looks its rows up once (through the page tables for a
//   pool, any page size) into shared memory, then copies each tile's K and V
//   rows of its head (hd bytes for int8 and int4, 2 hd for bf16) with 16-byte
//   cp.async, consecutive threads on consecutive chunks of a row, into a
//   kStages-deep ring, and the head's scales once per row, as the 4-byte
//   words that cover its hd / group values. A whole split (two tiles) is in
//   flight before its first tile is used. Rows past the range are
//   zero-filled. int4 reads the hd bytes its head shares with head h +- Hkv
//   / 2 and keeps one nibble: those bytes are read twice, once per head.
// * Arithmetic: a score is a 16-element dot per thread (a 16-byte chunk of
//   the K row, dequantized exactly by a byte permute and a subtraction in
//   place of a quarter-rate int-to-float conversion) against q in shared
//   memory, up to four query rows at once (independent FMA chains), reduced
//   over the hd / 16 threads of the row by shuffles; the softmax takes two
//   query rows per warp; P.V gives each thread a 16-element chunk of hd for
//   its query rows (1 or 4, a template parameter) and a slice of the tile's
//   rows, the slices summed in a fixed order at the end. Element indices
//   come from compile-time hd: there are copies for hd 32, 64, 80 and 128.
//   A score row takes hd / 16 threads rounded up to a power of two for the
//   shuffles (hd 80: 8 lanes, the last 3 idle and adding 0, so no
//   arithmetic is spent on padding; P.V deals 5 chunks a row to its
//   threads). Each thread's chunk is fixed, so its byte offset, its int4
//   nibble and its scale index are worked out once: a chunk's scale is
//   that of its flat element index over ``group`` (a multiple of 16, so a
//   chunk lies inside one group, while a head's groups may cross heads:
//   hd 80 over groups of 64), and an int4 chunk is the low nibbles of
//   bytes f .. f + 15 for flat index f < F / 2, else the high nibbles of
//   bytes f - F / 2 .. (a head may straddle F / 2 when Hkv is odd). The
//   entry point refuses any other hd, a group that is not a multiple of 16
//   or does not divide F, int4 where F / 2 is not a multiple of 16 (a
//   chunk would straddle the halves: hd 80 with an odd Hkv), and a split
//   other than its own, launching nothing.
// * q is read in place from its (B, s, H, hd) layout (bf16 or f32, any
//   strides but the last); the merge writes (B, s, H, hd) in q's dtype,
//   bf16 rounded to nearest even.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // KV rows per tile
constexpr int kPerLane = kTile / 32;   // a lane's scores of a tile in the softmax
constexpr int kStages = 2;     // tiles in the cp.async ring
constexpr int kScW = 5;        // 4-byte scale words per staged row (<= 8 scales)
constexpr int kMaxRows = 4;    // query rows of one block (more go to more blocks)

// Logical rows per split (flash-decoding), by the query rows of one thread
// in P.V: 256 where a KV head has a single query row (light blocks: fewer,
// longer ones beat the merge), else 128.
__host__ __device__ constexpr int split_of(int rpt) { return rpt == 1 ? 256 : 128; }
static_assert(split_of(1) % kTile == 0 && split_of(4) % kTile == 0,
              "a split is a whole number of tiles");
static_assert(kTile % 32 == 0, "a tile is whole warps of softmax lanes");
static_assert(kStages >= 2, "the ring needs two stages");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The rep * qs query rows of a KV head are dealt to ceil(rows / kMaxRows)
// blocks of at most kMaxRows rows each.
__host__ __device__ inline int row_groups(int rows) {
  return (rows + kMaxRows - 1) / kMaxRows;
}

__host__ __device__ inline int rows_per_group(int rows) {
  const int n = row_groups(rows);
  return (rows + n - 1) / n;
}

// Query rows of one thread in P.V: 1 where a block has one query row
// (whisper's heads), else 4 (the split kernel is instantiated for both).
__host__ __device__ constexpr int rows_per_thread(int rows) {
  return rows == 1 ? 1 : 4;
}

// The split of a KV head's ``rows`` = rep * qs query rows (the plain
// version's ``split_rows``).
__host__ __device__ inline int split_rows(int rows) {
  return split_of(rows_per_thread(rows_per_group(rows)));
}

// Threads of P.V per query-row group, slices of the tile's rows: the
// largest power of two that fits the block (shared with the host's
// shared-memory count).
__host__ __device__ inline int pv_slices(int rows, int chunks) {
  const int rpt = rows_per_thread(rows);
  const int groups = (rows + rpt - 1) / rpt;
  int ts = 1;
  while (ts * 2 <= kTile && ts * 2 * chunks * groups <= kThreads) ts *= 2;
  return ts;
}

// Threads of one score row: hd / 16 chunks rounded up to a power of two
// (the shuffle width); lanes past the chunks sit idle.
__host__ __device__ constexpr int score_lanes(int hd) {
  return hd / 16 <= 2 ? hd / 16 : (hd / 16 <= 4 ? 4 : 8);
}

// Bytes of one row of one head as staged: hd for int8 and int4, 2 hd bf16.
__host__ __device__ constexpr int row_bytes(int prec, int hd) {
  return prec == 2 ? 2 * hd : hd;
}

__host__ __device__ inline int stage_bytes(int prec, int hd) {
  return 2 * kTile * row_bytes(prec, hd) + (prec == 2 ? 0 : 2 * kTile * kScW * 4);
}

struct Layout {   // byte offsets into dynamic shared memory
  int ring, q, p, m, l, c, lim, krow, vrow, kshift, vshift, total;
};

__host__ __device__ inline Layout layout(int prec, int hd, int rows) {
  Layout o;
  const int ring = kStages * stage_bytes(prec, hd);
  const int red = pv_slices(rows, hd / 16) * rows * hd * 4;  // aliases the ring
  o.ring = 0;
  o.q = ring > red ? ring : red;
  o.p = o.q + rows * hd * 4;
  o.m = o.p + rows * kTile * 4;
  o.l = o.m + rows * 4;
  o.c = o.l + rows * 4;
  o.lim = o.c + rows * 4;
  o.krow = o.lim + rows * 4;
  const int split = split_of(rows_per_thread(rows));
  o.vrow = o.krow + split * 4;
  o.kshift = o.vrow + split * 4;
  o.vshift = o.kshift + split;
  o.total = o.vshift + split;
  return o;
}

// Four signed bytes (``w`` biased by 0x80 each, so byte k holds x_k + 128)
// as exact floats: 0x4B0000uu is 2^23 + uu, so one byte permute and one
// subtraction replace a quarter-rate integer-to-float conversion.
__device__ __forceinline__ void bytes4(uint32_t w, float bias, float* x) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    x[k] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + k)) - bias;
}

// The 16 elements of chunk ``c`` (head elements 16c .. 16c + 15) of one
// staged row, as floats without their scale: int8 bytes, the low or high
// nibbles of int4 bytes (two's complement in [-8, 7]), or bf16 values.
template <int PREC>
__device__ __forceinline__ void chunk16(const unsigned char* row, int c,
                                        bool hi, float (&x)[16]) {
  if (PREC == 2) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + 32 * c);
    const uint4 b = *reinterpret_cast<const uint4*>(row + 32 * c + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    const uint4 a = *reinterpret_cast<const uint4*>(row + 16 * c);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (PREC == 0) {
        bytes4(w[j] ^ 0x80808080u, 8388736.f, x + 4 * j);          // 2^23 + 128
      } else {
        const uint32_t n = (hi ? w[j] >> 4 : w[j]) & 0x0F0F0F0Fu;
        bytes4(n ^ 0x08080808u, 8388616.f, x + 4 * j);              // 2^23 + 8
      }
    }
  }
}

// Where the rows of one K/V source live and how a head's bytes sit in them.
struct Source {
  const unsigned char* kd;
  const unsigned char* ks;   // bf16 scales as bytes (unused for bf16 pages)
  const unsigned char* vd;
  const unsigned char* vs;
  const int* ktab;           // the slot's page tables, or nullptr (dense)
  const int* vtab;
  long long row_of_pos0;     // dense: flat row of logical position 0
};

struct Head {
  size_t row_stride;         // bytes of one stored row (all heads)
  int f0;                    // flat index of the head's first element (h * hd)
  int half;                  // int4: F / 2, the flat index of the first high nibble
  int ns_row;                // scales per stored row (F / group)
  int s0, ns;                // the head's first scale in a row, and the count
                             // of groups its elements touch
  int group;                 // elements per scale (a multiple of 16)
};

// Byte offset, within a stored row, of the 16 bytes that hold chunk c of
// a head's row as staged (c counts 16-byte copies: 8 elements for bf16, 16
// otherwise).
template <int PREC>
__device__ __forceinline__ int chunk_offset(const Head& hd, int c) {
  if (PREC == 2) return 2 * hd.f0 + 16 * c;
  const int f = hd.f0 + 16 * c;
  return PREC == 1 && f >= hd.half ? f - hd.half : f;
}

// int4: whether 16-element chunk c of the head is stored as high nibbles.
__device__ __forceinline__ bool chunk_hi(const Head& hd, int c) {
  return hd.f0 + 16 * c >= hd.half;
}

// The index of 16-element chunk c's scale among the head's staged scales.
__device__ __forceinline__ int chunk_sidx(const Head& hd, int c) {
  return (hd.f0 + 16 * c) / hd.group - hd.s0;
}

// The stored K and V row of each of the block's rows (logical positions
// lo + i, i < n), looked up once (through the page tables for a pool): -1
// for a row that is not read (i >= nrows or past load_end); with the parity
// of the row's first scale, which sets where it lands in its 4-byte word.
__device__ __forceinline__ void lookup_rows(int* krow, int* vrow,
                                            unsigned char* kshift,
                                            unsigned char* vshift,
                                            const Source& src, const Head& hd,
                                            int P, int lo, int n, int nrows,
                                            int load_end) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pos = lo + i;
    long long kr = -1, vr = -1;
    if (i < nrows && pos < load_end) {
      if (src.ktab != nullptr) {
        const int pg = pos / P, off = pos - pg * P;
        kr = (long long)src.ktab[pg] * P + off;
        vr = (long long)src.vtab[pg] * P + off;
      } else {
        kr = vr = src.row_of_pos0 + pos;
      }
    }
    krow[i] = (int)kr;
    vrow[i] = (int)vr;
    kshift[i] = (unsigned char)((kr * hd.ns_row + hd.s0) & 1);
    vshift[i] = (unsigned char)((vr * hd.ns_row + hd.s0) & 1);
  }
}

// Start the cp.async copies of the tile whose first row is block row r0:
// consecutive threads copy consecutive 16-byte chunks of a row; a row that
// is not read is zero-filled, its scales too.
template <int PREC, int HD>
__device__ __forceinline__ void copy_tile(unsigned char* st, const int* krow,
                                           const int* vrow, const Source& src,
                                           const Head& hd, int r0) {
  constexpr int RB = row_bytes(PREC, HD);
  constexpr int NC = RB / 16;
  for (int i = threadIdx.x; i < 2 * kTile * NC; i += kThreads) {
    const int which = i / (kTile * NC), t = (i / NC) % kTile, c = i % NC;
    const int row = (which == 0 ? krow : vrow)[r0 + t];
    const unsigned char* base = which == 0 ? src.kd : src.vd;
    cp_async16(st + (which * kTile + t) * RB + 16 * c,
               row >= 0 ? base + (size_t)row * hd.row_stride + chunk_offset<PREC>(hd, c)
                        : base,
               row >= 0 ? 16 : 0);
  }
  // the head's scales of each row (K's, then V's): halfs [a, a + ns) of the
  // scale array, copied as the 4-byte words that cover them (a word never
  // reaches past the last scale it holds: the copy stops at 2 * (a + ns)
  // bytes)
  for (int i = threadIdx.x; PREC != 2 && i < 2 * kTile; i += kThreads) {
    const int which = i / kTile, t = i % kTile;
    const long long row = (which == 0 ? krow : vrow)[r0 + t];
    const unsigned char* sbase = which == 0 ? src.ks : src.vs;
    unsigned char* sdst = st + 2 * kTile * RB + (which * kTile + t) * kScW * 4;
    const long long a = row * hd.ns_row + hd.s0;
    const long long w0 = a >> 1;
    const int nw = (int)(((a + hd.ns + 1) >> 1) - w0);
#pragma unroll
    for (int k = 0; k < kScW; ++k) {
      if (row < 0) {
        cp_async4(sdst + 4 * k, sbase, 0);
      } else if (k < nw) {
        const long long end = 2 * (a + hd.ns) - 4 * (w0 + k);
        cp_async4(sdst + 4 * k, sbase + 4 * (w0 + k), end < 4 ? (int)end : 4);
      }
    }
  }
}

// The scale of a chunk of a staged row whose scale is the head's ``sidx``-th
// (chunk_sidx; 1 for bf16 pages).
template <int PREC>
__device__ __forceinline__ float chunk_scale(const unsigned char* words,
                                             unsigned char shift, int sidx) {
  if (PREC == 2) return 1.f;
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(words)[shift + sidx]);
}

// Scores of N query rows r0 .. r0 + N - 1 against tile row t (16-element
// chunk c of it in x, its scale sc; ``on`` false for an idle lane, which
// adds 0): N independent FMA chains, reduced over the GL lanes of the row,
// written by its chunk-0 thread (-inf where the row is not seen). q_s
// interleaves a row's G = hd / 16 chunks.
template <int N, int G, int GL, int HD>
__device__ __forceinline__ void score_rows(const float* q_s, const float (&x)[16],
                                           float sc, int c, bool on, int r0,
                                           int t, bool live, int pos,
                                           const int* lim_s, float inv_sqrt,
                                           float* p_s) {
  float s[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    float a = 0.f;
    if (on) {
      const float4* qv = reinterpret_cast<const float4*>(q_s + (r0 + u) * HD) + c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = qv[k * G];
        a = fmaf(v.x, x[4 * k], a);
        a = fmaf(v.y, x[4 * k + 1], a);
        a = fmaf(v.z, x[4 * k + 2], a);
        a = fmaf(v.w, x[4 * k + 3], a);
      }
    }
    s[u] = a * sc;
  }
#pragma unroll
  for (int o = GL / 2; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < N; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
  if (c == 0) {
#pragma unroll
    for (int u = 0; u < N; ++u)
      p_s[(r0 + u) * kTile + t] =
          (live && pos < lim_s[r0 + u]) ? s[u] * inv_sqrt : neg_inf();
  }
}

template <int PREC, int HD, int RPT>
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const void* __restrict__ q, int qf32, long long q_sb,
                  long long q_ss, long long q_sh,
                  const unsigned char* __restrict__ kd,
                  const unsigned char* __restrict__ ks,
                  const unsigned char* __restrict__ vd,
                  const unsigned char* __restrict__ vs,
                  const int* __restrict__ valid_len,
                  const int* __restrict__ ktable, const int* __restrict__ vtable,
                  const unsigned char* __restrict__ fkd,
                  const unsigned char* __restrict__ fks,
                  const unsigned char* __restrict__ fvd,
                  const unsigned char* __restrict__ fvs,
                  const int* __restrict__ base_pos, float* __restrict__ part_acc,
                  float2* __restrict__ part_ml, int S, int P, int n_log,
                  int Hkv, int rep, int qs, int ns_row, int group, int causal,
                  int Sf, int n_split, float inv_sqrt) {
  constexpr int RB = row_bytes(PREC, HD);
  constexpr int G = HD / 16;       // 16-element chunks per row
  constexpr int GL = score_lanes(HD);   // threads of a score row (>= G)
  constexpr int kSplit = split_of(RPT);
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's query rows: rows rbase .. rbase + R - 1 of the KV head's
  // rep * qs (query row r is head h * rep + r / qs, query r % qs)
  const int R_all = rep * qs, RG = rows_per_group(R_all);
  const int ng = row_groups(R_all);
  const int rbase = (blockIdx.x % ng) * RG;
  const int R = R_all - rbase < RG ? R_all - rbase : RG;
  const Layout lay = layout(PREC, HD, RG);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* c_s = reinterpret_cast<float*>(smem + lay.c);
  int* lim_s = reinterpret_cast<int*>(smem + lay.lim);
  int* krow = reinterpret_cast<int*>(smem + lay.krow);
  int* vrow = reinterpret_cast<int*>(smem + lay.vrow);
  unsigned char* kshift = smem + lay.kshift;
  unsigned char* vshift = smem + lay.vshift;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = blockIdx.y, h = blockIdx.x / ng, b = blockIdx.z;
  const int nparts = gridDim.y;
  const bool fresh = j == n_split;          // the fresh-row block
  const int valid = valid_len[b];
  const int base = Sf > 0 ? base_pos[b] : valid;
  int end = valid < base ? valid : base;
  end = end < 0 ? 0 : (end > S ? S : end);
  const size_t pbase = ((size_t)(b * Hkv + h) * nparts + j) * R_all + rbase;

  int lo, hi, load_end;
  if (fresh) {
    lo = base;
    hi = base + Sf;
    load_end = valid;
  } else {
    lo = j * kSplit;
    hi = (j + 1) * kSplit < end ? (j + 1) * kSplit : end;
    load_end = hi;
  }
  if (!fresh && lo >= end) {   // nothing of this slot in the split: the empty state
    for (int i = tid; i < R * HD; i += kThreads) part_acc[pbase * HD + i] = 0.f;
    for (int r = tid; r < R; r += kThreads) part_ml[pbase + r] = make_float2(neg_inf(), 0.f);
  } else {
    Head hd;
    hd.row_stride = (size_t)Hkv * HD * (PREC == 2 ? 2 : 1) / (PREC == 1 ? 2 : 1);
    hd.f0 = h * HD;
    hd.half = Hkv * HD / 2;
    hd.ns_row = ns_row;
    hd.group = group;
    hd.s0 = hd.f0 / group;
    hd.ns = (hd.f0 + HD - 1) / group - hd.s0 + 1;
    // a pool's logical rows go through the slot's K and V page tables
    const bool paged = ktable != nullptr;
    const int* kt = paged ? ktable + (size_t)b * n_log : nullptr;
    const int* vt = paged ? vtable + (size_t)b * n_log : nullptr;
    const Source src = fresh ? Source{fkd, fks, fvd, fvs, nullptr, nullptr,
                                      (long long)b * Sf - base}
                             : Source{kd, ks, vd, vs, kt, vt, (long long)b * S};
    const int ntiles = (hi - lo + kTile - 1) / kTile;

    // look the rows up, start their loads (the whole ring: kStages tiles),
    // then read the queries while they are in flight
    lookup_rows(krow, vrow, kshift, vshift, src, hd, P, lo, ntiles * kTile,
                hi - lo, load_end);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (k < ntiles)
        copy_tile<PREC, HD>(smem + lay.ring + k * stage_bytes(PREC, HD), krow,
                             vrow, src, hd, k * kTile);
      cp_async_commit();
    }
    // q_s[r] holds query row rbase + r with element 16c + 4k + e at
    // (k * G + c) * 4 + e, so the G threads of a row read 16 consecutive
    // bytes each
    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int rr = (rbase + r) / qs, qi = rbase + r - rr * qs;
      const long long off = b * q_sb + qi * q_ss + (long long)(h * rep + rr) * q_sh + d;
      const float v = qf32 ? static_cast<const float*>(q)[off]
                           : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[off]);
      q_s[r * HD + (((d >> 2) & 3) * G + (d >> 4)) * 4 + (d & 3)] = v;
    }
    for (int r = tid; r < R; r += kThreads) {
      const int limit = causal ? valid - qs + 1 + (rbase + r) % qs : valid;
      lim_s[r] = (!fresh && limit > base) ? base : limit;   // stale past base
      m_s[r] = neg_inf();
      l_s[r] = 0.f;
    }

    // P.V: thread = (chunk c, row slice ts, query-row group rg)
    const int TS = pv_slices(RG, G);
    const int pc = tid % G, pts = (tid / G) % TS, prg = tid / (G * TS);
    const bool pv_on = prg * RPT < R;
    // a thread's chunk is the same in every tile, so its nibble and scale
    // index are too (scores: chunk sc_c, idle past G; P.V: chunk pc)
    const int sc_c = tid % GL;
    const bool sc_on = sc_c < G;
    const bool sc_hi = PREC == 1 && chunk_hi(hd, sc_on ? sc_c : 0);
    const int sc_idx = chunk_sidx(hd, sc_on ? sc_c : 0);
    const bool pv_hi = PREC == 1 && chunk_hi(hd, pc);
    const int pv_idx = chunk_sidx(hd, pc);
    float acc[RPT][16];
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[a][e] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      // tile it has landed once at most kStages - 1 (it == 0) or kStages - 2
      // (after a refill) younger groups are pending
      if (it == 0) {
        cp_async_wait<kStages - 1>();
      } else {
        cp_async_wait<kStages - 2>();
      }
      __syncthreads();
      if (it > 0) {   // refill the slot of tile it - 1, which every thread is done with
        const int nxt = it + kStages - 1;
        if (nxt < ntiles)
          copy_tile<PREC, HD>(smem + lay.ring + (nxt % kStages) * stage_bytes(PREC, HD),
                               krow, vrow, src, hd, nxt * kTile);
        cp_async_commit();
      }
      const int slot = it % kStages;
      const unsigned char* st = smem + lay.ring + slot * stage_bytes(PREC, HD);
      const unsigned char* kst = st;
      const unsigned char* vst = st + kTile * RB;
      const unsigned char* ksc = st + 2 * kTile * RB;
      const unsigned char* vsc = ksc + kTile * kScW * 4;
      const int pos0 = lo + it * kTile;
      const int nrows = hi - pos0 < kTile ? hi - pos0 : kTile;

      // scores: row t, chunk c, query rows four (then two, then one) at once
      // (independent FMA chains); reduced over the GL lanes of the row
      for (int t = tid / GL; t < kTile; t += kThreads / GL) {
        const int c = sc_c;
        float x[16];
        float sc = 0.f;
        if (sc_on) {
          chunk16<PREC>(kst + t * RB, c, sc_hi, x);
          sc = chunk_scale<PREC>(ksc + t * kScW * 4, kshift[it * kTile + t], sc_idx);
        }
        const int pos = pos0 + t;
        const bool live = t < nrows;
        int r0 = 0;
        for (; r0 + 4 <= R; r0 += 4)
          score_rows<4, G, GL, HD>(q_s, x, sc, c, sc_on, r0, t, live, pos, lim_s,
                                   inv_sqrt, p_s);
        if (r0 + 2 <= R) {
          score_rows<2, G, GL, HD>(q_s, x, sc, c, sc_on, r0, t, live, pos, lim_s,
                                   inv_sqrt, p_s);
          r0 += 2;
        }
        if (r0 < R)
          score_rows<1, G, GL, HD>(q_s, x, sc, c, sc_on, r0, t, live, pos, lim_s,
                                   inv_sqrt, p_s);
      }
      __syncthreads();
      // online softmax: a warp takes two query rows at once, a lane kPerLane
      // of the tile's rows
      for (int r0 = 2 * warp; r0 < R; r0 += 2 * kWarps) {
        float sv[2][kPerLane], mt[2], m_old[2], m_new[2], sum[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + u < R ? r0 + u : r0;
          mt[u] = neg_inf();
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            sv[u][k] = p_s[r * kTile + lane + 32 * k];
            mt[u] = fmaxf(mt[u], sv[u][k]);
          }
          m_old[u] = m_s[r];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            mt[u] = fmaxf(mt[u], __shfl_xor_sync(0xffffffffu, mt[u], o));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          m_new[u] = fmaxf(m_old[u], mt[u]);
          sum[u] = 0.f;
#pragma unroll
          for (int k = 0; k < kPerLane; ++k) {
            sv[u][k] = sv[u][k] == neg_inf() ? 0.f : expf(sv[u][k] - m_new[u]);
            sum[u] += sv[u][k];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + u;
          if (r < R) {
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) p_s[r * kTile + lane + 32 * k] = sv[u][k];
            if (lane == 0) {
              const float corr = m_old[u] == neg_inf() ? 0.f : expf(m_old[u] - m_new[u]);
              c_s[r] = corr;
              l_s[r] = l_s[r] * corr + sum[u];
              m_s[r] = m_new[u];
            }
          }
        }
      }
      __syncthreads();
      // P.V into registers
      if (pv_on) {
#pragma unroll
        for (int a = 0; a < RPT; ++a) {
          const int r = prg * RPT + a;
          const float corr = r < R ? c_s[r] : 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[a][e] *= corr;
        }
#pragma unroll 2
        for (int t = pts; t < nrows; t += TS) {
          float x[16];
          chunk16<PREC>(vst + t * RB, pc, pv_hi, x);
          const float sc = chunk_scale<PREC>(vsc + t * kScW * 4,
                                             vshift[it * kTile + t], pv_idx);
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const int r = prg * RPT + a;
            if (r < R) {
              const float pw = p_s[r * kTile + t] * sc;
#pragma unroll
              for (int e = 0; e < 16; ++e) acc[a][e] = fmaf(pw, x[e], acc[a][e]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // sum the row slices in a fixed order (the ring is free now)
    float* red = reinterpret_cast<float*>(smem + lay.ring);
    if (pv_on) {
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const int r = prg * RPT + a;
        if (r < R) {
          float4* dst = reinterpret_cast<float4*>(red + ((size_t)pts * R + r) * HD + 16 * pc);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dst[k] = make_float4(acc[a][4 * k], acc[a][4 * k + 1], acc[a][4 * k + 2],
                                 acc[a][4 * k + 3]);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < R * HD; i += kThreads) {
      float s = 0.f;
#pragma unroll 8
      for (int ts = 0; ts < TS; ++ts) s += red[(size_t)ts * R * HD + i];
      part_acc[pbase * HD + i] = s;
    }
    for (int r = tid; r < R; r += kThreads) part_ml[pbase + r] = make_float2(m_s[r], l_s[r]);
  }
}

// Merge the partials of query row r of (slot b, KV head h) in split order
// (the fresh part last): out = sum_j w_j acc_j / max(sum_j w_j l_j, 1e-30),
// w_j = exp(m_j - max_j m_j), 0 for a part with m_j = -inf (its terms are
// exact zeros, so skipping them changes no bit). One thread per element of
// hd; writes (B, s, H, hd) in q's dtype.
template <int HD>
__global__ void __launch_bounds__(HD)
decode_attn_merge(const float* __restrict__ part_acc,
                  const float2* __restrict__ part_ml, void* __restrict__ out,
                  int qf32, int nparts, int Hkv, int rep, int qs) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int R = rep * qs;
  const size_t p0 = (size_t)(b * Hkv + h) * nparts * R + r;
  float mx = neg_inf();
#pragma unroll 8
  for (int j = 0; j < nparts; ++j) mx = fmaxf(mx, part_ml[p0 + (size_t)j * R].x);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int j = 0; j < nparts; ++j) {
    const float2 ml = part_ml[p0 + (size_t)j * R];
    const float w = ml.x == neg_inf() ? 0.f : expf(ml.x - mx);
    if (w != 0.f) {
      l += w * ml.y;
      a += w * part_acc[(p0 + (size_t)j * R) * HD + d];
    }
  }
  const float o = a / fmaxf(l, 1e-30f);
  const int rr = r / qs, qi = r - rr * qs;
  const size_t off = (((size_t)b * qs + qi) * (Hkv * rep) + h * rep + rr) * HD + d;
  if (qf32) {
    static_cast<float*>(out)[off] = o;
  } else {
    static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16_rn(o);
  }
}

struct Args {
  const void* q;
  int qf32;
  long long q_sb, q_ss, q_sh;
  const unsigned char *kd, *ks, *vd, *vs;
  const int *valid, *ktable, *vtable;
  const unsigned char *fkd, *fks, *fvd, *fvs;
  const int* base;
  float* part_acc;
  float2* part_ml;
  void* out;
  int B, S, P, n_log, Hkv, rep, qs, ns_row, group, causal, Sf, n_split;
  float inv_sqrt;
};

template <int PREC, int HD, int RPT>
int launch(const Args& a, cudaStream_t st) {
  const int smem = layout(PREC, HD, rows_per_group(a.rep * a.qs)).total;
  // past 48 KB a block needs the instantiation's opt-in, set once (not per
  // launch, so a launch can be captured in a CUDA graph); the merge kernel
  // uses no shared memory and needs none
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_split<PREC, HD, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const int nparts = a.n_split + (a.Sf > 0 ? 1 : 0);
  // heads (and row groups) vary fastest: blocks that run side by side read
  // the other heads' bytes of the same rows
  const dim3 grid(a.Hkv * row_groups(a.rep * a.qs), nparts, a.B);
  decode_attn_split<PREC, HD, RPT><<<grid, kThreads, smem, st>>>(
      a.q, a.qf32, a.q_sb, a.q_ss, a.q_sh, a.kd, a.ks, a.vd, a.vs, a.valid,
      a.ktable, a.vtable, a.fkd, a.fks, a.fvd, a.fvs, a.base, a.part_acc,
      a.part_ml, a.S, a.P, a.n_log, a.Hkv, a.rep, a.qs, a.ns_row, a.group,
      a.causal, a.Sf, a.n_split, a.inv_sqrt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attn_merge<HD><<<dim3(a.rep * a.qs, a.Hkv, a.B), HD, 0, st>>>(
      a.part_acc, a.part_ml, a.out, a.qf32, nparts, a.Hkv, a.rep, a.qs);
  return (int)cudaGetLastError();
}

template <int PREC, int HD>
int launch_rows(const Args& a, cudaStream_t st) {
  return rows_per_thread(rows_per_group(a.rep * a.qs)) == 1
             ? launch<PREC, HD, 1>(a, st)
             : launch<PREC, HD, 4>(a, st);
}

template <int PREC>
int launch_hd(const Args& a, int hd, cudaStream_t st) {
  if (hd == 32) return launch_rows<PREC, 32>(a, st);
  if (hd == 64) return launch_rows<PREC, 64>(a, st);
  if (hd == 80) return launch_rows<PREC, 80>(a, st);
  if (hd == 128) return launch_rows<PREC, 128>(a, st);
  return (int)cudaErrorInvalidValue;   // no copy for this head dim
}

}  // namespace

// Dynamic shared memory of one split block for a KV head's ``rows`` =
// rep * qs query rows at head dim ``hd`` and precision ``prec``; -1 where
// the kernel does not take the shape (hd not 32, 64, 80 or 128).
REPRO_API int repro_decode_attn_smem(int rows, int hd, int prec) {
  if ((hd != 32 && hd != 64 && hd != 80 && hd != 128) || rows < 1) return -1;
  return layout(prec, hd, rows_per_group(rows)).total;
}

// q (B, s, H, hd) bf16 (qf32 = 0) or f32, element strides q_sb, q_ss, q_sh
// (the last dim contiguous), head h * rep + r of KV head h; a dense cache
// (n_log == 0): K/V data (B, S, F_store) with scales (B, S, F / group) bf16
// (ignored for bf16 pages), tables ignored; a paged cache (n_log > 0): K/V
// pools (N, P, F_store) with scales (N, P, F / group) and K/V tables
// (B, n_log) int32, S ignored (it is n_log * P); valid (B,) int32 counts the
// valid rows including the fresh ones; fresh K/V (B, Sf, F_store) and scales
// (B, Sf, F / group) at positions base (B,) int32 + j (all ignored when
// Sf == 0); ``scratch`` f32 of B * Hkv * (ceil(S / L) + (Sf > 0)) *
// rep * s * (hd + 2) elements (the per-split partials); out (B, s, H, hd)
// contiguous in q's dtype. prec: 0 int8, 1 int4, 2 bf16. group (int8, int4)
// is a multiple of 16 that divides F = Hkv * hd. ``split`` is the caller's
// logical rows per split (the plain version's ``split_rows(rep * qs)``,
// which sized the scratch). Returns cudaErrorInvalidValue, launching
// nothing, for a shape the kernel has no copy for (hd not 32, 64, 80 or
// 128; another group or precision; int4 where F / 2 is not a multiple of
// 16) or a split other than its own.
REPRO_API int repro_decode_attn(const void* q, const void* kd, const void* ks,
                                const void* vd, const void* vs,
                                const void* valid, const void* ktable,
                                const void* vtable, const void* fkd,
                                const void* fks, const void* fvd,
                                const void* fvs, const void* base, void* out,
                                void* scratch, long long q_sb, long long q_ss,
                                long long q_sh, int qf32, int B, int S, int P,
                                int n_log, int Hkv, int rep, int qs, int hd,
                                int group, int prec, int causal, int Sf,
                                int split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1 || qs < 1 || Hkv < 1 || prec < 0 || prec > 2 ||
      (hd != 32 && hd != 64 && hd != 80 && hd != 128) ||
      (prec != 2 && (group < 16 || group % 16 || (Hkv * hd) % group)) ||
      (prec == 1 && (Hkv * hd / 2) % 16) || split != split_rows(rep * qs))
    return (int)cudaErrorInvalidValue;
  if (prec == 2) group = 16;   // no scales: a value that keeps the arithmetic defined
  if (n_log > 0) S = n_log * P;
  const int L = split;
  const int n_split = S > 0 ? (S + L - 1) / L : 1;
  const int nparts = n_split + (Sf > 0 ? 1 : 0);
  Args a;
  a.q = q;
  a.qf32 = qf32;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.kd = static_cast<const unsigned char*>(kd);
  a.ks = static_cast<const unsigned char*>(ks);
  a.vd = static_cast<const unsigned char*>(vd);
  a.vs = static_cast<const unsigned char*>(vs);
  a.valid = static_cast<const int*>(valid);
  a.ktable = n_log > 0 ? static_cast<const int*>(ktable) : nullptr;
  a.vtable = n_log > 0 ? static_cast<const int*>(vtable) : nullptr;
  a.fkd = static_cast<const unsigned char*>(fkd);
  a.fks = static_cast<const unsigned char*>(fks);
  a.fvd = static_cast<const unsigned char*>(fvd);
  a.fvs = static_cast<const unsigned char*>(fvs);
  a.base = static_cast<const int*>(base);
  a.part_acc = static_cast<float*>(scratch);
  a.part_ml = reinterpret_cast<float2*>(static_cast<float*>(scratch) +
                                        (size_t)B * Hkv * nparts * rep * qs * hd);
  a.out = out;
  a.B = B;
  a.S = S;
  a.P = P;
  a.n_log = n_log;
  a.Hkv = Hkv;
  a.rep = rep;
  a.qs = qs;
  a.ns_row = Hkv * hd / group;
  a.group = group;
  a.causal = causal;
  a.Sf = Sf;
  a.n_split = n_split;
  a.inv_sqrt = 1.0f / sqrtf((float)hd);
  if (prec == 0) return launch_hd<0>(a, hd, st);
  if (prec == 1) return launch_hd<1>(a, hd, st);
  return launch_hd<2>(a, hd, st);
}
