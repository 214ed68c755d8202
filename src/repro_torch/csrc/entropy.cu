// Softmax entropy of whole weight arrays, for Hopper (paper section 3.1):
//
//     H = lse(w) - sum_i softmax(w)_i * w_i = (m + log Z) - S / Z
//
// with m = max w, Z = sum e^(w - m), S = sum w e^(w - m) over each flattened
// array, in f32 (eps = 0, the closed form of ``entropy_ref``).
//
// Replaces the TPU kernel ``entropy_pallas`` (src/repro/kernels/entropy/
// kernel.py:55). The TPU grid walked (1, 1024) chunks of one array in order
// and carried (m, Z, S) in a VMEM scratch from one step to the next. Here
// one launch takes a whole list of arrays (every matrix of a model's
// analysis), described by a table passed by value as a kernel parameter
// (no host-to-device copy, so a CUDA graph can capture the launch): per
// array its pointer, element count, dtype (bf16 or f32) and first tile.
// Up to kSmallArrays arrays take a table of that many entries; longer
// lists, up to kMaxArrays, a table of 20 KB (CUDA 12.1 takes up to 32764
// bytes of parameters on sm_70 and later).
//
//   * pass 1: each array is cut into tiles of kTile elements; a tile never
//     spans two arrays. Persistent blocks copy the table into shared
//     memory; then each warp walks tiles on its own (no block barrier
//     between tiles), finds its tile's array by a binary search over the
//     first-tile offsets, folds the tile into one (m, Z, S) and writes it as
//     the tile's partial;
//   * pass 2: one block per array merges that array's partials in tile
//     order (contiguous runs per thread, then a tree over the runs in
//     order) and writes its H.
// No atomics: an array's H depends on its elements and dtype only, not on
// the other arrays of the launch or on how the blocks were scheduled.
//
// What bounds it on the H100: one read of every array (2 or 4 bytes an
// element) over 3.35 TB/s. The fold is built so that the instruction count
// stays under that: each lane issues kLoads 16-byte loads before it folds
// any, takes their max, rescales its running state once if the max rose,
// and then takes the elements' exponentials independently, with no branch
// per element: e = 2^(x log2 e - m log2 e), one FFMA and one ex2 (the
// approximate ex2 that exp2f compiles to under fast math, 2 ulp). The
// ragged tail of an array and an array that is not 16-byte aligned take
// the scalar path (expf, one element at a time). Indices are size_t: the
// largest input (an embedding table of 393M elements) is past 2^31 bytes.
// The tile (16 KB of bf16, 8 rounds of kLoads loads a lane) and the loads'
// L2 prefetch hint were chosen on an H100 among tiles of 2048-16384
// elements, 4 or 8 loads and 4-8 blocks an SM (PERF.md section 6).
//
// The merge of two states with m = -inf on both sides (an empty thread,
// warp or tile run) would compute exp(-inf - -inf) = NaN; ``merge``
// returns the empty state there instead.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // pass 1
constexpr int kMinBlocks = 6;        // pass-1 blocks an SM (40 registers)
constexpr long long kTile = 8192;    // elements of one tile (one warp's)
constexpr int kLoads = 4;            // 16-byte loads a lane has in flight
constexpr int kSmallArrays = 16;     // the table of a short list
constexpr int kMaxArrays = 1024;     // the table of a long list (20 KB)
constexpr int kFinalThreads = 1024;  // pass 2
constexpr int kFinalBatch = 8;       // partials pass 2 loads before merging
constexpr float kLog2e = 1.4426950408889634f;

struct State {
  float m, z, s;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ State empty_state() { return {neg_inf(), 0.f, 0.f}; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes read once: not kept in L1, and the L2 asked to fetch the whole
// 256-byte sector group (the lanes' next loads are its neighbours).
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The scalar path: fold one element into a running state, one exp per
// element (two when the element raises the running max).
__device__ __forceinline__ void fold(State& st, float x) {
  if (x > st.m) {
    const float c = expf(st.m - x);  // 0 while the state is empty
    st.z = st.z * c + 1.f;
    st.s = st.s * c + x;
    st.m = x;
  } else {
    const float e = expf(x - st.m);
    st.z += e;
    st.s = fmaf(x, e, st.s);
  }
}

__device__ __forceinline__ State merge(State a, State b) {
  const float m = fmaxf(a.m, b.m);
  if (m == neg_inf()) return empty_state();
  const float ca = expf(a.m - m), cb = expf(b.m - m);
  return {m, a.z * ca + b.z * cb, a.s * ca + b.s * cb};
}

// The warp's 32 states merged in lane order: lanes 2i and 2i + 1 first,
// then pairs of pairs, ...; the lower run always on the left, so both lanes
// of a pair compute the same value and lane 0 ends with the whole warp.
__device__ __forceinline__ State warp_merge(State st) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    State other;
    other.m = __shfl_xor_sync(0xffffffffu, st.m, o);
    other.z = __shfl_xor_sync(0xffffffffu, st.z, o);
    other.s = __shfl_xor_sync(0xffffffffu, st.s, o);
    st = (lane & o) ? merge(other, st) : merge(st, other);
  }
  return st;
}

// The block's kFinalThreads (32 warps) states merged in thread order: each
// warp's in lane order, then warp 0 merges the warps' in the same way.
// Valid in thread 0.
__device__ __forceinline__ State block_merge(State st) {
  __shared__ State warps[kFinalThreads / 32];
  static_assert(kFinalThreads == 32 * 32, "one warp merges the warps");
  st = warp_merge(st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = st;
  __syncthreads();
  if (warp == 0) st = warp_merge(warps[lane]);
  return st;
}

// This lane's share of one tile of cnt elements at w, folded into a state.
template <typename T>
__device__ __forceinline__ State fold_tile(const T* __restrict__ w,
                                           size_t cnt, int lane) {
  State st = empty_state();
  size_t tail = 0;
  if ((reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const size_t nv = cnt / kPer;
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    for (size_t b = lane; b < nv; b += 32 * kLoads) {
      uint4 u[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        if (b + k * 32 < nv) u[k] = ld_stream(wv + b + k * 32);
      float vmax = neg_inf();
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        if (b + k * 32 < nv)
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            vmax = fmaxf(vmax, vec_elem<T>(u[k], j));
      if (vmax > st.m) {  // once per kLoads vectors, not per element
        const float c = ex2((st.m - vmax) * kLog2e);  // 0 while empty
        st.z *= c;
        st.s *= c;
        st.m = vmax;
      }
      const float ml = st.m * kLog2e;
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        if (b + k * 32 < nv)
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const float x = vec_elem<T>(u[k], j);
            const float e = ex2(fmaf(x, kLog2e, -ml));
            st.z += e;
            st.s = fmaf(x, e, st.s);
          }
    }
    tail = nv * kPer;
  }
  for (size_t i = tail + lane; i < cnt; i += 32) fold(st, to_f32(w[i]));
  return st;
}

// The table of one launch: per array its pointer, its element count * 2 +
// 1 if bf16, and its first tile; first[narrays] is the tiles of all arrays.
template <int N>
struct Table {
  const void* ptr[N];
  long long nf[N];
  int first[N + 1];
};

// Pass 1: persistent blocks; each warp walks tiles on its own (no block
// barrier between tiles), folds one and writes its partial (m, Z, S, 0).
// The block first copies the table into shared memory.
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
entropy_tiles_kernel(const __grid_constant__ Table<N> tab, int narrays,
                     int tiles, float4* __restrict__ partial) {
  extern __shared__ long long meta[];  // 2 * narrays, then first[]
  int* first = reinterpret_cast<int*>(meta + 2 * narrays);
  for (int i = threadIdx.x; i <= narrays; i += kThreads) {
    if (i < narrays) {
      meta[2 * i] = reinterpret_cast<long long>(tab.ptr[i]);
      meta[2 * i + 1] = tab.nf[i];
    }
    first[i] = tab.first[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  for (int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); t < tiles;
       t += warps) {
    // the array of tile t: the last a with first[a] <= t
    int lo = 0, hi = narrays - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const long long nf = meta[2 * lo + 1];
    const size_t n = (size_t)(nf >> 1);
    const size_t begin = (size_t)(t - first[lo]) * kTile;
    const size_t cnt = n - begin < (size_t)kTile ? n - begin : (size_t)kTile;
    State st = (nf & 1)
        ? fold_tile(reinterpret_cast<const __nv_bfloat16*>(meta[2 * lo]) +
                        begin, cnt, lane)
        : fold_tile(reinterpret_cast<const float*>(meta[2 * lo]) + begin,
                    cnt, lane);
    st = warp_merge(st);
    if (lane == 0) partial[t] = make_float4(st.m, st.z, st.s, 0.f);
  }
}

// Pass 2: block a merges array a's partials first[a] .. first[a + 1] - 1 in
// tile order: thread i a contiguous run of them, in kFinalBatch loads at a
// time, then the runs in thread order; writes H.
template <int N>
__global__ void __launch_bounds__(kFinalThreads)
entropy_final_kernel(const __grid_constant__ Table<N> tab,
                     const float4* __restrict__ partial,
                     float* __restrict__ out) {
  const int a = blockIdx.x;
  const int lo = tab.first[a];
  const int hi = tab.first[a + 1];
  const int run = (hi - lo + kFinalThreads - 1) / kFinalThreads;
  const int begin = lo + threadIdx.x * run;
  const int end = begin + run < hi ? begin + run : hi;
  State st = empty_state();
  for (int i = begin; i < end; i += kFinalBatch) {
    float4 p[kFinalBatch];
#pragma unroll
    for (int k = 0; k < kFinalBatch; ++k)
      if (i + k < end) p[k] = partial[i + k];
#pragma unroll
    for (int k = 0; k < kFinalBatch; ++k)
      if (i + k < end) st = merge(st, {p[k].x, p[k].y, p[k].z});
  }
  st = block_merge(st);
  if (threadIdx.x == 0) out[a] = (st.m + logf(st.z)) - st.s / st.z;
}

// The host table (narrays x 4 int64: pointer, element count, 1 if bf16,
// first tile) into a Table<N>, and both passes launched with it.
template <int N>
int launch(const long long* table, int narrays, int tiles, float4* partial,
           float* out, cudaStream_t st) {
  Table<N> tab;
  for (int i = 0; i < narrays; ++i) {
    tab.ptr[i] = reinterpret_cast<const void*>(table[4 * i]);
    tab.nf[i] = table[4 * i + 1] * 2 + table[4 * i + 2];
    tab.first[i] = (int)table[4 * i + 3];
  }
  tab.first[narrays] = tiles;
  const size_t smem = (size_t)narrays * 2 * sizeof(long long) +
                      (size_t)(narrays + 1) * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, entropy_tiles_kernel<N>, kThreads, smem);
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  entropy_tiles_kernel<N><<<grid, kThreads, smem, st>>>(tab, narrays, tiles,
                                                         partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  entropy_final_kernel<N><<<narrays, kFinalThreads, 0, st>>>(tab, partial,
                                                              out);
  return (int)cudaGetLastError();
}

}  // namespace

// table: narrays x 4 int64 in host memory, read before the call returns
// (see ``launch``), first tiles in order, every array non-empty; tile: the
// caller's tile, which must be kTile; partial: tiles float4 scratch; out:
// narrays f32. Returns cudaErrorInvalidValue, with no launch, for a table
// it cannot hold (0 or more than kMaxArrays arrays, fewer tiles than
// arrays) or another tile.
REPRO_API int repro_entropy_many(const void* table, int narrays, int tiles,
                                 int tile, void* partial, void* out,
                                 void* stream) {
  if (narrays < 1 || narrays > kMaxArrays || tiles < narrays ||
      tile != kTile)
    return (int)cudaErrorInvalidValue;
  const long long* tab = static_cast<const long long*>(table);
  float4* part = static_cast<float4*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrays <= kSmallArrays)
    return launch<kSmallArrays>(tab, narrays, tiles, part, o, st);
  return launch<kMaxArrays>(tab, narrays, tiles, part, o, st);
}
