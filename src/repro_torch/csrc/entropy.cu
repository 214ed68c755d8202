// Softmax entropy of a whole weight array, for Hopper (paper section 3.1):
//
//     H = lse(w) - sum_i softmax(w)_i * w_i = (m + log Z) - S / Z
//
// with m = max w, Z = sum e^(w - m), S = sum w e^(w - m) over the flattened
// array, in f32 (eps = 0, the closed form of ``entropy_ref``).
//
// Replaces the TPU kernel ``entropy_pallas`` (src/repro/kernels/entropy/
// kernel.py:55). The TPU grid walked (1, 1024) chunks in order and carried
// (m, Z, S) in a VMEM scratch from one step to the next. Hopper blocks run in
// no order, so:
//   * pass 1: a grid-stride loop; each thread folds its elements into its
//     own online (m, Z, S), the warp merges its 32 states by shuffles and
//     the block its warps' states through shared memory, always in the
//     same order, and the block writes one partial (m, Z, S);
//   * pass 2: one block merges the partials in a fixed order and writes H.
// No atomics: the result depends on n and the dtype only, not on how the
// blocks were scheduled.
//
// What bounds it on the H100: one read of the array (2 or 4 bytes an
// element) over 3.35 TB/s; one exp an element is far below the f32 rate.
// The array is read in place, bf16 or f32, with 16-byte loads when it is
// 16-byte aligned and bounds checked at the ragged end; the TPU wrapper's
// padded f32 copy (kernel.py:57-60) is not made. Indices are size_t: the
// largest input (an embedding table of 393M elements) is past 2^31 bytes.
//
// The merge of two states with m = -inf on both sides (an empty thread,
// warp or block) would compute exp(-inf - -inf) = NaN; ``merge`` returns
// the empty state there instead.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct State {
  float m, z, s;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ State empty_state() { return {neg_inf(), 0.f, 0.f}; }

// Fold one element into a running state: one exp per element (two when the
// element raises the running max).
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

__device__ __forceinline__ State warp_merge(State st) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    State other;
    other.m = __shfl_xor_sync(0xffffffffu, st.m, o);
    other.z = __shfl_xor_sync(0xffffffffu, st.z, o);
    other.s = __shfl_xor_sync(0xffffffffu, st.s, o);
    // the lower lane's state first, so both lanes compute the same value
    st = (threadIdx.x & o) ? merge(other, st) : merge(st, other);
  }
  return st;
}

// The block's threads' states merged in a fixed order; valid in thread 0.
__device__ __forceinline__ State block_merge(State st) {
  __shared__ State warps[kThreads / 32];
  st = warp_merge(st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    st = warps[0];
    for (int w = 1; w < kThreads / 32; ++w) st = merge(st, warps[w]);
  }
  return st;
}

// Pass 1. VEC: the array is 16-byte aligned and read 16 bytes at a time.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
entropy_partial_kernel(const T* __restrict__ w, size_t n,
                       float* __restrict__ partial) {
  State st = empty_state();
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  size_t tail = 0;
  if (VEC) {
    constexpr int kPer = 16 / sizeof(T);
    const size_t nv = n / kPer;
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    for (size_t i = tid; i < nv; i += stride) {
      const uint4 u = __ldg(wv + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) fold(st, to_f32(e[j]));
    }
    tail = nv * kPer;
  }
  for (size_t i = tail + tid; i < n; i += stride) fold(st, to_f32(w[i]));
  st = block_merge(st);
  if (threadIdx.x == 0) {
    partial[3 * (size_t)blockIdx.x] = st.m;
    partial[3 * (size_t)blockIdx.x + 1] = st.z;
    partial[3 * (size_t)blockIdx.x + 2] = st.s;
  }
}

// Pass 2: one block; thread t merges partials t, t + kThreads, ... in order,
// then the block merges the threads in order.
__global__ void __launch_bounds__(kThreads)
entropy_final_kernel(const float* __restrict__ partial, int nparts,
                     float* __restrict__ out) {
  State st = empty_state();
  for (int i = threadIdx.x; i < nparts; i += kThreads)
    st = merge(st, {partial[3 * i], partial[3 * i + 1], partial[3 * i + 2]});
  st = block_merge(st);
  if (threadIdx.x == 0) out[0] = (st.m + logf(st.z)) - st.s / st.z;
}

template <typename T>
int launch(const void* w, size_t n, int aligned, int nparts, float* partial,
           float* out, cudaStream_t st) {
  const T* wp = static_cast<const T*>(w);
  if (aligned)
    entropy_partial_kernel<T, true><<<nparts, kThreads, 0, st>>>(wp, n, partial);
  else
    entropy_partial_kernel<T, false><<<nparts, kThreads, 0, st>>>(wp, n, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  entropy_final_kernel<<<1, kThreads, 0, st>>>(partial, nparts, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of pass-1 blocks for n elements, i.e. the (nparts, 3) f32 partial
// buffer the caller allocates: about 16 elements a thread, at most 1024
// blocks (about eight per SM), at least one.
REPRO_API int repro_entropy_parts(long long n) {
  const long long per_block = 16LL * kThreads;
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > 1024) b = 1024;
  return (int)b;
}

// w: n elements, bf16 (w_bf16 = 1) or f32, 16-byte aligned when aligned = 1;
// partial: (nparts, 3) f32 scratch; out: one f32.
REPRO_API int repro_entropy(const void* w, int w_bf16, long long n,
                            int aligned, int nparts, void* partial, void* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (w_bf16)
    return launch<__nv_bfloat16>(w, (size_t)n, aligned, nparts, part, o, st);
  return launch<float>(w, (size_t)n, aligned, nparts, part, o, st);
}
