// Comparison-free top-k by iterated digit-plane min-search, for Hopper.
//
// Replaces src/repro/kernels/radix_topk.py::_topk_kernel (the Pallas TPU
// kernel behind topk_keys).  For each row of (B, N) uint32 keys it emits
// the k smallest, ascending, with first-tie indices: k rounds, each a walk
// of the radix-2^r digits at shifts 32-r, 32-2r, ..., >= 0 (exactly the
// reference's; for an r that does not divide 32 the low 32 mod r bits are
// never read, and the emitted key lacks them), keeping the lanes whose
// digit is the least present one, then taking the lowest surviving index
// and removing it from the valid set.
//
// Design: one thread block per row (a single warp for N <= 256).  Per digit
// each thread ORs 1 << digit of its searched lanes into a 2^r-bit presence
// word (up to 8 x 32 bits for r = 8); an OR-reduce across the block
// (__reduce_or_sync, then one shared-memory pass over the warps) gives the
// row's word, and __ffs its least digit.  This replaces the TPU's 2^r
// masked any-reductions per digit.  The first tie is a min-reduce over the
// survivors' indices.  The ragged edge is masked: a lane past N is never
// valid, and nothing is padded with a sentinel.  Shared scratch is
// double-buffered, so each reduction costs one barrier (none for a
// one-warp block).
//
// Rows of up to kMaxRegLanes lanes (topk_kernel): thread t owns lanes t,
// t+T, t+2T, ... with their keys in registers, and a bit mask each of its
// valid lanes and of its lanes still in the search; its loops stop after
// its last searched lane.  Wider rows (topk_wide_kernel): the row's keys
// are staged in dynamic shared memory when they fit (about 58K lanes) and
// read from global memory otherwise, and a lane keeps no state.  Rounds
// emit (key, index) pairs in increasing order, so a lane is still valid
// iff its pair is above the last one emitted, and it is still in the
// search iff its key's digits above the current shift equal those found.
//
// Bound: integer operations.  The keys are read once (4 bytes a lane) and
// 8 bytes a selected key are written; the search does k * floor(32/r)
// digit steps over the searched lanes (extract, test, OR into the presence
// word, compare, clear), so on this card the kernel is bound by
// operations, and at small N by the reductions' latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kLanesPerThread = 16;
constexpr int kMaxRegLanes = 1024 * kLanesPerThread;

// OR the per-thread presence words across the block; every thread gets
// the row's words.  red is the half of the double-buffered scratch to use.
template <int NW>
__device__ __forceinline__ void or_reduce(uint32_t (&pres)[NW],
                                          uint32_t (*red)[NW], int warp,
                                          int lane, int nwarps) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    pres[w] = __reduce_or_sync(0xffffffffu, pres[w]);
  if (nwarps > 1) {
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < NW; ++w) red[warp][w] = pres[w];
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t acc = 0u;
      for (int q = 0; q < nwarps; ++q) acc |= red[q][w];
      pres[w] = acc;
    }
  }
}

// The least index across the block; every thread gets it.
template <int NW>
__device__ __forceinline__ uint32_t min_reduce(uint32_t cand,
                                               uint32_t (*red)[NW], int warp,
                                               int lane, int nwarps) {
  cand = __reduce_min_sync(0xffffffffu, cand);
  if (nwarps > 1) {
    if (lane == 0) red[warp][0] = cand;
    __syncthreads();
    uint32_t acc = 0xFFFFFFFFu;
    for (int q = 0; q < nwarps; ++q) acc = min(acc, red[q][0]);
    cand = acc;
  }
  return cand;
}

template <int NW>
__device__ __forceinline__ void add_digit(uint32_t (&pres)[NW], uint32_t d) {
  if (NW == 1) {
    pres[0] |= 1u << d;
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w)
      pres[w] |= (uint32_t)((d >> 5) == (uint32_t)w) << (d & 31u);
  }
}

// the least present digit (a searched lane always exists: k <= N)
template <int NW>
__device__ __forceinline__ uint32_t least_digit(const uint32_t (&pres)[NW]) {
  uint32_t dmin = 0u;
#pragma unroll
  for (int w = NW - 1; w >= 0; --w)
    if (pres[w]) dmin = 32u * w + (uint32_t)(__ffs(pres[w]) - 1);
  return dmin;
}

template <int NW>
__global__ void __launch_bounds__(1024)
topk_kernel(const uint32_t* __restrict__ keys, int32_t* __restrict__ out_key,
            int32_t* __restrict__ out_idx, int N, int k, int r) {
  __shared__ uint32_t red[2][kMaxWarps][NW];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nwarps = T >> 5;
  const uint32_t* row = keys + (size_t)blockIdx.x * N;

  uint32_t key[kLanesPerThread];
  uint32_t valid = 0;  // bit i: lane t + i*T is a real, not yet chosen lane
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int j = t + i * T;
    key[i] = j < N ? row[j] : 0u;
    valid |= (uint32_t)(j < N) << i;
  }
  const uint32_t digit_mask = (1u << r) - 1u;
  int p = 0;  // which half of the double-buffered scratch

  for (int round = 0; round < k; ++round) {
    uint32_t m = valid;  // lanes still in this round's search
    uint32_t min_key = 0;
    for (int shift = 32 - r; shift >= 0; shift -= r) {
      // this thread's presence word over its searched lanes
      uint32_t pres[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) pres[w] = 0u;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        if ((m >> i) == 0u) break;
        if ((m >> i) & 1u) add_digit<NW>(pres, (key[i] >> shift) & digit_mask);
      }
      or_reduce<NW>(pres, red[p], warp, lane, nwarps);
      if (nwarps > 1) p ^= 1;
      const uint32_t dmin = least_digit<NW>(pres);
      // number exclusion: lanes with another digit leave the search
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        if ((m >> i) == 0u) break;
        if (((key[i] >> shift) & digit_mask) != dmin) m &= ~(1u << i);
      }
      min_key |= dmin << shift;
    }
    // first of ties: the least index still in the search
    const uint32_t cand = min_reduce<NW>(
        m ? (uint32_t)(t + (__ffs(m) - 1) * T) : 0xFFFFFFFFu, red[p], warp,
        lane, nwarps);
    if (nwarps > 1) p ^= 1;
    const int chosen = (int)cand;
    if (chosen % T == t) valid &= ~(1u << (chosen / T));
    if (t == 0) {
      out_idx[(size_t)blockIdx.x * k + round] = chosen;
      out_key[(size_t)blockIdx.x * k + round] = (int32_t)min_key;
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(1024)
topk_wide_kernel(const uint32_t* __restrict__ keys,
                 int32_t* __restrict__ out_key, int32_t* __restrict__ out_idx,
                 int N, int k, int r, int staged) {
  extern __shared__ uint32_t row_keys[];
  __shared__ uint32_t red[2][kMaxWarps][NW];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nwarps = T >> 5;
  const uint32_t* src = keys + (size_t)blockIdx.x * N;
  if (staged) {
    for (int j = t; j < N; j += T) row_keys[j] = src[j];
    __syncthreads();
    src = row_keys;
  }
  const uint32_t digit_mask = (1u << r) - 1u;
  // the bits the walk reads: all but the low 32 mod r
  const uint32_t read_mask = ~((1u << (32 % r)) - 1u);
  uint64_t last = 0;  // (key << 32 | index) of the last lane chosen
  int p = 0;

  for (int round = 0; round < k; ++round) {
    uint32_t min_key = 0;  // the digits found so far
    for (int shift = 32 - r; shift >= 0; shift -= r) {
      const int above = shift + r;  // digits at and above are found
      uint32_t pres[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) pres[w] = 0u;
      for (int j = t; j < N; j += T) {
        const uint32_t kj = src[j] & read_mask;
        if (round > 0 && (((uint64_t)kj << 32) | (uint32_t)j) <= last)
          continue;  // chosen in an earlier round
        if (above < 32 && (kj >> above) != (min_key >> above))
          continue;  // left this round's search
        add_digit<NW>(pres, (kj >> shift) & digit_mask);
      }
      or_reduce<NW>(pres, red[p], warp, lane, nwarps);
      if (nwarps > 1) p ^= 1;
      min_key |= least_digit<NW>(pres) << shift;
    }
    // first of ties: the least valid index whose read bits equal the
    // found key (a thread's lanes ascend, so its first match is its least)
    uint32_t cand = 0xFFFFFFFFu;
    for (int j = t; j < N; j += T) {
      const uint32_t kj = src[j] & read_mask;
      if (kj == min_key &&
          (round == 0 || (((uint64_t)kj << 32) | (uint32_t)j) > last)) {
        cand = (uint32_t)j;
        break;
      }
    }
    cand = min_reduce<NW>(cand, red[p], warp, lane, nwarps);
    if (nwarps > 1) p ^= 1;
    last = ((uint64_t)min_key << 32) | cand;
    if (t == 0) {
      out_idx[(size_t)blockIdx.x * k + round] = (int32_t)cand;
      out_key[(size_t)blockIdx.x * k + round] = (int32_t)min_key;
    }
  }
}

template <int NW>
int launch_nw(const uint32_t* keys, int32_t* out_key, int32_t* out_idx,
              int B, int N, int k, int r, cudaStream_t s) {
  if (N <= kMaxRegLanes) {
    int threads = ((N + 7) / 8 + 31) / 32 * 32;  // about 8 lanes a thread
    threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
    topk_kernel<NW><<<B, threads, 0, s>>>(keys, out_key, out_idx, N, k, r);
    return (int)cudaGetLastError();
  }
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e != cudaSuccess) return (int)e;
  const size_t room = (size_t)optin - sizeof(uint32_t) * 2 * kMaxWarps * NW;
  const size_t need = (size_t)N * sizeof(uint32_t);
  const int staged = need <= room;
  const size_t smem = staged ? need : 0;
  e = cudaFuncSetAttribute(topk_wide_kernel<NW>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  topk_wide_kernel<NW><<<B, 1024, smem, s>>>(keys, out_key, out_idx, N, k, r,
                                             staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* radix_topk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// keys: (B, N) uint32; out_key, out_idx: (B, k) int32.  1 <= k <= N,
// 1 <= r <= 8.
extern "C" int radix_topk_launch(const void* keys, void* out_key,
                                 void* out_idx, int B, int N, int k, int r,
                                 void* stream) {
  if (B == 0) return 0;
  if (N < 1 || k < 1 || k > N || r < 1 || r > 8)
    return (int)cudaErrorInvalidValue;
  const uint32_t* kp = (const uint32_t*)keys;
  int32_t* ok = (int32_t*)out_key;
  int32_t* oi = (int32_t*)out_idx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (r <= 5 ? 1 : (1 << r) / 32) {
    case 1: return launch_nw<1>(kp, ok, oi, B, N, k, r, s);
    case 2: return launch_nw<2>(kp, ok, oi, B, N, k, r, s);
    case 4: return launch_nw<4>(kp, ok, oi, B, N, k, r, s);
    default: return launch_nw<8>(kp, ok, oi, B, N, k, r, s);
  }
}
