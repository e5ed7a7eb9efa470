// Top-k of uint32 keys by warp argmin and radix select, for Hopper.
//
// Replaces src/repro/kernels/radix_topk.py::_topk_kernel (the Pallas TPU
// kernel behind topk_keys).  For each row of (B, N) uint32 keys it emits
// the k smallest (masked key, index) pairs in ascending order: the key is
// masked to the bits the reference's digit walk reads (its shifts
// 32-r, 32-2r, ..., >= 0 never read the low 32 mod r bits, so for an r
// that does not divide 32 keys that differ only there are equal, tie by
// index, and are emitted with those bits clear), and ties go to the
// lowest index.  That is the reference's k rounds of digit-plane
// min-search, computed here without its per-digit presence reductions.
//
// Three forms, one launch per call, chosen by N and k:
//
// 1. N <= 1024 (routers, short rows): one warp a row, eight rows a block.
//    Lane l holds the masked keys of lanes l, l+32, ... in registers (one
//    instantiation per keys-a-lane count: 1-6, 8, 12, 16, 24, 32), a bit
//    mask of those not yet emitted, and its least (key, index) among them.
//    A round is one warp argmin: __reduce_min_sync on the key, then on the
//    index among the lanes whose candidate key equals it; the lane that
//    owned the winner clears its bit and takes its next candidate, over
//    four independent compare chains.  No shared memory, no block barrier.
// 2. N > 1024 and k <= kSortCap (vocabularies): one block a row, radix
//    select.  Up to four histogram passes of 8-bit digits, MSB first, over
//    the lanes whose higher digits equal the prefix found so far (256
//    counters in shared memory, predicated shared reductions), give the
//    prefix at which the running count crosses k, the count c_less below
//    it and the count at it.  Every key below the prefix, and the first
//    k - c_less keys at it in index order (a ballot scan over chunks of the
//    row, in lane order, stopping once enough are found), go into k slots
//    of shared memory; a bitonic sort of the (key << 32 | index) words
//    emits them.  The passes stop early once every key at the prefix is
//    taken.  The first pass stages the row in dynamic shared memory where
//    it fits (opt-in up to 227 KiB: radix_topk_stage_limit), 16-byte loads
//    several in flight a thread; wider rows are read from global memory
//    every pass.
// 3. N > 1024 and k > kSortCap: k rounds of the digit-plane min-search,
//    one block a row (the previous design of this kernel, kept for these
//    shapes: no shipped path asks for more than 32 minima).  Each digit
//    step OR-reduces a 2^r-bit presence word across the block and takes
//    its least digit with __ffs; a lane is valid iff its pair is above the
//    last one emitted, so it keeps no state.
//
// Bound: bytes.  The keys are read once (4 bytes a lane) and 8 bytes a
// selected key are written.  The warp form does a few integer operations
// a key to load it and its lane's first candidate, and a round rescans one
// lane's ceil(N/32) keys; the select form a few a key a pass, at most four
// passes and a compaction sweep: at the main path's shapes both are far
// below the bytes, and the forms are bound by latency (a round's two
// dependent warp reductions; a sweep's shared-memory loads) and by the
// instruction rate.
// The select form's one block a row leaves SMs idle when B is below the
// SM count.  The ragged edge is masked everywhere: a lane past N is never
// counted, and no key is padded with a sentinel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 8;         // rows a block in the warp form
constexpr int kWarpMaxN = 1024;      // widest row of the warp form
constexpr int kSortCap = 1024;       // largest k of the select form
constexpr int kMaxWarps = 32;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // no candidate (never an index)

// ---------------------------------------------------------------- form 1

// this lane's least (key, index) among the keys whose bit is set in
// `left` (kNone, kNone if none).  Up to four independent chains over the
// keys i = g mod 4, each visited from the highest lane down so that <=
// leaves its lowest index of equal keys, then merged: the chains overlap
// where one chain's dependent compares would leave the warp waiting.
template <int P>
__device__ __forceinline__ void lane_min(const uint32_t (&key)[P],
                                         uint32_t left, int lane,
                                         uint32_t& bk, uint32_t& bi) {
  constexpr int G = P >= 8 ? 4 : 1;
  uint32_t ck[G], ci[G];
#pragma unroll
  for (int g = 0; g < G; ++g) ck[g] = ci[g] = kNone;
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    if (((left >> i) & 1u) && key[i] <= ck[i % G]) {
      ck[i % G] = key[i];
      ci[i % G] = (uint32_t)(lane + 32 * i);
    }
  }
  bk = ck[0];
  bi = ci[0];
#pragma unroll
  for (int g = 1; g < G; ++g) {
    if (ck[g] < bk || (ck[g] == bk && ci[g] < bi)) {
      bk = ck[g];
      bi = ci[g];
    }
  }
}

template <int P>
__global__ void __launch_bounds__(32 * kWarpRows)
topk_warp_kernel(const uint32_t* __restrict__ keys,
                 int32_t* __restrict__ out_key, int32_t* __restrict__ out_idx,
                 int B, int N, int k, uint32_t read_mask) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp: no barrier follows
  const uint32_t* src = keys + (size_t)row * N;
  uint32_t key[P];
  uint32_t left = 0u;  // bit i: key i is in the row and not yet emitted
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = lane + 32 * i;
    key[i] = j < N ? __ldg(src + j) & read_mask : 0u;
    left |= (uint32_t)(j < N) << i;
  }
  uint32_t bk, bi;  // this lane's candidate
  lane_min<P>(key, left, lane, bk, bi);
  int32_t* ok = out_key + (size_t)row * k;
  int32_t* oi = out_idx + (size_t)row * k;
  uint32_t hold_k = 0u, hold_i = 0u;  // lane l holds round l mod 32's pair
  for (int round = 0; round < k; ++round) {
    const uint32_t mk = __reduce_min_sync(0xFFFFFFFFu, bk);
    const uint32_t mi = __reduce_min_sync(0xFFFFFFFFu, bk == mk ? bi : kNone);
    const int slot = round & 31;
    if (lane == slot) {
      hold_k = mk;
      hold_i = mi;
    }
    if ((slot == 31 || round == k - 1) && lane <= slot) {
      ok[round - slot + lane] = (int32_t)hold_k;
      oi[round - slot + lane] = (int32_t)hold_i;
    }
    if (lane == (int)(mi & 31u)) {  // the winner's lane: its next candidate
      left &= ~(1u << (mi >> 5));
      lane_min<P>(key, left, lane, bk, bi);
    }
  }
}

template <int P>
int launch_warp(const uint32_t* keys, int32_t* ok, int32_t* oi, int B, int N,
                int k, uint32_t read_mask, cudaStream_t s) {
  const int blocks = (B + kWarpRows - 1) / kWarpRows;
  topk_warp_kernel<P><<<blocks, 32 * kWarpRows, 0, s>>>(keys, ok, oi, B, N, k,
                                                        read_mask);
  return (int)cudaGetLastError();
}

// the warp form with the fewest keys a lane that holds a row of N <= 1024
int launch_warp_for(const uint32_t* keys, int32_t* ok, int32_t* oi, int B,
                    int N, int k, uint32_t read_mask, cudaStream_t s) {
  switch ((N + 31) / 32) {
    case 1: return launch_warp<1>(keys, ok, oi, B, N, k, read_mask, s);
    case 2: return launch_warp<2>(keys, ok, oi, B, N, k, read_mask, s);
    case 3: return launch_warp<3>(keys, ok, oi, B, N, k, read_mask, s);
    case 4: return launch_warp<4>(keys, ok, oi, B, N, k, read_mask, s);
    case 5: return launch_warp<5>(keys, ok, oi, B, N, k, read_mask, s);
    case 6: return launch_warp<6>(keys, ok, oi, B, N, k, read_mask, s);
    case 7: case 8:
      return launch_warp<8>(keys, ok, oi, B, N, k, read_mask, s);
    case 9: case 10: case 11: case 12:
      return launch_warp<12>(keys, ok, oi, B, N, k, read_mask, s);
    case 13: case 14: case 15: case 16:
      return launch_warp<16>(keys, ok, oi, B, N, k, read_mask, s);
    case 17: case 18: case 19: case 20: case 21: case 22: case 23: case 24:
      return launch_warp<24>(keys, ok, oi, B, N, k, read_mask, s);
    default: return launch_warp<32>(keys, ok, oi, B, N, k, read_mask, s);
  }
}

// ---------------------------------------------------------------- form 2

// the select form's shared memory ahead of the staged keys (16-byte
// aligned: the row is staged with 16-byte stores)
struct alignas(16) SelectShared {
  uint64_t pairs[kSortCap];  // the selected (key << 32 | index) words
  uint32_t hist[256];
  uint32_t wcnt[2][kMaxWarps];  // per-warp tie counts, double-buffered
  uint32_t found[4];            // digit, count below it, count at it
  uint32_t filled;              // slots taken by the unordered sweep
};

constexpr int kUnroll = 8;     // keys a thread has in flight in a sweep
constexpr int kStageVecs = 4;  // 16-byte loads a thread has in flight

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one more in a shared counter where p holds: a predicated reduction, so
// that a sweep's tests leave no branch to reconverge
__device__ __forceinline__ void count_if(bool p, uint32_t* counter) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n"
      " @q red.shared.add.u32 [%0], 1;\n}\n" ::"r"(smem_addr(counter)),
      "r"((uint32_t)p)
      : "memory");
}

template <bool Staged>
__device__ __forceinline__ uint32_t row_key(const uint32_t* row,
                                            const uint32_t* src, int j,
                                            uint32_t read_mask) {
  return Staged ? row[j] : __ldg(src + j) & read_mask;
}

// f(j, key) for every lane j of the row, called by every thread the same
// number of times (j >= N past the ragged edge, so f may vote across the
// warp), with kUnroll loads in flight a thread rather than one at a time.
template <bool Staged, class F>
__device__ __forceinline__ void sweep(const uint32_t* row, const uint32_t* src,
                                      int N, uint32_t read_mask, F f) {
  const int T = blockDim.x;
  for (int base = threadIdx.x; base - (int)threadIdx.x < N;
       base += kUnroll * T) {
    uint32_t kv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * T;
      kv[u] = j < N ? row_key<Staged>(row, src, j, read_mask) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(base + u * T, kv[u]);
  }
}

template <bool Staged>
__global__ void __launch_bounds__(1024, 1)
topk_select_kernel(const uint32_t* __restrict__ keys,
                   int32_t* __restrict__ out_key,
                   int32_t* __restrict__ out_idx, int N, int k,
                   uint32_t read_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  SelectShared& sh = *reinterpret_cast<SelectShared*>(smem);
  uint32_t* row = reinterpret_cast<uint32_t*>(smem + sizeof(SelectShared));
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int nwarps = T >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  const uint32_t* src = keys + (size_t)blockIdx.x * N;

  int m = 1;  // the sort's width: k rounded up to a power of two
  while (m < k) m <<= 1;
  for (int i = k + t; i < m; i += T) sh.pairs[i] = ~0ull;  // sorts last
  for (int b = t; b < 256; b += T) sh.hist[b] = 0u;
  if (t == 0) sh.filled = 0u;
  __syncthreads();

  // the first pass reads the row from global memory (and stages it); its
  // counters take plain shared reductions (faster here than aggregating a
  // warp's equal digits with __match_any_sync)
  if (Staged && (((uintptr_t)src) & 15u) == 0 && (N & 3) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(row);
    const int n4 = N / 4;
    for (int base = t; base - t < n4; base += kStageVecs * T) {
      uint4 x[kStageVecs];
#pragma unroll
      for (int u = 0; u < kStageVecs; ++u)
        x[u] = base + u * T < n4 ? __ldg(v + base + u * T)
                                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < kStageVecs; ++u) {
        const bool in = base + u * T < n4;
        x[u].x &= read_mask;
        x[u].y &= read_mask;
        x[u].z &= read_mask;
        x[u].w &= read_mask;
        if (in) d[base + u * T] = x[u];
        count_if(in, &sh.hist[x[u].x >> 24]);
        count_if(in, &sh.hist[x[u].y >> 24]);
        count_if(in, &sh.hist[x[u].z >> 24]);
        count_if(in, &sh.hist[x[u].w >> 24]);
      }
    }
  } else {
    sweep<false>(row, src, N, read_mask, [&](int j, uint32_t kj) {
      if (Staged && j < N) row[j] = kj;
      count_if(j < N, &sh.hist[kj >> 24]);
    });
  }

  // threshold: the prefix (bits shift .. 31) at which the count crosses k
  uint32_t prefix = 0u;
  uint32_t need = (uint32_t)k;  // still to take at or above the prefix
  uint32_t c_less = 0u;         // keys below the prefix
  uint32_t at = 0u;             // keys at the prefix
  int shift = 24;
  for (;; shift -= 8) {
    if (shift < 24) {
      for (int b = t; b < 256; b += T) sh.hist[b] = 0u;
      __syncthreads();
      sweep<Staged>(row, src, N, read_mask, [&](int j, uint32_t kj) {
        count_if(j < N && (kj >> (shift + 8)) == prefix,
                 &sh.hist[(kj >> shift) & 255u]);
      });
    }
    __syncthreads();
    if (warp == 0) {
      // lane l scans bins 8l .. 8l+7; the lane whose range crosses `need`
      // finds the digit
      const uint32_t* bins = sh.hist + 8 * lane;
      uint32_t sum = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += bins[q];
      uint32_t incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      const uint32_t cross = __ballot_sync(0xFFFFFFFFu, incl >= need);
      if (lane == __ffs(cross) - 1) {
        uint32_t below = incl - sum;
        int q = 0;
        while (below + bins[q] < need) below += bins[q++];
        sh.found[0] = 8u * lane + q;
        sh.found[1] = below;
        sh.found[2] = bins[q];
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | sh.found[0];
    c_less += sh.found[1];
    need -= sh.found[1];
    at = sh.found[2];
    if (at == need || shift == 0) break;
  }

  // compaction, unordered: every key below the prefix, and every key at it
  // when all of them are taken
  // (a group of kUnroll keys a thread is skipped when no lane of the warp
  // takes one: few do)
  const bool all_at = at == need;
  for (int base = t; base - t < N; base += kUnroll * T) {
    uint32_t kv[kUnroll], takes = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * T;
      kv[u] = j < N ? row_key<Staged>(row, src, j, read_mask) : 0u;
      const uint32_t hi = kv[u] >> shift;
      takes |= (uint32_t)(j < N && (hi < prefix || (all_at && hi == prefix)))
               << u;
    }
    if (!__any_sync(0xFFFFFFFFu, takes)) continue;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool take = (takes >> u) & 1u;
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, take);
      if (bal) {
        const int leader = __ffs(bal) - 1;
        uint32_t slot = 0u;
        if (lane == leader)
          slot = atomicAdd(&sh.filled, (uint32_t)__popc(bal));
        slot = __shfl_sync(0xFFFFFFFFu, slot, leader) + __popc(bal & lt);
        if (take)
          sh.pairs[slot] = ((uint64_t)kv[u] << 32) | (uint32_t)(base + u * T);
      }
    }
  }
  // the first `need` keys at the prefix, in index order: chunk by chunk,
  // a lane's rank is the ties in earlier chunks, earlier warps and lower
  // lanes
  if (!all_at) {
    uint32_t running = 0u;
    int p = 0;
    for (int base = 0; base < N && running < need; base += T) {
      const int j = base + t;
      bool eq = false;
      uint32_t kj = 0u;
      if (j < N) {
        kj = row_key<Staged>(row, src, j, read_mask);
        eq = (kj >> shift) == prefix;
      }
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, eq);
      if (lane == 0) sh.wcnt[p][warp] = (uint32_t)__popc(bal);
      __syncthreads();
      uint32_t before = 0u, total = 0u;
      for (int q = 0; q < nwarps; ++q) {
        const uint32_t c = sh.wcnt[p][q];
        before += q < warp ? c : 0u;
        total += c;
      }
      const uint32_t rank = running + before + __popc(bal & lt);
      if (eq && rank < need)
        sh.pairs[c_less + rank] = ((uint64_t)kj << 32) | (uint32_t)j;
      running += total;
      p ^= 1;
    }
  }
  __syncthreads();

  // bitonic sort of the m words, ascending; one warp for m <= 64
  const bool one_warp = m <= 64;
  if (!one_warp || warp == 0) {
    const int workers = one_warp ? 32 : T;
    for (int size = 2; size <= m; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = t; i < m / 2; i += workers) {
          const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
          const int hi = lo + stride;
          const uint64_t a = sh.pairs[lo], b = sh.pairs[hi];
          if ((a > b) == ((lo & size) == 0)) {
            sh.pairs[lo] = b;
            sh.pairs[hi] = a;
          }
        }
        if (one_warp) __syncwarp();
        else __syncthreads();
      }
    }
  }
  __syncthreads();
  int32_t* ok = out_key + (size_t)blockIdx.x * k;
  int32_t* oi = out_idx + (size_t)blockIdx.x * k;
  for (int i = t; i < k; i += T) {
    const uint64_t w = sh.pairs[i];
    ok[i] = (int32_t)(uint32_t)(w >> 32);
    oi[i] = (int32_t)(uint32_t)w;
  }
}

int optin_smem(int* bytes) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  return (int)e;
}

int launch_select(const uint32_t* keys, int32_t* ok, int32_t* oi, int B,
                  int N, int k, uint32_t read_mask, cudaStream_t s) {
  int optin = 0;
  int e = optin_smem(&optin);
  if (e) return e;
  const bool staged = N <= (optin - (int)sizeof(SelectShared)) / 4;
  const size_t smem = sizeof(SelectShared) + (staged ? 4 * (size_t)N : 0);
  // about 8 keys a thread, 128 to 1024 threads
  int threads = ((N + 7) / 8 + 31) / 32 * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  if (staged) {
    e = (int)cudaFuncSetAttribute(topk_select_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (e) return e;
    topk_select_kernel<true><<<B, threads, smem, s>>>(keys, ok, oi, N, k,
                                                      read_mask);
  } else {
    topk_select_kernel<false><<<B, threads, smem, s>>>(keys, ok, oi, N, k,
                                                       read_mask);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- form 3

// OR the per-thread presence words across the block; every thread gets
// the row's words.  red is the half of the double-buffered scratch to use.
template <int NW>
__device__ __forceinline__ void or_reduce(uint32_t (&pres)[NW],
                                          uint32_t (*red)[NW], int warp,
                                          int lane, int nwarps) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    pres[w] = __reduce_or_sync(0xffffffffu, pres[w]);
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

// The least index across the block; every thread gets it.
template <int NW>
__device__ __forceinline__ uint32_t min_reduce(uint32_t cand,
                                               uint32_t (*red)[NW], int warp,
                                               int lane, int nwarps) {
  cand = __reduce_min_sync(0xffffffffu, cand);
  if (lane == 0) red[warp][0] = cand;
  __syncthreads();
  uint32_t acc = 0xFFFFFFFFu;
  for (int q = 0; q < nwarps; ++q) acc = min(acc, red[q][0]);
  return acc;
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
topk_rounds_kernel(const uint32_t* __restrict__ keys,
                   int32_t* __restrict__ out_key,
                   int32_t* __restrict__ out_idx, int N, int k, int r,
                   int staged) {
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
      p ^= 1;
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
    p ^= 1;
    last = ((uint64_t)min_key << 32) | cand;
    if (t == 0) {
      out_idx[(size_t)blockIdx.x * k + round] = (int32_t)cand;
      out_key[(size_t)blockIdx.x * k + round] = (int32_t)min_key;
    }
  }
}

template <int NW>
int launch_rounds(const uint32_t* keys, int32_t* ok, int32_t* oi, int B,
                  int N, int k, int r, cudaStream_t s) {
  int optin = 0;
  int e = optin_smem(&optin);
  if (e) return e;
  const size_t room = (size_t)optin - sizeof(uint32_t) * 2 * kMaxWarps * NW;
  const int staged = (size_t)N * sizeof(uint32_t) <= room;
  const size_t smem = staged ? (size_t)N * sizeof(uint32_t) : 0;
  e = (int)cudaFuncSetAttribute(topk_rounds_kernel<NW>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  if (e) return e;
  topk_rounds_kernel<NW><<<B, 1024, smem, s>>>(keys, ok, oi, N, k, r, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* radix_topk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// The widest row the select form stages in shared memory on the current
// device (wider rows are read from global memory), or -1 on an error.
extern "C" int radix_topk_stage_limit(void) {
  int optin = 0;
  if (optin_smem(&optin)) return -1;
  return (optin - (int)sizeof(SelectShared)) / 4;
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
  // the bits the reference's digit walk reads: all but the low 32 mod r
  const uint32_t read_mask = ~((1u << (32 % r)) - 1u);
  if (N <= kWarpMaxN)
    return launch_warp_for(kp, ok, oi, B, N, k, read_mask, s);
  if (k <= kSortCap)
    return launch_select(kp, ok, oi, B, N, k, read_mask, s);
  switch (r <= 5 ? 1 : (1 << r) / 32) {
    case 1: return launch_rounds<1>(kp, ok, oi, B, N, k, r, s);
    case 2: return launch_rounds<2>(kp, ok, oi, B, N, k, r, s);
    case 4: return launch_rounds<4>(kp, ok, oi, B, N, k, r, s);
    default: return launch_rounds<8>(kp, ok, oi, B, N, k, r, s);
  }
}
