// One digit-read min- (or max-) search over raw bit-planes, for Hopper.
//
// Replaces src/repro/kernels/digit_read.py::_dr_kernel (the Pallas TPU
// kernel).  Input is the physical array image: (B, W, N) uint8 bit-planes,
// MSB first.  The search walks the W columns with the number-exclusion mask
// and returns the survivor mask ((B, N) bool) and the count of useful
// (mixed) digit reads ((B,) int32).  A lane is a hit where its byte equals
// the excluded digit (1 ascending, 0 descending) and kept elsewhere, so a
// byte outside {0, 1} means what it means to the reference kernel.
//
// Bound: one read of the planes (B*W*N bytes) plus one write of the mask
// and the counts; a compare and two ORs per lane and column, far below the
// card's integer rate, so the kernel is bound by bytes: 0.0213 ms at
// (4096, 16, 1024) on the H100's 3.35 TB/s.
//
// Two forms, chosen by the wrapper (kernels/digit_read.py) and counted
// there one by one:
// - warp (N <= 2048): one warp a row, eight rows a 256-thread block.  Lane
//   t of the warp owns the 16-lane chunks t, t + 32, ... of every column
//   (at most four: 64 lanes).  It issues the loads of all W <= 32 columns
//   before the walk, 16 bytes each where N is a multiple of 16, and turns
//   each column on arrival into a word of hits (__vcmpeq4 against the
//   excluded digit, the byte compares gathered by a multiply): 32 bits up
//   to 1024 lanes, which keeps a thread under 64 registers so that 4096
//   rows are all in flight at once on the H100, 64 bits beyond.  The walk
//   runs in registers: a column's "any hit, any keep" is one
//   __reduce_or_sync of a 2-bit flag, and no block barrier is taken.
// - block (N > 2048, up to the wrapper's 65536): the port's first kernel,
//   kept as it was: one block a row, each thread a contiguous run of at most 64 lanes in a 64-bit
//   word, two __syncthreads_or a column.
// The ragged edge is masked in both (no lane padding, unlike the TPU
// version's 128-lane tiles).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxW = 32;          // columns a warp-form lane keeps
constexpr int kRowsPerBlock = 8;   // warps (rows) a warp-form block
constexpr int kMaxLanes = 64;      // lanes a block-form thread keeps

// bit i of the result is byte i of v == e (e: the digit in all 4 bytes)
__device__ __forceinline__ uint32_t eq4(uint32_t v, uint32_t e) {
  const uint32_t x = __vcmpeq4(v, e) & 0x80808080u;
  return (x * 0x00204081u) >> 28;
}

// 16 hit bits of the 16 lanes of one chunk
__device__ __forceinline__ uint32_t eq16(uint4 v, uint32_t e) {
  return eq4(v.x, e) | eq4(v.y, e) << 4 | eq4(v.z, e) << 8 |
         eq4(v.w, e) << 12;
}

// bytes 0/1 of 4 mask bits
__device__ __forceinline__ uint32_t bytes4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// Warp form.  CH: 16-lane chunks a lane (N <= 512 * CH), whose hit bits
// fit a 32-bit word up to CH = 2 (N <= 1024: few enough registers for
// every row of a large batch in flight at once) and a 64-bit one beyond;
// VEC: N % 16 == 0 and 16-byte aligned planes / mask, so chunks move as
// uint4.
template <int CH, bool VEC>
__global__ void __launch_bounds__(32 * kRowsPerBlock, CH <= 2 ? 4 : 2)
dr_warp_kernel(const uint8_t* __restrict__ planes, bool* __restrict__ mask,
               int* __restrict__ drs, int B, int W, int N, uint32_t exc) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;   // a whole warp: the reductions below stay full
  const uint8_t* P = planes + (size_t)b * W * N;
  const uint32_t e = exc * 0x01010101u;

  typedef typename std::conditional<(CH <= 2), uint32_t, uint64_t>::type
      Word;
  // the lanes this thread owns that lie inside the row
  Word valid = 0;
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int l0 = 16 * (lane + 32 * q);
    const int n = min(max(N - l0, 0), 16);
    valid |= (Word)((1u << n) - 1u) << (16 * q);
  }

  // every column's loads first, each column a word of hits on arrival
  Word hit[kMaxW];
#pragma unroll
  for (int c = 0; c < kMaxW; ++c) {
    hit[c] = 0;
    if (c < W) {
      const uint8_t* col = P + (size_t)c * N;
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        const int l0 = 16 * (lane + 32 * q);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (VEC) {
          if (l0 < N) v = __ldg(reinterpret_cast<const uint4*>(col + l0));
        } else {
          uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (l0 + j < N) vb[j] = __ldg(col + l0 + j);
        }
        hit[c] |= (Word)eq16(v, e) << (16 * q);
      }
    }
  }

  // the walk: one warp OR of (any hit, any keep) a column
  int useful = 0;
#pragma unroll
  for (int c = 0; c < kMaxW; ++c) {
    if (c < W) {
      const Word hits = valid & hit[c];
      const Word kept = valid & ~hit[c];
      const unsigned f = __reduce_or_sync(
          kFull, (hits != 0 ? 1u : 0u) | (kept != 0 ? 2u : 0u));
      if (f == 3u) {   // a mixed read excludes the hits
        valid = kept;
        ++useful;
      }
    }
  }

  bool* M = mask + (size_t)b * N;
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int l0 = 16 * (lane + 32 * q);
    if (l0 >= N) break;
    const uint32_t bits = (uint32_t)(valid >> (16 * q)) & 0xFFFFu;
    const uint4 v = make_uint4(bytes4(bits & 15u), bytes4((bits >> 4) & 15u),
                               bytes4((bits >> 8) & 15u), bytes4(bits >> 12));
    if (VEC) {
      *reinterpret_cast<uint4*>(M + l0) = v;
    } else {
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(&v);
      for (int j = 0; j < 16 && l0 + j < N; ++j) M[l0 + j] = vb[j] != 0;
    }
  }
  if (lane == 0) drs[b] = useful;
}

// Block form (the port's first kernel): one block a row, a thread a run
// of `lanes` lanes, a column's any-hit / any-keep as two __syncthreads_or.
__global__ void __launch_bounds__(1024)
dr_block_kernel(const uint8_t* __restrict__ planes, bool* __restrict__ mask,
                int* __restrict__ drs, int W, int N, int lanes,
                uint8_t exc) {
  const int b = blockIdx.x;
  const uint8_t* P = planes + (size_t)b * W * N;
  const int lo = min((int)threadIdx.x * lanes, N);
  const int hi = min(lo + lanes, N);
  const int n = hi - lo;
  uint64_t valid = n == 64 ? ~0ull : ((1ull << n) - 1ull);
  int useful = 0;
  for (int c = 0; c < W; ++c) {
    const uint8_t* row = P + (size_t)c * N + lo;
    uint64_t keep = 0;
    for (int j = 0; j < n; ++j) keep |= (uint64_t)(row[j] != exc) << j;
    const uint64_t kept = valid & keep;
    const uint64_t hit = valid & ~keep;
    const int any_hit = __syncthreads_or(hit != 0);
    const int any_keep = __syncthreads_or(kept != 0);
    if (any_hit && any_keep) {  // a mixed read excludes the hits
      valid = kept;
      ++useful;
    }
  }
  bool* M = mask + (size_t)b * N + lo;
  for (int j = 0; j < n; ++j) M[j] = (valid >> j) & 1ull;
  if (threadIdx.x == 0) drs[b] = useful;
}

template <int CH>
cudaError_t launch_warp(const uint8_t* planes, bool* mask, int* drs, int B,
                        int W, int N, uint32_t exc, cudaStream_t s) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  const bool vec = N % 16 == 0 && (uintptr_t)planes % 16 == 0 &&
                   (uintptr_t)mask % 16 == 0;
  if (vec)
    dr_warp_kernel<CH, true><<<blocks, 32 * kRowsPerBlock, 0, s>>>(
        planes, mask, drs, B, W, N, exc);
  else
    dr_warp_kernel<CH, false><<<blocks, 32 * kRowsPerBlock, 0, s>>>(
        planes, mask, drs, B, W, N, exc);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* digit_read_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// planes: (B, W, N) uint8; mask: (B, N) bool; drs: (B,) int32.  form: 0
// warp (1 <= N <= 2048, W <= 32), 1 block (N <= 65536).
extern "C" int digit_read_launch(const void* planes, void* mask, void* drs,
                                 int B, int W, int N, int ascending,
                                 int form, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* p = (const uint8_t*)planes;
  const uint32_t exc = ascending ? 1u : 0u;
  if (form == 0) {
    if (N < 1 || N > 2048 || W > kMaxW) return (int)cudaErrorInvalidValue;
    switch ((N + 511) / 512) {
      case 1: return (int)launch_warp<1>(p, (bool*)mask, (int*)drs, B, W, N,
                                         exc, s);
      case 2: return (int)launch_warp<2>(p, (bool*)mask, (int*)drs, B, W, N,
                                         exc, s);
      case 3: return (int)launch_warp<3>(p, (bool*)mask, (int*)drs, B, W, N,
                                         exc, s);
      default: return (int)launch_warp<4>(p, (bool*)mask, (int*)drs, B, W, N,
                                          exc, s);
    }
  }
  if (form != 1) return (int)cudaErrorInvalidValue;
  int threads = ((N + 3) / 4 + 31) / 32 * 32;  // about 4 lanes a thread
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int lanes = (N + threads - 1) / threads;
  if (lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  dr_block_kernel<<<B, threads, 0, s>>>(p, (bool*)mask, (int*)drs, W, N,
                                        lanes, (uint8_t)exc);
  return (int)cudaGetLastError();
}
