// Fused TNS controller for Hopper, bit-sliced: digit read -> tree-node-
// skipping descent -> winner write-back, the whole sort of one instance
// (bank) in one warp.
//
// Replaces src/repro/kernels/fused_tns.py::_fused_tns_kernel (the Pallas
// TPU kernel) and computes its emission-episode model exactly; see that
// module's docstring for why an episode (reload, descent, emission) is
// mechanically the paper's controller.  Outputs match it bit for bit: a
// (B, N) int32 rank ring (-1 = never emitted) and a (B, 8) int32 counter
// block [cycles, DRs, reload cycles, useful DRs, emitted, episodes,
// lane-episodes, 0].  The reference leaves columns 5-7 zero; here 5 and 6
// count the episodes run and the alive lanes summed over them.
//
// Layout: the paper's digit read reads one column of the array for every
// row at once, so the kernel holds the array by columns: lane i of a
// column is bit i & 31 of word i >> 5, and word j belongs to thread
// j & 31 of the bank's warp, which thus holds ceil(N / 1024) words of each
// column (WPT, rounded up to a power of two).  The columns sit in the
// warp's slice of shared memory, packed once from the (W, N) uint8 planes
// with 16-byte loads, eight in flight a lane; the alive set and the
// episode's candidate set are words of the same shape in registers.  The
// TPU kernel's per-lane W-bit keys and their argmin become word operations
// over columns:
// - reload: the LIFO node at a present column c stores the set that
//   reached c when it was pushed; it is live iff that set still holds an
//   alive lane (one warp reduction, which also counts the set), and the
//   deepest live one is resumed with that set.  Where the stored sets do
//   not fit beside the columns (N > 16384 with W > 27) a walk from the
//   root rebuilds them: the alive set narrowed by the path digit of every
//   compared column, the episode model's own definition.
// - descent: from the column after it, keep the lanes whose digit is the
//   kept one if any lane has it; the column is mixed iff some lanes have
//   it and some do not (one warp OR-reduction of two flags).  The mixed
//   columns are the pushes (their sets are stored) and the useful reads,
//   the deepest one bounds the DR span, the survivors are the winner tie
//   set; the walk stops once a single lane is left.
// - emission: the first r winners in index order, by a warp exclusive
//   scan of the per-word counts, are written to the rank ring and cleared
//   from the alive set (a lone winner takes no scan).
// The path, skip and present words, the counters and every branch are
// uniform across the warp.  There is no block barrier: one warp is one
// bank, and a block holds four independent banks (one when N > 1024).
//
// Bound: bytes are one read of the planes and sign plus one write of rank
// and counters, tiny next to the work.  The work is a chain of N episodes
// for a full sort, each a reload check, a few columns of the descent and
// the emission: about 20-30 instructions a column and a warp reduction
// whose result every later step waits for.  One bank alone is bound by
// the latency of that chain; with the 31 banks an SM holds at B = 4096
// the schedulers are busy about as long as the chain takes, so the card
// is bound by the issue of the episode's instructions (integer, vote and
// shared-memory), not by its bytes or its integer peak.  The design keeps
// all 4096 banks of a (4096, 1024) sort resident at once (one wave),
// costs a dead lane nothing beyond its bit, reads only the columns a
// descent needs, and spends no block barrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Fmt { kUnsigned = 0, kTwos = 1, kSignmag = 2, kFloat = 3 };
constexpr int kNcnt = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlockBanks = 4;  // banks a block when N <= 1024
constexpr int kMaxSmem = 232448;  // shared memory a block may use (227 KB)

// XOR mask whose bit W-1-c is the digit the machine KEEPS at column c
__device__ __forceinline__ int flip_mask(int fmt, bool ascending, int W,
                                         bool neg_pend) {
  const int msb = 1 << (W - 1);
  const int low = msb - 1;
  if (fmt == kUnsigned) return ascending ? 0 : (msb | low);
  if (fmt == kTwos) return ascending ? msb : low;
  const int base = ascending ? msb : 0;  // sign-magnitude / float
  return neg_pend ? (base | low) : base;
}

// Nonzero bytes of v -> 4 bits (byte 0 -> bit 0): the multiply gathers
// the bytes' low bits into bits 21-24 without carries.
__device__ __forceinline__ uint32_t nz4(uint32_t v) {
  const uint32_t x = __vcmpne4(v, 0u) & 0x01010101u;
  return ((x * 0x00204081u) >> 21) & 0xFu;
}

// Packs `rows` rows of n uint8 digits (row r at src + r * n) into rows of
// nwords words at dst + r * nwords: bit i & 31 of word i >> 5 is
// src[r * n + i] != 0, zero past n.  Every lane of the warp calls it;
// loads go in batches of 8 a lane, so that the warp keeps them in flight.
__device__ __forceinline__ void pack_rows(const uint8_t* __restrict__ src,
                                          int rows, int n,
                                          uint32_t* __restrict__ dst,
                                          int nwords, int lane) {
  constexpr int kBatch = 8;
  if ((n & 15) == 0 && ((uintptr_t)src & 15) == 0) {
    // 16 bytes = half a word a lane, written as one 16-bit half
    uint16_t* const dst16 = reinterpret_cast<uint16_t*>(dst);
    const int units = rows * (n >> 4);
    for (int u0 = 0; u0 < units; u0 += 32 * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int u = u0 + 32 * t + lane;
        v[t] = u < units ? __ldg(reinterpret_cast<const uint4*>(src) + u)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int u = u0 + 32 * t + lane;
        if (u >= units) break;
        const int r = (u << 4) / n;
        const int half = u - r * (n >> 4);  // 16-lane half of the row
        dst16[2 * r * nwords + half] = (uint16_t)(
            nz4(v[t].x) | nz4(v[t].y) << 4 | nz4(v[t].z) << 8 |
            nz4(v[t].w) << 12);
      }
    }
    for (int r = 0; r < rows; ++r)
      for (int h = (n >> 4) + lane; h < 2 * nwords; h += 32)
        dst16[2 * r * nwords + h] = 0;
    return;
  }
  const int used = (n + 31) >> 5;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* row = src + (size_t)r * n;
    for (int j0 = 0; j0 < used; j0 += kBatch) {
      uint8_t d[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int i = 32 * (j0 + t) + lane;
        d[t] = i < n ? __ldg(row + i) : 0;
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const uint32_t w = __ballot_sync(kFull, d[t] != 0);
        if (j0 + t < used && lane == ((j0 + t) & 31))
          dst[r * nwords + j0 + t] = w;
      }
    }
    for (int j = used + lane; j < nwords; j += 32) dst[r * nwords + j] = 0u;
  }
}

// WPT: words of each column a thread holds.  Shared memory of a warp:
// W digit columns, the sign row, then (when `store`) the LIFO's stored
// set for every column, each row 32 * WPT words.
template <int WPT>
__global__ void __launch_bounds__(WPT == 1 ? 32 * kBlockBanks : 32,
                                  WPT == 1 ? 32 / kBlockBanks : 1)
fused_tns_kernel(const uint8_t* __restrict__ planes,
                 const uint8_t* __restrict__ sign, int* __restrict__ rank,
                 int* __restrict__ cnt, int B, int W, int N, int k, int fmt,
                 bool ascending, int stop_n, bool store) {
  extern __shared__ uint32_t smem[];
  constexpr int kWords = 32 * WPT;  // words of a row, padded
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp leaves together
  const int rows = W + 1 + (store ? W : 0);
  uint32_t* const S = smem + (size_t)warp * rows * kWords;
  uint32_t* const Sg = S + W * kWords;       // sign row
  uint32_t* const St = S + (W + 1) * kWords;  // stored sets by column
  const uint8_t* P = planes + (size_t)b * W * N;
  int* R = rank + (size_t)b * N;
  int* const Rl = R + 32 * lane;  // the thread's words' first lanes

  for (int i = lane; i < N; i += 32) R[i] = -1;
  pack_rows(P, W, N, S, kWords, lane);
  if (sign != nullptr)
    pack_rows(sign + (size_t)b * N, 1, N, Sg, kWords, lane);
  else
    for (int j = lane; j < kWords; j += 32) Sg[j] = 0u;
  __syncwarp();  // the -1 fill and the packed rows before any later use

  uint32_t alive[WPT];
#pragma unroll
  for (int q = 0; q < WPT; ++q) {
    const int lo = 32 * (q * 32 + lane);  // first lane of the word
    alive[q] = lo + 32 <= N ? kFull
               : lo < N     ? (1u << (N - lo)) - 1u
                            : 0u;
  }

  // sign-pending lanes still alive: once none is, none ever is again
  bool neg_pend = fmt == kSignmag || fmt == kFloat;
  int pathv = 0, skipv = 0, present = 0;  // bit W-1-c = column c
  int out = 0, cyc = 0, drs = 0, rlc = 0, udr = 0, epi = 0, lane_ep = 0;

  while (out < stop_n && epi < stop_n) {
    ++epi;
    lane_ep += N - out;
    uint32_t m[WPT];  // the resumed set, then the winner set
#pragma unroll
    for (int q = 0; q < WPT; ++q) m[q] = alive[q];
    int c_res = -1;
    int t = N - out;  // lanes in m: every alive lane on a restart

    // ---- reload: resume the deepest live node, pop the drained ones
    if (k > 0 && present != 0) {
      if (store) {
        for (int p = present; p != 0; p &= p - 1) {  // deepest first
          const int c = W - __ffs(p);
          uint32_t s[WPT], n = 0;
#pragma unroll
          for (int q = 0; q < WPT; ++q) {
            s[q] = St[c * kWords + q * 32 + lane] & alive[q];
            n += __popc(s[q]);
          }
          const int ns = (int)__reduce_add_sync(kFull, n);
          if (ns > 0) {
            c_res = c;
            t = ns;
#pragma unroll
            for (int q = 0; q < WPT; ++q) m[q] = s[q];
            break;
          }
        }
      } else {
        const int deep = W - __ffs(present);  // deepest present column
        uint32_t cur[WPT];
#pragma unroll
        for (int q = 0; q < WPT; ++q) cur[q] = alive[q];
        for (int c = 0; c <= deep; ++c) {
          const int bit = 1 << (W - 1 - c);
          if (present & bit) {
            uint32_t n = 0;
#pragma unroll
            for (int q = 0; q < WPT; ++q) n += __popc(cur[q]);
            const int ns = (int)__reduce_add_sync(kFull, n);
            if (ns == 0) break;
            c_res = c;
            t = ns;
#pragma unroll
            for (int q = 0; q < WPT; ++q) m[q] = cur[q];
          }
          if (!(skipv & bit)) {
            const uint32_t flip = (pathv & bit) ? 0u : kFull;
#pragma unroll
            for (int q = 0; q < WPT; ++q)
              cur[q] &= S[c * kWords + q * 32 + lane] ^ flip;
          }
        }
      }
    }
    if (k > 0) {
      const int pos_res = W - 1 - c_res;  // c_res == -1 -> W
      const int below = (1 << pos_res) - 1;  // columns deeper than c_res
      const int drained = present & below;
      const int spent = max(__popc(drained) - 1, 0);
      present &= ~drained;
      // the resumed column holds the PRE-exclusion set: it becomes a
      // prefix hole; holes deeper belong to popped subtrees
      skipv = (skipv & ~below) | (c_res >= 0 ? 1 << pos_res : 0);
      cyc += spent;
      rlc += spent;
    }
    const int col0 = c_res + 1;

    if (neg_pend) {
      uint32_t any = 0;
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        const uint32_t sg = Sg[q * 32 + lane];
        any |= alive[q] & (ascending ? sg : ~sg);
      }
      neg_pend = __any_sync(kFull, any != 0);
    }
    const int flipv = flip_mask(fmt, ascending, W, neg_pend);

    // ---- descent from col0 (no holes from there on); a lone lane has
    // nothing to read.  Column c's outcome goes to bit W-1-c of `kept_any`
    // (some lane had the kept digit) and of `mixed` (and some had not).
    int kept_any = 0, mixed = 0;
    if (t > 1 && col0 < W) {
      const bool push = store && k > 0;
      const uint32_t* cp = S + col0 * kWords + lane;  // column c's words
      uint32_t* sp = St + col0 * kWords + lane;       // its stored set
      int bit = 1 << (W - 1 - col0);
      for (int c = col0;;) {
        const uint32_t flip = (flipv & bit) ? 0u : kFull;
        uint32_t z[WPT];
        uint32_t zo = 0, lo = 0;
#pragma unroll
        for (int q = 0; q < WPT; ++q) {
          z[q] = m[q] & (cp[q * 32] ^ flip);
          zo |= z[q];
          lo |= m[q] ^ z[q];  // z is a subset of m
        }
        const unsigned f = __reduce_or_sync(
            kFull, (zo != 0 ? 1u : 0u) | (lo != 0 ? 2u : 0u));
        if (f & 1u) kept_any |= bit;
        if (f == 3u) {  // mixed: a push, and a useful read
          mixed |= bit;
          uint32_t n1 = 0;
#pragma unroll
          for (int q = 0; q < WPT; ++q) {
            if (push) sp[q * 32] = m[q];
            m[q] = z[q];
            n1 += __popc(z[q]);
          }
          // a lone winner stays alone: no deeper column is mixed
          t = (int)__reduce_add_sync(kFull, n1);
        }
        if (t <= 1 || ++c >= W) break;
        bit >>= 1;
        cp += kWords;
        sp += kWords;
      }
    }
    // the winner's digit: the kept one where some lane had it (exact on
    // every column read, which covers the DR span below)
    const int wdig = ~(kept_any ^ flipv);
    const int dm = mixed != 0 ? W - __ffs(mixed) : -1;  // deepest mixed
    const int eb = mixed;

    // deepest column still read: W-1 when the winner is a tie, else the
    // deepest mixed one; mixed reads are the mixed columns in range
    const int cend = t >= 2 ? W - 1 : dm;
    const int ep_drs = max(cend - col0 + 1, 0);
    const int rm =
        cend >= col0 ? (1 << (W - col0)) - (1 << (W - 1 - cend)) : 0;
    const int ebits = eb & rm;
    udr += __popc(ebits);
    if (k > 0) {
      pathv = (pathv & ~rm) | (wdig & rm);
      // state-record pushes at the mixed columns; at capacity k the
      // shallowest drops first: keep the k deepest = k lowest set bits
      int u = present | ebits;
      int kept = 0;
      for (int j = 0; j < k && u != 0; ++j) {
        const int low_bit = u & -u;
        kept |= low_bit;
        u ^= low_bit;
      }
      present = kept;
    }

    // ---- emission: the first r winners, consecutive ranks, index order
    const int r = min(t, stop_n - out);
    if (t == 1) {
#pragma unroll
      for (int q = 0; q < WPT; ++q)
        if (m[q] != 0) {
          Rl[1024 * q + __ffs(m[q]) - 1] = out;
          alive[q] &= ~m[q];
        }
    } else {
      int base = 0;  // winners in the rounds before
#pragma unroll
      for (int q = 0; q < WPT; ++q) {
        if (base >= r) break;
        const int cq = __popc(m[q]);
        int inc = cq;  // warp inclusive scan of the word counts
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int v = __shfl_up_sync(kFull, inc, s);
          if (lane >= s) inc += v;
        }
        int p = base + inc - cq;
        uint32_t w = m[q];
        while (w != 0 && p < r) {
          const int bb = __ffs(w) - 1;
          Rl[1024 * q + bb] = out + p;
          alive[q] &= ~(1u << bb);
          w &= w - 1;
          ++p;
        }
        base += __shfl_sync(kFull, inc, 31);
      }
    }
    const int emit_cyc = ep_drs == 0 ? (t > 1 ? r : 1) : max(r - 1, 0);
    cyc += emit_cyc + ep_drs;
    drs += ep_drs;
    out += r;
  }

  if (lane == 0) {
    int* C = cnt + (size_t)b * kNcnt;
    C[0] = cyc;
    C[1] = drs;
    C[2] = rlc;
    C[3] = udr;
    C[4] = out;
    C[5] = epi;
    C[6] = lane_ep;
    C[7] = 0;
  }
}

template <int WPT>
int launch(const void* planes, const void* sign, void* rank, void* cnt,
           int B, int W, int N, int k, int fmt, int ascending, int stop_n,
           cudaStream_t stream) {
  const int warps = WPT == 1 ? kBlockBanks : 1;
  const size_t row = (size_t)32 * WPT * sizeof(uint32_t);
  // the stored sets go beside the columns where they fit
  const bool store = (size_t)warps * (2 * W + 1) * row <= kMaxSmem;
  const size_t smem = (size_t)warps * (W + 1 + (store ? W : 0)) * row;
  cudaError_t e = cudaFuncSetAttribute(
      fused_tns_kernel<WPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_tns_kernel<WPT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  fused_tns_kernel<WPT><<<(B + warps - 1) / warps, 32 * warps, smem,
                          stream>>>(
      (const uint8_t*)planes, (const uint8_t*)sign, (int*)rank, (int*)cnt, B,
      W, N, k, fmt, ascending != 0, stop_n, store);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* fused_tns_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// planes: (B, W, N) uint8; sign: (B, N) uint8 or NULL (all zero);
// rank: (B, N) int32; cnt: (B, 8) int32.  W <= 30, 1 <= N < 2^15,
// 1 <= stop_n <= N.
extern "C" int fused_tns_launch(const void* planes, const void* sign,
                                void* rank, void* cnt, int B, int W, int N,
                                int k, int fmt, int ascending, int stop_n,
                                void* stream) {
  if (B == 0) return 0;
  const int words = (N + 1023) / 1024;  // a column's words per thread
  const cudaStream_t s = (cudaStream_t)stream;
#define FUSED_TNS_LAUNCH(wpt)                                              \
  return launch<wpt>(planes, sign, rank, cnt, B, W, N, k, fmt, ascending, \
                     stop_n, s)
  if (words <= 1) FUSED_TNS_LAUNCH(1);
  if (words <= 2) FUSED_TNS_LAUNCH(2);
  if (words <= 4) FUSED_TNS_LAUNCH(4);
  if (words <= 8) FUSED_TNS_LAUNCH(8);
  if (words <= 16) FUSED_TNS_LAUNCH(16);
  FUSED_TNS_LAUNCH(32);
#undef FUSED_TNS_LAUNCH
}
