// Fused TNS controller for Hopper: digit read -> tree-node-skipping
// descent -> winner write-back, the whole sort of one instance in one
// thread block.
//
// Replaces src/repro/kernels/fused_tns.py::_fused_tns_kernel (the Pallas
// TPU kernel) and replays its emission-episode model exactly; see that
// module's docstring for why an episode (reload, descent, emission) is
// mechanically the paper's controller.  Outputs match it bit for bit: a
// (B, N) int32 rank ring (-1 = never emitted) and a (B, 8) int32 counter
// block [cycles, DRs, reload cycles, useful DRs, emitted, episodes,
// lane-episodes, 0].  The reference leaves columns 5-7 zero; here 5 and 6
// count the episodes run and the alive lanes summed over them (the work
// the data asked for).
//
// Layout: one block per instance.  The block packs each lane's digit
// column into one W-bit key (MSB = column 0), built column by column from
// coalesced reads of planes[b, c, :], and keeps the keys in dynamic shared
// memory with the alive and sign bits in the same word (bits 31 and 30;
// W <= 30).  Every thread then owns a CONTIGUOUS run of lanes, so the
// block exclusive scan of per-thread winner counts hands out ranks in
// index order (the emission order of ties).  The run index is skewed by
// one word every 32 so the runs do not fall on one shared-memory bank.
// The per-instance state (path word, skip word, the W-bit `present` word
// of the LIFO, counters) is uniform across the block: every thread holds
// it and updates it from the same block-reduced values.
//
// Each episode takes three block reductions (c_max and neg_pend; kmin;
// the winner count scan with dm and the divergence-bit OR): a warp
// intrinsic, one barrier, then one warp pass over the per-warp partials.
// The loop leaves as soon as `stop_n` numbers are out: every episode
// emits at least one, so at most stop_n episodes run (also a hard bound).
//
// Bound: the bytes are one read of planes and sign plus one write of rank
// and counters, tiny next to the work.  The work is about two dozen int32
// operations per alive lane per episode, N^2/2 lane-episodes for a full
// sort, so on this card the kernel is bound by integer operations, and
// for a single block by the latency of the serial episode chain (three
// barriers an episode), which the other resident blocks hide.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

enum Fmt { kUnsigned = 0, kTwos = 1, kSignmag = 2, kFloat = 3 };
constexpr int kNcnt = 8;
constexpr uint32_t kAlive = 1u << 31;
constexpr uint32_t kSign = 1u << 30;
constexpr uint32_t kKeyMask = kSign - 1u;

__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

// bit length of x >= 0 (0 -> 0)
__device__ __forceinline__ int bitlen(int x) { return 32 - __clz(x); }

// XOR mask turning the digit word into a key whose integer minimum is the
// machine's descent winner: bit W-1-c is the KEPT digit at column c.
__device__ __forceinline__ int flip_mask(int fmt, bool ascending, int W,
                                         bool neg_pend) {
  const int msb = 1 << (W - 1);
  const int low = msb - 1;
  if (fmt == kUnsigned) return ascending ? 0 : (msb | low);
  if (fmt == kTwos) return ascending ? msb : low;
  const int base = ascending ? msb : 0;  // sign-magnitude / float
  return neg_pend ? (base | low) : base;
}

__global__ void __launch_bounds__(1024)
fused_tns_kernel(const uint8_t* __restrict__ planes,
                 const uint8_t* __restrict__ sign, int* __restrict__ rank,
                 int* __restrict__ cnt, int W, int N, int k, int fmt,
                 bool ascending, int stop_n, int lanes) {
  extern __shared__ uint32_t s_key[];
  // per-warp partials; each reduction has its own rows, so one barrier a
  // reduction suffices (a row is rewritten only after two later barriers)
  __shared__ int red[6][32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint8_t* P = planes + (size_t)b * W * N;
  const uint8_t* S = sign == nullptr ? nullptr : sign + (size_t)b * N;
  int* R = rank + (size_t)b * N;

  for (int i = tid; i < N; i += blockDim.x) {
    uint32_t key = 0;
    for (int c = 0; c < W; ++c) key = (key << 1) | (P[(size_t)c * N + i] != 0);
    const uint32_t sg = (S != nullptr && S[i] != 0) ? kSign : 0u;
    s_key[sidx(i)] = key | sg | kAlive;
  }
  const int lo = min(tid * lanes, N);
  const int hi = min(lo + lanes, N);
  for (int i = lo; i < hi; ++i) R[i] = -1;
  __syncthreads();

  const int wmask = (1 << W) - 1;
  const bool is_signed = fmt == kSignmag || fmt == kFloat;
  const bool neg_sign = ascending;  // lanes with this sign bit keep neg_pend
  int pathv = 0, skipv = 0, present = 0;  // present: bit W-1-c = column c
  int out = 0, cyc = 0, drs = 0, rlc = 0, udr = 0, epi = 0, lane_ep = 0;

  while (out < stop_n && epi < stop_n) {
    ++epi;
    lane_ep += N - out;
    const int hole = ~skipv & wmask;  // columns the path match compares
    int c_res = -1;
    int col0 = 0;
    bool neg_pend = false;

    // ---- reload: pop drained nodes, resume the deepest live one
    if (k > 0 || is_signed) {
      int cmax_l = 0, neg_l = 0;
      for (int i = lo; i < hi; ++i) {
        const uint32_t w = s_key[sidx(i)];
        if (!(w & kAlive)) continue;
        if (k > 0) {
          const int md = ((int)(w & kKeyMask) ^ pathv) & hole;
          cmax_l = max(cmax_l, W - bitlen(md));
        }
        neg_l |= (((w & kSign) != 0) == neg_sign);
      }
      cmax_l = __reduce_max_sync(~0u, cmax_l);
      neg_l = (int)__reduce_or_sync(~0u, (unsigned)neg_l);
      if (lane == 0) {
        red[0][warp] = cmax_l;
        red[1][warp] = neg_l;
      }
      __syncthreads();
      const int c_max =
          __reduce_max_sync(~0u, lane < nwarps ? red[0][lane] : 0);
      neg_pend = is_signed &&
          __reduce_or_sync(~0u, lane < nwarps ? (unsigned)red[1][lane] : 0u);
      if (k > 0) {
        const int cm = min(c_max, W - 1);
        const int live = present & ~((1 << (W - 1 - cm)) - 1);
        c_res = live ? W - __ffs(live) : -1;
        const int drained =
            c_res >= 0 ? present & ((1 << (W - 1 - c_res)) - 1) : present;
        const int spent = max(__popc(drained) - 1, 0);
        present &= ~drained;
        // the resumed column holds the PRE-exclusion set: it becomes a
        // prefix hole; holes below it belong to popped subtrees
        const int pos_res = W - 1 - c_res;  // c_res == -1 -> W
        const int keepm = ~((1 << pos_res) - 1);
        const int resume = c_res >= 0 ? (1 << pos_res) : 0;
        skipv = (skipv & keepm) | resume;
        col0 = c_res + 1;
        cyc += spent;
        rlc += spent;
      }
    }

    // ---- descent: the winner tie set is the argmin of key ^ flip over
    // the resumed set m0, compared at the non-hole columns
    const int flipv = flip_mask(fmt, ascending, W, neg_pend);
    const int cmask = k > 0 ? (~skipv & wmask) : wmask;
#define FOR_M0(body)                                                   \
    for (int i = lo; i < hi; ++i) {                                    \
      const uint32_t w = s_key[sidx(i)];                               \
      if (!(w & kAlive)) continue;                                     \
      const int key = (int)(w & kKeyMask);                             \
      if (k > 0 && W - bitlen((key ^ pathv) & hole) < c_res) continue; \
      const int ckey = (key ^ flipv) & cmask;                          \
      body                                                             \
    }
    int kmin_l = INT_MAX;
    FOR_M0(kmin_l = min(kmin_l, ckey);)
    kmin_l = __reduce_min_sync(~0u, kmin_l);
    if (lane == 0) red[2][warp] = kmin_l;
    __syncthreads();
    const int kmin =
        __reduce_min_sync(~0u, lane < nwarps ? red[2][lane] : INT_MAX);

    // winners, the deepest loser divergence, the losers' divergence bits
    int t_l = 0, dm_l = -1;
    unsigned eb_l = 0;
    FOR_M0(
      if (ckey == kmin) {
        ++t_l;
      } else {
        const int bl = bitlen(ckey ^ kmin);
        dm_l = max(dm_l, W - bl);
        eb_l |= 1u << max(bl - 1, 0);
      })
    int inc = t_l;  // warp inclusive scan of the winner counts
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(~0u, inc, s);
      if (lane >= s) inc += v;
    }
    const int dmw = __reduce_max_sync(~0u, dm_l);
    const unsigned ebw = __reduce_or_sync(~0u, eb_l);
    if (lane == 31) red[3][warp] = inc;
    if (lane == 0) {
      red[4][warp] = dmw;
      red[5][warp] = (int)ebw;
    }
    __syncthreads();
    const int wt = lane < nwarps ? red[3][lane] : 0;
    const int before = __reduce_add_sync(~0u, lane < warp ? wt : 0);
    const int t = __reduce_add_sync(~0u, wt);
    const int dm = __reduce_max_sync(~0u, lane < nwarps ? red[4][lane] : -1);
    const int eb = (int)__reduce_or_sync(
        ~0u, lane < nwarps ? (unsigned)red[5][lane] : 0u);

    // deepest column still read: W-1 when the winner is a tie, else the
    // deepest divergence; mixed reads are the divergence bits in range
    const int cend = min(t >= 2 ? W : dm, W - 1);
    const int ep_drs = max(cend - col0 + 1, 0);
    const int rm =
        cend >= col0 ? (1 << (W - col0)) - (1 << (W - 1 - cend)) : 0;
    const int ebits = eb & rm;
    udr += __popc(ebits);
    if (k > 0) {
      pathv = (pathv & ~rm) | ((kmin ^ flipv) & rm);
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
    int p = before + inc - t_l;
    if (p < r) {
      FOR_M0(
        if (ckey == kmin) {
          if (p >= r) break;
          R[i] = out + p;
          s_key[sidx(i)] = w & ~kAlive;
          ++p;
        })
    }
#undef FOR_M0
    const int emit_cyc = ep_drs == 0 ? (t > 1 ? r : 1) : max(r - 1, 0);
    cyc += emit_cyc + ep_drs;
    drs += ep_drs;
    out += r;
  }

  if (tid == 0) {
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
  int threads = ((N + 7) / 8 + 31) / 32 * 32;  // about 8 lanes a thread
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int lanes = (N + threads - 1) / threads;
  const size_t smem = (size_t)(N + (N >> 5) + 1) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      fused_tns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_tns_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const uint8_t*)sign, (int*)rank, (int*)cnt, W,
      N, k, fmt, ascending != 0, stop_n, lanes);
  return (int)cudaGetLastError();
}
