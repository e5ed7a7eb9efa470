// Single-token (decode) attention over a KV cache in its stored layout,
// for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA
// (src/repro/models/layers.py::_sdpa).  It was added because the port's
// _sdpa, handed the (B, S, KV, hd) cache at one query token, re-lays the
// whole of k and v into its products' operands every layer of every decode
// step (at qwen2-moe's decode cell a copy of 1.34 GB a layer), then runs
// about ten float32 passes over the scores.  Its plain version is
// kernels/decode_attn.py::decode_attention_ref, _sdpa's arithmetic for one
// query token.
//
// What it computes, for row b, KV head h and each of its G query heads
// (query head h * G + g: _sdpa's grouped expansion), with the row's
// position p = positions[b]:
//   score[s] = (sum_d q[d] * k[s, d]) / div   (float32 sums of the
//     products), over the filled positions s <= p (at most S of them); a
//     row with p < 0 sees none and, as _sdpa's -1e30 mask gives it, weighs
//     all S positions alike;
//   prob = softmax(score) in float32 (max, exp, sum, divide), each rounded
//     to the cache's type before the value product;
//   out[d] = sum_s prob[s] * v[s, d] in float32, rounded once.
// Positions past p are never read: under _sdpa their weight is exactly 0,
// so a rewound row's stale entries change nothing.
//
// Bound: bytes.  Every filled k and v element is read once; the scores
// (float32, G a position) go out to a scratch and back.  At the decode
// cell (64 rows, 16 KV heads of 128, ~2220 of 2560 positions filled, bf16)
// that is 1.16 GB a layer, 0.35 ms at 3.35 TB/s; at 2 FLOPs a byte of k or
// v the arithmetic is far below the card's.
//
// Design:
// - one block of kWarps warps a (row, KV head, chunk of positions); it
//   serves all G query heads of the KV head, so k and v are read once for
//   the group;
// - a lane holds 8 consecutive elements of hd (one 16-byte load of a 2-byte
//   type, two of float32): `lanes` = hd / 8 rounded up to a power of two
//   (and to at least the group's registers, GM) lanes read one position,
//   neighbouring lanes neighbouring addresses, 32 / lanes positions a warp
//   at a time, kUnroll of them in flight a lane; a position's G dot
//   products are reduced over its lanes scattered, each lane ending with
//   one head's sum (GM - 1 + log2(lanes / GM) shuffles, not GM log2(lanes));
// - two launches: decode_scores_kernel writes the scores of its chunk;
//   decode_values_kernel takes each head's max and sum over all of the
//   row's scores, writes a tile of probabilities to shared memory (each
//   (head, position) once) and sums probabilities times v;
// - the positions are cut into P chunks, P > 1 only where B * KV blocks
//   would not keep the card busy (the wrapper picks P from the shape and
//   the group); then each chunk's float32 sums go to a scratch and
//   decode_combine_kernel adds them in chunk order and rounds once.
// At the cell's shape the pair takes 0.436-0.458 ms, 79-83 % of the bound
// (NVIDIA H100 80GB HBM3, 700 W); the scores and the values kernels take
// about half each.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;              // positions in flight a lane
constexpr int kTile = 256;              // positions a tile of probabilities
constexpr int kMaxHd = 256;             // the widest head (the block's sums
                                        // reuse the tile: kTile >= kMaxHd)
constexpr int kMaxGroup = 8;            // query heads a KV head
constexpr float kMasked = -1e30f;       // _sdpa's masked score

// the element type of code DT: 0 float32, 1 bfloat16, 2 float16
template <int DT> struct Elt { typedef float T; };
template <> struct Elt<1> { typedef __nv_bfloat16 T; };
template <> struct Elt<2> { typedef __half T; };

// 8 consecutive elements as loaded: one 16-byte word of a 2-byte type, two
// of float32
struct Raw { uint4 a, b; };

template <int DT>
__device__ __forceinline__ Raw load8(const typename Elt<DT>::T* p) {
  Raw r;
  r.a = __ldg(reinterpret_cast<const uint4*>(p));
  if constexpr (DT == 0) r.b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  else r.b = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

__device__ __forceinline__ Raw zero8() {
  Raw r;
  r.a = r.b = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

template <int DT>
__device__ __forceinline__ void unpack8(const Raw& r, float f[8]) {
  const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                         r.b.x, r.b.y, r.b.z, r.b.w};
  if constexpr (DT == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t;
      if constexpr (DT == 1)
        t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      else
        t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// x rounded to the element type (to nearest even) and back
template <int DT>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (DT == 1) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (DT == 2) return __half2float(__float2half_rn(x));
  else return x;
}

template <int DT>
__device__ __forceinline__ typename Elt<DT>::T to_elt(float x) {
  if constexpr (DT == 1) return __float2bfloat16_rn(x);
  else if constexpr (DT == 2) return __float2half_rn(x);
  else return x;
}

// positions row b attends: p + 1 for its position p, at most S; 0 where
// p < 0 (no filled position)
__device__ __forceinline__ int filled(const void* pos, int pos64,
                                      long long stride, int b, int S) {
  const long long p = pos64 ? static_cast<const long long*>(pos)[b * stride]
                            : static_cast<const int*>(pos)[b * stride];
  return p < 0 ? 0 : (p >= S ? S : static_cast<int>(p) + 1);
}

// x[g] reduced over the block (max, or sum), in every thread
template <int GM, bool MAX>
__device__ __forceinline__ void block_reduce(float (&x)[GM], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFull, x[g], off);
      x[g] = MAX ? fmaxf(x[g], o) : x[g] + o;
    }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) red[warp * GM + g] = x[g];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float t = red[g];
    for (int w = 1; w < kWarps; ++w)
      t = MAX ? fmaxf(t, red[w * GM + g]) : t + red[w * GM + g];
    x[g] = t;
  }
  __syncthreads();
}

// Scores of one (row, KV head, chunk): sc[(bh * G + g) * S + s].  GM: the
// query heads' registers, 1 for G = 1, else kMaxGroup (the published
// groups are 1, 5 and 8; one instantiation for every G > 1 halves the
// build).
template <int DT, int GM>
__global__ void __launch_bounds__(kThreads)
decode_scores_kernel(const typename Elt<DT>::T* __restrict__ q,
                     const typename Elt<DT>::T* __restrict__ k,
                     long long kb, long long ks, long long kh,
                     const void* __restrict__ pos, int pos64,
                     long long pstride, float* __restrict__ sc, int KV,
                     int G, int S, int hd, int lanes, int chunk, float div) {
  typedef typename Elt<DT>::T T;
  const int bh = blockIdx.x, b = bh / KV, h = bh - b * KV;
  const int n = filled(pos, pos64, pstride, b, S);
  const int nr = n > 0 ? n : S;
  const int s0 = blockIdx.y * chunk, s1 = min(s0 + chunk, nr);
  if (s0 >= s1) return;
  float* out = sc + (size_t)bh * G * S;
  if (n == 0) {  // nothing filled: every score masked, k unread
    for (int g = 0; g < G; ++g)
      for (int s = s0 + threadIdx.x; s < s1; s += kThreads)
        out[(size_t)g * S + s] = kMasked;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (lanes - 1), grp = lane / lanes;
  const int ppw = 32 / lanes, step = kWarps * ppw;
  const bool active = sub * 8 < hd;
  float qf[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (active && g < G) {
      unpack8<DT>(load8<DT>(q + ((size_t)bh * G + g) * hd + sub * 8), qf[g]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[g][j] = 0.f;
    }
  }
  const T* kp = k + b * kb + h * kh + sub * 8;
  // warp-uniform trip count: every lane reaches the shuffles
  for (int base = s0 + warp * ppw; base < s1; base += step * kUnroll) {
    Raw raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * step + grp;
      raw[u] = active && s < s1 ? load8<DT>(kp + s * ks) : zero8();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + u * step + grp;
      float kf[8], d[GM];
      unpack8<DT>(raw[u], kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d[g] = fmaf(qf[g][j], kf[j], d[g]);
      }
      // the GM sums over the position's lanes, scattered: each halving
      // step trades half of a lane's heads with its partner, until lane
      // `sub` holds head sub / (lanes / GM) alone; then a plain reduction
#pragma unroll
      for (int c = GM, off = lanes >> 1; c > 1; c >>= 1, off >>= 1) {
        const bool up = sub & off;
#pragma unroll
        for (int i = 0; i < c / 2; ++i) {
          const float mine = up ? d[i + c / 2] : d[i];
          d[i] = mine + __shfl_xor_sync(kFull, up ? d[i] : d[i + c / 2], off);
        }
      }
      const int span = lanes / GM;  // lanes holding one head's parts
      for (int off = span >> 1; off > 0; off >>= 1)
        d[0] += __shfl_xor_sync(kFull, d[0], off);
      const int g = sub / span;
      if (sub % span == 0 && g < G && s < s1)
        out[(size_t)g * S + s] = d[0] / div;
    }
  }
}

// Probabilities times v over one chunk: the output (P == 1) or the chunk's
// float32 sums, part[((bh * P + c) * G + g) * hd + d].
template <int DT, int GM>
__global__ void __launch_bounds__(kThreads)
decode_values_kernel(const typename Elt<DT>::T* __restrict__ v,
                     long long vb, long long vs, long long vh,
                     const void* __restrict__ pos, int pos64,
                     long long pstride, const float* __restrict__ sc,
                     typename Elt<DT>::T* __restrict__ out,
                     float* __restrict__ part, int KV, int G, int S, int hd,
                     int lanes, int chunk) {
  typedef typename Elt<DT>::T T;
  // a tile's probabilities, then the block's sums (G x hd <= GM x kTile)
  __shared__ float wt[GM * kTile];
  __shared__ float red[kWarps * GM];
  const int bh = blockIdx.x, b = bh / KV, h = bh - b * KV;
  const int P = gridDim.y, c = blockIdx.y;
  const int n = filled(pos, pos64, pstride, b, S);
  const int nr = n > 0 ? n : S;
  const int s0 = c * chunk, s1 = min(s0 + chunk, nr);
  if (s0 >= s1) {  // a chunk past the row's filled positions adds 0
    for (int i = threadIdx.x; i < G * hd; i += kThreads)
      part[((size_t)bh * P + c) * G * hd + i] = 0.f;
    return;
  }
  const float* row = sc + (size_t)bh * G * S;
  // each head's max and sum over all of the row's scores
  float m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) m[g] = -INFINITY;
  for (int s = threadIdx.x; s < nr; s += kThreads)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) m[g] = fmaxf(m[g], row[(size_t)g * S + s]);
  block_reduce<GM, true>(m, red);
#pragma unroll
  for (int g = 0; g < GM; ++g) l[g] = 0.f;
  for (int s = threadIdx.x; s < nr; s += kThreads)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) l[g] += expf(row[(size_t)g * S + s] - m[g]);
  block_reduce<GM, false>(l, red);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (lanes - 1), grp = lane / lanes;
  const int ppw = 32 / lanes, step = kWarps * ppw;
  const bool active = sub * 8 < hd;
  const T* vp = v + b * vb + h * vh + sub * 8;
  float acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  for (int t0 = s0; t0 < s1; t0 += kTile) {
    const int tn = min(kTile, s1 - t0);
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
        for (int j = threadIdx.x; j < tn; j += kThreads)
          wt[g * kTile + j] = rounded<DT>(
              expf(row[(size_t)g * S + t0 + j] - m[g]) / l[g]);
    __syncthreads();
    for (int base = warp * ppw; base < tn; base += step * kUnroll) {
      Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * step + grp;
        raw[u] = active && j < tn ? load8<DT>(vp + (t0 + j) * vs) : zero8();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * step + grp;
        if (!(active && j < tn)) continue;
        float vf[8];
        unpack8<DT>(raw[u], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) continue;
          const float w = wt[g * kTile + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();
  }
  // the warp's position groups, then the warps in turn, into wt
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      for (int off = lanes; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && grp == 0 && active)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float* p = &wt[g * hd + sub * 8 + e];
            *p = (w == 0 ? 0.f : *p) + acc[g][e];
          }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    if (P == 1) out[(size_t)bh * G * hd + i] = to_elt<DT>(wt[i]);
    else part[((size_t)bh * P + c) * G * hd + i] = wt[i];
  }
}

// The chunks' sums of each (row, KV head) added in chunk order, rounded.
template <int DT>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part,
                      typename Elt<DT>::T* __restrict__ out, int GH, int P) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < GH; i += kThreads) {
    float t = 0.f;
    for (int c = 0; c < P; ++c) t += part[((size_t)bh * P + c) * GH + i];
    out[(size_t)bh * GH + i] = to_elt<DT>(t);
  }
}

struct Args {
  const void *q, *k, *v, *pos;
  long long kb, ks, kh, vb, vs, vh, pstride;
  int pos64;
  float *scores, *part;
  void* out;
  int B, KV, G, S, hd, lanes, P, chunk;
  float div;
};

template <int DT, int GM>
cudaError_t launch(const Args& a, cudaStream_t st) {
  typedef typename Elt<DT>::T T;
  const dim3 grid(a.B * a.KV, a.P);
  decode_scores_kernel<DT, GM><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), a.kb, a.ks,
      a.kh, a.pos, a.pos64, a.pstride, a.scores, a.KV, a.G, a.S, a.hd,
      a.lanes, a.chunk, a.div);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_values_kernel<DT, GM><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a.v), a.vb, a.vs, a.vh, a.pos, a.pos64,
      a.pstride, a.scores, static_cast<T*>(a.out), a.part, a.KV, a.G, a.S,
      a.hd, a.lanes, a.chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.P == 1) return e;
  decode_combine_kernel<DT><<<a.B * a.KV, kThreads, 0, st>>>(
      a.part, static_cast<T*>(a.out), a.G * a.hd, a.P);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_group(const Args& a, int gm, cudaStream_t st) {
  return gm == 1 ? launch<DT, 1>(a, st) : launch<DT, kMaxGroup>(a, st);
}

}  // namespace

extern "C" const char* decode_attn_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// q: (B, KV * G, hd) contiguous; k, v: (B, S, KV, hd) with these element
// strides of rows, positions and heads, hd contiguous, every 8 elements
// 16-byte aligned; pos: (B,) int32 or int64 (pos64) at element stride
// pstride; scores: B * KV * G * S float32; part: B * KV * P * G * hd
// float32 where P > 1; out: (B, KV * G, hd).  dtype: 0 float32, 1 bfloat16,
// 2 float16.  The positions are cut into P chunks of `chunk`.
extern "C" int decode_attn_launch(
    const void* q, const void* k, const void* v, long long kb, long long ks,
    long long kh, long long vb, long long vs, long long vh, const void* pos,
    int pos64, long long pstride, void* scores, void* part, void* out, int B,
    int KV, int G, int S, int hd, int dtype, int P, int chunk, float div,
    void* stream) {
  if (B == 0 || KV == 0 || G == 0) return 0;
  if (S < 1 || hd < 8 || hd > kMaxHd || hd % 8 != 0 || G > kMaxGroup ||
      P < 1 || chunk < 1 || (long long)P * chunk < S ||
      (P > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // lanes a position: hd / 8 rounded up to a power of two, and at least
  // the group's registers (GM), which the scores' reduction scatters
  const int gm = G == 1 ? 1 : kMaxGroup;
  int lanes = 1;
  while (lanes * 8 < hd || lanes < gm) lanes <<= 1;
  const Args a{q, k, v, pos, kb, ks, kh, vb, vs, vh, pstride, pos64,
               static_cast<float*>(scores), static_cast<float*>(part), out,
               B, KV, G, S, hd, lanes, P, chunk, div};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch_group<0>(a, gm, st);
    case 1: return (int)launch_group<1>(a, gm, st);
    case 2: return (int)launch_group<2>(a, gm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
