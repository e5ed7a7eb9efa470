// In-situ-pruned matrix product y = (x * keep_mask) @ w, for Hopper.
//
// Replaces src/repro/kernels/masked_matmul.py::_mm_kernel (the Pallas TPU
// kernel behind pruned_matmul): x is (M, K), w is (K, N), keep_mask is a
// (K,) lane mask, the sum is kept in float32 and the output is in x's
// dtype.  As on the TPU, the mask costs one multiply per input element as
// the x tile is loaded, instead of a masked copy of x in device memory.
//
// Design: a plain tiled kernel, one output tile per thread block, K walked
// inside the block with x and w tiles staged in shared memory.
// - bfloat16: 128 x 128 tiles, K steps of 32, eight warps each holding a
//   64 x 32 float32 accumulator in WMMA fragments (mma.sync on the tensor
//   cores, 16 x 16 x 16).  Where K and N are multiples of 8 and the
//   pointers are 16-byte aligned, tiles load with 16-byte vector loads and
//   the next tile is fetched into registers while the current one is
//   multiplied; otherwise element by element.
// - float32: 64 x 64 tiles, K steps of 16, a 4 x 4 float32 block per
//   thread with FFMA (never TF32, so that it matches a float32 reference).
// Ragged edges are masked on load (zeros) and on store; nothing is padded
// in device memory.  wgmma, TMA and a pipelined shared-memory ring are not
// used here.
//
// Bound: at the main path's shape (4096 x 2048 x 8192, bfloat16) the
// product needs 2*M*K*N = 1.4e11 operations against 8.4e7 bytes, far
// above the card's balance point, so it is bound by the tensor cores
// (989 TFLOP/s bf16); this simple kernel does not approach that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bfloat16
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;   // padded rows (WMMA ldm: multiple of 8)
constexpr int B_LD = BN + 8;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ bf16 masked(bf16 v, bool keep) {
  // x * 0 (not a select), so that inf and NaN lanes give NaN as x * mask
  return keep ? v : __float2bfloat16(__bfloat162float(v) * 0.0f);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const uint8_t* __restrict__ keep, bf16* __restrict__ y,
               int M, int K, int N) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float stage[kThreads / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // vector path: each thread moves 2 x 8 elements of each tile
  uint4 ra[2], rb[2];
  auto load_vec = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int ar = idx >> 2, ac = (idx & 3) * 8;     // A: 128 x 32
      const int gm = m0 + ar, gk = k0 + ac;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        v = *(const uint4*)(x + (size_t)gm * K + gk);
        const uint2 kv = *(const uint2*)(keep + gk);
        const uint8_t* kb = (const uint8_t*)&kv;
        bf16* e = (bf16*)&v;
#pragma unroll
        for (int q = 0; q < 8; ++q) e[q] = masked(e[q], kb[q] != 0);
      }
      ra[i] = v;
      const int br = idx >> 4, bc = (idx & 15) * 8;    // B: 32 x 128
      const int hk = k0 + br, hn = n0 + bc;
      rb[i] = (hk < K && hn < N)
                  ? *(const uint4*)(w + (size_t)hk * N + hn)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_vec = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      *(uint4*)(As + (idx >> 2) * A_LD + (idx & 3) * 8) = ra[i];
      *(uint4*)(Bs + (idx >> 4) * B_LD + (idx & 15) * 8) = rb[i];
    }
  };
  auto load_scalar = [&](int k0) {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int ar = idx / BK, ac = idx % BK;
      const int gm = m0 + ar, gk = k0 + ac;
      As[ar * A_LD + ac] = (gm < M && gk < K)
                               ? masked(x[(size_t)gm * K + gk], keep[gk] != 0)
                               : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int br = idx / BN, bc = idx % BN;
      const int hk = k0 + br, hn = n0 + bc;
      Bs[br * B_LD + bc] = (hk < K && hn < N) ? w[(size_t)hk * N + hn] : zero;
    }
  };

  if (VEC) load_vec(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (VEC) {
      store_vec();
      if (k0 + BK < K) load_vec(k0 + BK);   // in flight during the MMAs
    } else {
      load_scalar(k0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each fragment through the warp's staging tile, then a
  // bounds-checked, rounded store
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 64 + i * 16, c0 = n0 + wn * 32 + j * 16;
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const int gm = r0 + e / 16, gn = c0 + e % 16;
        if (gm < M && gn < N) y[(size_t)gm * N + gn] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- float32
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(256)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const uint8_t* __restrict__ keep, float* __restrict__ y,
              int M, int K, int N) {
  __shared__ float As[FK][FM + 4];   // x tile, transposed: As[k][m]
  __shared__ float Bs[FK][FN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 256;
      const int ar = idx / FK, ac = idx % FK;
      const int gm = m0 + ar, gk = k0 + ac;
      float v = 0.0f;
      if (gm < M && gk < K) {
        v = x[(size_t)gm * K + gk];
        if (!keep[gk]) v *= 0.0f;          // x * 0, as x * mask
      }
      As[ac][ar] = v;
      const int br = idx / FN, bc = idx % FN;
      const int hk = k0 + br, hn = n0 + bc;
      Bs[br][bc] = (hk < K && hn < N) ? w[(size_t)hk * N + hn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" const char* masked_matmul_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// dtype: 0 float32, 1 bfloat16.  x: (M, K), w: (K, N), keep: (K,) uint8,
// y: (M, N), all contiguous, x / w / y of one dtype.
extern "C" int masked_matmul_launch(const void* x, const void* w,
                                    const void* keep, void* y, int M, int K,
                                    int N, int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    mm_f32_kernel<<<grid, 256, 0, s>>>((const float*)x, (const float*)w,
                                       (const uint8_t*)keep, (float*)y, M, K,
                                       N);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = K % 8 == 0 && N % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0 && (uintptr_t)keep % 8 == 0;
  if (vec)
    mm_bf16_kernel<true><<<grid, kThreads, 0, s>>>(
        (const bf16*)x, (const bf16*)w, (const uint8_t*)keep, (bf16*)y, M, K,
        N);
  else
    mm_bf16_kernel<false><<<grid, kThreads, 0, s>>>(
        (const bf16*)x, (const bf16*)w, (const uint8_t*)keep, (bf16*)y, M, K,
        N);
  return (int)cudaGetLastError();
}
