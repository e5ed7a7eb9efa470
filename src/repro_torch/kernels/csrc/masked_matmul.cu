// In-situ-pruned matrix product y = (x * keep_mask) @ w, for Hopper.
//
// Replaces src/repro/kernels/masked_matmul.py::_mm_kernel (the Pallas TPU
// kernel behind pruned_matmul): x is (M, K), w is (K, N), keep_mask is a
// (K,) lane mask, the sum is kept in float32 and the output is in x's
// dtype.  As on the TPU, the mask is a multiply applied inside the kernel
// (times 0, not a select, so that a NaN or an infinity in a pruned lane
// gives NaN where x * mask does); there is no masked copy of x or w in
// device memory.
//
// Bound: at the main path's shape (4096 x 2048 x 8192, bfloat16, 1434 of
// 2048 lanes kept) the product needs 2*M*K_kept*N = 9.6e10 useful
// operations against 1.2e8 bytes, far above the card's balance point, so
// it is bound by the tensor cores: 0.0973 ms at 989 TFLOP/s bf16.  The
// kernel multiplies over the full K (pruned lanes times 0), as
// torch.matmul(x * keep, w) does.
//
// Three forms, chosen by the wrapper (kernels/masked_matmul.py) and
// counted there one by one:
// - wgmma (bfloat16, K > 0, K and N multiples of 8, x and w 16-byte
//   aligned: TMA's stride and alignment rules): a persistent,
//   warp-specialised kernel, one block an SM walking 128 x 256 output
//   tiles, K steps of 64 (one 128-byte swizzled row of bfloat16).  A ring
//   of 4 stages in dynamic shared memory (16 KiB of x and 32 KiB of w a
//   stage, 192 KiB), a full / empty mbarrier pair a stage, and a 16 KiB
//   output staging buffer a consumer: 224 KiB of the 227 a block may opt
//   into.  A producer warpgroup (one thread) issues the TMA
//   loads (cp.async.bulk.tensor, SWIZZLE_128B): one 64 x 128 box of x and
//   four 64 x 64 boxes of w, whose inner extent the swizzle caps at 64
//   bfloat16; it runs on into the next tile while the consumers store this
//   one.  Two consumer warpgroups each own 64 x 256 of the tile in 128
//   float32 registers a thread and issue wgmma.mma_async m64n256k16 with A
//   (x, K-major) and B (w, N-major: the descriptor's transpose bit) read
//   from shared memory.  setmaxnreg hands the producer's registers to the
//   consumers (40 / 232 a thread), but ptxas compiles every thread within
//   the 168 that 384 threads a block leave, which the consumers fit;
//   A fed from registers, with its 16 to 48 more a thread, does not.
//   The mask: (x * keep) @ w = x @ (keep * w) term by term, NaN included
//   (x * 0 * w is NaN exactly where x or w is not finite, whichever factor
//   takes the 0), so the kernel multiplies the pruned k-rows of the w tile
//   by 0: a pruned lane is one whole 512-byte row there (128 bytes in each
//   of the four boxes, so the swizzle does not matter), where in the x
//   tile it would touch nearly every 16-byte chunk; the mask's cost is
//   shared-memory traffic, so the fewer bytes the better.  A k step's
//   pruned rows come from two warp ballots over its 64 keep bytes; the
//   eight consumer warps multiply them in place, fence the generic-proxy
//   writes for wgmma's async proxy (fence.proxy.async) and meet at a named
//   barrier of both warpgroups; a step with no pruned lane skips all of
//   it.  The step's wgmma run while the next step is masked; a stage
//   returns to the producer once both consumers' wgmma on it have
//   completed.
//   The epilogue rounds the float32 accumulators to bfloat16 into the
//   consumer's staging buffer (two 64 x 64 boxes laid out as SWIZZLE_128B,
//   so the writes meet no bank conflict) and leaves by TMA stores, 128
//   columns at a time, which clip the ragged edge; the consumer goes on to
//   its next tile while they drain (ragged loads come in as zeros through
//   TMA's out-of-bounds fill).  No split-K and no atomics: the result is
//   deterministic.  The tensor maps are encoded on the host at each launch
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   no -lcuda) and passed as __grid_constant__.
// - wmma (every other bfloat16 shape, K = 0 included, which no tensor map
//   can describe): the port's first bfloat16 kernel, kept as it was.
//   128 x 128 tiles, K steps of 32, eight warps each holding a 64 x 32
//   float32 accumulator in WMMA fragments (mma.sync, 16 x 16 x 16).  Where K and N are multiples of 8 and the
//   pointers are 16-byte aligned, tiles load with 16-byte vector loads and
//   the next tile is fetched into registers while the current one is
//   multiplied; otherwise element by element.
// - ffma (float32): 64 x 64 tiles, K steps of 16, a 4 x 4 float32 block
//   per thread with FFMA (never TF32, so that it matches a float32
//   reference; wgmma has no float32 mode).
// The wmma and ffma forms mask ragged edges on load (zeros) and on store;
// nothing is padded in device memory.
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
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

// ------------------------------------------------------------ bf16 wgmma
constexpr int GM = 128, GN = 256, GK = 64;   // tile and K step
constexpr int kStages = 4;
constexpr int kABytes = GM * GK * 2;         // x tile: 16 KiB
constexpr int kBBox = GK * 64 * 2;           // one 64 x 64 box of w: 8 KiB
constexpr int kBBytes = 4 * kBBox;           // w tile: 32 KiB
constexpr int kOutBox = 64 * 64 * 2;         // one 64 x 64 box of y: 8 KiB
constexpr int kOutBytes = 2 * kOutBox;       // a consumer's staging: 16 KiB
constexpr int kWgThreads = 128;
constexpr int kConsumerWarps = 8;
constexpr int kGemmThreads = 3 * kWgThreads; // producer + two consumers
constexpr int kGemmSmem = kStages * (kABytes + kBBytes) + 2 * kOutBytes +
                          2 * kStages * 8 + 1024;  // + alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.  A wait
// that lasts billions of cycles can only be a fault: it traps, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor for a SWIZZLE_128B operand: start
// address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// D(64 x 256, f32) = A(64 x 16, bf16, K-major, from its descriptor) *
// B(16 x 256, bf16, N-major: the transpose bit set, from its descriptor)
// + D where scale_d is not 0
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}
// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence, commit and wait instructions
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__global__ void __launch_bounds__(kGemmThreads, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap ymap,
                const uint8_t* __restrict__ keep, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  // the ring: stages aligned to 1024 bytes, the swizzle pattern's period
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sA = base;
  const uint32_t sB = sA + kStages * kABytes;
  // each consumer's staging buffer for the output
  const uint32_t sOut = sB + kStages * kBBytes;
  // a stage's barriers: full (its TMA loads landed) and empty (both
  // consumers' wgmma on it completed)
  const uint32_t sFull = sOut + 2 * kOutBytes;
  const uint32_t sEmpty = sFull + 8 * kStages;

  const int wg = threadIdx.x / kWgThreads;
  const int t = threadIdx.x % kWgThreads;
  const int nk = (K + GK - 1) / GK;
  const int n_tiles = (N + GN - 1) / GN;
  const int tiles = n_tiles * ((M + GM - 1) / GM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sFull + 8 * s, 1);
      mbar_init(sEmpty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      // ---- producer: one thread keeps the ring's TMA loads in flight
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * GM, n0 = tile % n_tiles * GN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(sEmpty + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(sFull + 8 * s, kABytes + kBBytes);
          tma_load_2d(sA + s * kABytes, &xmap, sFull + 8 * s, kt * GK, m0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_2d(sB + s * kBBytes + j * kBBox, &wmap, sFull + 8 * s,
                        n0 + 64 * j, kt * GK);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup g owns rows 64 g .. 64 g + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1;
    const int warp = t / 32, lane = t % 32;
    const int gw = 4 * g + warp;
    const uint16_t* keep2 = reinterpret_cast<const uint16_t*>(keep);
    float acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * GM, n0 = tile % n_tiles * GN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        // the k step's pruned rows of w: bit i of lo / hi is row 2 i / 2 i
        // + 1 (lanes past K load as zeros and need no mask)
        const int kl = kt * GK + 2 * lane;
        const uint32_t two = kl < K ? __ldg(keep2 + kl / 2) : 0x0101u;
        const uint32_t lo = __ballot_sync(0xFFFFFFFFu, (two & 0xFFu) == 0);
        const uint32_t hi = __ballot_sync(0xFFFFFFFFu, (two & 0xFF00u) == 0);
        mbar_wait(sFull + 8 * s, (it / kStages) & 1);
        if ((lo | hi) != 0) {
          // warp gw of the eight multiplies rows gw, gw + 8, ... by 0 where
          // pruned: lane l takes 16 bytes of the row's 512 (box l / 8)
          const uint32_t word = (gw & 1) ? hi : lo;
          uint8_t* const row0 = gbase + (sB - sA) + s * kBBytes +
                                (lane >> 3) * kBBox + gw * 128 +
                                (lane & 7) * 16;
#pragma unroll
          for (int i = 0; i < GK / 8; ++i) {
            if ((word >> ((gw >> 1) + 4 * i)) & 1u) {
              uint4* p = reinterpret_cast<uint4*>(row0 + i * 8 * 128);
              uint4 v = *p;
              v.x = mul_bf16x2(v.x, 0u);
              v.y = mul_bf16x2(v.y, 0u);
              v.z = mul_bf16x2(v.z, 0u);
              v.w = mul_bf16x2(v.w, 0u);
              *p = v;
            }
          }
          // the generic-proxy writes become visible to wgmma's async proxy;
          // both consumer warpgroups read the whole w tile
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, %0;" ::"n"(2 * kWgThreads) : "memory");
        }
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        const uint64_t da =
            smem_desc(sA + s * kABytes + g * (64 * 128), 16, 1024);
        const uint64_t db = smem_desc(sB + s * kBBytes, kBBox, 1024);
#pragma unroll
        for (int kk = 0; kk < GK / 16; ++kk)
          // A: 16 k-lanes are 32 bytes along the swizzled row; B: 16
          // k-rows are two 1024-byte groups of 8
          wgmma_m64n256k16(acc, da + 2 * kk, db + 128 * kk, 1);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // the previous stage's wgmma have completed: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        if (kt > 0 && lane == 0)
          mbar_arrive(sEmpty + 8 * ((it - 1) % kStages));
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(sEmpty + 8 * ((it - 1) % kStages));

      // epilogue, while the producer fills the ring for the next tile: the
      // consumer's 64 x 256 of bfloat16 leaves through TMA stores (which
      // clip the ragged edge), 128 columns at a time from its staging
      // buffer of two 64 x 64 boxes laid out as SWIZZLE_128B (conflict-free
      // writes).  d[i] of thread (warp, lane) is row 16 warp + lane / 4
      // (+ 8 for i & 2), column 8 (i / 4) + 2 (lane % 4) (+ 1 for i & 1).
      const uint32_t out = sOut + g * kOutBytes;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the buffer is free once the last store has read it
        if (t == 0)
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        asm volatile("bar.sync %0, %1;" ::"r"(2 + g), "n"(kWgThreads)
                     : "memory");
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * half + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + lane / 4 + 8 * h;
            st_shared_u32(out + (jj >> 3) * kOutBox + r * 128 +
                              (((jj & 7) ^ (r & 7)) << 4) + (lane % 4) * 4,
                          pack_bf16x2(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, %1;" ::"r"(2 + g), "n"(kWgThreads)
                     : "memory");
        if (t == 0) {
          tma_store_2d(&ymap, out, n0 + 128 * half, m0 + 64 * g);
          tma_store_2d(&ymap, out + kOutBox, n0 + 128 * half + 64,
                       m0 + 64 * g);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      }
    }
    // the stores have read their buffers before the block leaves
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bfloat16 tensor map over a row-major (rows, cols) matrix, boxes of
// box_rows x 64 (one 128-byte swizzled row wide), out-of-bounds as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* x, const void* w, const void* keep, void* y,
                 int M, int K, int N, cudaStream_t s) {
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || (uintptr_t)x % 16 != 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)keep % 2 != 0 ||
      (uintptr_t)y % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, ymap;
  if (!encode_map(&xmap, x, M, K, GM) || !encode_map(&wmap, w, K, N, GK) ||
      !encode_map(&ymap, y, M, N, 64))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  static int sms[64] = {};   // per device: SM count once opted in, else 0
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        mm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGemmSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return (int)e;
  }
  // persistent: one block an SM, each walking tiles sms apart
  const long long tiles =
      (long long)((N + GN - 1) / GN) * ((M + GM - 1) / GM);
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  mm_wgmma_kernel<<<grid, kGemmThreads, kGemmSmem, s>>>(
      xmap, wmap, ymap, (const uint8_t*)keep, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* masked_matmul_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// form: 0 ffma (float32), 1 wmma (bfloat16), 2 wgmma (bfloat16, K > 0, K
// and N multiples of 8, x and w 16-byte aligned).  x: (M, K), w: (K, N),
// keep: (K,) uint8, y: (M, N), all contiguous, x / w / y of one dtype.
extern "C" int masked_matmul_launch(const void* x, const void* w,
                                    const void* keep, void* y, int M, int K,
                                    int N, int form, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    mm_f32_kernel<<<grid, 256, 0, s>>>((const float*)x, (const float*)w,
                                       (const uint8_t*)keep, (float*)y, M, K,
                                       N);
    return (int)cudaGetLastError();
  }
  if (form == 2) return launch_wgmma(x, w, keep, y, M, K, N, s);
  if (form != 1) return (int)cudaErrorInvalidValue;
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
