// Order-preserving sort-key packing and its inverse, for Hopper.
//
// Replaces src/repro/kernels/bitplane_pack.py::_pack_f32_kernel,
// ::_unpack_f32_kernel and ::_pack_i32_kernel (the Pallas TPU kernels,
// tiled there by _blocked_elementwise into padded (256, 512) blocks).
// The transforms map float32 / bfloat16 / int32 to uint32 keys whose
// unsigned order is the value order (negative floats flip every bit,
// everything else flips the sign bit), and uint32 keys back to float32.
// bfloat16 is read as it is: its 16 bits shifted left by 16 are the exact
// float32, so the widening costs no pass.  -0.0, +-inf and NaN keep the
// reference's bit patterns (the transforms are pure bit operations).
//
// Design: one flat grid-stride loop over the tensor, no padding, no
// tiling.  Each step of a thread moves 16 bytes of input with one vector
// load (4 float32 / int32 or 8 bfloat16) and writes 16 or 32 bytes of
// keys; the ragged tail and unaligned pointers take a scalar loop.
//
// Bound: bytes.  Every element is read once and written once, with two or
// three integer operations in between, so on this card the kernel is
// bound by device memory (3.35 TB/s): 8 bytes an element for float32 and
// int32, 6 for bfloat16.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kPackF32 = 0, kPackBF16 = 1, kPackI32 = 2, kUnpackF32 = 3 };

__device__ __forceinline__ uint32_t pack_f32(uint32_t u) {
  return (u >> 31) ? ~u : (u ^ 0x80000000u);
}

__device__ __forceinline__ uint32_t unpack_f32(uint32_t key) {
  return (key >> 31) ? (key ^ 0x80000000u) : ~key;
}

template <int OP>
__device__ __forceinline__ uint32_t transform(uint32_t in) {
  if (OP == kPackF32) return pack_f32(in);
  if (OP == kPackBF16) return pack_f32(in << 16);
  if (OP == kPackI32) return in ^ 0x80000000u;
  return unpack_f32(in);
}

// Input elements are 4 bytes, except bfloat16 (2); outputs are 4 bytes.
template <int OP>
__global__ void __launch_bounds__(256)
pack_kernel(const void* __restrict__ src, uint32_t* __restrict__ dst,
            int64_t n, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    if (OP == kPackBF16) {
      const uint4* s = (const uint4*)src;       // 8 bf16 a load
      uint4* d = (uint4*)dst;                   // two 16-byte stores
      const int64_t groups = n / 8;
      for (int64_t g = tid; g < groups; g += stride) {
        const uint4 v = s[g];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t o[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[2 * i] = transform<OP>(w[i] & 0xFFFFu);
          o[2 * i + 1] = transform<OP>(w[i] >> 16);
        }
        d[2 * g] = make_uint4(o[0], o[1], o[2], o[3]);
        d[2 * g + 1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      done = groups * 8;
    } else {
      const uint4* s = (const uint4*)src;       // 4 words a load
      uint4* d = (uint4*)dst;
      const int64_t groups = n / 4;
      for (int64_t g = tid; g < groups; g += stride) {
        const uint4 v = s[g];
        d[g] = make_uint4(transform<OP>(v.x), transform<OP>(v.y),
                          transform<OP>(v.z), transform<OP>(v.w));
      }
      done = groups * 4;
    }
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const uint32_t in = OP == kPackBF16
                            ? (uint32_t)((const uint16_t*)src)[i]
                            : ((const uint32_t*)src)[i];
    dst[i] = transform<OP>(in);
  }
}

template <int OP>
int launch(const void* src, void* dst, int64_t n, cudaStream_t stream) {
  const int threads = 256;
  const int64_t per_step = OP == kPackBF16 ? 8 : 4;
  int64_t blocks = (n / per_step + threads - 1) / threads;
  // a grid-stride loop: a few waves of resident blocks cover any size
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  const int vec = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  pack_kernel<OP><<<(int)blocks, threads, 0, stream>>>(
      src, (uint32_t*)dst, n, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* bitplane_pack_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// op: 0 pack float32, 1 pack bfloat16, 2 pack int32, 3 unpack to float32.
// src: n elements (2 bytes each for bfloat16, else 4); dst: n uint32 words.
extern "C" int bitplane_pack_launch(const void* src, void* dst, int64_t n,
                                    int op, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kPackF32: return launch<kPackF32>(src, dst, n, s);
    case kPackBF16: return launch<kPackBF16>(src, dst, n, s);
    case kPackI32: return launch<kPackI32>(src, dst, n, s);
    case kUnpackF32: return launch<kUnpackF32>(src, dst, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
