// One digit-read min- (or max-) search over raw bit-planes, for Hopper.
//
// Replaces src/repro/kernels/digit_read.py::_dr_kernel (the Pallas TPU
// kernel).  Input is the physical array image: (B, W, N) uint8 bit-planes,
// MSB first.  The search walks the W columns with the number-exclusion mask
// and returns the survivor mask (ties included, (B, N) bool) and the count
// of useful (mixed) digit reads ((B,) int32).
//
// Design: one thread block per row; each thread owns a contiguous run of at
// most 64 lanes and keeps their exclusion mask in one 64-bit register.  A
// column's any-hit / any-keep are two __syncthreads_or.  The ragged edge is
// masked (no lane padding, unlike the TPU version's 128-lane tiles).
//
// Bound: one read of the planes (B*W*N bytes) plus one write of the mask;
// the arithmetic is a compare and two ORs per lane and column, so on this
// card the kernel is bound by bytes, and by the 2*W block barriers for
// small B.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLanes = 64;

__global__ void __launch_bounds__(1024)
digit_read_kernel(const uint8_t* __restrict__ planes, bool* __restrict__ mask,
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

}  // namespace

extern "C" const char* digit_read_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// planes: (B, W, N) uint8; mask: (B, N) bool; drs: (B,) int32.
extern "C" int digit_read_launch(const void* planes, void* mask, void* drs,
                                 int B, int W, int N, int ascending,
                                 void* stream) {
  if (B == 0) return 0;
  int threads = ((N + 3) / 4 + 31) / 32 * 32;  // about 4 lanes a thread
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int lanes = (N + threads - 1) / threads;
  if (lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  digit_read_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (bool*)mask, (int*)drs, W, N, lanes,
      (uint8_t)(ascending ? 1 : 0));
  return (int)cudaGetLastError();
}
