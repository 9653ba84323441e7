// Hopper kernel: batched Montgomery multiplication over a prime field.
//
// Replaces the TPU kernel Field._mul_pallas (pallas_call at
// handel_tpu/ops/fp.py:577, body Field._mul_cols :328-368): the one kernel
// on the verify path. Every Fp, Fp2 and Fp12 multiply of a verify launch is
// one call, stacked wide by ops/tower.py (an Fp12 multiply is one call at
// 54x the batch width).
//
// What bounds it on an H100: per element it reads 2 * N16 * 4 bytes and
// writes N16 * 4 bytes (192 B for BN254), against 2 N^2 + N 32x32->64-bit
// products for N = N16/2 words, each two int32 multiply-adds (272 for
// BN254), plus about as many carry adds. The card does ~5 int32 operations
// (16.7 T/s) per byte of HBM (3.35 TB/s), so a wide batch is bound by the
// bytes and the design spends nothing that adds traffic; a narrow batch
// (an Fp12 multiply at 128 lanes is 13,824 columns) is bound by the launch.
//
// Design: one thread per column, so the 32 threads of a warp read 32
// neighbouring addresses of each limb row (coalesced 128-byte lines). Each
// thread keeps its element in registers as 32-bit words (8 for BN254, 12
// for BLS12-381), runs word-serial CIOS with 64-bit products and finishes
// with one conditional subtraction; nothing goes through shared memory. The
// ragged edge is masked by a bounds check, so no padding copy is needed.
// The TPU kernel's 16-bit limbs with lazy column carries existed because
// the TPU vector unit has no 32x32->64 multiply; Hopper has it, which
// quarters the limb products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_mont.cuh"

namespace {

constexpr int kThreads = 256;

template <int N16>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, int64_t lda,
                    const int32_t* __restrict__ b, int64_t ldb,
                    int32_t* __restrict__ out, int64_t ldo, int64_t cols,
                    handel::MontParams prm) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j < cols) handel::mont_mul_column<N16>(a, lda, b, ldb, out, ldo, j, prm);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (handel_tpu_torch/kernels/fp_mont.py). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched). cols == 0 launches
// nothing. nlimbs16 must be 16 or 24; p_words holds nlimbs16/2 words.
extern "C" int handel_mont_mul(const int32_t* a, int64_t lda, const int32_t* b,
                               int64_t ldb, int32_t* out, int64_t ldo,
                               int64_t cols, int nlimbs16,
                               const uint32_t* p_words, uint32_t n0,
                               void* stream) {
  if (cols == 0) return 0;
  handel::MontParams prm = {};
  const int words = nlimbs16 / 2;
  if (words > handel::kMaxWords) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < words; ++k) prm.p[k] = p_words[k];
  prm.n0 = n0;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  switch (nlimbs16) {
    case 16:
      mont_mul_kernel<16><<<grid, kThreads, 0, s>>>(a, lda, b, ldb, out, ldo,
                                                   cols, prm);
      break;
    case 24:
      mont_mul_kernel<24><<<grid, kThreads, 0, s>>>(a, lda, b, ldb, out, ldo,
                                                   cols, prm);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
