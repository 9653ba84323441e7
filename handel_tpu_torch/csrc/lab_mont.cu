// Hopper kernels B3a and B3b: the kernel lab's two Montgomery-product
// formulations.
//
// Replace the TPU kernel LabField.jit_pallas (pallas_call at
// scripts/fp_kernel_lab.py:234), which the reference builds around either
// body, cios_fullwidth_body (:92-131) or separated_body (:183-213), with a
// grid over the batch in tiles of 256 to 2048 columns. The lab
// (handel_tpu_torch/scripts/fp_kernel_lab.py) races them against B1 and the
// other formulations of the same product; no verify path calls them.
//
// What bounds them on an H100: per element they read 2 N and write N int32
// digits (192 bytes for BN254, N = 16), like B1. Unlike B1 they multiply
// 16-bit digits, so the schoolbook product alone is N^2 = 256 products
// (B1: 64 word products of 2 multiply-adds each), and each product is
// followed by a mask, a shift and two adds: B3a does 2 N^2 products, about
// 10 N^2 integer operations (2,560 at N = 16), B3b about 2.5 N^2 products,
// 12.5 N^2 operations. At five int32 operations per byte of HBM (16.7 T/s
// over 3.35 TB/s) a wide call of either is bound by its operations, not
// the bytes; chip_smoke.py holds both to B1's bound all the same, since
// the function is B1's.
//
// Design: one thread per column, digits and lazy column sums in registers
// (B3a holds 2N + 1 sums beside the 2N input digits: 97 words at N = 24),
// fully unrolled by the template on N, so every index is static; no shared
// memory. The block size is the lab's counterpart of the Pallas tile: each
// of 64, 128, 256 and 512 threads is its own instantiation with matching
// __launch_bounds__, so the register budget follows the block size (512
// threads leave at most 128 registers a thread). The ragged edge is masked
// by a bounds check; the row stride is an argument.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lab_mont.cuh"

namespace {

template <int N16, int kForm, int kThreads>
__global__ void __launch_bounds__(kThreads)
    lab_mont_kernel(const int32_t* __restrict__ a, int64_t lda,
                    const int32_t* __restrict__ b, int64_t ldb,
                    int32_t* __restrict__ out, int64_t ldo, int64_t cols,
                    handel::LabParams prm) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j < cols)
    handel::lab_mont_column<N16, kForm>(a, lda, b, ldb, out, ldo, j, prm);
}

template <int N16, int kForm, int kThreads>
int launch(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb,
           int32_t* out, int64_t ldo, int64_t cols,
           const handel::LabParams& prm, cudaStream_t s) {
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  lab_mont_kernel<N16, kForm, kThreads>
      <<<grid, kThreads, 0, s>>>(a, lda, b, ldb, out, ldo, cols, prm);
  return (int)cudaGetLastError();
}

template <int N16, int kForm>
int launch_threads(int threads, const int32_t* a, int64_t lda,
                   const int32_t* b, int64_t ldb, int32_t* out, int64_t ldo,
                   int64_t cols, const handel::LabParams& prm,
                   cudaStream_t s) {
  switch (threads) {
    case 64:
      return launch<N16, kForm, 64>(a, lda, b, ldb, out, ldo, cols, prm, s);
    case 128:
      return launch<N16, kForm, 128>(a, lda, b, ldb, out, ldo, cols, prm, s);
    case 256:
      return launch<N16, kForm, 256>(a, lda, b, ldb, out, ldo, cols, prm, s);
    case 512:
      return launch<N16, kForm, 512>(a, lda, b, ldb, out, ldo, cols, prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int N16>
int launch_form(int form, int threads, const int32_t* a, int64_t lda,
                const int32_t* b, int64_t ldb, int32_t* out, int64_t ldo,
                int64_t cols, const handel::LabParams& prm, cudaStream_t s) {
  if (form == 0)
    return launch_threads<N16, 0>(threads, a, lda, b, ldb, out, ldo, cols,
                                  prm, s);
  if (form == 1)
    return launch_threads<N16, 1>(threads, a, lda, b, ldb, out, ldo, cols,
                                  prm, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (handel_tpu_torch/kernels/lab_mont.py). form 0 launches B3a
// (cios_fullwidth), 1 launches B3b (separated). Launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched); it allocates
// nothing and never synchronises, so a CUDA graph can capture it. cols == 0
// launches nothing. nlimbs16 must be 16 or 24, threads 64, 128, 256 or 512;
// p and pprime hold nlimbs16 16-bit digits each, n0 = -p^-1 mod 2^16.
extern "C" int handel_lab_mont_mul(int form, const int32_t* a, int64_t lda,
                                   const int32_t* b, int64_t ldb, int32_t* out,
                                   int64_t ldo, int64_t cols, int nlimbs16,
                                   const uint32_t* p, const uint32_t* pprime,
                                   uint32_t n0, int threads, void* stream) {
  if (cols == 0) return 0;
  if (nlimbs16 > handel::kLabMaxDigits) return (int)cudaErrorInvalidValue;
  handel::LabParams prm = {};
  for (int k = 0; k < nlimbs16; ++k) {
    prm.p[k] = p[k];
    prm.pprime[k] = pprime[k];
  }
  prm.n0 = n0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nlimbs16) {
    case 16:
      return launch_form<16>(form, threads, a, lda, b, ldb, out, ldo, cols,
                             prm, s);
    case 24:
      return launch_form<24>(form, threads, a, lda, b, ldb, out, ldo, cols,
                             prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
