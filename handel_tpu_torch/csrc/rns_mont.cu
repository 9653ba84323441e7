// Hopper kernel B2: resident RNS Montgomery multiplication.
//
// Replaces the TPU kernel RnsField._mul_resident_pallas (pallas_call at
// handel_tpu/ops/rns.py:571, body RnsField._mul_resident_core :518-530):
// every product of the residue-resident pairing of the rns field backend.
// Each stacked tower multiply (an Fp12 multiply is 54x the batch wide) is
// one call.
//
// What bounds it on an H100: per column it reads 2 K and writes K int32
// residues (552 bytes for BN254, K = 46; 780 for BLS12-381, K = 65) and does
// about 1,200 (BN254) or 2,300 (BLS12-381) integer multiply-adds, most of
// them the two constant-matrix contractions, plus about 250 or 350 modular
// reductions. At about five int32 operations per byte the card can afford
// (16.7 T/s over 3.35 TB/s), a wide call sits near the line between the two
// bounds; a narrow one (13,824 columns for an Fp12 multiply at 128 lanes) is
// bound by the launch.
//
// Design: one thread per column, so each residue row is read and written by
// a warp as 32 neighbouring words (coalesced). The field's constant table
// (moduli, reciprocals, the extension matrices E and E2, ~5 KB for BN254,
// ~9.6 KB for BLS12-381) is staged into shared memory once per block; all
// threads of a warp read the same entry at the same step, a broadcast. The
// residues live in registers: the template on the base sizes fixes every
// loop bound, so the arrays are fully unrolled. Reductions use a float
// quotient estimate with an exact integer correction. The TPU kernel's
// 7-bit-plane int8 matrix products were shaped for the MXU; here the
// contractions are int32 multiply-adds, and a tensor-core form is later
// work. The row stride is an argument, so column slices launch without a
// copy; the ragged edge is masked by a bounds check.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_mont.cuh"

namespace {

constexpr int kThreads = 128;

template <int KA, int KB>
__global__ void __launch_bounds__(kThreads)
    rns_mul_resident_kernel(const int32_t* __restrict__ a, int64_t lda,
                            const int32_t* __restrict__ b, int64_t ldb,
                            int32_t* __restrict__ out, int64_t ldo,
                            int64_t cols, const int32_t* __restrict__ consts) {
  using L = handel::RnsLayout<KA, KB>;
  __shared__ int32_t sc[L::size];
  for (int t = threadIdx.x; t < L::size; t += kThreads) sc[t] = consts[t];
  __syncthreads();
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j < cols)
    handel::rns_mul_resident_column<KA, KB>(a, lda, b, ldb, out, ldo, j, sc);
}

template <int KA, int KB>
int launch(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb,
           int32_t* out, int64_t ldo, int64_t cols, const int32_t* consts,
           cudaStream_t s) {
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  rns_mul_resident_kernel<KA, KB>
      <<<grid, kThreads, 0, s>>>(a, lda, b, ldb, out, ldo, cols, consts);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (handel_tpu_torch/kernels/rns_mont.py). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched). cols == 0 launches
// nothing. (kA, kB) must be (24, 21) (BN254) or (34, 30) (BLS12-381);
// `consts` is the field's device constant table (handel::RnsLayout).
extern "C" int handel_rns_mul_resident(const int32_t* a, int64_t lda,
                                       const int32_t* b, int64_t ldb,
                                       int32_t* out, int64_t ldo, int64_t cols,
                                       int ka, int kb, const int32_t* consts,
                                       void* stream) {
  if (cols == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (ka == 24 && kb == 21)
    return launch<24, 21>(a, lda, b, ldb, out, ldo, cols, consts, s);
  if (ka == 34 && kb == 30)
    return launch<34, 30>(a, lda, b, ldb, out, ldo, cols, consts, s);
  return (int)cudaErrorInvalidValue;
}
