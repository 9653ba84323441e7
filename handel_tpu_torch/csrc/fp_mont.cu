// Hopper kernel B1: batched Montgomery multiplication over a prime field.
//
// Replaces the TPU kernel Field._mul_pallas (pallas_call at
// handel_tpu/ops/fp.py:577, body Field._mul_cols :328-368): the one kernel
// on the verify path. Every Fp, Fp2 and Fp12 multiply of a verify launch is
// one call, stacked wide by ops/tower.py (an Fp12 multiply is one call at
// 54x the batch width).
//
// What bounds it on an H100: per element it reads 2 * N16 * 4 bytes and
// writes N16 * 4 bytes (192 B for BN254), against 2 N^2 + N 32x32->64-bit
// products for N = N16/2 words (272 int32 multiply-adds for BN254) plus
// about as many carry adds. The card does ~5 int32 operations (16.7 T/s)
// per byte of HBM (3.35 TB/s), so a wide call is bound by the bytes. The
// calls of the verify path are narrow (an Fp12 multiply at 128 lanes is
// 13,824 columns): one thread per column filled 54 of the 132 SMs and left
// each call to one thread's serial chain of 136 multiply-adds.
//
// Design: a narrow call shares each column among TPI = 2 or 4 consecutive
// lanes of a warp (fp_mont.cuh: W = N / TPI words a lane; the word of b and
// the quotient broadcast by shuffles, carries between lanes kept lazy and
// resolved once at the end by ballots). At 13,824 columns two lanes are
// 27,648 threads in 216 blocks of 128 and four 55,296 in 432, where one
// lane filled 54 SMs; each thread's chain is a half or a quarter as long.
// Products and carries are PTX carry chains (mad.lo.cc, madc.hi.cc,
// addc.cc) on 32-bit words. A wide call, which reads at the byte-bound end,
// runs one lane a column: word-serial CIOS with 64-bit products
// (mont_mul_words) in blocks of 256, which on the card beat the carry
// chains run with one lane by 4-5%. The wrapper's width rule picks the
// instance (kernels/fp_mont.py `lanes_for`, measured: PERF.md). Each limb
// row is read by a warp in whole 32-byte sectors; nothing goes through
// shared memory. The row stride is an argument, so row slices launch
// without a copy; the ragged edge is masked (every lane of a warp takes
// part in the shuffles, lanes past the edge on zeros, and only live
// columns store).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_mont.cuh"

namespace {

// threads a block: 128 for the lanes, so that an Fp12-wide call covers
// every SM; 256 for one lane a column, as wide calls run best
template <int TPI>
__host__ __device__ constexpr int threads_for() { return TPI == 1 ? 256 : 128; }

template <int N16, int TPI>
__global__ void __launch_bounds__(threads_for<TPI>())
    mont_mul_kernel(const int32_t* __restrict__ a, int64_t lda,
                    const int32_t* __restrict__ b, int64_t ldb,
                    int32_t* __restrict__ out, int64_t ldo, int64_t cols,
                    handel::MontParams prm) {
  const int64_t t = (int64_t)blockIdx.x * threads_for<TPI>() + threadIdx.x;
  if constexpr (TPI == 1) {
    if (t < cols) handel::mont_mul_column<N16>(a, lda, b, ldb, out, ldo, t, prm);
  } else {
    const int64_t j = t / TPI;
    handel::mont_mul_lanes<N16, TPI>(a, lda, b, ldb, out, ldo, j, j < cols,
                                     (int)(threadIdx.x % TPI), prm);
  }
}

template <int N16, int TPI>
int launch(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb,
           int32_t* out, int64_t ldo, int64_t cols,
           const handel::MontParams& prm, cudaStream_t s) {
  constexpr int threads = threads_for<TPI>();
  const dim3 grid((unsigned)((cols * TPI + threads - 1) / threads));
  mont_mul_kernel<N16, TPI><<<grid, threads, 0, s>>>(a, lda, b, ldb, out, ldo,
                                                     cols, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (handel_tpu_torch/kernels/fp_mont.py). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched). cols == 0 launches
// nothing. nlimbs16 must be 16 or 24; p_words holds nlimbs16/2 words; tpi
// (lanes per column) must be 1, 2 or 4.
extern "C" int handel_mont_mul(const int32_t* a, int64_t lda, const int32_t* b,
                               int64_t ldb, int32_t* out, int64_t ldo,
                               int64_t cols, int nlimbs16,
                               const uint32_t* p_words, uint32_t n0, int tpi,
                               void* stream) {
  if (cols == 0) return 0;
  handel::MontParams prm = {};
  const int words = nlimbs16 / 2;
  if (words > handel::kMaxWords) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < words; ++k) prm.p[k] = p_words[k];
  prm.n0 = n0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nlimbs16 == 16 && tpi == 4)
    return launch<16, 4>(a, lda, b, ldb, out, ldo, cols, prm, s);
  if (nlimbs16 == 24 && tpi == 4)
    return launch<24, 4>(a, lda, b, ldb, out, ldo, cols, prm, s);
  if (nlimbs16 == 16 && tpi == 2)
    return launch<16, 2>(a, lda, b, ldb, out, ldo, cols, prm, s);
  if (nlimbs16 == 24 && tpi == 2)
    return launch<24, 2>(a, lda, b, ldb, out, ldo, cols, prm, s);
  if (nlimbs16 == 16 && tpi == 1)
    return launch<16, 1>(a, lda, b, ldb, out, ldo, cols, prm, s);
  if (nlimbs16 == 24 && tpi == 1)
    return launch<24, 1>(a, lda, b, ldb, out, ldo, cols, prm, s);
  return (int)cudaErrorInvalidValue;
}
