// Montgomery multiplication of prime-field elements, one column per call.
//
// The arithmetic of the hand-written Hopper kernel in fp_mont.cu, kept in
// __host__ __device__ functions so that the same text builds with nvcc for
// the card and with a host C++ compiler for the CPU tests
// (tests/test_torch_fp_host.py).
//
// Function: out = a * b * R^-1 mod p with R = 2^(16 * N16), canonical
// (< p), for canonical inputs a, b < p. This is the function of the TPU
// kernel Field._mul_pallas / Field._mul_cols in handel_tpu/ops/fp.py,
// bit for bit: the boundary keeps its layout of N16 16-bit limbs per
// element, limbs-major, (N16, B) with one element per column, stored in
// int32. Inside, the column is regrouped into N16/2 32-bit words and
// multiplied by word-serial CIOS (Koc, Acar, Kaliski 1996). R does not
// change: 2^(32 * N16/2) = 2^(16 * N16), so Montgomery-form outputs are the
// reference's. Products are 32x32->64-bit (mul.wide / mad.wide on the card).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define HANDEL_HD __host__ __device__ __forceinline__
#define HANDEL_UNROLL _Pragma("unroll")
#else
#define HANDEL_HD inline
#define HANDEL_UNROLL
#endif

namespace handel {

// The largest field of the port: BLS12-381, 24 limbs of 16 bits.
constexpr int kMaxWords = 12;

struct MontParams {
  uint32_t p[kMaxWords];  // the modulus, 32-bit words, little-endian
  uint32_t n0;            // -p^-1 mod 2^32
};

// r = a * b * 2^(-32 N) mod p, canonical, for a, b < p.
// t holds the running sum in N + 2 words; after each outer step it is
// < 2p, so one conditional subtraction at the end makes it canonical.
template <int N>
HANDEL_HD void mont_mul_words(const uint32_t* a, const uint32_t* b,
                              const uint32_t* p, uint32_t n0, uint32_t* r) {
  uint32_t t[N + 2];
  HANDEL_UNROLL
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    // t += a * b[i]; each step fits 64 bits: (2^32-1)^2 + 2 (2^32-1) = 2^64-1
    uint64_t c = 0;
    HANDEL_UNROLL
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    // t = (t + m p) / 2^32, with m chosen so the low word cancels
    uint32_t m = t[0] * n0;
    s = (uint64_t)m * p[0] + t[0];
    c = s >> 32;
    HANDEL_UNROLL
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p: subtract p once when t >= p
  uint32_t d[N];
  uint64_t borrow = 0;
  HANDEL_UNROLL
  for (int j = 0; j < N; ++j) {
    uint64_t x = (uint64_t)t[j] - p[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = x >> 63;
  }
  const bool ge = (t[N] != 0) || (borrow == 0);
  HANDEL_UNROLL
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : t[j];
}

// One column j of out = mont_mul(a, b) on (N16, B) int32 limb arrays with
// row strides lda/ldb/ldo (elements); column stride 1.
template <int N16>
HANDEL_HD void mont_mul_column(const int32_t* a, int64_t lda, const int32_t* b,
                               int64_t ldb, int32_t* out, int64_t ldo,
                               int64_t j, const MontParams& prm) {
  constexpr int N = N16 / 2;
  uint32_t x[N], y[N], r[N];
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    x[k] = (uint32_t)a[(2 * k) * lda + j] |
           ((uint32_t)a[(2 * k + 1) * lda + j] << 16);
    y[k] = (uint32_t)b[(2 * k) * ldb + j] |
           ((uint32_t)b[(2 * k + 1) * ldb + j] << 16);
  }
  mont_mul_words<N>(x, y, prm.p, prm.n0, r);
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    out[(2 * k) * ldo + j] = (int32_t)(r[k] & 0xFFFFu);
    out[(2 * k + 1) * ldo + j] = (int32_t)(r[k] >> 16);
  }
}

}  // namespace handel
