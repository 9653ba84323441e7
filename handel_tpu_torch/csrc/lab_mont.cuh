// The two Montgomery-product formulations of the kernel lab, one column per
// call: kernels B3a (cios_fullwidth) and B3b (separated) of lab_mont.cu.
//
// Kept in __host__ __device__ functions so that the same text builds with
// nvcc for the card and with a host C++ compiler for the CPU tests
// (tests/test_torch_lab_host.py).
//
// Function of both: out = X - p if X >= p else X, where
// X = ((a b + m p) / R) mod R, R = 2^(16 N), m = -a b p^-1 mod R, on
// (N, B) int32 arrays of 16-bit digits (one element per column, limbs-major).
// For canonical inputs (a, b < p) that is the canonical Montgomery product
// a b R^-1 mod p: the function of kernel B1 (fp_mont.cu) and of the
// reference's Field._mul_cols, bit for bit. On raw 16-bit digits (values up
// to R - 1) X is still the quotient truncated mod R, exactly as the
// reference lab's two bodies (scripts/fp_kernel_lab.py cios_fullwidth_body,
// separated_body) truncate it, so the kernels match those bodies there too.
//
// Both formulations keep the reference's 16-bit digits and lazy 32-bit
// column sums: every product is 16 x 16 -> 32 bits, split into its low and
// high halves before it is added to a column, so no 64-bit product appears
// (kernel B1, by contrast, multiplies 32-bit words into 64 bits). Each sum
// is bounded below 2^32 in the comments where it is formed.

#pragma once

#include <stdint.h>

#ifndef HANDEL_HD
#ifdef __CUDACC__
#define HANDEL_HD __host__ __device__ __forceinline__
#define HANDEL_UNROLL _Pragma("unroll")
#else
#define HANDEL_HD inline
#define HANDEL_UNROLL
#endif
#endif

namespace handel {

// The largest field of the port: BLS12-381, 24 digits of 16 bits.
constexpr int kLabMaxDigits = 24;
constexpr uint32_t kDigitMask = 0xFFFFu;

struct LabParams {
  uint32_t p[kLabMaxDigits];       // the modulus, 16-bit digits
  uint32_t pprime[kLabMaxDigits];  // p' = -p^-1 mod R, 16-bit digits
  uint32_t n0;                     // -p^-1 mod 2^16
};

// r - p when r >= p, else r, for canonical 16-bit digits r < R: the
// borrow chain of the reference's Field._cond_sub_p_rows.
template <int N>
HANDEL_HD void lab_cond_sub_p(const uint32_t* r, const uint32_t* p,
                              uint32_t* out) {
  uint32_t d[N];
  int32_t borrow = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    const int32_t x = (int32_t)r[i] - (int32_t)p[i] - borrow;
    borrow = x < 0;
    d[i] = (uint32_t)(x + (borrow << 16));
  }
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) out[i] = borrow ? r[i] : d[i];
}

// Kernel B3a: CIOS with lazy column accumulation, the reference's
// cios_fullwidth_body. All n^2 digit products land in 2N + 1 lazy columns;
// then N interleaved reduction steps each pick m = t0 n0 mod 2^16 for the
// current column and add m p's halves into the columns above it; then one
// spill pass moves each high column's bits above 16 into the next column,
// one carry pass normalises, and one conditional subtract makes it
// canonical.
//
// Bounds: a column receives at most 2N halves (< 2^16 each) of the
// schoolbook products and 2N of the reduction, so it stays below
// 4N 2^16 <= 2^23 for N = 24; a carry is below 2^8.
template <int N>
HANDEL_HD void lab_cios_fullwidth(const uint32_t* a, const uint32_t* b,
                                  const LabParams& prm, uint32_t* out) {
  uint32_t c[2 * N + 1];
  HANDEL_UNROLL
  for (int k = 0; k < 2 * N + 1; ++k) c[k] = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    HANDEL_UNROLL
    for (int j = 0; j < N; ++j) {
      const uint32_t t = a[i] * b[j];  // < 2^32
      c[i + j] += t & kDigitMask;
      c[i + j + 1] += t >> 16;
    }
  }
  uint32_t carry = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    const uint32_t t0 = c[i] + carry;           // < 2^24
    const uint32_t m = (t0 * prm.n0) & kDigitMask;  // low 16 bits survive the wrap
    HANDEL_UNROLL
    for (int j = 0; j < N; ++j) {
      const uint32_t mp = m * prm.p[j];  // < 2^32
      if (j == 0)
        carry = (t0 + (mp & kDigitMask)) >> 16;  // the low 16 bits cancel
      else
        c[i + j] += mp & kDigitMask;
      c[i + j + 1] += mp >> 16;
    }
  }
  c[N] += carry;
  // spill and carry over the high half; what passes the top is dropped
  uint32_t r[N];
  uint32_t cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    const uint32_t spill = k ? (c[N + k - 1] >> 16) : 0u;
    const uint32_t t = (c[N + k] & kDigitMask) + spill + cy;  // < 2^18
    r[k] = t & kDigitMask;
    cy = t >> 16;
  }
  lab_cond_sub_p<N>(r, prm.p, out);
}

// Kernel B3b: separated Montgomery, the reference's separated_body.
// T = a b; m = (T mod R) p' mod R, a product against the constant p'
// truncated to N columns; T + m p, a product against the constant p; the
// low half is 0 mod R, so only its carry into column N is kept; the high
// half is normalised (mod R) and conditionally reduced. The reference
// splits each constant into 8-bit halves because its operands stay
// semi-normalised (< 2^17) and its 32-bit lanes would overflow; here every
// operand of a constant product is first normalised to 16-bit digits by a
// carry pass, so each product is 16 x 16 -> 32 bits like the others.
//
// Bounds: c[] receives at most 2N halves of a b and 2N of m p, < 2^23;
// mc[] at most 2N halves of tl p', < 2^22; carries are below 2^8.
template <int N>
HANDEL_HD void lab_separated(const uint32_t* a, const uint32_t* b,
                             const LabParams& prm, uint32_t* out) {
  uint32_t c[2 * N];
  HANDEL_UNROLL
  for (int k = 0; k < 2 * N; ++k) c[k] = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    HANDEL_UNROLL
    for (int j = 0; j < N; ++j) {
      const uint32_t t = a[i] * b[j];
      c[i + j] += t & kDigitMask;
      c[i + j + 1] += t >> 16;
    }
  }
  // T mod R as 16-bit digits
  uint32_t tl[N];
  uint32_t cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    const uint32_t t = c[k] + cy;
    tl[k] = t & kDigitMask;
    cy = t >> 16;
  }
  // m = tl p' mod R: only the columns below N
  uint32_t mc[N];
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) mc[k] = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    HANDEL_UNROLL
    for (int j = 0; i + j < N; ++j) {
      const uint32_t t = tl[i] * prm.pprime[j];
      mc[i + j] += t & kDigitMask;
      if (i + j + 1 < N) mc[i + j + 1] += t >> 16;
    }
  }
  uint32_t m[N];
  cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    const uint32_t t = mc[k] + cy;
    m[k] = t & kDigitMask;
    cy = t >> 16;
  }
  // T + m p
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    HANDEL_UNROLL
    for (int j = 0; j < N; ++j) {
      const uint32_t t = m[i] * prm.p[j];
      c[i + j] += t & kDigitMask;
      c[i + j + 1] += t >> 16;
    }
  }
  // the low half's digits are all 0: keep its carry into column N
  cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) cy = (c[k] + cy) >> 16;
  // the high half mod R
  uint32_t h[N];
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    const uint32_t t = c[N + k] + cy;
    h[k] = t & kDigitMask;
    cy = t >> 16;
  }
  lab_cond_sub_p<N>(h, prm.p, out);
}

// One column j of a formulation on (N, B) int32 digit arrays with row
// strides lda/ldb/ldo (elements); column stride 1. kForm 0 is B3a, 1 B3b.
template <int N, int kForm>
HANDEL_HD void lab_mont_column(const int32_t* a, int64_t lda, const int32_t* b,
                               int64_t ldb, int32_t* out, int64_t ldo,
                               int64_t j, const LabParams& prm) {
  uint32_t x[N], y[N], r[N];
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    x[k] = (uint32_t)a[k * lda + j];
    y[k] = (uint32_t)b[k * ldb + j];
  }
  if (kForm == 0)
    lab_cios_fullwidth<N>(x, y, prm, r);
  else
    lab_separated<N>(x, y, prm, r);
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) out[k * ldo + j] = (int32_t)r[k];
}

}  // namespace handel
