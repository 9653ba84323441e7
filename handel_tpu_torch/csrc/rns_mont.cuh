// Resident RNS Montgomery multiplication, one column per call.
//
// The arithmetic of the hand-written Hopper kernel in rns_mont.cu, kept in
// __host__ __device__ functions so that the same text builds with nvcc for
// the card and with a host C++ compiler for the CPU tests
// (tests/test_torch_rns_host.py).
//
// Function: the joint residues of a * b * M^-1 for joint-residue operands a,
// b, exactly as RnsField._mul_resident_core in handel_tpu/ops/rns.py (the
// body of the TPU kernel RnsField._mul_resident_pallas) and its port's plain
// version in handel_tpu_torch/ops/rns.py. A column holds K = KA + KB + 1
// residues, each < its modulus m_i < 2^13: base A rows, base B rows, then the
// redundant row m_r. Steps, each reduced to a canonical residue:
//   1. d_i   = a_i b_i                                   mod m_i (all rows)
//   2. xi_i  = d_i c1_i                                  mod m_i (base A)
//   3. Q_j   = sum_i E[j, i] xi_i                        mod m_j (B and m_r)
//   4. r_j   = (d_j + Q_j (p mod m_j)) M^-1              mod m_j
//   5. xi'_j = r_j c2_j                                  mod m_j (base B)
//   6. alpha = ((sum_j xi'_j L_mr_j) - r_mr) MB^-1       mod m_r
//   7. out_i = sum_j E2[i, j] xi'_j - alpha (MB mod m_i) mod m_i (base A)
// and the output column is [out ; r]. Every residue the steps produce is the
// canonical residue of an integer the algorithm fixes, so any exact reduction
// gives the reference's bits. Every product is < 2^26 and every sum of at
// most 34 such products is < 2^32, so uint32 arithmetic is exact throughout.

#pragma once

#include <stdint.h>

#ifndef __CUDA_ARCH__
#include <cstring>
#endif

#ifdef __CUDACC__
#define HANDEL_HD __host__ __device__ __forceinline__
#define HANDEL_UNROLL _Pragma("unroll")
#else
#define HANDEL_HD inline
#define HANDEL_UNROLL
#endif

namespace handel {

// Offsets (in int32 words) of the constant table of one field, built by
// handel_tpu_torch/kernels/rns_mont.py `pack_constants` in the same order.
template <int KA, int KB>
struct RnsLayout {
  static constexpr int K = KA + KB + 1;  // joint base A ++ B ++ [m_r]
  static constexpr int KB1 = KB + 1;     // base B ++ [m_r]
  static constexpr int m = 0;                     // K moduli
  static constexpr int minv = m + K;              // K floats 1/m_i, as bits
  static constexpr int c1 = minv + K;             // KA
  static constexpr int E = c1 + KA;               // KB1 x KA, row-major
  static constexpr int pB = E + KB1 * KA;         // KB1: p mod m_j
  static constexpr int MinvB = pB + KB1;          // KB1: M^-1 mod m_j
  static constexpr int c2 = MinvB + KB1;          // KB
  static constexpr int Lmr = c2 + KB;             // KB: (MB/m_j) mod m_r
  static constexpr int E2 = Lmr + KB;             // KA x KB, row-major
  static constexpr int MBA = E2 + KA * KB;        // KA: MB mod m_i
  static constexpr int MBinvr = MBA + KA;         // 1: MB^-1 mod m_r
  static constexpr int size = MBinvr + 1;
};

HANDEL_HD float rns_as_float(int32_t x) {
#ifdef __CUDA_ARCH__
  return __int_as_float(x);
#else
  float f;
  std::memcpy(&f, &x, sizeof f);
  return f;
#endif
}

// v mod m, canonical, for any uint32 v and 2 < m < 2^13. The quotient
// estimate trunc(f32(v) * f32(1/m)) is within one of floor(v/m): the
// relative error is below 3 * 2^-24 on a quotient below 2^20, under 0.2.
// v - q m then lies in [-m, 2m), which int32 holds exactly even where the
// uint32 product q m wraps, and one step each way makes it canonical.
HANDEL_HD uint32_t rns_mod(uint32_t v, uint32_t m, float minv) {
  const uint32_t q = (uint32_t)((float)v * minv);
  int32_t r = (int32_t)(v - q * m);
  if (r < 0) r += (int32_t)m;
  if (r >= (int32_t)m) r -= (int32_t)m;
  return (uint32_t)r;
}

// One column j of out = a * b * M^-1 in joint residues, on (K, B) int32
// arrays with row strides lda/ldb/ldo (elements) and column stride 1. `c`
// is the field's constant table (RnsLayout<KA, KB>).
template <int KA, int KB>
HANDEL_HD void rns_mul_resident_column(const int32_t* a, int64_t lda,
                                       const int32_t* b, int64_t ldb,
                                       int32_t* out, int64_t ldo, int64_t j,
                                       const int32_t* c) {
  using L = RnsLayout<KA, KB>;
  constexpr int K = L::K;
  constexpr int KB1 = L::KB1;
  const uint32_t* u = reinterpret_cast<const uint32_t*>(c);
  // 1. residue-wise product, every row
  uint32_t d[K];
  HANDEL_UNROLL
  for (int i = 0; i < K; ++i) {
    const uint32_t x = (uint32_t)a[i * lda + j] * (uint32_t)b[i * ldb + j];
    d[i] = rns_mod(x, u[L::m + i], rns_as_float(c[L::minv + i]));
  }
  // 2. folded Montgomery quotient digits in base A
  uint32_t xi[KA];
  HANDEL_UNROLL
  for (int i = 0; i < KA; ++i)
    xi[i] = rns_mod(d[i] * u[L::c1 + i], u[L::m + i], rns_as_float(c[L::minv + i]));
  // 3-4. extension A -> B ++ [m_r], then r = (T + q p) / M residue-wise
  uint32_t r[KB1];
  HANDEL_UNROLL
  for (int jj = 0; jj < KB1; ++jj) {
    const int row = KA + jj;
    const uint32_t mj = u[L::m + row];
    const float mjinv = rns_as_float(c[L::minv + row]);
    uint32_t s = 0;
    HANDEL_UNROLL
    for (int i = 0; i < KA; ++i) s += u[L::E + jj * KA + i] * xi[i];
    const uint32_t q = rns_mod(s, mj, mjinv);
    const uint32_t qp = rns_mod(q * u[L::pB + jj], mj, mjinv);
    r[jj] = rns_mod((d[row] + qp) * u[L::MinvB + jj], mj, mjinv);
  }
  // 5-6. Shenoy digits over base B and the exact CRT offset through m_r
  const uint32_t mr = u[L::m + K - 1];
  const float mrinv = rns_as_float(c[L::minv + K - 1]);
  uint32_t xp[KB];
  uint32_t sr = 0;
  HANDEL_UNROLL
  for (int jj = 0; jj < KB; ++jj) {
    const int row = KA + jj;
    xp[jj] = rns_mod(r[jj] * u[L::c2 + jj], u[L::m + row], rns_as_float(c[L::minv + row]));
    sr += rns_mod(xp[jj] * u[L::Lmr + jj], mr, mrinv);
  }
  sr = rns_mod(sr, mr, mrinv);
  const uint32_t alpha = rns_mod((sr + mr - r[KB]) * u[L::MBinvr], mr, mrinv);
  // 7. exact extension B -> A
  HANDEL_UNROLL
  for (int i = 0; i < KA; ++i) {
    const uint32_t mi = u[L::m + i];
    const float miinv = rns_as_float(c[L::minv + i]);
    uint32_t s = 0;
    HANDEL_UNROLL
    for (int jj = 0; jj < KB; ++jj) s += u[L::E2 + i * KB + jj] * xp[jj];
    const uint32_t ra = rns_mod(s, mi, miinv);
    const uint32_t corr = rns_mod(alpha * u[L::MBA + i], mi, miinv);
    out[i * ldo + j] = (int32_t)rns_mod(ra + mi - corr, mi, miinv);
  }
  HANDEL_UNROLL
  for (int jj = 0; jj < KB1; ++jj) out[(KA + jj) * ldo + j] = (int32_t)r[jj];
}

}  // namespace handel
