// Montgomery multiplication of prime-field elements, one column shared by
// TPI lanes.
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
// int32. Inside, the column is regrouped into N = N16/2 32-bit words and
// multiplied by word-serial CIOS (Koc, Acar, Kaliski 1996). R does not
// change: 2^(32 * N16/2) = 2^(16 * N16), so Montgomery-form outputs are the
// reference's.
//
// Several lanes per column (the cooperative scheme of NVlabs' CGBN, as a
// design): TPI lanes each hold W = N / TPI consecutive words of a, b, p and
// of the running sum t. Each CIOS step broadcasts the word b[i] from the
// lane that holds it, adds a * b[i] into every lane's words, broadcasts the
// quotient m = t[0] n0 from lane 0, adds m p, and shifts t down one word:
// each lane takes its upper neighbour's lowest word. Carries between lanes
// stay lazy: a lane keeps what passes its top word in a two-word spill at
// the weight of its neighbour's word 0, moved down with the shift. Only at
// the end are the spills added into the next lane and the carries resolved
// across lanes at once from two ballots (generate, propagate), as in a
// carry-lookahead adder; the conditional subtraction of p resolves its
// borrows the same way.
//
// The pieces that differ between the card and the host, each with a host
// twin that computes the same bits:
//   Chain        32-bit multiply-add and add with a carry flag: PTX
//                mad.lo.cc / madc.hi.cc / addc.cc / sub.cc on the card,
//                uint64 arithmetic on the host;
//   the lanes    __shfl_sync and __ballot_sync in mont_mul_lanes on the
//                card, a loop over the TPI lanes in mont_mul_column_lanes
//                on the host.

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

// A chain of 32-bit additions that threads one carry (or borrow) flag from
// each operation to the next. Every call sets the flag; the first call of a
// chain ignores it. On the card each call is one PTX instruction with .cc,
// and the chain's calls must follow each other with nothing between them
// that writes the flag (nothing the compiler emits for this code does).
struct Chain {
#ifdef __CUDA_ARCH__
  bool live = false;  // known at compile time once the loops are unrolled
#else
  uint32_t cf = 0;
#endif

  // lo(a * b) + c + flag
  HANDEL_HD uint32_t madlo(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    if (live)
      asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    else
      asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    live = true;
    return r;
#else
    const uint64_t s = (uint64_t)(uint32_t)(a * b) + c + cf;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
  }

  // hi(a * b) + c + flag
  HANDEL_HD uint32_t madhi(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    if (live)
      asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    else
      asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    live = true;
    return r;
#else
    const uint64_t s = (((uint64_t)a * b) >> 32) + c + cf;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
  }

  // a + b + flag
  HANDEL_HD uint32_t add(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    if (live)
      asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    else
      asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    live = true;
    return r;
#else
    const uint64_t s = (uint64_t)a + b + cf;
    cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
  }

  // the carry flag as 0 or 1
  HANDEL_HD uint32_t carry() {
#ifdef __CUDA_ARCH__
    if (!live) return 0;
    uint32_t r;
    asm volatile("addc.u32 %0, 0, 0;" : "=r"(r));
    return r;
#else
    return cf;
#endif
  }

  // a - b - flag (the flag is a borrow)
  HANDEL_HD uint32_t sub(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    uint32_t r;
    if (live)
      asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    else
      asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    live = true;
    return r;
#else
    const uint64_t s = (uint64_t)a - b - cf;
    cf = (uint32_t)(s >> 63);
    return (uint32_t)s;
#endif
  }

  // the borrow flag as 0 or 1
  HANDEL_HD uint32_t borrow() {
#ifdef __CUDA_ARCH__
    if (!live) return 0;
    uint32_t r;
    asm volatile("subc.u32 %0, 0, 0;" : "=r"(r));
    return r & 1u;
#else
    return cf;
#endif
  }
};

// One lane a column (TPI = 1, the width rule's choice for wide calls): r =
// a * b * 2^(-32 N) mod p, canonical, for a, b < p, by word-serial CIOS
// with 64-bit products. t holds the running sum in N + 2 words; after each
// outer step it is < 2p, so one conditional subtraction makes it canonical.
// On the card this form, whose products compile to wide multiply-adds, ran
// 4-5% faster at 2^20 columns and above than the lanes' carry chains run
// with one lane (PERF.md, PR 4).
template <int N>
HANDEL_HD void mont_mul_words(const uint32_t* a, const uint32_t* b, const uint32_t* p,
                              uint32_t n0, uint32_t* r) {
  uint32_t t[N + 2];
  HANDEL_UNROLL
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    // t += a * b[i]; each step fits 64 bits: (2^32-1)^2 + 2 (2^32-1) = 2^64-1
    uint64_t c = 0;
    HANDEL_UNROLL
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    // t = (t + m p) / 2^32, with m chosen so the low word cancels
    const uint32_t m = t[0] * n0;
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
  uint32_t d[N];
  uint64_t borrow = 0;
  HANDEL_UNROLL
  for (int j = 0; j < N; ++j) {
    const uint64_t x = (uint64_t)t[j] - p[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = x >> 63;
  }
  const bool ge = (t[N] != 0) || (borrow == 0);
  HANDEL_UNROLL
  for (int j = 0; j < N; ++j) r[j] = ge ? d[j] : t[j];
}

// One lane's share of the running CIOS sum: W words, then a two-word spill
// (s0 + 2^32 s1) at the weight of the next lane's word 0. The column's sum
// is the lanes' words and spills added at their weights.
//
// Bounds: a shift leaves s1 = 0 and s0 <= 3, so a lane's value is below
// 4 * 2^(32W); one step adds two products below 2^(32W) * 2^32, so the
// spill stays below 2^33 + 4: s1 <= 2, never wraps.
template <int W>
struct LaneSum {
  uint32_t t[W];
  uint32_t s0, s1;
};

// sum += x * y for the lane's W words x and one word y: the low halves of
// the products in one chain, the high halves one word up in a second.
template <int W>
HANDEL_HD void lane_mad(LaneSum<W>& s, const uint32_t* x, uint32_t y) {
  Chain lo;
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) s.t[w] = lo.madlo(x[w], y, s.t[w]);
  s.s0 = lo.add(s.s0, 0);
  s.s1 = lo.add(s.s1, 0);
  Chain hi;
  HANDEL_UNROLL
  for (int w = 0; w + 1 < W; ++w) s.t[w + 1] = hi.madhi(x[w], y, s.t[w + 1]);
  s.s0 = hi.madhi(x[W - 1], y, s.s0);
  s.s1 = hi.add(s.s1, 0);
}

// sum /= 2^32: every word moves down one place; the lane's top word takes
// its spill plus `next`, the upper neighbour's word 0 (0 for the top lane).
// Lane 0's word 0 is 0 here (m cancelled it) and is dropped.
template <int W>
HANDEL_HD void lane_shift(LaneSum<W>& s, uint32_t next) {
  HANDEL_UNROLL
  for (int w = 0; w + 1 < W; ++w) s.t[w] = s.t[w + 1];
  Chain c;
  s.t[W - 1] = c.add(s.s0, next);
  s.s0 = c.add(s.s1, 0);
  s.s1 = 0;
}

// words += v (a small value); returns the carry out, and in `ones` whether
// every word is now 2^32 - 1 (a carry into the lane would pass through).
template <int W>
HANDEL_HD uint32_t lane_add_small(uint32_t* t, uint32_t v, bool& ones) {
  Chain c;
  t[0] = c.add(t[0], v);
  HANDEL_UNROLL
  for (int w = 1; w < W; ++w) t[w] = c.add(t[w], 0);
  const uint32_t g = c.carry();
  ones = true;
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) ones = ones && (t[w] == 0xFFFFFFFFu);
  return g;
}

// d = t - q; returns the borrow out, and in `zero` whether d is 0 (a borrow
// into the lane would pass through).
template <int W>
HANDEL_HD uint32_t lane_sub(const uint32_t* t, const uint32_t* q, uint32_t* d, bool& zero) {
  Chain c;
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) d[w] = c.sub(t[w], q[w]);
  const uint32_t b = c.borrow();
  zero = true;
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) zero = zero && (d[w] == 0);
  return b;
}

// d -= v for v in {0, 1}; a borrow out of the lane is already counted by
// lane_carry_in.
template <int W>
HANDEL_HD void lane_sub_bit(uint32_t* d, uint32_t v) {
  Chain c;
  d[0] = c.sub(d[0], v);
  HANDEL_UNROLL
  for (int w = 1; w < W; ++w) d[w] = c.sub(d[w], 0);
}

// Carry lookahead across lanes: bit l of g (p) says lane l generates (passes
// on) a carry. Returns the carries: bit l is the carry into lane l, bit TPI
// the carry past the top. (g + (g|p)) is the adder's sum; xor with both
// addends leaves the carry vector.
HANDEL_HD uint32_t lane_carry_in(uint32_t g, uint32_t p) {
  const uint32_t b = g | p;
  return ((g + b) ^ g ^ b);
}

// The lane's W words of a column: words lane*W .. lane*W + W - 1 of the
// (N16, B) int32 limb array x at column j (two 16-bit limbs a word).
template <int W>
HANDEL_HD void load_lane_words(const int32_t* x, int64_t ld, int64_t j, int lane,
                               uint32_t* out) {
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) {
    const int k = lane * W + w;
    out[w] = (uint32_t)x[(2 * k) * ld + j] | ((uint32_t)x[(2 * k + 1) * ld + j] << 16);
  }
}

template <int W>
HANDEL_HD void store_lane_words(int32_t* x, int64_t ld, int64_t j, int lane,
                                const uint32_t* r) {
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) {
    const int k = lane * W + w;
    x[(2 * k) * ld + j] = (int32_t)(r[w] & 0xFFFFu);
    x[(2 * k + 1) * ld + j] = (int32_t)(r[w] >> 16);
  }
}

// Column j of out = mont_mul(a, b) with one lane (mont_mul_words), on
// (N16, B) int32 limb arrays with row strides lda/ldb/ldo; the same text
// on the card and the host.
template <int N16>
HANDEL_HD void mont_mul_column(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb,
                               int32_t* out, int64_t ldo, int64_t j, const MontParams& prm) {
  constexpr int N = N16 / 2;
  uint32_t x[N], y[N], r[N];
  load_lane_words<N>(a, lda, j, 0, x);
  load_lane_words<N>(b, ldb, j, 0, y);
  mont_mul_words<N>(x, y, prm.p, prm.n0, r);
  store_lane_words<N>(out, ldo, j, 0, r);
}

// Host twin of the card's lanes: column j of out = mont_mul(a, b) on (N16, B)
// int32 limb arrays with row strides lda/ldb/ldo, the TPI lanes stepped one
// after another at each exchange, every exchange reading the values all
// lanes held before it.
template <int N16, int TPI>
inline void mont_mul_column_lanes(const int32_t* a, int64_t lda, const int32_t* b,
                                  int64_t ldb, int32_t* out, int64_t ldo, int64_t j,
                                  const MontParams& prm) {
  constexpr int N = N16 / 2;
  constexpr int W = N / TPI;
  static_assert(W * TPI == N, "TPI must divide the word count");
  uint32_t x[TPI][W], y[TPI][W], p[TPI][W];
  LaneSum<W> s[TPI] = {};
  for (int l = 0; l < TPI; ++l) {
    load_lane_words<W>(a, lda, j, l, x[l]);
    load_lane_words<W>(b, ldb, j, l, y[l]);
    for (int w = 0; w < W; ++w) p[l][w] = prm.p[l * W + w];
  }
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = y[i / W][i % W];                   // broadcast
    for (int l = 0; l < TPI; ++l) lane_mad<W>(s[l], x[l], bi);
    const uint32_t m = s[0].t[0] * prm.n0;                 // broadcast
    for (int l = 0; l < TPI; ++l) lane_mad<W>(s[l], p[l], m);
    uint32_t next[TPI];                                    // shuffle down
    for (int l = 0; l < TPI; ++l) next[l] = l + 1 < TPI ? s[l + 1].t[0] : 0;
    for (int l = 0; l < TPI; ++l) lane_shift<W>(s[l], next[l]);
  }
  // spills into the next lane, carries resolved by lookahead
  uint32_t cin[TPI];                                       // shuffle up
  for (int l = 0; l < TPI; ++l) cin[l] = l > 0 ? s[l - 1].s0 : 0;
  uint32_t top = s[TPI - 1].s0;
  uint32_t g = 0, pr = 0;                                  // ballots
  for (int l = 0; l < TPI; ++l) {
    bool ones;
    g |= lane_add_small<W>(s[l].t, cin[l], ones) << l;
    pr |= (uint32_t)ones << l;
  }
  const uint32_t c = lane_carry_in(g, pr);
  for (int l = 0; l < TPI; ++l) {
    bool ones;
    lane_add_small<W>(s[l].t, (c >> l) & 1u, ones);
  }
  top += (c >> TPI) & 1u;
  // t < 2p: subtract p once when t >= p
  uint32_t d[TPI][W];
  uint32_t bg = 0, bp = 0;
  for (int l = 0; l < TPI; ++l) {
    bool zero;
    bg |= lane_sub<W>(s[l].t, p[l], d[l], zero) << l;
    bp |= (uint32_t)zero << l;
  }
  const uint32_t bc = lane_carry_in(bg, bp);
  const bool ge = top != 0 || ((bc >> TPI) & 1u) == 0;
  for (int l = 0; l < TPI; ++l) {
    lane_sub_bit<W>(d[l], (bc >> l) & 1u);
    store_lane_words<W>(out, ldo, j, l, ge ? d[l] : s[l].t);
  }
}

#ifdef __CUDACC__
// The card's form of mont_mul_column_lanes: this thread is lane `lane` of
// the TPI consecutive lanes of its warp that share column j. Every thread
// of the warp must call it (the shuffles and ballots take the whole warp);
// a thread whose column lies past the edge (live false) computes on zeros
// and stores nothing.
template <int N16, int TPI>
__device__ __forceinline__ void mont_mul_lanes(const int32_t* __restrict__ a, int64_t lda,
                                               const int32_t* __restrict__ b, int64_t ldb,
                                               int32_t* __restrict__ out, int64_t ldo,
                                               int64_t j, bool live, int lane,
                                               const MontParams& prm) {
  constexpr int N = N16 / 2;
  constexpr int W = N / TPI;
  static_assert(W * TPI == N && TPI > 1 && TPI < 32, "TPI must divide the word count");
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int base = (threadIdx.x & 31) & ~(TPI - 1);
  uint32_t x[W], y[W], p[W];
  if (live) {
    load_lane_words<W>(a, lda, j, lane, x);
    load_lane_words<W>(b, ldb, j, lane, y);
  } else {
    HANDEL_UNROLL
    for (int w = 0; w < W; ++w) x[w] = y[w] = 0;
  }
  // p's words for this lane, by constant indices (a dynamic index into the
  // parameter block would copy it to local memory)
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) {
    p[w] = prm.p[w];
    HANDEL_UNROLL
    for (int l = 1; l < TPI; ++l)
      if (lane == l) p[w] = prm.p[l * W + w];
  }
  LaneSum<W> s;
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) s.t[w] = 0;
  s.s0 = s.s1 = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = __shfl_sync(kAll, y[i % W], i / W, TPI);
    lane_mad<W>(s, x, bi);
    const uint32_t m = __shfl_sync(kAll, s.t[0], 0, TPI) * prm.n0;
    lane_mad<W>(s, p, m);
    uint32_t next = __shfl_down_sync(kAll, s.t[0], 1, TPI);
    if (lane == TPI - 1) next = 0;
    lane_shift<W>(s, next);
  }
  // the spills into the next lane, carries resolved by lookahead
  uint32_t cin = __shfl_up_sync(kAll, s.s0, 1, TPI);
  if (lane == 0) cin = 0;
  uint32_t top = __shfl_sync(kAll, s.s0, TPI - 1, TPI);
  constexpr uint32_t mask = (1u << TPI) - 1u;
  bool ones;
  const uint32_t g = lane_add_small<W>(s.t, cin, ones);
  const uint32_t c = lane_carry_in((__ballot_sync(kAll, g != 0) >> base) & mask,
                                   (__ballot_sync(kAll, ones) >> base) & mask);
  lane_add_small<W>(s.t, (c >> lane) & 1u, ones);
  top += (c >> TPI) & 1u;
  // t < 2p: less p when t >= p, its borrows resolved the same way
  uint32_t d[W];
  bool zero;
  const uint32_t bo = lane_sub<W>(s.t, p, d, zero);
  const uint32_t bc = lane_carry_in((__ballot_sync(kAll, bo != 0) >> base) & mask,
                                    (__ballot_sync(kAll, zero) >> base) & mask);
  lane_sub_bit<W>(d, (bc >> lane) & 1u);
  const bool ge = top != 0 || ((bc >> TPI) & 1u) == 0;
  if (live) {
    HANDEL_UNROLL
    for (int w = 0; w < W; ++w) d[w] = ge ? d[w] : s.t[w];
    store_lane_words<W>(out, ldo, j, lane, d);
  }
}
#endif  // __CUDACC__

}  // namespace handel
