// The two Montgomery-product formulations of the kernel lab: kernels B3a
// (cios_fullwidth) and B3b (separated) of lab_mont.cu.
//
// Kept in __host__ __device__ functions so that the same text builds with
// nvcc for the card and with a host C++ compiler for the CPU tests
// (tests/test_torch_lab_host.py). Every intrinsic the card runs (__dp4a,
// __byte_perm, __funnelshift_r, and the tensor cores' mma.sync through
// mma_u8_host) has a host twin here, a plain loop giving the same bits.
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
// Every step below is exact, so any order of the same sums gives those bits.
//
// Digit products are issued on bytes. The bytes of a 16-bit digit d are
// d & 0xFF and d >> 8; byte x of an N-digit number sits at "byte position"
// x, weight 2^(8 x). A product's byte-position sums
//   s[q] = sum over i + j = q of A_i B_j
// have at most 2N terms below 255^2, so each stays below 2N 255^2 < 2^22
// (N <= 24), and two neighbours fold into one lazy 16-bit column
// c[k] = s[2k] + (s[2k + 1] << 8) < 2^22 257 < 2^30.
//   * a b (both kernels): one __dp4a adds four byte products to a position:
//     a's bytes 4w .. 4w + 3 against b's bytes q - 4w .. q - 4w - 3, a
//     byte-reversed window of b cut from two words of b's reversed bytes by
//     one funnel shift, shared by every w at the same q - 4w. (2N)^2 / 4 =
//     N^2 dp4a, against N^2 16 x 16 products of a multiply, a mask, a shift
//     and two adds each.
//   * B3b's two products against constants, tl p' mod R and m p, run on the
//     int8 tensor cores (lab_separated_warp_host, and sep_product in
//     lab_mont.cu): a warp owns 32 columns; each product is a fixed
//     Toeplitz byte matrix of the constant (rows: output byte positions;
//     depth: the operand's 2N bytes, padded to 32 or 64) times the warp's
//     byte planes (8 columns an n-tile), in mma.sync m16n8k32 u8 x u8 -> s32
//     fragments. Rows are permuted so that a lane's C rows g and g + 8 are
//     positions 2r and 2r + 1 of one 16-bit column r, folded at once.
//   * B3a's interleaved reduction picks m_i one 16-bit column at a time, but
//     adds two steps' m_i p at once: one __dp4a a byte position multiplies
//     the four bytes of m_i and m_(i+1) by a window of p's bytes, about 2N
//     + 6 instructions of the multiply pipe a pair of steps where one
//     multiply-add (or __dp2a_lo) a position and step would take 4N. Its
//     serial dependence on m_i keeps it off the tensor cores: m_(i+1)
//     needs column i + 1 after m_i p is added.

#pragma once

#include <stdint.h>

#ifndef __CUDA_ARCH__
#include <cstring>
#include <vector>
#endif

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
  uint32_t p[kLabMaxDigits];  // the modulus, 16-bit digits
  // B3a's reduction windows of p's bytes pb: pw[e] = pb[e], pb[e-1],
  // pb[e-2], pb[e-3] (byte 0 first; 0 outside 0 <= x < 2N) for
  // 5 <= e <= 2N + 2, and pw[4] = pb[4], 0, pb[2], 0; and pb[2], pb[3]
  uint32_t pw[2 * kLabMaxDigits + 3];
  uint32_t pb2, pb3;
  uint32_t n0;  // -p^-1 mod 2^16
};

// The kernels' parameters from p's digits.
inline LabParams lab_params(int nlimbs16, const uint32_t* p, uint32_t n0) {
  LabParams prm = {};
  uint32_t pb[2 * kLabMaxDigits + 3] = {};
  for (int k = 0; k < nlimbs16; ++k) {
    prm.p[k] = p[k];
    pb[2 * k] = p[k] & 0xFFu;
    pb[2 * k + 1] = (p[k] >> 8) & 0xFFu;
  }
  auto at = [&](int x) { return x >= 0 && x < 2 * nlimbs16 ? pb[x] : 0u; };
  for (int e = 5; e <= 2 * nlimbs16 + 2; ++e)
    prm.pw[e] = at(e) | at(e - 1) << 8 | at(e - 2) << 16 | at(e - 3) << 24;
  prm.pw[4] = at(4) | at(2) << 16;
  prm.pb2 = at(2);
  prm.pb3 = at(3);
  prm.n0 = n0;
  return prm;
}

// ---- the card's integer intrinsics, with their host twins ----------------

// c + the sum of the four byte products of x and y (unsigned): __dp4a
HANDEL_HD uint32_t dp4a(uint32_t x, uint32_t y, uint32_t c) {
#ifdef __CUDA_ARCH__
  return __dp4a(x, y, c);
#else
  for (int k = 0; k < 4; ++k) c += ((x >> (8 * k)) & 0xFFu) * ((y >> (8 * k)) & 0xFFu);
  return c;
#endif
}

// Byte k of the result is byte (s >> 4k) & 7 of y:x (selectors 0 to 7 only)
HANDEL_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= (uint32_t)((v >> (8 * ((s >> (4 * k)) & 7u))) & 0xFFu) << (8 * k);
  return r;
#endif
}

// The low word of hi:lo shifted right by n (0 < n < 32)
HANDEL_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, n);
#else
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> n);
#endif
}

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

// ---- a b on bytes: __dp4a ------------------------------------------------

// The word of b's bytes B_d, B_(d-1), B_(d-2), B_(d-3) (byte 0 first; B_x = 0
// outside 0 <= x < 2N), 0 <= d <= 2N + 2, from rb[u], the bytes
// B_(4u+3) .. B_(4u) of b's words: d = 4u + 3 - s takes the top 4 - s bytes
// of rb[u] and the low s of rb[u - 1], one funnel shift.
template <int N>
HANDEL_HD uint32_t lab_window(const uint32_t* rb, int d) {
  constexpr int W = N / 2;
  const int s = (3 - d) & 3;
  const int u = (d + s - 3) / 4;
  const uint32_t lo = u < W ? rb[u] : 0u;
  const uint32_t hi = u >= 1 ? rb[u - 1] : 0u;
  return s ? funnel_r(lo, hi, 8 * s) : lo;
}

// The byte-position sums of a b: s[q] = sum over i + j = q of A_i B_j for
// q < 4N - 1, s[4N - 1] = 0; each below 2N 255^2 < 2^22. a and b hold N
// 16-bit digits. Each position takes one dp4a per word w of a whose bytes
// meet b's.
template <int N>
HANDEL_HD void lab_ab_bytes(const uint32_t* a, const uint32_t* b, uint32_t* s) {
  constexpr int W = N / 2;
  uint32_t aw[W], rb[W];
  HANDEL_UNROLL
  for (int w = 0; w < W; ++w) {
    aw[w] = byte_perm(a[2 * w], a[2 * w + 1], 0x5410u);  // A_4w .. A_4w+3
    rb[w] = byte_perm(b[2 * w], b[2 * w + 1], 0x0145u);  // B_4w+3 .. B_4w
  }
  HANDEL_UNROLL
  for (int q = 0; q < 4 * N - 1; ++q) {
    uint32_t acc = 0;
    HANDEL_UNROLL
    for (int w = 0; w < W; ++w) {
      const int d = q - 4 * w;
      if (d >= 0 && d <= 2 * N + 2) acc = dp4a(aw[w], lab_window<N>(rb, d), acc);
    }
    s[q] = acc;
  }
  s[4 * N - 1] = 0;
}

// ---- kernel B3a: interleaved CIOS ----------------------------------------

// The reference's cios_fullwidth_body on byte positions. a b's 4N position
// sums; then N interleaved reduction steps, two at a time. Step i
// normalises positions 2i and 2i + 1 (carry cy into 2i + 2), reads column
// i's 16 bits u, picks m_i = u n0 mod 2^16 and takes the exact carry of
// u + m_i p_0 (its low 16 bits cancel). Step i adds m_i times p's bytes 2
// and 3 into positions 2i + 2 and 2i + 3 (two multiply-adds), which is all
// step i + 1 needs to pick m_(i+1) from column i + 1 the same way. The
// rest of both products goes in with one __dp4a a position: the bytes of
// m_i and m_(i+1), [m_i lo, m_i hi, m_(i+1) lo, m_(i+1) hi] at offset 2i,
// against the window pw[e] of p's bytes e .. e - 3 at position 2i + e,
// e = 5 .. 2N + 2; at e = 4 the window leaves out the two byte products
// already added (m_i hi p_3, and m_(i+1) hi p_1 inside its carry). Then the
// high half's positions are normalised to digits (what passes the top is
// dropped: mod R) and conditionally reduced.
//
// Bounds: a position holds a b's sum (< 2^22), at most N / 2 dp4a sums of
// four byte products (< 2^18 each) and, at 2i + 2 and 2i + 3 just before
// they are read, one product m_i pb (< 2^24): below 2^25; u + m p_0 <
// 2^16 + (2^16 - 1)^2 < 2^32; a carry is below 2^18.
template <int N>
HANDEL_HD void lab_cios_fullwidth(const uint32_t* a, const uint32_t* b,
                                  const LabParams& prm, uint32_t* out) {
  uint32_t s[4 * N];
  lab_ab_bytes<N>(a, b, s);
  uint32_t cy = 0;
  HANDEL_UNROLL
  for (int i = 0; i < N; i += 2) {
    uint32_t t = s[2 * i] + cy;
    uint32_t t2 = s[2 * i + 1] + (t >> 8);
    uint32_t u = byte_perm(t, t2, 0x0040u) & kDigitMask;
    const uint32_t m = (u * prm.n0) & kDigitMask;
    cy = (t2 >> 8) + ((u + m * prm.p[0]) >> 16);
    s[2 * i + 2] += m * prm.pb2;
    s[2 * i + 3] += m * prm.pb3;
    t = s[2 * i + 2] + cy;
    t2 = s[2 * i + 3] + (t >> 8);
    u = byte_perm(t, t2, 0x0040u) & kDigitMask;
    const uint32_t m2 = (u * prm.n0) & kDigitMask;
    cy = (t2 >> 8) + ((u + m2 * prm.p[0]) >> 16);
    const uint32_t mm = byte_perm(m, m2, 0x5410u);
    HANDEL_UNROLL
    for (int e = 4; e <= 2 * N + 2; ++e) s[2 * i + e] = dp4a(mm, prm.pw[e], s[2 * i + e]);
  }
  uint32_t r[N];
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    const uint32_t t = s[2 * N + 2 * k] + cy;
    const uint32_t t2 = s[2 * N + 2 * k + 1] + (t >> 8);
    r[k] = byte_perm(t, t2, 0x0040u) & kDigitMask;
    cy = t2 >> 8;
  }
  lab_cond_sub_p<N>(r, prm.p, out);
}

// One column j of an (N, B) int32 digit array with row stride lda, row by
// row from a running pointer.
template <int N>
HANDEL_HD void lab_load_column(const int32_t* a, int64_t lda, int64_t j, uint32_t* x) {
  const int32_t* p = a + j;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k, p += lda) {
#ifdef __CUDA_ARCH__
    x[k] = (uint32_t)__ldg(p);
#else
    x[k] = (uint32_t)*p;
#endif
  }
}

// The same column of N digits into out (row stride ldo).
template <int N>
HANDEL_HD void lab_store_column(int32_t* out, int64_t ldo, int64_t j, const uint32_t* r) {
  int32_t* p = out + j;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k, p += ldo) *p = (int32_t)r[k];
}

// ---- kernel B3b: separated Montgomery on a warp of 32 columns -------------
//
// The reference's separated_body: T = a b; tl = T mod R; m = tl p' mod R;
// T + m p, whose low half is 0 mod R (only its carry into column N is
// kept); the high half mod R, conditionally reduced. Lane l of a warp owns
// column col0 + l for the lane-wise steps (loads, a b, carries, the
// subtract, stores); the two constant products are warp-wide mma.sync
// products, their operands and results passing through the warp's shared
// memory: X holds each column's bytes (tl, then m) as rows of PB words,
// where lane (g, t) of an n-tile reads the B fragment words
// 8 ks + 4 h + t of row 8 nt + g; Y receives the products' 16-bit column
// sums, row 8 nt + 2t + e, word 8 mt + g from lane (g, t), and lane l reads
// its row with 16-byte loads. PB and PY are 4 times an odd number, so those
// accesses meet no bank twice.
//
// The fragment table (built by handel_tpu_torch/kernels/lab_mont.py
// `separated_fragments`, the same for every column): for product 1 (tl p',
// MT1 row tiles) then product 2 (m p, MT2), every (mt, ks) tile with a
// nonzero entry (sep_tile_live), in order; for each, 32 lanes of 4 words,
// lane (g, t)'s A fragment: word r holds the entries of row position
// 16 mt + 2g + (r & 1), depth 32 ks + 16 (r >> 1) + 4t .. + 3, the entry at
// (pos, k) being byte pos - k of the constant where 0 <= pos - k < 2N and
// k < 2N, else 0. The zero depth past 2N lets X's padding words hold
// anything.
//
// Bounds: c[k] (a b, 16-bit lazy) < 2^22 257; a product's 16-bit column
// sum the same; T + m p's column plus a carry < 2^31.
template <int N>
struct SepLayout {
  static constexpr int KS = (2 * N + 31) / 32;  // 32-byte depth steps
  static constexpr int MT1 = 2 * N / 16;        // row tiles of tl p' mod R
  static constexpr int MT2 = 4 * N / 16;        // of m p
  static constexpr int PB = 8 * KS + 4;         // X row pitch, words
  static constexpr int PY = 2 * N + 4;          // Y row pitch, words
  static constexpr int X = 0, Y = 32 * PB, words = Y + 32 * PY;
};

// Whether row tile mt, depth step ks of a constant product has a nonzero
// entry: row positions 16 mt .. 16 mt + 15, depth 32 ks .. min(32 ks + 31,
// 2N - 1), an entry nonzero only where 0 <= pos - k < 2N.
HANDEL_HD constexpr bool sep_tile_live(int N, int mt, int ks) {
  return 32 * ks < 2 * N && 16 * mt + 15 >= 32 * ks &&
         16 * mt - (32 * ks + 31 < 2 * N ? 32 * ks + 31 : 2 * N - 1) < 2 * N;
}

// Index of tile (mt, ks) of product `prod` (1 or 2) in the fragment table;
// sep_tile_index(N, 3, 0, 0) is the number of tiles.
HANDEL_HD constexpr int sep_tile_index(int N, int prod, int mt, int ks) {
  int n = 0;
  for (int p = 1; p <= 2; ++p)
    for (int t = 0; t < (p == 1 ? 2 * N / 16 : 4 * N / 16); ++t)
      for (int s = 0; s < (2 * N + 31) / 32; ++s) {
        if (p == prod && t == mt && s == ks) return n;
        if (sep_tile_live(N, t, s)) ++n;
      }
  return n;
}

// W words from p to v (16-byte loads on the card; p 16-byte aligned, W a
// multiple of 4), and from v to p.
template <int W>
HANDEL_HD void ld_words(const uint32_t* p, uint32_t* v) {
#ifdef __CUDA_ARCH__
  HANDEL_UNROLL
  for (int k = 0; k < W; k += 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + k);
    v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
  }
#else
  std::memcpy(v, p, sizeof(uint32_t) * W);
#endif
}

template <int W>
HANDEL_HD void st_words(uint32_t* p, const uint32_t* v) {
#ifdef __CUDA_ARCH__
  HANDEL_UNROLL
  for (int k = 0; k < W; k += 4)
    *reinterpret_cast<uint4*>(p + k) = make_uint4(v[k], v[k + 1], v[k + 2], v[k + 3]);
#else
  std::memcpy(p, v, sizeof(uint32_t) * W);
#endif
}

// 16-bit digits (low halves of v) as N / 2 words of bytes into X's row
template <int N>
HANDEL_HD void sep_put_bytes(uint32_t* xs, int lane, const uint32_t* v) {
  uint32_t w[N / 2];
  HANDEL_UNROLL
  for (int k = 0; k < N / 2; ++k) w[k] = byte_perm(v[2 * k], v[2 * k + 1], 0x5410u);
  st_words<N / 2>(xs + lane * SepLayout<N>::PB, w);
}

// Lane step 1: T = a b as 2N lazy 16-bit columns c, and tl = T mod R into
// X's row `lane`.
template <int N>
HANDEL_HD void sep_lane_products(const uint32_t* x, const uint32_t* y, uint32_t* c,
                                 uint32_t* xs, int lane) {
  uint32_t s[4 * N];
  lab_ab_bytes<N>(x, y, s);
  HANDEL_UNROLL
  for (int k = 0; k < 2 * N; ++k) c[k] = s[2 * k] + (s[2 * k + 1] << 8);
  uint32_t tl[N];
  uint32_t cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    tl[k] = c[k] + cy;  // its low 16 bits are digit k
    cy = tl[k] >> 16;
  }
  sep_put_bytes<N>(xs, lane, tl);
}

// This lane's B fragment of n-tile nt, depth step ks, from X.
template <int N>
HANDEL_HD void sep_b_frag(const uint32_t* xs, int nt, int ks, int lane, uint32_t* b) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* row = xs + (8 * nt + g) * SepLayout<N>::PB + 8 * ks + t;
  b[0] = row[0];
  b[1] = row[4];
}

// This lane's A fragment of table tile `tile` (16-byte loads on the card).
HANDEL_HD void sep_a_frag(const uint32_t* frags, int tile, int lane, uint32_t* a) {
#ifdef __CUDA_ARCH__
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(frags) + (tile * 32 + lane));
  a[0] = q.x, a[1] = q.y, a[2] = q.z, a[3] = q.w;
#else
  std::memcpy(a, frags + 4 * (tile * 32 + lane), 4 * sizeof(uint32_t));
#endif
}

// A C fragment of n-tile nt, row tile mt into Y: rows g and g + 8 are
// positions 2r and 2r + 1 of 16-bit column r = 8 mt + g, folded.
template <int N>
HANDEL_HD void sep_store_c(uint32_t* ys, int nt, int mt, int lane, const int32_t* acc) {
  constexpr int PY = SepLayout<N>::PY;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* col = ys + (8 * nt + 2 * t) * PY + 8 * mt + g;
  col[0] = (uint32_t)acc[0] + ((uint32_t)acc[2] << 8);
  col[PY] = (uint32_t)acc[1] + ((uint32_t)acc[3] << 8);
}

// Lane step 2: m = (tl p' mod R) from product 1's column sums in Y (only
// columns below N were formed), normalised mod R, into X's row `lane`.
template <int N>
HANDEL_HD void sep_lane_quotient(const uint32_t* ys, uint32_t* xs, int lane) {
  uint32_t v[N];
  ld_words<N>(ys + lane * SepLayout<N>::PY, v);
  uint32_t cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    v[k] += cy;  // its low 16 bits are digit k of m
    cy = v[k] >> 16;
  }
  sep_put_bytes<N>(xs, lane, v);
}

// Lane step 3: T + m p from c and product 2's column sums in Y; the low
// half's carry into column N, the high half mod R, the conditional
// subtract.
template <int N>
HANDEL_HD void sep_lane_finish(const uint32_t* c, const uint32_t* ys, const LabParams& prm,
                               int lane, uint32_t* out) {
  uint32_t v[2 * N];
  ld_words<2 * N>(ys + lane * SepLayout<N>::PY, v);
  uint32_t cy = 0;
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) cy = (c[k] + v[k] + cy) >> 16;
  uint32_t h[N];
  HANDEL_UNROLL
  for (int k = 0; k < N; ++k) {
    const uint32_t t = c[N + k] + v[N + k] + cy;
    h[k] = t & kDigitMask;
    cy = t >> 16;
  }
  lab_cond_sub_p<N>(h, prm.p, out);
}

#ifndef __CUDA_ARCH__
// Host twin of one mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 over a
// warp: c[l] += A . B for the fragments a[l], b[l] of the 32 lanes, each
// element read from the lane and byte the PTX fragment layout puts it in
// (lane l is g = l / 4, t = l % 4: A row g + 8 (r & 1), depth
// 16 (r >> 1) + 4t + byte in register r; B depth 16 h + 4t + byte, column g
// in register h; C rows g, g + 8, columns 2t, 2t + 1).
inline void mma_u8_host(int32_t c[32][4], const uint32_t a[32][4], const uint32_t b[32][2]) {
  auto byte = [](uint32_t w, int k) { return (int32_t)((w >> (8 * (k & 3))) & 0xFFu); };
  for (int l = 0; l < 32; ++l)
    for (int e = 0; e < 4; ++e) {
      const int row = (l >> 2) + 8 * (e >> 1), col = 2 * (l & 3) + (e & 1);
      int32_t s = 0;
      for (int k = 0; k < 32; ++k) {
        const int32_t x = byte(a[4 * (row & 7) + (k & 15) / 4][(row >> 3) + 2 * (k >> 4)], k);
        const int32_t y = byte(b[4 * col + (k & 15) / 4][k >> 4], k);
        s += x * y;
      }
      c[l][e] += s;
    }
}

// Host twin of one constant product (prod 1: tl p', prod 2: m p) over a
// warp: B fragments from X, A fragments from the table, into Y.
template <int N, int PROD>
inline void sep_product_host(const uint32_t* frags, const uint32_t* xs, uint32_t* ys) {
  using L = SepLayout<N>;
  constexpr int MT = PROD == 1 ? L::MT1 : L::MT2;
  for (int nt = 0; nt < 4; ++nt)
    for (int mt = 0; mt < MT; ++mt) {
      int32_t acc[32][4] = {};
      for (int ks = 0; ks < L::KS; ++ks) {
        if (!sep_tile_live(N, mt, ks)) continue;
        uint32_t af[32][4], bf[32][2];
        for (int l = 0; l < 32; ++l) {
          sep_a_frag(frags, sep_tile_index(N, PROD, mt, ks), l, af[l]);
          sep_b_frag<N>(xs, nt, ks, l, bf[l]);
        }
        mma_u8_host(acc, af, bf);
      }
      for (int l = 0; l < 32; ++l) sep_store_c<N>(ys, nt, mt, l, acc[l]);
    }
}

// Host twin of one warp of kernel B3b: columns col0 .. col0 + 31 of (N, B)
// int32 arrays with row strides lda/ldb/ldo. A lane past `cols` computes on
// the last column (its column of each product is its own) and stores
// nothing. The lanes run one after another between the exchanges, in the
// card's order: products, tensor-core product 1, quotients, product 2, the
// finish.
template <int N>
inline void lab_separated_warp_host(const int32_t* a, int64_t lda, const int32_t* b,
                                    int64_t ldb, int32_t* out, int64_t ldo, int64_t col0,
                                    int64_t cols, const uint32_t* frags,
                                    const LabParams& prm) {
  using L = SepLayout<N>;
  std::vector<uint32_t> sm(L::words, 0), c(32 * 2 * N);
  uint32_t* xs = sm.data() + L::X;
  uint32_t* ys = sm.data() + L::Y;
  for (int l = 0; l < 32; ++l) {
    uint32_t x[N], y[N];
    const int64_t j = col0 + l < cols ? col0 + l : cols - 1;
    lab_load_column<N>(a, lda, j, x);
    lab_load_column<N>(b, ldb, j, y);
    sep_lane_products<N>(x, y, c.data() + 2 * N * l, xs, l);
  }
  sep_product_host<N, 1>(frags, xs, ys);
  for (int l = 0; l < 32; ++l) sep_lane_quotient<N>(ys, xs, l);
  sep_product_host<N, 2>(frags, xs, ys);
  for (int l = 0; l < 32; ++l) {
    uint32_t r[N];
    sep_lane_finish<N>(c.data() + 2 * N * l, ys, prm, l, r);
    if (col0 + l < cols) lab_store_column<N>(out, ldo, col0 + l, r);
  }
}
#endif  // !__CUDA_ARCH__

}  // namespace handel
