// Resident RNS Montgomery multiplication on a warp's tile of 8 columns.
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
// redundant row m_r. The reference's steps, each reduced to a canonical
// residue:
//   1. d_i   = a_i b_i                                   mod m_i (all rows)
//   2. xi_i  = d_i c1_i                                  mod m_i (base A)
//   3. Q_j   = sum_i E[j, i] xi_i                        mod m_j (B and m_r)
//   4. r_j   = (d_j + Q_j (p mod m_j)) M^-1              mod m_j
//   5. xi'_j = r_j c2_j                                  mod m_j (base B)
//   6. alpha = ((sum_j xi'_j L_mr_j) - r_mr) MB^-1       mod m_r
//   7. out_i = sum_j E2[i, j] xi'_j - alpha (MB mod m_i) mod m_i (base A)
// and the output column is [out ; r]. Every residue the steps produce is the
// canonical residue of an integer the algorithm fixes, so any exact reduction
// of the same residue class gives the reference's bits. This code takes
// fewer reductions (161 a column for BN254 where the steps as written take
// 252), each an exact Barrett reduction with no int/float conversion
// (rns_mod), by folding constants:
//   4. r_j = (d_j M^-1 + Q_j pM_j) mod m_j, with pM_j = p M^-1 mod m_j;
//   6. sum_j xi'_j L_mr_j is one more row of step 7's contraction (row KA of
//      its matrix), reduced once;
//   7. out_i = (sum_j E2[i, j] xi'_j + alpha (m_i - (MB mod m_i))) mod m_i.
// Every product is < 2^26 and every sum of at most 34 such products is below
// 34 * 2^26 < 2^32, so uint32 arithmetic is exact throughout.
//
// The two contractions (steps 3 and 7) are int8 products, the reference's
// `int8_dots` form (handel_tpu/ops/rns.py `_dot`): both factors split at bit
// 7 into a low plane (< 2^7) and a high plane (< 2^6), and
//   sum W x = ll + ((lh + hl) << 7) + (hh << 14)
// with ll = Wlo . xlo, lh + hl = Wlo . xhi + Whi . xlo, hh = Whi . xhi, each
// an int32 dot product of int8 planes. The recombination is the exact
// integer sum, below 2^32, so it is taken in uint32 and reduced once; the
// reference reduces its high part first only because its lanes are int32.
//
// Work split: one warp owns a tile of 8 NT columns (NT = 1 or 2 n-tiles of
// 8), and each contraction is a W (rows x depth) . x (depth x 8 columns)
// product per n-tile in mma.sync m16n8k32 fragments (PTX ISA,
// "mma.m16n8k32" fragment layouts; lane l is g = l / 4, t = l % 4):
//   B fragment (x)  lane (g, t) holds column g, depth rows 4t..4t+3 and
//                   16+4t..16+4t+3 of each 32-deep step;
//   C fragment      lane (g, t) holds rows g and g+8 of each 16-row tile,
//                   columns 2t and 2t+1.
// So the residue-wise work follows the fragments: lane (g, t) reduces the
// base-A rows of step 3's B fragment (steps 1-2, packing xi straight into
// its fragment registers; E's depth is permuted so that these are rows t,
// t + 4, ... and the 4 lanes of a column share them evenly), and the base-B
// rows of step 3's C fragment (step 1 for those rows, then 4-5). The xi'
// planes go through a small per-warp buffer in shared memory into step 7's
// B fragment (a transpose); alpha's two inputs are broadcast by shuffles;
// step 7's epilogue runs in its C fragment. A row's constants come in one
// 16-byte record and serve every n-tile; so do the matrices' fragments.
// Nothing crosses warps. On the card each contraction is four mma.sync
// products per 16-row tile, 32 of depth and n-tile; on the host
// (rns_mul_resident_warp_host) the 32 lanes are stepped one after another
// between the exchanges, and each mma.sync is `mma_host`, a plain loop over
// the same int8 fragment registers giving the same int32 partials.

#pragma once

#include <stdint.h>

#ifndef __CUDA_ARCH__
#include <cstring>
#include <vector>
#endif

#ifdef __CUDACC__
#define HANDEL_HD __host__ __device__ __forceinline__
#define HANDEL_UNROLL _Pragma("unroll")
#else
#define HANDEL_HD inline
#define HANDEL_UNROLL
#endif

namespace handel {

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Offsets (in int32 words) of the constant table of one field, built by
// handel_tpu_torch/kernels/rns_mont.py `pack_constants` in the same order.
template <int KA, int KB>
struct RnsLayout {
  static constexpr int K = KA + KB + 1;  // joint base A ++ B ++ [m_r]
  static constexpr int KB1 = KB + 1;     // base B ++ [m_r]
  // one 16-byte record per row (RowRec): base-A row i {m_i, mu_i, c1_i,
  // m_i - (MB mod m_i)}; row KA + j {m_j, mu_j, M^-1 mod m_j, p M^-1 mod
  // m_j}; mu = floor(2^32 / m) is the Barrett factor
  static constexpr int rec = 0;
  static constexpr int c2 = rec + 4 * K;  // KB
  static constexpr int MBinvr = c2 + KB;  // 1: MB^-1 mod m_r
  // int8 planes (low 7 bits, then the bits above) of step 3's matrix E
  // (M3 x K3: KB1 rows, KA deep) and step 7's (M7 x K7: E2's KA rows, then
  // L_mr as row KA; KB deep), zero-padded to whole mma tiles, row-major with
  // rows of P3 (P7) bytes: 16 bytes past the depth put the 8 rows a
  // fragment load reads in distinct banks. E's depth is permuted: depth k
  // holds base-A row a_row(k) (below), so each lane of a B fragment holds
  // every fourth row and the 4 lanes share the rows evenly
  static constexpr int M3 = round_up(KB1, 16), K3 = round_up(KA, 32), P3 = K3 + 16;
  static constexpr int M7 = round_up(KA + 1, 16), K7 = round_up(KB, 32), P7 = K7 + 16;
  static constexpr int MT3 = M3 / 16, KS3 = K3 / 32, MT7 = M7 / 16, KS7 = K7 / 32;
  static constexpr int Elo = round_up(MBinvr + 1, 4);
  static constexpr int Ehi = Elo + M3 * P3 / 4;
  static constexpr int E2lo = Ehi + M3 * P3 / 4;
  static constexpr int E2hi = E2lo + M7 * P7 / 4;
  static constexpr int size = E2hi + M7 * P7 / 4;
};

// Shared memory of one warp, in 32-bit words: a ring of STAGES stages of
// the operand tile (a then b, K rows of TS words, N = 8 NT columns used),
// then the xi' planes (N columns of PX bytes, low plane then high). The
// stage being computed on also holds the output tile once its operands are
// read; the others are in flight.
template <int KA, int KB, int NT>
struct WarpLayout {
  using L = RnsLayout<KA, KB>;
  static constexpr int N = 8 * NT;  // columns of a warp's tile: NT mma n-tiles
  // row stride: 16-byte aligned rows for cp.async; the 4 lanes of a column
  // read 4 consecutive rows (a_row), which 8 words (24 for two n-tiles) put
  // in distinct banks
  static constexpr int TS = NT == 1 ? 8 : 8 * NT + 8;
  static constexpr int STAGES = 3;
  static constexpr int stage = 2 * L::K * TS;
  static constexpr int PX = L::K7 + 16;
  static constexpr int xp = STAGES * stage;
  static constexpr int words = xp + 2 * N * PX / 4;
};

// Shared memory of a block of WARPS warps: the constant table, then each
// warp's region.
template <int KA, int KB, int NT, int WARPS>
struct BlockLayout {
  using L = RnsLayout<KA, KB>;
  using WL = WarpLayout<KA, KB, NT>;
  static constexpr int warp0 = round_up(L::size, 4);
  static constexpr int words = warp0 + WARPS * WL::words;
  static constexpr int bytes = 4 * words;
};

// The base-A row that depth k of step 3's contraction holds: slot u of
// lane t of the B fragment (k = 32 ks + 16 h + 4 t + q, u = 8 ks + 4 h + q)
// holds row 4 u + t, so lane t reduces rows t, t + 4, t + 8, ...
HANDEL_HD int a_row(int k) {
  const int ks = k / 32, h = (k % 32) / 16, t = (k % 16) / 4, q = k % 4;
  return 4 * (8 * ks + 4 * h + q) + t;
}

HANDEL_HD uint32_t umulhi(uint32_t x, uint32_t y) {
#ifdef __CUDA_ARCH__
  return __umulhi(x, y);
#else
  return (uint32_t)(((uint64_t)x * y) >> 32);
#endif
}

// v mod m, canonical, for any uint32 v and 1 < m < 2^13, given
// mu = floor(2^32 / m) (Barrett). q = hi32(v mu) lies in
// (v/m - 2, v/m], so r = v - q m lies in [0, 2m); r - m wraps above r
// exactly when r < m, so the unsigned minimum of the two is canonical. Four
// integer instructions and no conversion.
HANDEL_HD uint32_t rns_mod(uint32_t v, uint32_t m, uint32_t mu) {
  const uint32_t r = v - umulhi(v, mu) * m;
  const uint32_t s = r - m;
  return s < r ? s : r;
}

// A row's record of the table (RnsLayout::rec): the modulus, its Barrett
// factor and two constants of the row, in one 16-byte load on the card.
struct RowRec {
  uint32_t m, mu, x, y;
  HANDEL_HD uint32_t mod(uint32_t v) const { return rns_mod(v, m, mu); }
};

template <int KA, int KB>
HANDEL_HD RowRec row_rec(const uint32_t* c, int row) {
  using L = RnsLayout<KA, KB>;
#ifdef __CUDA_ARCH__
  const uint4 w = *reinterpret_cast<const uint4*>(c + L::rec + 4 * row);
  return RowRec{w.x, w.y, w.z, w.w};
#else
  const uint32_t* w = c + L::rec + 4 * row;
  return RowRec{w[0], w[1], w[2], w[3]};
#endif
}

// The exact sum of the four plane products, in uint32 (below 34 * 2^26).
HANDEL_HD uint32_t recombine(int32_t ll, int32_t mid, int32_t hh) {
  return (uint32_t)ll + ((uint32_t)mid << 7) + ((uint32_t)hh << 14);
}

// x < 2^13 into byte q of a fragment register of each plane: the low 7
// bits into `lo`, the bits above (< 2^6) into `hi`.
HANDEL_HD void split7(uint32_t x, int q, uint32_t& lo, uint32_t& hi) {
  lo |= (x & 0x7Fu) << (8 * q);
  hi |= (x >> 7) << (8 * q);
}

// The 4 bytes at p as one little-endian word (p 4-byte aligned).
HANDEL_HD uint32_t ld_word(const int8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t w;
  std::memcpy(&w, p, sizeof w);
  return w;
#endif
}

// One lane's registers across a warp tile. Index names: n an 8-column
// n-tile of the warp's tile, mt a 16-row tile, ks a 32-deep step, h a
// fragment register's half of the depth, s the upper (1) or lower (0) 8
// rows of a 16-row tile, e the column 2t + e of the n-tile.
template <int KA, int KB, int NT>
struct LaneRegs {
  using L = RnsLayout<KA, KB>;
  uint32_t xlo[NT][L::KS3][2], xhi[NT][L::KS3][2];  // step 3's B fragment: xi planes
  uint32_t d[NT][L::MT3][2][2];                     // rows KA + 16 mt + 8 s + g: d, then r
  uint32_t s3[NT][L::MT3][4];                       // step 3's sums, C fragment order
  uint32_t ylo[NT][L::KS7][2], yhi[NT][L::KS7][2];  // step 7's B fragment: xi' planes
  uint32_t s7[NT][L::MT7][4];                       // step 7's sums
};

// Steps 1-2: from the staged operand tile (ta, tb: K rows of TS words),
// xi of the base-A rows of step 3's B fragment, packed into its registers
// as planes, and d of the rows of step 3's C fragment.
template <int KA, int KB, int NT>
HANDEL_HD void lane_products(LaneRegs<KA, KB, NT>& r, const uint32_t* c, const uint32_t* ta,
                             const uint32_t* tb, int lane) {
  using L = RnsLayout<KA, KB>;
  constexpr int TS = WarpLayout<KA, KB, NT>::TS;
  const int g = lane >> 2, t = lane & 3;
  HANDEL_UNROLL
  for (int n = 0; n < NT; ++n)
    HANDEL_UNROLL
    for (int ks = 0; ks < L::KS3; ++ks)
      HANDEL_UNROLL
      for (int h = 0; h < 2; ++h) r.xlo[n][ks][h] = r.xhi[n][ks][h] = 0;
  // slot u holds row 4 u + t (a_row)
  HANDEL_UNROLL
  for (int u = 0; u < (KA + 3) / 4; ++u) {
    const int i = 4 * u + t;
    if (4 * u + 3 < KA || i < KA) {
      const RowRec w = row_rec<KA, KB>(c, i);
      HANDEL_UNROLL
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + g;
        const uint32_t d = w.mod(ta[i * TS + col] * tb[i * TS + col]);
        split7(w.mod(d * w.x), u % 4, r.xlo[n][u / 8][(u % 8) / 4], r.xhi[n][u / 8][(u % 8) / 4]);
      }
    }
  }
  HANDEL_UNROLL
  for (int mt = 0; mt < L::MT3; ++mt)
    HANDEL_UNROLL
    for (int s = 0; s < 2; ++s) {
      const int j = 16 * mt + 8 * s + g, row = KA + j;
      const bool live = 16 * mt + 8 * s < L::KB1 && j < L::KB1;
      const RowRec w = live ? row_rec<KA, KB>(c, row) : RowRec{1, 0, 0, 0};
      HANDEL_UNROLL
      for (int n = 0; n < NT; ++n)
        HANDEL_UNROLL
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e;
          r.d[n][mt][s][e] = live ? w.mod(ta[row * TS + col] * tb[row * TS + col]) : 0;
        }
    }
}

// This lane's A fragment of a 16-row tile mt and 32-deep step ks of a plane
// with rows of P bytes.
HANDEL_HD void load_a_frag(const int8_t* w, int P, int mt, int ks, int lane, uint32_t* a) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = w + (16 * mt + g) * P + 32 * ks + 4 * t;
  a[0] = ld_word(p);
  a[1] = ld_word(p + 8 * P);
  a[2] = ld_word(p + 16);
  a[3] = ld_word(p + 8 * P + 16);
}

// Steps 3-5 on step 3's sums: Q, r (into the output tile `to`, rows KA..K-1,
// and the lane's d registers), and the xi' planes into the warp's buffer.
template <int KA, int KB, int NT>
HANDEL_HD void lane_quotient(LaneRegs<KA, KB, NT>& r, const uint32_t* c, uint32_t* to,
                             int8_t* xplo, int8_t* xphi, int lane) {
  using L = RnsLayout<KA, KB>;
  using WL = WarpLayout<KA, KB, NT>;
  const int g = lane >> 2, t = lane & 3;
  HANDEL_UNROLL
  for (int mt = 0; mt < L::MT3; ++mt)
    HANDEL_UNROLL
    for (int s = 0; s < 2; ++s) {
      const int j = 16 * mt + 8 * s + g, row = KA + j;
      if (16 * mt + 8 * s < L::KB1 && j < L::KB1) {
        const RowRec w = row_rec<KA, KB>(c, row);  // x: M^-1, y: p M^-1
        const uint32_t c2 = j < KB ? c[L::c2 + j] : 0;
        HANDEL_UNROLL
        for (int n = 0; n < NT; ++n)
          HANDEL_UNROLL
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t + e;
            const uint32_t q = w.mod(r.s3[n][mt][2 * s + e]);
            const uint32_t rr = w.mod(r.d[n][mt][s][e] * w.x + q * w.y);
            r.d[n][mt][s][e] = rr;
            to[row * WL::TS + col] = rr;
            if (j < KB) {
              const uint32_t x = w.mod(rr * c2);
              xplo[col * WL::PX + j] = (int8_t)(x & 0x7Fu);
              xphi[col * WL::PX + j] = (int8_t)(x >> 7);
            }
          }
      }
    }
}

// Step 7's B fragment from the warp's xi' planes. Depth rows past KB hold
// stale bytes; the matrix planes are zero there.
template <int KA, int KB, int NT>
HANDEL_HD void lane_load_digits(LaneRegs<KA, KB, NT>& r, const int8_t* xplo, const int8_t* xphi,
                                int lane) {
  using L = RnsLayout<KA, KB>;
  using WL = WarpLayout<KA, KB, NT>;
  const int g = lane >> 2, t = lane & 3;
  HANDEL_UNROLL
  for (int n = 0; n < NT; ++n)
    HANDEL_UNROLL
    for (int ks = 0; ks < L::KS7; ++ks)
      HANDEL_UNROLL
      for (int h = 0; h < 2; ++h) {
        const int off = (8 * n + g) * WL::PX + 32 * ks + 16 * h + 4 * t;
        r.ylo[n][ks][h] = ld_word(xplo + off);
        r.yhi[n][ks][h] = ld_word(xphi + off);
      }
}

// Where alpha's inputs sit: step 7's row KA (the L_mr sum) and step 3's row
// KB (r_mr), as (16-row tile, C-fragment half s, lane group g).
template <int KA, int KB>
struct AlphaSources {
  static constexpr int mt7 = KA / 16, s7 = (KA % 16) / 8, g7 = KA % 8;
  static constexpr int mt3 = KB / 16, s3 = (KB % 16) / 8, g3 = KB % 8;
};

// Steps 6-7: alpha for columns 2t, 2t+1 of each n-tile from the L_mr sums
// and r_mr of those columns (smr, rmr: broadcast from the lanes that hold
// them), then the base-A rows of step 7's C fragment into the output tile.
template <int KA, int KB, int NT>
HANDEL_HD void lane_extend(const LaneRegs<KA, KB, NT>& r, const uint32_t* c, uint32_t* to,
                           const uint32_t (&smr)[NT][2], const uint32_t (&rmr)[NT][2], int lane) {
  using L = RnsLayout<KA, KB>;
  using WL = WarpLayout<KA, KB, NT>;
  const int g = lane >> 2, t = lane & 3;
  const RowRec wr = row_rec<KA, KB>(c, L::K - 1);
  const uint32_t mbinv = c[L::MBinvr];
  uint32_t alpha[NT][2];
  HANDEL_UNROLL
  for (int n = 0; n < NT; ++n)
    HANDEL_UNROLL
    for (int e = 0; e < 2; ++e) alpha[n][e] = wr.mod((wr.mod(smr[n][e]) + wr.m - rmr[n][e]) * mbinv);
  HANDEL_UNROLL
  for (int mt = 0; mt < L::MT7; ++mt)
    HANDEL_UNROLL
    for (int s = 0; s < 2; ++s) {
      const int i = 16 * mt + 8 * s + g;
      if (16 * mt + 8 * s < KA && i < KA) {
        const RowRec w = row_rec<KA, KB>(c, i);  // y: m_i - (MB mod m_i)
        HANDEL_UNROLL
        for (int n = 0; n < NT; ++n)
          HANDEL_UNROLL
          for (int e = 0; e < 2; ++e)
            to[i * WL::TS + 8 * n + 2 * t + e] = w.mod(r.s7[n][mt][2 * s + e] + alpha[n][e] * w.y);
      }
    }
}

#ifndef __CUDA_ARCH__
// Host twin of one mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 over a
// warp: c[l] += A . B for the fragments a[l], b[l] of the 32 lanes, each
// element read from the lane and byte the PTX fragment layout puts it in.
inline void mma_host(int32_t c[32][4], const uint32_t a[32][4], const uint32_t b[32][2]) {
  auto byte = [](uint32_t w, int k) { return (int32_t)(int8_t)(w >> (8 * (k & 3))); };
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

// Host twin of a contraction for one n-tile: the sums of plane rows mt of
// `lo`/`hi` (rows of P bytes) against the lanes' B fragments (xlo/xhi per
// lane, KS steps), recombined, into out[l][mt][e].
template <int MT, int KS>
inline void contract_host(const int8_t* lo, const int8_t* hi, int P,
                          const uint32_t (*xlo)[KS][2], const uint32_t (*xhi)[KS][2],
                          uint32_t (*out)[MT][4]) {
  for (int mt = 0; mt < MT; ++mt) {
    int32_t ll[32][4] = {}, mid[32][4] = {}, hh[32][4] = {};
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t al[32][4], ah[32][4], bl[32][2], bh[32][2];
      for (int l = 0; l < 32; ++l) {
        load_a_frag(lo, P, mt, ks, l, al[l]);
        load_a_frag(hi, P, mt, ks, l, ah[l]);
        for (int h = 0; h < 2; ++h) {
          bl[l][h] = xlo[l][ks][h];
          bh[l][h] = xhi[l][ks][h];
        }
      }
      mma_host(ll, al, bl);
      mma_host(mid, al, bh);
      mma_host(mid, ah, bl);
      mma_host(hh, ah, bh);
    }
    for (int l = 0; l < 32; ++l)
      for (int e = 0; e < 4; ++e) out[l][mt][e] = recombine(ll[l][e], mid[l][e], hh[l][e]);
  }
}

// Host twin of one warp on one tile: columns col0 .. col0 + 8 NT - 1 of
// (K, B) int32 arrays with row strides lda/ldb/ldo (those past `cols`
// staged as zeros and not stored). The lanes run one after another between
// the exchanges, in the card's order: products, step 3's mma, quotients,
// the xi' transpose, step 7's mma, the two broadcasts, the extension.
template <int KA, int KB, int NT>
inline void rns_mul_resident_warp_host(const int32_t* a, int64_t lda, const int32_t* b,
                                       int64_t ldb, int32_t* out, int64_t ldo, int64_t col0,
                                       int64_t cols, const int32_t* table) {
  using L = RnsLayout<KA, KB>;
  using WL = WarpLayout<KA, KB, NT>;
  using AS = AlphaSources<KA, KB>;
  constexpr int K = L::K, TS = WL::TS;
  std::vector<uint32_t> c(L::size), sm(WL::words, 0);
  std::memcpy(c.data(), table, sizeof(int32_t) * L::size);
  uint32_t* ta = sm.data();
  uint32_t* tb = ta + K * TS;
  int8_t* xplo = reinterpret_cast<int8_t*>(sm.data() + WL::xp);
  int8_t* xphi = xplo + WL::N * WL::PX;
  const int64_t live = cols - col0 < WL::N ? cols - col0 : WL::N;
  for (int i = 0; i < K; ++i)
    for (int n = 0; n < live; ++n) {
      ta[i * TS + n] = (uint32_t)a[i * lda + col0 + n];
      tb[i * TS + n] = (uint32_t)b[i * ldb + col0 + n];
    }
  const int8_t* w = reinterpret_cast<const int8_t*>(c.data());
  std::vector<LaneRegs<KA, KB, NT>> r(32);
  for (int l = 0; l < 32; ++l) lane_products(r[l], c.data(), ta, tb, l);
  for (int n = 0; n < NT; ++n) {
    uint32_t xlo[32][L::KS3][2], xhi[32][L::KS3][2], s3[32][L::MT3][4];
    for (int l = 0; l < 32; ++l) {
      std::memcpy(xlo[l], r[l].xlo[n], sizeof xlo[l]);
      std::memcpy(xhi[l], r[l].xhi[n], sizeof xhi[l]);
    }
    contract_host<L::MT3, L::KS3>(w + 4 * L::Elo, w + 4 * L::Ehi, L::P3, xlo, xhi, s3);
    for (int l = 0; l < 32; ++l) std::memcpy(r[l].s3[n], s3[l], sizeof s3[l]);
  }
  for (int l = 0; l < 32; ++l) lane_quotient(r[l], c.data(), ta, xplo, xphi, l);
  for (int l = 0; l < 32; ++l) lane_load_digits(r[l], xplo, xphi, l);
  for (int n = 0; n < NT; ++n) {
    uint32_t ylo[32][L::KS7][2], yhi[32][L::KS7][2], s7[32][L::MT7][4];
    for (int l = 0; l < 32; ++l) {
      std::memcpy(ylo[l], r[l].ylo[n], sizeof ylo[l]);
      std::memcpy(yhi[l], r[l].yhi[n], sizeof yhi[l]);
    }
    contract_host<L::MT7, L::KS7>(w + 4 * L::E2lo, w + 4 * L::E2hi, L::P7, ylo, yhi, s7);
    for (int l = 0; l < 32; ++l) std::memcpy(r[l].s7[n], s7[l], sizeof s7[l]);
  }
  for (int l = 0; l < 32; ++l) {
    uint32_t smr[NT][2], rmr[NT][2];
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 2; ++e) {  // the shuffles' twin
        smr[n][e] = r[4 * AS::g7 + (l & 3)].s7[n][AS::mt7][2 * AS::s7 + e];
        rmr[n][e] = r[4 * AS::g3 + (l & 3)].d[n][AS::mt3][AS::s3][e];
      }
    lane_extend(r[l], c.data(), ta, smr, rmr, l);
  }
  for (int i = 0; i < K; ++i)
    for (int n = 0; n < live; ++n) out[i * ldo + col0 + n] = (int32_t)ta[i * TS + n];
}
#endif  // !__CUDA_ARCH__

}  // namespace handel
