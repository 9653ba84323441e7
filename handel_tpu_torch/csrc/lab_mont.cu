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
// What bounds them on an H100: per column they read 2N and write N int32
// digits (192 bytes for BN254, N = 16; 288 for BLS12-381, N = 24), like
// B1, so 1,048,592 columns cannot take less than 0.0601 / 0.0901 ms of
// HBM (a + b on the same shapes takes 0.068 / 0.101), and they issue many
// integer instructions a column, at most 16 of 32 lanes a clock for each
// integer pipe (multiply-add and dot product; add, logic, shift, permute).
// The first design (one thread a column, every 16 x 16 digit product a
// multiply, a mask, a shift and two adds into lazy columns) issued 2,367 /
// 5,075 SASS instructions a column in B3a and 2,843 / 6,165 in B3b, and
// was bound by them: 0.2299 and 0.2585 ms at 1,048,592 x 24, time growing
// as N^2.
//
// What this design does about it: it issues digit products on bytes
// (lab_mont.cuh):
//   * a b, both kernels: __dp4a sums four byte products into a byte-position
//     column in one instruction, against a byte-reversed window of b cut by
//     one funnel shift and shared by every word of a at that offset: N^2
//     dp4a (280 / 612) and about 0.25 N^2 more, against about 4.5 N^2.
//   * B3b's two products against constants (1.5 N^2 of its 2.5 N^2 digit
//     products) run on the int8 tensor cores: a warp owns 32 columns, each
//     product is a Toeplitz byte matrix of the constant (built once, on the
//     host: kernels/lab_mont.py `separated_fragments`) times the warp's
//     byte planes in mma.sync m16n8k32 u8 products (24 / 52 IMMA a warp),
//     the columns' bytes and the 16-bit column sums passing through the
//     warp's shared memory.
//   * B3a's interleaved reduction stays on the ALUs (m_(i+1) needs column
//     i + 1 after m_i p is added, a serial chain the tensor cores cannot
//     take) but adds two steps' m p with one __dp4a a byte position (the
//     bytes of m_i and m_(i+1) against a window of p's bytes), and reads
//     each m_i off the two byte positions of its column.
// Now, in SASS instructions a column (cuobjdump, NOPs out; each thread
// owns a column and runs its code once): B3a 1,048 / 1,940, B3b 904 /
// 1,542, 2.3-4.0x fewer, and each takes about half its former time,
// within 1.35x of the bytes bound at 1,048,592 x 24 (PERF.md §6). What
// holds them back now: the two integer pipes' issue, the serial carry
// chains (B3b: tl, m, the low carry, the high digits and the subtract, N
// steps each) at 12 to 28 warps an SM, and the bytes. A B3b lane past the
// last column loads the last column, so no load is predicated (predicated
// loads rebuilt each 64-bit address: 319 more instructions at N = 24).
// Tried and left out, timed on the H100 (PERF.md §6): staging the next
// tile by cp.async in a persistent loop (no gain at N = 24, 10% slower at
// 16), streaming cache hints (8-11% slower), a register cap on B3b (it
// spills; 10% slower).
//
// Instances: warps per block, 1, 2 or 4 (1 by default); a block covers 32
// columns a warp. B3a: one thread a column, everything in registers, no
// shared memory; 72 / 95 registers, no spill. B3b: (8 KS + 4 + 2N + 4) 32
// words of dynamic shared memory a warp (6,144 bytes at N = 16, 9,216 at
// N = 24); 112 / 163 registers at 1 warp a block, 72 / 118 at 2 and 4, no
// spill. The ragged edge is masked: a
// B3b lane past the last column computes on the last column and stores
// nothing, so that every lane of a warp takes part in its mma.sync
// products; a warp (B3a: a thread) wholly past it returns at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lab_mont.cuh"

namespace {

// c += a . b on the int8 tensor cores, unsigned bytes: one m16n8k32
// product, int32 sums (handel::mma_u8_host is its host twin)
__device__ __forceinline__ void mma_u8(int32_t* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One constant product (PROD 1: tl p', 2: m p) over the warp's 4 n-tiles:
// every B fragment from X first, then each live A tile once, serving every
// n-tile; the C fragments folded into Y. handel::sep_product_host is its
// host twin.
template <int N, int PROD>
__device__ __forceinline__ void sep_product(const uint32_t* __restrict__ frags,
                                            const uint32_t* xs, uint32_t* ys, int lane) {
  using L = handel::SepLayout<N>;
  constexpr int MT = PROD == 1 ? L::MT1 : L::MT2;
  uint32_t bf[4][L::KS][2];
  HANDEL_UNROLL
  for (int nt = 0; nt < 4; ++nt)
    HANDEL_UNROLL
    for (int ks = 0; ks < L::KS; ++ks) handel::sep_b_frag<N>(xs, nt, ks, lane, bf[nt][ks]);
  HANDEL_UNROLL
  for (int mt = 0; mt < MT; ++mt) {
    int32_t acc[4][4] = {};
    HANDEL_UNROLL
    for (int ks = 0; ks < L::KS; ++ks) {
      if (!handel::sep_tile_live(N, mt, ks)) continue;
      uint32_t af[4];
      handel::sep_a_frag(frags, handel::sep_tile_index(N, PROD, mt, ks), lane, af);
      HANDEL_UNROLL
      for (int nt = 0; nt < 4; ++nt) mma_u8(acc[nt], af, bf[nt][ks]);
    }
    HANDEL_UNROLL
    for (int nt = 0; nt < 4; ++nt) handel::sep_store_c<N>(ys, nt, mt, lane, acc[nt]);
  }
}

// Kernel B3a: one thread a column. The occupancy hint (20 warps an SM at
// N = 24, at most 102 registers a thread; 28 at N = 16) costs no spill and
// took 3% off its time on the H100 (PERF.md §6).
template <int N, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, (N == 24 ? 20 : 28) / kWarps)
    lab_cios_fullwidth_kernel(const int32_t* __restrict__ a, int64_t lda,
                              const int32_t* __restrict__ b, int64_t ldb,
                              int32_t* __restrict__ out, int64_t ldo, int64_t cols,
                              handel::LabParams prm) {
  const int64_t j = (int64_t)blockIdx.x * (kWarps * 32) + threadIdx.x;
  if (j >= cols) return;
  uint32_t x[N], y[N], r[N];
  handel::lab_load_column<N>(a, lda, j, x);
  handel::lab_load_column<N>(b, ldb, j, y);
  handel::lab_cios_fullwidth<N>(x, y, prm, r);
  handel::lab_store_column<N>(out, ldo, j, r);
}

// Kernel B3b: a warp on 32 columns (handel::lab_separated_warp_host is its
// host twin).
template <int N, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    lab_separated_kernel(const int32_t* __restrict__ a, int64_t lda,
                         const int32_t* __restrict__ b, int64_t ldb,
                         int32_t* __restrict__ out, int64_t ldo, int64_t cols,
                         const uint32_t* __restrict__ frags, handel::LabParams prm) {
  using L = handel::SepLayout<N>;
  extern __shared__ __align__(16) uint32_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  if (col0 >= cols) return;  // the whole warp
  uint32_t* xs = sm + warp * L::words + L::X;
  uint32_t* ys = sm + warp * L::words + L::Y;
  const int64_t j = col0 + lane;
  const bool live = j < cols;
  uint32_t c[2 * N];
  {
    // a lane past the last column computes on the last column (its column
    // of each product is its own) and stores nothing: no load is predicated
    uint32_t x[N], y[N];
    handel::lab_load_column<N>(a, lda, live ? j : cols - 1, x);
    handel::lab_load_column<N>(b, ldb, live ? j : cols - 1, y);
    handel::sep_lane_products<N>(x, y, c, xs, lane);
  }
  __syncwarp();  // every lane's tl bytes are in X
  sep_product<N, 1>(frags, xs, ys, lane);
  __syncwarp();  // product 1's sums are in Y; every lane has read X
  handel::sep_lane_quotient<N>(ys, xs, lane);
  __syncwarp();  // every lane's m bytes are in X; every lane has read Y
  sep_product<N, 2>(frags, xs, ys, lane);
  __syncwarp();  // product 2's sums are in Y
  uint32_t r[N];
  handel::sep_lane_finish<N>(c, ys, prm, lane, r);
  if (live) handel::lab_store_column<N>(out, ldo, j, r);
}

template <int N, int kWarps>
int launch_cios(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb, int32_t* out,
                int64_t ldo, int64_t cols, const handel::LabParams& prm, cudaStream_t s) {
  constexpr int T = kWarps * 32;
  const dim3 grid((unsigned)((cols + T - 1) / T));
  lab_cios_fullwidth_kernel<N, kWarps><<<grid, T, 0, s>>>(a, lda, b, ldb, out, ldo, cols, prm);
  return (int)cudaGetLastError();
}

template <int N, int kWarps>
int launch_separated(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb,
                     int32_t* out, int64_t ldo, int64_t cols, const uint32_t* frags,
                     const handel::LabParams& prm, cudaStream_t s) {
  constexpr int T = kWarps * 32;
  constexpr int bytes = kWarps * handel::SepLayout<N>::words * 4;
  auto kernel = lab_separated_kernel<N, kWarps>;
  // once per instance, at its first (eager) call: above 48 KB of dynamic
  // shared memory a kernel must opt in
  static bool ready = false;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid((unsigned)((cols + T - 1) / T));
  kernel<<<grid, T, bytes, s>>>(a, lda, b, ldb, out, ldo, cols, frags, prm);
  return (int)cudaGetLastError();
}

template <int N, int kWarps>
int launch_form(int form, const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb,
                int32_t* out, int64_t ldo, int64_t cols, const uint32_t* frags,
                const handel::LabParams& prm, cudaStream_t s) {
  if (form == 0) return launch_cios<N, kWarps>(a, lda, b, ldb, out, ldo, cols, prm, s);
  if (form == 1)
    return launch_separated<N, kWarps>(a, lda, b, ldb, out, ldo, cols, frags, prm, s);
  return (int)cudaErrorInvalidValue;
}

template <int N>
int launch_warps(int form, int warps, const int32_t* a, int64_t lda, const int32_t* b,
                 int64_t ldb, int32_t* out, int64_t ldo, int64_t cols,
                 const uint32_t* frags, const handel::LabParams& prm, cudaStream_t s) {
  switch (warps) {
    case 1:
      return launch_form<N, 1>(form, a, lda, b, ldb, out, ldo, cols, frags, prm, s);
    case 2:
      return launch_form<N, 2>(form, a, lda, b, ldb, out, ldo, cols, frags, prm, s);
    case 4:
      return launch_form<N, 4>(form, a, lda, b, ldb, out, ldo, cols, frags, prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (handel_tpu_torch/kernels/lab_mont.py). form 0 launches B3a
// (cios_fullwidth), 1 launches B3b (separated). Launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched); it allocates
// nothing and never synchronises, so a CUDA graph can capture it. cols == 0
// launches nothing. nlimbs16 must be 16 or 24, warps 1, 2 or 4; p holds
// nlimbs16 16-bit digits, n0 = -p^-1 mod 2^16; frags (B3b only; 16-byte
// aligned) is the field's fragment table (lab_mont.cuh, SepLayout).
extern "C" int handel_lab_mont_mul(int form, const int32_t* a, int64_t lda,
                                   const int32_t* b, int64_t ldb, int32_t* out,
                                   int64_t ldo, int64_t cols, int nlimbs16,
                                   const uint32_t* p, uint32_t n0,
                                   const uint32_t* frags, int warps, void* stream) {
  if (cols == 0) return 0;
  if (nlimbs16 > handel::kLabMaxDigits) return (int)cudaErrorInvalidValue;
  if (form == 1 && (uintptr_t)frags % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const handel::LabParams prm = handel::lab_params(nlimbs16, p, n0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nlimbs16) {
    case 16:
      return launch_warps<16>(form, warps, a, lda, b, ldb, out, ldo, cols, frags, prm, s);
    case 24:
      return launch_warps<24>(form, warps, a, lda, b, ldb, out, ldo, cols, frags, prm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of B3b takes, in bytes (0 for an instance
// that does not exist); for the build report.
extern "C" int handel_lab_smem_bytes(int nlimbs16, int warps) {
  if (warps != 1 && warps != 2 && warps != 4) return 0;
  if (nlimbs16 == 16) return warps * handel::SepLayout<16>::words * 4;
  if (nlimbs16 == 24) return warps * handel::SepLayout<24>::words * 4;
  return 0;
}
