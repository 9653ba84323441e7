// Hopper kernel B2: resident RNS Montgomery multiplication.
//
// Replaces the TPU kernel RnsField._mul_resident_pallas (pallas_call at
// handel_tpu/ops/rns.py:571, body RnsField._mul_resident_core :518-530):
// every product of the residue-resident pairing of the rns field backend.
// Each stacked tower multiply (an Fp12 multiply is 54x the batch wide) is
// one call.
//
// What bounds it on an H100: per column it reads 2 K and writes K int32
// residues (552 bytes for BN254, K = 46; 780 for BLS12-381, K = 65). The
// reference's steps take about 1,200 (BN254) or 2,300 (BLS12-381) integer
// multiply-adds a column, most of them the two constant-matrix contractions,
// and about 250 or 350 modular reductions; with a float quotient estimate
// each takes two int/float conversions, which the card runs at a quarter of
// its integer rate. On the CUDA cores alone that sits at the byte bound or
// above it, and the verify
// path's calls are narrow (13,824 columns for an Fp12 multiply at 128
// lanes): one thread per column left 24 SMs idle, four warps on each of the
// others, and every column to one thread's serial chain.
//
// Design (the arithmetic and the lane layout are in rns_mont.cuh):
//   - A warp owns tiles of 8 or 16 columns (one or two mma n-tiles): 4
//     lanes a column, each with a quarter of its residues. At 13,824
//     columns 8-column tiles are 1,728 warp tiles, 13 warps on each SM;
//     wide calls take 16-column tiles, whose two n-tiles share each row's
//     constants and each matrix fragment and give every lane twice the
//     independent work. The wrapper's width rule picks (kernels/rns_mont.py
//     `tile_for`, measured: PERF.md).
//   - The two contractions run on the int8 tensor cores: mma.sync m16n8k32
//     products of 7-bit planes (the reference's `int8_dots` form), four per
//     16-row tile, 32 of depth and n-tile, recombined exactly in uint32. The
//     lanes' residue-wise work follows the mma fragments, so xi goes from
//     the reductions straight into the B fragment's registers and step 3's
//     sums are reduced where the C fragment leaves them; only xi' is
//     transposed, through a few hundred bytes of the warp's shared memory.
//   - The reductions are exact Barrett reductions (a high multiply, a
//     multiply-subtract and one conditional subtraction, no int/float
//     conversion), cut from 252 to 161 a column (BN254) by folding
//     constants; the L_mr sum of step 6 rides step 7's contraction as one
//     more matrix row. A row's modulus, Barrett factor and two constants
//     come in one 16-byte shared-memory load.
//   - Operands arrive by cp.async: 16-byte copies where the row bases and
//     strides allow, 4-byte copies otherwise (row slices at any column
//     offset), zero-filled past the edge. The grid is persistent (up to 4
//     blocks of 4 warps an SM); each warp walks its tiles with a
//     three-stage ring, the next two tiles' copies in flight while the
//     current one is computed, and the constant table (with the matrices'
//     int8 planes) comes into shared memory once per block, in flight with
//     the first tiles.
//   - The output tile is written back from shared memory, whole rows of the
//     warp's tile a store: whole 32-byte sectors. The row stride is an
//     argument, so row slices launch without a copy.
//   - Nothing synchronises across warps after the table: a warp's tiles,
//     copies and exchanges are its own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rns_mont.cuh"

namespace {

constexpr int kMaxBlocksPerSm = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// c += a . b on the int8 tensor cores: one m16n8k32 product, int32 sums
// (handel::mma_host is its host twin)
__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A contraction for this lane: the sums of plane rows 16 mt .. of `lo`/`hi`
// (rows of P bytes) against the warp's B fragments of each n-tile,
// recombined, in C fragment order. Each A fragment serves every n-tile.
template <int NT, int MT, int KS>
__device__ __forceinline__ void contract(const int8_t* lo, const int8_t* hi, int P,
                                         const uint32_t (&xlo)[NT][KS][2],
                                         const uint32_t (&xhi)[NT][KS][2], int lane,
                                         uint32_t (&out)[NT][MT][4]) {
  HANDEL_UNROLL
  for (int mt = 0; mt < MT; ++mt) {
    int32_t ll[NT][4] = {}, mid[NT][4] = {}, hh[NT][4] = {};
    HANDEL_UNROLL
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t al[4], ah[4];
      handel::load_a_frag(lo, P, mt, ks, lane, al);
      handel::load_a_frag(hi, P, mt, ks, lane, ah);
      HANDEL_UNROLL
      for (int n = 0; n < NT; ++n) {
        mma_s8(ll[n], al, xlo[n][ks]);
        mma_s8(mid[n], al, xhi[n][ks]);
        mma_s8(mid[n], ah, xlo[n][ks]);
        mma_s8(hh[n], ah, xhi[n][ks]);
      }
    }
    HANDEL_UNROLL
    for (int n = 0; n < NT; ++n)
      HANDEL_UNROLL
      for (int e = 0; e < 4; ++e) out[n][mt][e] = handel::recombine(ll[n][e], mid[n][e], hh[n][e]);
  }
}

// Columns col0 .. col0 + N - 1 of a and b into one stage of the warp's
// ring, asynchronously; columns past `cols` are zero-filled.
template <int KA, int KB, int NT>
__device__ __forceinline__ void stage_tile(uint32_t* st, const int32_t* __restrict__ a,
                                           int64_t lda, const int32_t* __restrict__ b,
                                           int64_t ldb, int64_t col0, int64_t cols, bool vec,
                                           int lane) {
  using WL = handel::WarpLayout<KA, KB, NT>;
  constexpr int K = WL::L::K, TS = WL::TS, N = WL::N;
  const int64_t live = cols - col0 < N ? cols - col0 : N;
  uint32_t* sa = st;
  uint32_t* sb = st + K * TS;
  if (vec) {
    // lane: row lane / (N/4) + (32/(N/4)) k, the 4 columns from (lane % (N/4)) * 4
    constexpr int CH = N / 4, RP = 32 / CH;
    const int n = (lane % CH) * 4;
    const int64_t left = live - n;
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0);
    const int i0 = lane / CH;
    const int32_t* pa = a + i0 * lda + col0 + n;
    const int32_t* pb = b + i0 * ldb + col0 + n;
    for (int i = i0; i < K; i += RP, pa += RP * lda, pb += RP * ldb) {
      cp_async16(sa + i * TS + n, bytes ? pa : a, bytes);
      cp_async16(sb + i * TS + n, bytes ? pb : b, bytes);
    }
  } else {
    // lane: row lane / N + (32/N) k, column lane % N
    constexpr int RP = 32 / N;
    const int n = lane % N;
    const int bytes = n < live ? 4 : 0;
    const int i0 = lane / N;
    const int32_t* pa = a + i0 * lda + col0 + n;
    const int32_t* pb = b + i0 * ldb + col0 + n;
    for (int i = i0; i < K; i += RP, pa += RP * lda, pb += RP * ldb) {
      cp_async4(sa + i * TS + n, bytes ? pa : a, bytes);
      cp_async4(sb + i * TS + n, bytes ? pb : b, bytes);
    }
  }
}

// Block sizes: a block is 4 warps; `T` (columns a block covers at a time)
// sets the warp's tile, 8 (one n-tile) or 16 columns (two).
constexpr int kWarps = 4;

// At most 128 registers a thread for 4 blocks an SM at one n-tile a warp,
// 168 for 3 at two.
template <int KA, int KB, int T>
__global__ void __launch_bounds__(kWarps * 32, T == 32 ? 4 : 3)
    rns_mul_resident_kernel(const int32_t* __restrict__ a, int64_t lda,
                            const int32_t* __restrict__ b, int64_t ldb,
                            int32_t* __restrict__ out, int64_t ldo, int64_t cols,
                            const int32_t* __restrict__ consts, bool vec) {
  constexpr int NT = T / (8 * kWarps), WARPS = kWarps;
  using L = handel::RnsLayout<KA, KB>;
  using WL = handel::WarpLayout<KA, KB, NT>;
  using AS = handel::AlphaSources<KA, KB>;
  using BL = handel::BlockLayout<KA, KB, NT, WARPS>;
  constexpr int K = L::K, TS = WL::TS;
  constexpr unsigned kAll = 0xFFFFFFFFu;
  extern __shared__ __align__(16) uint32_t sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* ws = sm + BL::warp0 + warp * WL::words;
  int8_t* xplo = reinterpret_cast<int8_t*>(ws + WL::xp);
  int8_t* xphi = xplo + WL::N * WL::PX;
  const uint32_t* c = sm;
  const int8_t* w = reinterpret_cast<const int8_t*>(sm);
  const int64_t tiles = (cols + WL::N - 1) / WL::N;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  int64_t tile = (int64_t)blockIdx.x * WARPS + warp;

  // the constant table (16-byte aligned, a whole number of 16-byte pieces)
  // and this warp's first STAGES - 1 tiles, in flight together: one copy
  // group each
  for (int i = 4 * threadIdx.x; i < L::size; i += 4 * WARPS * 32) cp_async16(sm + i, consts + i, 16);
  cp_async_commit();
  HANDEL_UNROLL
  for (int k = 0; k + 1 < WL::STAGES; ++k) {
    const int64_t pre = tile + k * stride;
    if (pre < tiles)
      stage_tile<KA, KB, NT>(ws + k * WL::stage, a, lda, b, ldb, pre * WL::N, cols, vec, lane);
    cp_async_commit();
  }
  cp_async_wait<WL::STAGES - 1>();  // this thread's table copies have landed
  __syncthreads();                  // (every thread's)

  for (int s = 0; tile < tiles; tile += stride, s = s + 1 < WL::STAGES ? s + 1 : 0) {
    // the tile STAGES - 1 ahead into the stage the last tile left
    const int64_t ahead = tile + (WL::STAGES - 1) * stride;
    const int sa = s == 0 ? WL::STAGES - 1 : s - 1;
    if (ahead < tiles)
      stage_tile<KA, KB, NT>(ws + sa * WL::stage, a, lda, b, ldb, ahead * WL::N, cols, vec, lane);
    cp_async_commit();
    cp_async_wait<WL::STAGES - 1>();  // this tile's copies have landed (this lane's)
    __syncwarp();                     // (every lane's)
    uint32_t* ta = ws + s * WL::stage;  // operands, then the output tile
    const uint32_t* tb = ta + K * TS;

    handel::LaneRegs<KA, KB, NT> r;
    handel::lane_products(r, c, ta, tb, lane);
    contract<NT, L::MT3, L::KS3>(w + 4 * L::Elo, w + 4 * L::Ehi, L::P3, r.xlo, r.xhi, lane, r.s3);
    __syncwarp();  // every lane has read its operands: the stage takes the output
    handel::lane_quotient(r, c, ta, xplo, xphi, lane);
    __syncwarp();
    handel::lane_load_digits(r, xplo, xphi, lane);
    contract<NT, L::MT7, L::KS7>(w + 4 * L::E2lo, w + 4 * L::E2hi, L::P7, r.ylo, r.yhi, lane, r.s7);
    uint32_t smr[NT][2], rmr[NT][2];
    HANDEL_UNROLL
    for (int n = 0; n < NT; ++n)
      HANDEL_UNROLL
      for (int e = 0; e < 2; ++e) {
        smr[n][e] = __shfl_sync(kAll, r.s7[n][AS::mt7][2 * AS::s7 + e], 4 * AS::g7 + (lane & 3));
        rmr[n][e] = __shfl_sync(kAll, r.d[n][AS::mt3][AS::s3][e], 4 * AS::g3 + (lane & 3));
      }
    handel::lane_extend(r, c, ta, smr, rmr, lane);
    __syncwarp();

    // the output tile: a warp store covers 32 / N rows of N columns
    const int64_t col0 = tile * WL::N;
    const int live = cols - col0 < WL::N ? (int)(cols - col0) : WL::N;
    const int n = lane % WL::N;
    if (n < live)
      for (int i = lane / WL::N; i < K; i += 32 / WL::N)
        out[i * ldo + col0 + n] = (int32_t)ta[i * TS + n];
    __syncwarp();  // the stage is refilled at the next tile
  }
  cp_async_wait<0>();
}

template <int KA, int KB, int T>
int launch(const int32_t* a, int64_t lda, const int32_t* b, int64_t ldb, int32_t* out,
           int64_t ldo, int64_t cols, const int32_t* consts, cudaStream_t s) {
  constexpr int NT = T / (8 * kWarps), WARPS = kWarps;
  using BL = handel::BlockLayout<KA, KB, NT, WARPS>;
  auto kernel = rns_mul_resident_kernel<KA, KB, T>;
  // set up once per instance, at its first (eager) call: the shared memory
  // attribute, and the blocks per SM the occupancy allows
  static int per_sm = 0;
  static int sms = 0;
  if (per_sm == 0) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BL::bytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, n = 0, p = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kernel, WARPS * 32, BL::bytes)) !=
        cudaSuccess)
      return (int)e;
    if (p < 1) return (int)cudaErrorInvalidConfiguration;
    sms = n;
    per_sm = p < kMaxBlocksPerSm ? p : kMaxBlocksPerSm;
  }
  const int64_t blocks = (cols + T - 1) / T;
  const int64_t resident = (int64_t)per_sm * sms;
  const dim3 grid((unsigned)(blocks < resident ? blocks : resident));
  // 16-byte copies need 16-byte aligned row bases: aligned pointers and
  // row strides that are whole multiples of 4 elements
  const bool vec = ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0) && (lda % 4 == 0) &&
                   (ldb % 4 == 0);
  kernel<<<grid, WARPS * 32, BL::bytes, s>>>(a, lda, b, ldb, out, ldo, cols, consts, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes
// (handel_tpu_torch/kernels/rns_mont.py). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched). cols == 0 launches
// nothing. (kA, kB) must be (24, 21) (BN254) or (34, 30) (BLS12-381);
// `consts` is the field's device constant table (handel::RnsLayout), 16-byte
// aligned; `tile` (columns a block of 4 warps covers at a time: 8 or 16 a
// warp) must be 32 or 64.
extern "C" int handel_rns_mul_resident(const int32_t* a, int64_t lda,
                                       const int32_t* b, int64_t ldb,
                                       int32_t* out, int64_t ldo, int64_t cols,
                                       int ka, int kb, const int32_t* consts,
                                       int tile, void* stream) {
  if (cols == 0) return 0;
  if ((uintptr_t)consts % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (ka == 24 && kb == 21 && tile == 32)
    return launch<24, 21, 32>(a, lda, b, ldb, out, ldo, cols, consts, s);
  if (ka == 24 && kb == 21 && tile == 64)
    return launch<24, 21, 64>(a, lda, b, ldb, out, ldo, cols, consts, s);
  if (ka == 34 && kb == 30 && tile == 32)
    return launch<34, 30, 32>(a, lda, b, ldb, out, ldo, cols, consts, s);
  if (ka == 34 && kb == 30 && tile == 64)
    return launch<34, 30, 64>(a, lda, b, ldb, out, ldo, cols, consts, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of one instance takes, in bytes (0 for an
// instance that does not exist); for the build report.
extern "C" int handel_rns_smem_bytes(int ka, int kb, int tile) {
  if (ka == 24 && kb == 21 && tile == 32) return handel::BlockLayout<24, 21, 1, kWarps>::bytes;
  if (ka == 24 && kb == 21 && tile == 64) return handel::BlockLayout<24, 21, 2, kWarps>::bytes;
  if (ka == 34 && kb == 30 && tile == 32) return handel::BlockLayout<34, 30, 1, kWarps>::bytes;
  if (ka == 34 && kb == 30 && tile == 64) return handel::BlockLayout<34, 30, 2, kWarps>::bytes;
  return 0;
}
