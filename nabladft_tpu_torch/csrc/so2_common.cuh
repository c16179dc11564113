// Device code shared by the SO(2) message kernels (csrc/escn_layer.cu, kernels M and N;
// csrc/eqv2_attn.cu, kernels O and P), QHNet's gate products (csrc/qhnet_tp.cu, I-L),
// PaiNN's radial products (csrc/painn_fused.cu, A-D) and SchNet's backward products
// (csrc/schnet_fused.cu, F and H): each source includes it and builds its own copy.
//
// The product engine: every SO(2) product of M-P, on Hopper's tensor cores.
//   * so2_mma_kernel: a grouped product over a list of rows (the live pairs or edges of a
//     batch): C[e, n] = sum over segments of sign * A[row(e), k] B[k, n] (B as [K, N] or
//     transposed), with a store, bias (+ silu) or (bias +) gate-multiply epilogue and an
//     optional row gather (A) or scatter (C) through the row list;
//   * so2_mmw_kernel + so2_reduce_kernel: weight gradients out[m, n] = sum over the rows of
//     A[e, m] B[e, n], as partial tiles over a split of the rows sized from the tile count
//     (so that the blocks fill the SMs' last wave), summed in a fixed order; so2_colsum_kernel +
//     so2_colsum_reduce_kernel the same for the column sums (bias and LayerNorm gradients).
//     No atomics: the same bits every run;
//   * so2_prep_kernel: each weight segment of a launch as K-major TF32 halves (hi, lo);
// and, beside the engine, live_rows (the live rows from 0/1 flags, in slot order, with the
// first row of each segment of slots: a count, a one-block scan of the counts and a list by
// ballot) and the pair rows of slots listed by sender, the warp sums of the per-sender
// stages, the m-major row tables of the truncated SO(3) stacks
// (compile-time in L, M), the staging of the truncated S2 grid's tables in shared memory,
// and silu on that grid (one channel's stack in registers) with its transpose.
//
// Precision: 3xTF32, fp32-accurate. x = hi + lo, hi = tf32(x) rounded to nearest
// (cvt.rna), lo = tf32(x - hi); each product is a_hi b_hi + a_hi b_lo + a_lo b_hi on
// wgmma.m64n128k8.tf32 with fp32 accumulators. The dropped a_lo b_lo is ~2^-22 of |a b|
// (one-pass TF32 keeps ~2^-11). Three tensor-core passes run at 495 / 3 TFLOP/s on an H100
// SXM, against 67 for fp32 FMA on the CUDA cores.
// bfloat16 A operands (a segment's `abf16`, gathered rows only: PaiNN's bf16 mode) are read
// as bf16 straight from device memory (8-byte cp.async chunks into a bf16 tile) and widened
// in the fragment loads: a bf16 value is a TF32 value whose lo half is zero. A segment whose
// B values are also exact in TF32 (`one`: bf16 weights held as fp32) runs one pass, a_hi
// b_hi: the other two passes' products, a_hi b_lo and a_lo b_hi, are exactly zero there.
// The bf16-rounding operand mode (a segment's `rbf16`, or every segment of an Engine whose
// `rbf16` is set: M-P's mxu_bf16 mode, the TPU kernels' `_mdot(a, b, True)`) rounds both
// operands of a product to bf16, nearest-even (cvt.rn.bf16.f32, as astype(bfloat16)): A at
// its fragment load, B in the prep (products) or in the transposer warps (weight
// gradients), each written as a TF32 value with lo = 0; so it runs the one pass, exactly the
// product of the rounded values, summed in fp32 as every other mode.
// The bf16 operand mode (an Engine's `b16`: M-P's mxu_bf16 mode where the kernels write their
// products' operands as bf16) runs on Hopper's bf16 tensor cores, at twice the TF32 rate on
// tiles of twice the k: operands are bf16 in device memory and in shared memory, a stage is
// 64 k (128 bytes, the same 128-byte swizzle), and each k16 step is one
// wgmma.m64n128k16.f32.bf16.bf16 with both operands read from shared memory through
// descriptors (so2_mma16_kernel, so2_mmw16_kernel). A bf16 x bf16 product is exact in fp32,
// so the mode gives `rbf16`'s products of the same rounded values, summed in another order.
//   * products: so2_prep_kernel writes B once per launch as one K-major bf16 copy (rounded
//     nearest-even); A comes by TMA (a bf16 box) or, gathered, by cp.async in 16-byte chunks
//     of 8 values, swizzled by hand. A is not loaded to registers: the tensor cores read it
//     from shared memory, so the consumers spend no instructions or registers on fragments
//     and hold only the two accumulators. A segment's sign is applied where its stage's sum
//     is added to the total (tot += sign * acc, exact): no negated copy of B, no per-value
//     sign flips.
//   * weight gradients: both operands are [rows, .] bf16 and come by TMA as raw [64 rows][64
//     values] boxes; wgmma reads them as MN-major operands (its transpose bits, 16-bit types
//     only), so this mode needs no transposer warps and no padded tile. Rows past a split's
//     end (its last stage only) are zeroed in shared memory before the stage's wgmmas.
//   * K and the row strides are multiples of 8 values (16-byte rows), checked on the host.
// The 128 x 128 tile stays: a 256-wide one would need a warpgroup's stage sum and its total
// in 2 x 128 registers a thread, past the 255 a thread may hold.
//
// A block: two consumer warpgroups, each 64 rows of the 128 x 128 tile (one m64 block), and
// one producer warp, over a ring of STAGES k tiles of 32 (128 bytes of fp32) in dynamic
// shared memory, synchronised by full / empty mbarriers. The tensor cores round their sums
// toward zero, an error that grows with K (on an H100, 3e-4 of the output's scale for sums
// over ~20k rows); so
// each stage's 12 wgmmas sum from zero into one accumulator, which is then added, rounded
// to nearest, into a second one in registers (128 of them a thread).
// wgmma.tf32 reads only K-major operands from shared memory, so:
//   * products: A (rows of K) is K-major as stored. It comes by TMA (a 2-D box of 128 rows,
//     128-byte swizzle) or, for gathered rows (TMA has no row gather), by cp.async (16
//     bytes a thread, the same swizzle written by hand). The consumers load their A
//     fragments to registers (conflict-free under the swizzle), apply the segment's sign
//     and split them there; wgmma takes A from registers. B (the weights, a few MB) is
//     written once per launch by so2_prep_kernel as [2][N][K] (hi, lo: K-major whether the
//     segment reads B as [K, N] or transposed) and comes by TMA (3-D box, 128-byte swizzle)
//     to feed wgmma's shared-memory descriptor directly.
//   * weight gradients: both operands are [rows, .] with K = the rows. A comes by cp.async
//     into a padded [32][128 + 8] tile (gathered or not), which makes the fragment loads
//     conflict-free (TMA cannot pad); B's raw [32][128] tile comes by TMA, and three
//     transposer warps turn it into a K-major swizzled (hi, lo) tile for the descriptor,
//     a stage ahead of the consumers (a third mbarrier per stage says it is written).
// Products walk GROUP row tiles per column tile before the next, so that the A rows and the
// weight tiles in flight both stay in L2. A launch of small K (QHNet's gates, K = 8-128) may
// run persistent: one block per SM strides over the tiles, the ring running on from tile to
// tile. The epilogue loads a row's bias and gate values together before it uses them. Every
// product takes K and N multiples of 4, with 16-byte aligned rows; the host checks it. A k tile
// that runs past K (PaiNN's R = 100) reads zeros there on both sides: TMA fills a box past the
// tensor with zeros, and the gather copies no 16-byte chunk that starts at or past K.

#pragma once

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled (reached at run time)
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <vector>

namespace {

constexpr int BM = 128;         // rows of a product tile (weight gradients: its m)
constexpr int BN = 128;         // columns of a tile (the wgmma n)
constexpr int BK = 32;          // k of a stage: 128 bytes of fp32, one 128-byte swizzle row
constexpr int STAGES = 4;       // the ring's depth
constexpr int GT = 288;         // threads: consumer warpgroups 0, 1 and the producer warp 8
constexpr int GTW = 384;        // weight gradients: the same, and transposer warps 9-11
constexpr int WSTAGES = 3;      // the weight-gradient ring's depth
constexpr int APAD = BM + 8;    // a weight-gradient A row in shared memory (floats)
constexpr int GROUP = 16;       // row tiles a column tile takes before the next
constexpr int SMS = 132;        // the H100 SXM's multiprocessors (the row split's target)
constexpr int MAX_SPLIT_BLOCKS = 8 * SMS;  // most blocks a split launch takes
constexpr int CS_SPLIT = 64;    // most row splits of the column sums
constexpr int NN_MAXP = 8;      // problems per product launch
constexpr int TN_MAXP = 10;     // problems per weight-gradient launch
constexpr int MAXSEG = 4;
constexpr int RT = 128;         // threads of the per-receiver kernels (one channel each)

constexpr int A_TILE = BM * BK * 4;    // bytes of a product A tile
constexpr int B_TILE = BN * BK * 4;    // bytes of one B tile (hi or lo, or a raw wgrad B)
constexpr int AW_TILE = BK * APAD * 4;  // bytes of a weight-gradient A tile
constexpr int MMA_SMEM = 1024 + STAGES * (A_TILE + 2 * B_TILE) + 2 * STAGES * 8 + BM * 4;
constexpr int MMW_SMEM = 1024 + WSTAGES * (3 * B_TILE + AW_TILE) + 3 * WSTAGES * 8;
// the bf16 operand mode
constexpr int BK16 = 64;                // k of a stage: 128 bytes of bf16
constexpr int STAGES16 = 6;             // its rings' depth
constexpr int TILE16 = BM * BK16 * 2;   // bytes of an A or B tile (BM == BN)
constexpr int BOX16 = TILE16 / 2;       // a weight-gradient box: [64 rows][64 values]
constexpr int MMA16_SMEM = 1024 + STAGES16 * 2 * TILE16 + 2 * STAGES16 * 8 + BM * 4;
constexpr int MMW16_SMEM = 1024 + STAGES16 * 2 * TILE16 + 2 * STAGES16 * 8;

enum { EPI_STORE = 0, EPI_GATES = 1, EPI_GATED = 2 };

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }
__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.f / (1.f + expf(-z));
  return s * (1.f + z * (1.f - s));
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, cp.async, TF32 and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}
// one arrival on b once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(b))
               : "memory");
}
// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 8 bytes (four bf16 values) global -> shared, as cp_async16
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// a bf16 value (its bits) as the fp32 value it is
__device__ __forceinline__ float bf16_bits(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}
// x rounded to bf16, nearest-even (cvt.rn, as astype(bfloat16)): its bits
__device__ __forceinline__ uint16_t bf16_rn(float x) {
  uint16_t h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return h;
}
// x rounded to bf16, nearest-even, as the fp32 value it is
__device__ __forceinline__ float round_bf16(float x) { return bf16_bits(bf16_rn(x)); }
// an output element: float32, or (B16) its bf16 rounding, nearest-even
template <bool B16>
__device__ __forceinline__ void put(void* p, long long i, float v) {
  if constexpr (B16)
    static_cast<uint16_t*>(p)[i] = bf16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both TF32 (lo carries the 13 bits hi drops, rounded to 11)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// the bf16-rounding mode's operand: hi = x rounded to bf16 (exact in TF32), lo = 0
__device__ __forceinline__ void round_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(round_bf16(x));
  lo = 0u;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// pin registers that an asynchronous wgmma reads or writes: the compiler may not move or
// reuse them across this point
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// shared-memory descriptor of a K-major [rows][32 fp32] tile, 128-byte swizzle (1024-byte
// aligned): 8-row groups 1024 bytes apart; the k8 step j of the tile is desc + 2 j
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// shared-memory descriptor of an MN-major operand of 16-bit values (the bf16 weight
// gradients): boxes of [rows (k)][64 values (m or n)], 128 bytes a row, 128-byte swizzle,
// `lbo` bytes from one box to the next along m or n; 8-row groups of k 1024 bytes apart; the
// k16 step j is desc + 128 j (2048 bytes)
__device__ __forceinline__ uint64_t desc_mn128(const void* tile, uint32_t lbo) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// d[64x128] = A[64x16] B[16x128] + (acc ? d : 0), bf16 operands in shared memory through
// descriptors (TRANS 0: both K-major; 1: both MN-major), fp32 sums
template <int TRANS>
__device__ __forceinline__ void mma_bf16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS));
}

// d[64x128] = A[64x8] (registers, TF32) B[8x128] (shared, K-major TF32) + (acc ? d : 0)
__device__ __forceinline__ void mma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// one k8 step of a warpgroup's m64 block, 3xTF32: 3 wgmmas on the B halves' descriptors
// (`one`: a_hi b_hi alone, for operands exact in TF32); `first` starts the stage's sum from
// zero
__device__ __forceinline__ void mma3(float (&acc)[64], uint32_t (&ah)[4], uint32_t (&al)[4],
                                     uint64_t dh, uint64_t dl, bool first, bool one) {
  wg_fence();
  mma_tf32(acc, ah, dh, first ? 0 : 1);
  if (!one) {
    mma_tf32(acc, ah, dl, 1);
    mma_tf32(acc, al, dh, 1);
  }
  wg_commit();
}

// The tensor cores round their sums toward zero, an error that grows with the number of
// sums into one accumulator. So each stage (K = 32: 12 sums) is summed there from zero and
// then added, rounded to nearest, into the fp32 total.
__device__ __forceinline__ void promote(float (&tot)[64], const float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] += acc[i];
}

// the k steps of one stage on a warpgroup's m64 block: fragments of A from shared memory
// (frag(kk, hi, lo) loads and splits the four values of step kk), B's halves through their
// descriptors; the next step's fragments load while this one's wgmmas run
template <typename Frag>
__device__ __forceinline__ void stage_mma(float (&acc)[64], float (&tot)[64], uint64_t dh,
                                          uint64_t dl, Frag frag, bool one = false) {
  uint32_t ah[2][4], al[2][4];  // [buffer][register]
  frag(0, ah[0], al[0]);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int b = kk & 1;
    mma3(acc, ah[b], al[b], dh + 2 * kk, dl + 2 * kk, kk == 0, one);
    if (kk + 1 < BK / 8) frag(kk + 1, ah[b ^ 1], al[b ^ 1]);
    wg_wait0();
    keep(acc);
    keep(ah[b]);
    keep(al[b]);
  }
  promote(tot, acc);
}

// one bf16 stage (64 k) of a warpgroup's m64 block: its four k16 steps summed from zero on
// the tensor cores, then added, times the segment's sign, to the fp32 total, rounded to
// nearest (the same rule as stage_mma's; the negation is exact). `step`: the descriptors'
// advance a k16 step (K-major: 2, 32 bytes; MN-major: 128, 2048 bytes).
template <int TRANS>
__device__ __forceinline__ void stage_mma16(float (&acc)[64], float (&tot)[64], uint64_t da,
                                            uint64_t db, int step, float sign) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK16 / 16; ++kk) mma_bf16<TRANS>(acc, da + kk * step, db + kk * step, kk);
  wg_commit();
  wg_wait0();
  keep(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = fmaf(sign, acc[i], tot[i]);
}

// ---------------------------------------------------------------------------
// products over the live rows: C[e, n] = sum_k A[e, k] B[k, n]
// ---------------------------------------------------------------------------

// a segment as the stages describe it (host)
struct Seg {
  const float* a;  // row e of A at a + row(e) * lda (elements; bf16 ones where abf16)
  const float* b;  // B [K, N] at b + k * ldb + n, or transposed: b + n * ldb + k
  int lda, ldb, k, btrans;
  float sign;
  int abf16;  // A holds bf16 values (gathered rows only)
  int one;    // A and B exact in TF32: one pass (a_hi b_hi)
  int rbf16;  // fp32 A and B, both rounded to bf16: one pass
};

struct NNProb {
  Seg seg[MAXSEG];
  int nseg, gather, scatter, epi, n, ldc, ldc2, ldg;
  float* c;            // EPI_STORE: acc; EPI_GATES: acc + bias; EPI_GATED: v (null: skip)
  float* c2;           // EPI_GATES: silu(acc + bias); EPI_GATED: v * gate (null: skip)
  const float* bias;   // [N]; EPI_GATED: v = acc + bias, or acc where null
  const float* gate;   // row e at gate + e * ldg
};

// a segment as the kernel reads it
struct MMSeg {
  CUtensorMap amap;  // A [max_rows, K], boxes of BM x BK (unused when gathered)
  CUtensorMap bmap;  // the prepped B [2][N][K] (hi, lo), boxes of BN x BK
  const float* a;
  int lda, k;
  float sign;
  int abf16, one, rbf16;
};

struct MMProb {
  MMSeg seg[MAXSEG];
  int nseg, gather, scatter, epi, n, ldc, ldc2, ldg;
  float* c;
  float* c2;
  const float* bias;
  const float* gate;
};

struct MMBatch {
  MMProb p[NN_MAXP];
  int np, tiles;           // column tiles over all problems
  int tile0[NN_MAXP + 1];  // first column tile of each problem
  int jobs;                // the tiles (a persistent launch's blocks stride over them)
};

// tile `id` of a launch: its problem, first row and first column; ids run over (group of
// GROUP row tiles, column tile, row tile in the group)
__device__ __forceinline__ int mm_tile(const MMBatch& bt, int id, int& m0, int& n0) {
  const int per = GROUP * bt.tiles;
  m0 = (id / per * GROUP + id % GROUP) * BM;
  const int ct = id % per / GROUP;
  int pi = 0;
  while (pi + 1 < bt.np && ct >= bt.tile0[pi + 1]) ++pi;
  n0 = (ct - bt.tile0[pi]) * BN;
  return pi;
}

// element (r, k) of a 128-byte-swizzled [BM][BK] tile
__device__ __forceinline__ float a_sw(const float* t, int r, int k) {
  return t[r * BK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3)];
}
// element (r, k) of a gathered bf16 [BM][BK] tile: 8-byte chunks of four values, chunk c of
// row r at c ^ (r & 7) (the fragment loads are conflict-free)
__device__ __forceinline__ float a_sw16(const uint16_t* t, int r, int k) {
  return bf16_bits(t[r * BK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3)]);
}

// the epilogue of a product tile: tot[4i + 2h + q] is row rb + 8 h, column 8 i + 2 t + q. A
// row's bias and gate values are all loaded before any is used, so that their latencies
// overlap (one after another they would cost a tile of small K more than its products)
__device__ __forceinline__ void mm_epilogue(const MMProb& P, const float (&tot)[64], int m0,
                                            int n0, int rb, int t, int nr,
                                            const int* __restrict__ eidx) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + rb + h * 8;
    if (r >= nr) continue;
    const long long orow = P.scatter ? (long long)eidx[r] : (long long)r;
    const int c0 = n0 + 2 * t;  // column of v[i] is c0 + 8 i
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = make_float2(tot[4 * i + 2 * h], tot[4 * i + 2 * h + 1]);
    if (P.epi != EPI_STORE && P.bias) {
      float2 bb[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        bb[i] = c0 + 8 * i < P.n ? *reinterpret_cast<const float2*>(P.bias + c0 + 8 * i)
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = make_float2(v[i].x + bb[i].x, v[i].y + bb[i].y);
    }
    if (P.c) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c0 + 8 * i < P.n) *reinterpret_cast<float2*>(P.c + orow * P.ldc + c0 + 8 * i) = v[i];
    }
    if (P.epi == EPI_STORE || !P.c2) continue;
    if (P.epi == EPI_GATES) {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = make_float2(silu(v[i].x), silu(v[i].y));
    } else {  // gate may be c2 itself: each element read and written by one thread
      const float* gr = P.gate + (long long)r * P.ldg + c0;
      float2 gg[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        gg[i] = c0 + 8 * i < P.n ? *reinterpret_cast<const float2*>(gr + 8 * i)
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = make_float2(v[i].x * gg[i].x, v[i].y * gg[i].y);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (c0 + 8 * i < P.n) *reinterpret_cast<float2*>(P.c2 + orow * P.ldc2 + c0 + 8 * i) = v[i];
  }
}

// One BM x BN tile of one problem a block (blockIdx.x the tile's id, mm_tile), or, PERSIST,
// tiles blockIdx.x, + gridDim.x, ... below bt.jobs, the ring running on from one tile to the
// next (the next tile's loads overlap this one's epilogue). Row tiles past *n_rows are
// skipped. The k tiles of all segments of a tile run as one sequence through the ring.
template <bool PERSIST>
__global__ void __launch_bounds__(GT, 1) so2_mma_kernel(const __grid_constant__ MMBatch bt,
                                                         const int* __restrict__ n_rows,
                                                         const int* __restrict__ eidx) {
  extern __shared__ uint8_t smem_raw[];
  const int nr = *n_rows;
  const int id0 = blockIdx.x, id_end = PERSIST ? bt.jobs : id0 + 1;
  const int stride = PERSIST ? gridDim.x : 1;
  if (!PERSIST) {
    int m0, n0;
    mm_tile(bt, id0, m0, n0);
    if (m0 >= nr) return;
  }

  uint8_t* base = align1024(smem_raw);
  float* As = reinterpret_cast<float*>(base);                       // STAGES x [BM][BK]
  float* Bh = reinterpret_cast<float*>(base + STAGES * A_TILE);     // STAGES x [BN][BK]
  float* Bl = Bh + STAGES * BN * BK;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * (A_TILE + 2 * B_TILE));
  uint64_t* empty = full + STAGES;
  int* ridx = reinterpret_cast<int*>(empty + STAGES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 33);  // the producer's 32 lanes and its expect_tx
      mbar_init(empty + s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    int it = 0;
    for (int id = id0; id < id_end; id += stride) {
      int m0, n0;
      const MMProb& P = bt.p[mm_tile(bt, id, m0, n0)];
      if (m0 >= nr) continue;
      if (P.gather) {
        __syncwarp();  // the previous tile's row list is read
        for (int r = lane; r < BM; r += 32) ridx[r] = m0 + r < nr ? eidx[m0 + r] : -1;
        __syncwarp();
      }
      for (int s = 0; s < P.nseg; ++s) {
        const MMSeg& S = P.seg[s];
        for (int k0 = 0; k0 < S.k; k0 += BK, ++it) {
          const int st = it % STAGES;
          mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
          float* at = As + st * BM * BK;
          if (lane == 0) {
            mbar_expect_tx(full + st, 2 * B_TILE + (P.gather ? 0 : A_TILE));
            tma_3d(Bh + st * BN * BK, &S.bmap, full + st, k0, n0, 0);
            tma_3d(Bl + st * BN * BK, &S.bmap, full + st, k0, n0, 1);
            if (!P.gather) tma_2d(at, &S.amap, full + st, k0, m0);
          }
          if (P.gather) {  // lane: chunk c (four values) of rows lane/8, +4, ...
            const int c = lane & 7;
            const bool k_ok = k0 + c * 4 < S.k;
            if (S.abf16) {  // 8-byte chunks into a bf16 tile
              const uint16_t* a16 = reinterpret_cast<const uint16_t*>(S.a);
              uint16_t* at16 = reinterpret_cast<uint16_t*>(at);
              for (int r = lane >> 3; r < BM; r += 4) {
                const int row = ridx[r];
                const bool ok = k_ok && row >= 0;
                const uint16_t* src = ok ? a16 + (long long)row * S.lda + k0 + c * 4 : a16;
                cp_async8(at16 + r * BK + ((c ^ (r & 7)) << 2), src, ok ? 8 : 0);
              }
            } else {
              for (int r = lane >> 3; r < BM; r += 4) {
                const int row = ridx[r];
                const bool ok = k_ok && row >= 0;
                const float* src = ok ? S.a + (long long)row * S.lda + k0 + c * 4 : S.a;
                cp_async16(at + r * BK + ((c ^ (r & 7)) << 2), src, ok ? 16 : 0);
              }
            }
            cp_async_arrive(full + st);
          } else {
            mbar_arrive(full + st);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumers: warpgroup wg holds rows wg*64 .. +63 of the tile (one m64 block)
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int rb = wg * 64 + (warp & 3) * 16 + g;  // the fragments' first row
  float acc[64], tot[64];
  int it = 0;
  for (int id = id0; id < id_end; id += stride) {
    int m0, n0;
    const MMProb& P = bt.p[mm_tile(bt, id, m0, n0)];
    if (m0 >= nr) continue;
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = 0.f;
    for (int s = 0; s < P.nseg; ++s) {
      const float sign = P.seg[s].sign;
      const int ks = P.seg[s].k;
      const bool a16 = P.seg[s].abf16, one = P.seg[s].one, rnd = P.seg[s].rbf16;
      for (int k0 = 0; k0 < ks; k0 += BK, ++it) {
        const int st = it % STAGES;
        mbar_wait(full + st, (it / STAGES) & 1);
        const float* at = As + st * BM * BK;
        const uint64_t dh = desc_sw128(Bh + st * BN * BK), dl = desc_sw128(Bl + st * BN * BK);
        // the operand mode is chosen once a stage: each fragment loader is branch-free
        if (a16) {
          const uint16_t* at16 = reinterpret_cast<const uint16_t*>(at);
          stage_mma(acc, tot, dh, dl, [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            const int k = kk * 8 + t;
            split_tf32(sign * a_sw16(at16, rb, k), hi[0], lo[0]);
            split_tf32(sign * a_sw16(at16, rb + 8, k), hi[1], lo[1]);
            split_tf32(sign * a_sw16(at16, rb, k + 4), hi[2], lo[2]);
            split_tf32(sign * a_sw16(at16, rb + 8, k + 4), hi[3], lo[3]);
          }, one);
        } else if (rnd) {
          stage_mma(acc, tot, dh, dl, [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            const int k = kk * 8 + t;
            round_tf32(sign * a_sw(at, rb, k), hi[0], lo[0]);
            round_tf32(sign * a_sw(at, rb + 8, k), hi[1], lo[1]);
            round_tf32(sign * a_sw(at, rb, k + 4), hi[2], lo[2]);
            round_tf32(sign * a_sw(at, rb + 8, k + 4), hi[3], lo[3]);
          }, true);
        } else {
          stage_mma(acc, tot, dh, dl, [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            const int k = kk * 8 + t;
            split_tf32(sign * a_sw(at, rb, k), hi[0], lo[0]);
            split_tf32(sign * a_sw(at, rb + 8, k), hi[1], lo[1]);
            split_tf32(sign * a_sw(at, rb, k + 4), hi[2], lo[2]);
            split_tf32(sign * a_sw(at, rb + 8, k + 4), hi[3], lo[3]);
          }, one);
        }
        if (lane == 0) mbar_arrive(empty + st);
      }
    }

    mm_epilogue(P, tot, m0, n0, rb, t, nr, eidx);
  }
}

// The bf16 operand mode's products: one BM x BN tile of one problem a block (blockIdx.x the
// tile's id, mm_tile; row tiles past *n_rows exit), the k tiles of all its segments as one
// sequence through a ring of STAGES16 stages. A [rows, K] and B (the prep's [N][K] copy) are
// bf16, K-major, 128-byte swizzled; each warpgroup's m64 rows of A and the whole B tile go to
// the tensor cores through descriptors.
__global__ void __launch_bounds__(GT, 1) so2_mma16_kernel(const __grid_constant__ MMBatch bt,
                                                           const int* __restrict__ n_rows,
                                                           const int* __restrict__ eidx) {
  extern __shared__ uint8_t smem_raw[];
  const int nr = *n_rows;
  int m0, n0;
  const MMProb& P = bt.p[mm_tile(bt, blockIdx.x, m0, n0)];
  if (m0 >= nr) return;

  uint8_t* base = align1024(smem_raw);
  uint8_t* As = base;                       // STAGES16 x [BM][BK16] bf16
  uint8_t* Bs = base + STAGES16 * TILE16;   // STAGES16 x [BN][BK16] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * STAGES16 * TILE16);
  uint64_t* empty = full + STAGES16;
  int* ridx = reinterpret_cast<int*>(empty + STAGES16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES16; ++s) {
      mbar_init(full + s, 33);  // the producer's 32 lanes and its expect_tx
      mbar_init(empty + s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (P.gather) {
      for (int r = lane; r < BM; r += 32) ridx[r] = m0 + r < nr ? eidx[m0 + r] : -1;
      __syncwarp();
    }
    int it = 0;
    for (int s = 0; s < P.nseg; ++s) {
      const MMSeg& S = P.seg[s];
      for (int k0 = 0; k0 < S.k; k0 += BK16, ++it) {
        const int st = it % STAGES16;
        mbar_wait(empty + st, ((it / STAGES16) & 1) ^ 1);
        uint8_t* at = As + st * TILE16;
        if (lane == 0) {
          mbar_expect_tx(full + st, TILE16 + (P.gather ? 0 : TILE16));
          tma_2d(Bs + st * TILE16, &S.bmap, full + st, k0, n0);
          if (!P.gather) tma_2d(at, &S.amap, full + st, k0, m0);
        }
        if (P.gather) {  // lane: 16-byte chunk c (8 values) of rows lane/8, +4, ...
          const int c = lane & 7;
          const bool k_ok = k0 + c * 8 < S.k;
          const uint16_t* a16 = reinterpret_cast<const uint16_t*>(S.a);
          for (int r = lane >> 3; r < BM; r += 4) {
            const int row = ridx[r];
            const bool ok = k_ok && row >= 0;
            const uint16_t* src = ok ? a16 + (long long)row * S.lda + k0 + c * 8 : a16;
            cp_async16(at + r * 128 + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);
          }
          cp_async_arrive(full + st);
        } else {
          mbar_arrive(full + st);
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumers: warpgroup wg holds rows wg*64 .. +63 of the tile (one m64 block)
  const int wg = warp >> 2, t = lane & 3;
  const int rb = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // the fragments' first row
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  int it = 0;
  for (int s = 0; s < P.nseg; ++s) {
    const float sign = P.seg[s].sign;
    for (int k0 = 0; k0 < P.seg[s].k; k0 += BK16, ++it) {
      const int st = it % STAGES16;
      mbar_wait(full + st, (it / STAGES16) & 1);
      // gathered rows came by cp.async (the generic proxy): order them before wgmma's reads
      if (P.gather) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage_mma16<0>(acc, tot, desc_sw128(As + st * TILE16 + wg * 64 * 128),
                     desc_sw128(Bs + st * TILE16), 2, sign);
      if (lane == 0) mbar_arrive(empty + st);
    }
  }
  mm_epilogue(P, tot, m0, n0, rb, t, nr, eidx);
}

// the B halves of a launch's segments: dst [2][N][K] (hi, lo) from B [K, N] (ld) or, btrans,
// from B^T [N, K] (ld), or, rnd, B rounded to bf16 and lo = 0, or, b16 (the bf16 operand
// mode), one [N][K] copy of B rounded to bf16; one 32 x 32 tile a block, through shared memory
struct PrepJob {
  const float* src;
  float* dst;
  int ld, k, n, btrans, tiles_k, tile0, rnd, b16;
};

struct PrepBatch {
  PrepJob j[NN_MAXP * MAXSEG];
  int nj;
};

__global__ void __launch_bounds__(256) so2_prep_kernel(const __grid_constant__ PrepBatch bt) {
  __shared__ float tile[32][33];  // [n][k]
  int ji = 0;
  while (ji + 1 < bt.nj && (int)blockIdx.x >= bt.j[ji + 1].tile0) ++ji;
  const PrepJob& J = bt.j[ji];
  const int tl = blockIdx.x - J.tile0;
  const int k0 = (tl % J.tiles_k) * 32, n0 = (tl / J.tiles_k) * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    if (J.btrans) {
      const bool ok = n0 + i < J.n && k0 + tx < J.k;
      tile[i][tx] = ok ? J.src[(long long)(n0 + i) * J.ld + k0 + tx] : 0.f;
    } else {
      const bool ok = k0 + i < J.k && n0 + tx < J.n;
      tile[tx][i] = ok ? J.src[(long long)(k0 + i) * J.ld + n0 + tx] : 0.f;
    }
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n >= J.n || k >= J.k) continue;
    if (J.b16) {
      reinterpret_cast<uint16_t*>(J.dst)[(long long)n * J.k + k] = bf16_rn(tile[i][tx]);
      continue;
    }
    uint32_t hi, lo;
    if (J.rnd)
      round_tf32(tile[i][tx], hi, lo);
    else
      split_tf32(tile[i][tx], hi, lo);
    const long long o = (long long)n * J.k + k;
    J.dst[o] = __uint_as_float(hi);
    J.dst[(long long)J.n * J.k + o] = __uint_as_float(lo);
  }
}

// ---------------------------------------------------------------------------
// weight gradients: out[m, n] = sum over the live rows e of A[e, m] B[e, n], as spl partial
// tiles (a split of the rows fixed by the shapes) and a fixed-order sum
// ---------------------------------------------------------------------------

enum { A_ROWS = 0, A_GATHER = 1, A_ONES = 2 };

struct TSeg {
  const float* a;  // row e at a + row(e) * lda (A_GATHER: row(e) = eidx[e]; bf16 where abf16)
  const float* b;  // row e at b + e * ldb
  int lda, ldb;
  float sign;
  int abf16;  // A holds bf16 values
  int rbf16;  // fp32 A and B, both rounded to bf16: one pass
};

struct TNProb {
  TSeg seg[2];
  int nseg, amode, m, n, ldo;
  float* out;
};

struct MWSeg {
  CUtensorMap bmap;  // B [max_rows, N], boxes of BK x BN (no swizzle); b16: 64 x 64, swizzled
  CUtensorMap amap;  // b16: A [max_rows, M], boxes of 64 x 64, swizzled (else unused)
  const float* a;
  int lda;
  float sign;
  int abf16, rbf16;
};

struct MWProb {
  MWSeg seg[2];
  int nseg, gather, m, n, ldo, tiles_n;
  float* out;
  long long part;  // offset of its partial tiles (floats)
};

struct MWBatch {
  MWProb p[TN_MAXP];
  int np, spl;
  int tile0[TN_MAXP + 1];
};

__device__ __forceinline__ int mw_problem(const MWBatch& bt, int t) {
  int pi = 0;
  while (pi + 1 < bt.np && t >= bt.tile0[pi + 1]) ++pi;
  return pi;
}

// the rows [lo, hi) of split sp: chunks of whole k tiles (of KT rows), fixed by n_rows and spl
template <int KT = BK>
__device__ __forceinline__ void split_rows(int nr, int spl, int sp, int& lo, int& hi) {
  const int chunk = ((nr + spl - 1) / spl + KT - 1) / KT * KT;
  lo = min(nr, sp * chunk);
  hi = min(nr, lo + chunk);
}

// a transposer thread's share of a weight-gradient stage: B's raw [BK][BN] tile (rows e0.. of
// the split, zeros at and past hi) -> K-major [BN][BK] hi and lo halves, 128-byte swizzled;
// RND: rounded to bf16, lo = 0
template <bool RND>
__device__ __forceinline__ void transpose_b(const float* raw, float* th, int tt, int e0, int hi) {
  for (int unit = tt; unit < BN * BK / 4; unit += 96) {  // column n, 4 rows from 4c
    const int n = unit & (BN - 1), c = unit >> 7;
    uint32_t h4[4], l4[4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int e = c * 4 + qq;  // rows past the split are zeros
      const float v = e0 + e < hi ? raw[e * BN + n] : 0.f;
      if (RND)
        round_tf32(v, h4[qq], l4[qq]);
      else
        split_tf32(v, h4[qq], l4[qq]);
    }
    const int o = n * BK + ((c ^ (n & 7)) << 2);  // 128-byte swizzle
    *reinterpret_cast<uint4*>(th + o) = make_uint4(h4[0], h4[1], h4[2], h4[3]);
    *reinterpret_cast<uint4*>(th + BN * BK + o) = make_uint4(l4[0], l4[1], l4[2], l4[3]);
  }
}

// a weight-gradient tile's epilogue: out (spl 1) or the split's partial tile
__device__ __forceinline__ void mw_epilogue(const MWBatch& bt, const MWProb& P,
                                            const float (&tot)[64], int tl, int sp, int m0,
                                            int n0, int rb, int t, float* __restrict__ part) {
  float* o = bt.spl > 1 ? part + P.part + ((long long)tl * bt.spl + sp) * BM * BN : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rb + h * 8;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = i * 8 + 2 * t;
      const float2 v = make_float2(tot[4 * i + 2 * h], tot[4 * i + 2 * h + 1]);
      if (o) {
        *reinterpret_cast<float2*>(o + r * BN + col) = v;
      } else if (m0 + r < P.m && n0 + col < P.n) {
        *reinterpret_cast<float2*>(P.out + (long long)(m0 + r) * P.ldo + n0 + col) = v;
      }
    }
  }
}

// One BM x BN tile of out (blockIdx.x over the problems' tiles) over the rows of split
// blockIdx.y; spl 1 writes out, else the partial tile. Warp 8 loads, warps 9-11 transpose
// and split B's tile for wgmma while the consumers multiply the stage before it.
__global__ void __launch_bounds__(GTW, 1) so2_mmw_kernel(const __grid_constant__ MWBatch bt,
                                                          const int* __restrict__ n_rows,
                                                          const int* __restrict__ eidx,
                                                          float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  const int pi = mw_problem(bt, blockIdx.x);
  const MWProb& P = bt.p[pi];
  const int tl = blockIdx.x - bt.tile0[pi], sp = blockIdx.y;
  const int m0 = (tl / P.tiles_n) * BM, n0 = (tl % P.tiles_n) * BN;
  int lo, hi;
  split_rows(*n_rows, bt.spl, sp, lo, hi);
  const int nk = (hi - lo + BK - 1) / BK;  // k tiles of each segment

  uint8_t* base = align1024(smem_raw);
  float* Bt = reinterpret_cast<float*>(base);   // WSTAGES x ([BN][BK] hi, [BN][BK] lo)
  float* Braw = Bt + WSTAGES * 2 * BN * BK;     // WSTAGES x [BK][BN]
  float* As = Braw + WSTAGES * BK * BN;         // WSTAGES x [BK][APAD]
  uint64_t* full = reinterpret_cast<uint64_t*>(As + WSTAGES * BK * APAD);
  uint64_t* ready = full + WSTAGES;  // B's halves written
  uint64_t* empty = ready + WSTAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + s, 33);
      mbar_init(ready + s, 96);  // every transposer thread
      mbar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // loader: B's raw tile by TMA, A's rows by cp.async
    int it = 0;
    for (int s = 0; s < P.nseg; ++s) {
      const MWSeg& S = P.seg[s];
      for (int q = 0; q < nk; ++q, ++it) {
        const int st = it % WSTAGES, e0 = lo + q * BK;
        mbar_wait(empty + st, ((it / WSTAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + st, B_TILE);
          tma_2d(Braw + st * BK * BN, &S.bmap, full + st, n0, e0);
        }
        const int e = e0 + lane;
        const int arow = e < hi ? (P.gather ? eidx[e] : e) : -1;
        float* at = As + st * BK * APAD;
        const bool m_ok = m0 + 4 * lane < P.m;  // lane: chunk of four values of each row
        if (S.abf16) {  // 8-byte chunks into a bf16 [BK][APAD] tile
          const uint16_t* a16 = reinterpret_cast<const uint16_t*>(S.a);
          uint16_t* at16 = reinterpret_cast<uint16_t*>(at);
#pragma unroll 4
          for (int r = 0; r < BK; ++r) {
            const int row = __shfl_sync(0xffffffffu, arow, r);
            const bool ok = row >= 0 && m_ok;
            const uint16_t* src = ok ? a16 + (long long)row * S.lda + m0 + 4 * lane : a16;
            cp_async8(at16 + r * APAD + 4 * lane, src, ok ? 8 : 0);
          }
        } else {
#pragma unroll 4
          for (int r = 0; r < BK; ++r) {
            const int row = __shfl_sync(0xffffffffu, arow, r);
            const bool ok = row >= 0 && m_ok;
            const float* src = ok ? S.a + (long long)row * S.lda + m0 + 4 * lane : S.a;
            cp_async16(at + r * APAD + 4 * lane, src, ok ? 16 : 0);
          }
        }
        cp_async_arrive(full + st);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  if (warp > 8) {  // transposers: B's raw [BK][BN] tile -> K-major [BN][BK] hi and lo
    const int tt = tid - 9 * 32;
    int it = 0;
    for (int s = 0; s < P.nseg; ++s) {
      const bool rnd = P.seg[s].rbf16;
      for (int q = 0; q < nk; ++q, ++it) {
        const int st = it % WSTAGES, e0 = lo + q * BK;
        mbar_wait(full + st, (it / WSTAGES) & 1);
        const float* raw = Braw + st * BK * BN;
        float* th = Bt + st * 2 * BN * BK;
        if (rnd)
          transpose_b<true>(raw, th, tt, e0, hi);
        else
          transpose_b<false>(raw, th, tt, e0, hi);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma's reads
        mbar_arrive(ready + st);
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int rb = wg * 64 + (warp & 3) * 16 + g;
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  int it = 0;
  for (int s = 0; s < P.nseg; ++s) {
    const float sign = P.seg[s].sign;
    const bool a16 = P.seg[s].abf16, rnd = P.seg[s].rbf16;
    for (int q = 0; q < nk; ++q, ++it) {
      const int st = it % WSTAGES, ph = (it / WSTAGES) & 1;
      mbar_wait(full + st, ph);
      mbar_wait(ready + st, ph);
      // A fragment: m = rb (+8), k = e (+4) of the padded [BK][APAD] tile
      const float* at = As + st * BK * APAD;
      const float* th = Bt + st * 2 * BN * BK;
      const uint64_t dh = desc_sw128(th), dl = desc_sw128(th + BN * BK);
      // the operand mode is chosen once a stage: each fragment loader is branch-free
      if (a16) {
        stage_mma(acc, tot, dh, dl, [&](int kk, uint32_t (&fh)[4], uint32_t (&fl)[4]) {
          const uint16_t* p = reinterpret_cast<const uint16_t*>(at) + (kk * 8 + t) * APAD + rb;
          split_tf32(sign * bf16_bits(p[0]), fh[0], fl[0]);
          split_tf32(sign * bf16_bits(p[8]), fh[1], fl[1]);
          split_tf32(sign * bf16_bits(p[4 * APAD]), fh[2], fl[2]);
          split_tf32(sign * bf16_bits(p[4 * APAD + 8]), fh[3], fl[3]);
        });
      } else if (rnd) {
        stage_mma(acc, tot, dh, dl, [&](int kk, uint32_t (&fh)[4], uint32_t (&fl)[4]) {
          const float* p = at + (kk * 8 + t) * APAD + rb;
          round_tf32(sign * p[0], fh[0], fl[0]);
          round_tf32(sign * p[8], fh[1], fl[1]);
          round_tf32(sign * p[4 * APAD], fh[2], fl[2]);
          round_tf32(sign * p[4 * APAD + 8], fh[3], fl[3]);
        }, true);
      } else {
        stage_mma(acc, tot, dh, dl, [&](int kk, uint32_t (&fh)[4], uint32_t (&fl)[4]) {
          const float* p = at + (kk * 8 + t) * APAD + rb;
          split_tf32(sign * p[0], fh[0], fl[0]);
          split_tf32(sign * p[8], fh[1], fl[1]);
          split_tf32(sign * p[4 * APAD], fh[2], fl[2]);
          split_tf32(sign * p[4 * APAD + 8], fh[3], fl[3]);
        });
      }
      if (lane == 0) mbar_arrive(empty + st);
    }
  }

  mw_epilogue(bt, P, tot, tl, sp, m0, n0, rb, t, part);
}

// The bf16 operand mode's weight gradients: one BM x BN tile of out over the rows of split
// blockIdx.y, as so2_mmw_kernel, with both operands bf16 [rows, .] by TMA: a stage holds A's
// two boxes [64 rows][64 m] and B's two [64 rows][64 n], which wgmma reads MN-major (a
// warpgroup: its A box, both B boxes). A split's last stage may run past its rows: the
// consumers zero those rows of the four boxes first (rows past the split may be live rows of
// the next one, or past the live count).
__global__ void __launch_bounds__(GT, 1) so2_mmw16_kernel(const __grid_constant__ MWBatch bt,
                                                           const int* __restrict__ n_rows,
                                                           float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  const int pi = mw_problem(bt, blockIdx.x);
  const MWProb& P = bt.p[pi];
  const int tl = blockIdx.x - bt.tile0[pi], sp = blockIdx.y;
  const int m0 = (tl / P.tiles_n) * BM, n0 = (tl % P.tiles_n) * BN;
  int lo, hi;
  split_rows<BK16>(*n_rows, bt.spl, sp, lo, hi);
  const int nk = (hi - lo + BK16 - 1) / BK16;  // k tiles of each segment

  uint8_t* base = align1024(smem_raw);
  uint8_t* As = base;                      // STAGES16 x 2 boxes [BK16][64] (m)
  uint8_t* Bs = base + STAGES16 * TILE16;  // STAGES16 x 2 boxes [BK16][64] (n)
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * STAGES16 * TILE16);
  uint64_t* empty = full + STAGES16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES16; ++s) {
      mbar_init(full + s, 1);   // the producer's expect_tx
      mbar_init(empty + s, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues the four boxes of a stage
    if (lane == 0) {
      int it = 0;
      for (int s = 0; s < P.nseg; ++s) {
        const MWSeg& S = P.seg[s];
        for (int q = 0; q < nk; ++q, ++it) {
          const int st = it % STAGES16, e0 = lo + q * BK16;
          mbar_wait(empty + st, ((it / STAGES16) & 1) ^ 1);
          mbar_expect_tx(full + st, 2 * TILE16);
          tma_2d(As + st * TILE16, &S.amap, full + st, m0, e0);
          tma_2d(As + st * TILE16 + BOX16, &S.amap, full + st, m0 + 64, e0);
          tma_2d(Bs + st * TILE16, &S.bmap, full + st, n0, e0);
          tma_2d(Bs + st * TILE16 + BOX16, &S.bmap, full + st, n0 + 64, e0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, t = lane & 3;
  const int rb = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  int it = 0;
  for (int s = 0; s < P.nseg; ++s) {
    const float sign = P.seg[s].sign;
    for (int q = 0; q < nk; ++q, ++it) {
      const int st = it % STAGES16;
      mbar_wait(full + st, (it / STAGES16) & 1);
      const int valid = hi - (lo + q * BK16);  // rows of the split in this stage
      if (valid < BK16) {  // zero rows valid.. of the four boxes (whole 128-byte lines)
        const int per = (BK16 - valid) * 8;  // 16-byte chunks a box
        for (int u = tid; u < 4 * per; u += 256) {
          const int box = u / per, j = u - box * per;
          uint8_t* b = (box < 2 ? As : Bs) + st * TILE16 + (box & 1) * BOX16;
          *reinterpret_cast<uint4*>(b + (valid + j / 8) * 128 + (j & 7) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma's reads
        asm volatile("bar.sync 1, 256;" ::: "memory");                // both warpgroups
      }
      stage_mma16<1>(acc, tot, desc_mn128(As + st * TILE16 + wg * BOX16, BOX16),
                     desc_mn128(Bs + st * TILE16, BOX16), 128, sign);
      if (lane == 0) mbar_arrive(empty + st);
    }
  }
  mw_epilogue(bt, P, tot, tl, sp, m0, n0, rb, t, part);
}

// out = the spl partial tiles summed in order: the same bits every run. Block (x, y) sums
// the y-th of gridDim.y chunks of tile x (a launch of few tiles still fills the SMs).
__global__ void __launch_bounds__(256) so2_reduce_kernel(const __grid_constant__ MWBatch bt,
                                                          const float* __restrict__ part) {
  const int pi = mw_problem(bt, blockIdx.x);
  const MWProb& P = bt.p[pi];
  const int tl = blockIdx.x - bt.tile0[pi];
  const int m0 = (tl / P.tiles_n) * BM, n0 = (tl % P.tiles_n) * BN;
  const float* src = part + P.part + (long long)tl * bt.spl * BM * BN;
  const int per = BM * BN / gridDim.y, el_end = (blockIdx.y + 1) * per;
  for (int el = blockIdx.y * per + threadIdx.x; el < el_end; el += blockDim.x) {
    const int gm = m0 + el / BN, gn = n0 + el % BN;
    if (gm >= P.m || gn >= P.n) continue;
    float s = 0.f;
    for (int q = 0; q < bt.spl; ++q) s += src[(long long)q * BM * BN + el];
    P.out[(long long)gm * P.ldo + gn] = s;
  }
}

// column sums out[n] = sign * sum over the live rows of B[e, n]: per split of the rows a
// partial row (one thread a column, rows in order), then the splits summed in order
struct CSProb {
  const float* b;
  float* out;
  int ldb, n;
  float sign;
  long long part;
};

struct CSBatch {
  CSProb p[TN_MAXP];
  int np, spl;
  int blk0[TN_MAXP + 1];  // first column block of each problem
};

__global__ void __launch_bounds__(256) so2_colsum_kernel(const __grid_constant__ CSBatch bt,
                                                          const int* __restrict__ n_rows,
                                                          float* __restrict__ part) {
  int pi = 0;
  while (pi + 1 < bt.np && (int)blockIdx.x >= bt.blk0[pi + 1]) ++pi;
  const CSProb& P = bt.p[pi];
  const int col = ((int)blockIdx.x - bt.blk0[pi]) * 256 + threadIdx.x;
  if (col >= P.n) return;
  const int nr = *n_rows;
  const int chunk = (nr + bt.spl - 1) / bt.spl;
  const int lo = min(nr, (int)blockIdx.y * chunk), hi = min(nr, lo + chunk);
  float s = 0.f;
#pragma unroll 8
  for (int e = lo; e < hi; ++e) s += __ldg(P.b + (long long)e * P.ldb + col);
  part[P.part + (long long)blockIdx.y * P.n + col] = s;
}

__global__ void __launch_bounds__(256) so2_colsum_reduce_kernel(const __grid_constant__ CSBatch bt,
                                                                 const float* __restrict__ part) {
  int pi = 0;
  while (pi + 1 < bt.np && (int)blockIdx.x >= bt.blk0[pi + 1]) ++pi;
  const CSProb& P = bt.p[pi];
  const int col = ((int)blockIdx.x - bt.blk0[pi]) * 256 + threadIdx.x;
  if (col >= P.n) return;
  float s = 0.f;
  for (int q = 0; q < bt.spl; ++q) s += part[P.part + (long long)q * P.n + col];
  P.out[col] = P.sign * s;
}

// ---------------------------------------------------------------------------
// the live-row list from 0/1 flags in slot order, the slots in segments of `seg` (a receiver's
// pairs or edges; PaiNN's B and D, SchNet's F and H: a sender's): so2_count_kernel counts each
// segment's live slots (a warp a segment), so2_starts_kernel scans the counts in one block and
// so2_list_kernel lists each segment's live slots by ballot (a warp a segment); live_rows
// launches the three
// ---------------------------------------------------------------------------

constexpr int LIST_WARPS = 8;  // segments a block of the count and list kernels

// rs[s] = the live slots of segment s
__global__ void __launch_bounds__(LIST_WARPS * 32) so2_count_kernel(const int* __restrict__ flags,
                                                                    int* __restrict__ rs,
                                                                    int nseg, int seg) {
  const int s = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= nseg) return;  // the whole warp shares s
  const int* f = flags + (long long)s * seg;
  int n = 0;
  for (int k0 = 0; k0 < seg; k0 += 32)
    n += __popc(__ballot_sync(0xffffffffu, k0 + lane < seg && f[k0 + lane] != 0));
  if (lane == 0) rs[s] = n;
}

// in place: rs[s] = the live slots of segments 0 .. s-1 for s <= nseg, and *n_rows = rs[nseg]
// = their count. One block: each thread sums a run of segments, then a scan of the runs.
__global__ void __launch_bounds__(1024) so2_starts_kernel(int* __restrict__ rs,
                                                          int* __restrict__ n_rows, int nseg) {
  __shared__ int sums[1024];
  const int tid = threadIdx.x, per = (nseg + 1023) / 1024;
  const int lo = min(nseg, tid * per), hi = min(nseg, lo + per);
  int c = 0;
  for (int s = lo; s < hi; ++s) c += rs[s];
  sums[tid] = c;
  __syncthreads();
  for (int off = 1; off < 1024; off *= 2) {
    const int v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int ex = sums[tid] - c;
  for (int s = lo; s < hi; ++s) {  // each thread rewrites only its own run
    const int n = rs[s];
    rs[s] = ex;
    ex += n;
  }
  if (tid == 1023) rs[nseg] = *n_rows = sums[1023];
}

// eidx[e] = the e-th live slot, pos[p] = its row or -1
__global__ void __launch_bounds__(LIST_WARPS * 32) so2_list_kernel(const int* __restrict__ flags,
                                                                   const int* __restrict__ rs,
                                                                   int* __restrict__ eidx,
                                                                   int* __restrict__ pos,
                                                                   int nseg, int seg) {
  const int s = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= nseg) return;  // the whole warp shares s
  int base = rs[s];
  for (int k0 = 0; k0 < seg; k0 += 32) {
    const long long p = (long long)s * seg + k0 + lane;
    const bool in = k0 + lane < seg, live = in && flags[p] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (in) {
      const int e = base + __popc(m & ((1u << lane) - 1));
      pos[p] = live ? e : -1;
      if (live) eidx[e] = (int)p;
    }
    base += __popc(m);
  }
}

// eidx [npairs], pos [npairs], rs [npairs / seg + 1] (each segment's first row, then the
// count) and *n_rows (the count) from the flags [npairs] (npairs a multiple of seg)
cudaError_t live_rows(const int* flags, int* eidx, int* pos, int* rs, int* n_rows,
                      long long npairs, int seg, cudaStream_t st) {
  const int nseg = (int)(npairs / seg);
  const unsigned blocks = (unsigned)std::max(1, (nseg + LIST_WARPS - 1) / LIST_WARPS);
  so2_count_kernel<<<blocks, LIST_WARPS * 32, 0, st>>>(flags, rs, nseg, seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  so2_starts_kernel<<<1, 1024, 0, st>>>(rs, n_rows, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  so2_list_kernel<<<blocks, LIST_WARPS * 32, 0, st>>>(flags, rs, eidx, pos, nseg, seg);
  return cudaGetLastError();
}

// row[e] = the pair row (b*A + i)*A + j of the e-th live slot eidx[e] = (b*A + j)*A + i, when
// the slots are listed a segment a sender (PaiNN's B and D, SchNet's F and H): for the gathers
// of the products (e below the live count)
__global__ void so2_pair_rows_kernel(const int* __restrict__ eidx, const int* __restrict__ n_rows,
                                     int* __restrict__ row, int A) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= *n_rows) return;
  const int p = eidx[e], bj = p / A, i = p - bj * A, b = bj / A, j = bj - b * A;
  row[e] = (b * A + i) * A + j;
}

// ---------------------------------------------------------------------------
// per-sender stages (B, D, F, H): the warp's sums of several per-pair values
// ---------------------------------------------------------------------------

// One step of warp_sums: a lane keeps half of its first 2 O values, adds its partner's copy
// of that half and sends the other half; then the next step on the kept half. One instance a
// step, so that every loop bound is a constant and the values stay in registers.
template <int O, int N>
__device__ __forceinline__ void fold_half(float (&val)[N], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int q = 0; q < O; ++q) {
    const float send = up ? val[q] : val[q + O];
    const float keep = up ? val[q + O] : val[q];
    val[q] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) fold_half<O / 2>(val, lane);
}

// The warp's sums of N values a lane (N a power of two, 2 to 32) in N - 1 shuffles, then one
// for each halving of 32 / N: lane l returns the warp's sum of value l % N, in a fixed order.
template <int N>
__device__ __forceinline__ float warp_sums(float (&val)[N], int lane) {
  static_assert(N >= 2 && N <= 32 && (N & (N - 1)) == 0, "a power of two, 2 to 32");
  fold_half<N / 2>(val, lane);
  float s = val[0];
#pragma unroll
  for (int o = N; o < 32; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// ---------------------------------------------------------------------------
// per-receiver stages; L and M are compile-time so the stacks stay in registers
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int mclip(int l, int M) { return l < M ? l : M; }

__host__ __device__ constexpr int s_trunc(int L, int M) {
  int s = 0;
  for (int l = 0; l <= L; ++l) s += 2 * mclip(l, M) + 1;
  return s;
}

// offset of D^l's truncated rows in the compact Wigner row
__host__ __device__ constexpr int k_off(int l, int M) {
  int o = 0;
  for (int q = 0; q < l; ++q) o += (2 * mclip(q, M) + 1) * (2 * q + 1);
  return o;
}

// (l, m) of m-major row r: m=0 (l=0..L), then +m and -m (l=m..L) for m=1..M
__host__ __device__ constexpr int row_l(int L, int M, int r) {
  if (r <= L) return r;
  r -= L + 1;
  for (int a = 1; a <= M; ++a) {
    const int n = L + 1 - a;
    if (r < n) return a + r;
    r -= n;
    if (r < n) return a + r;
    r -= n;
  }
  return -1;
}

__host__ __device__ constexpr int row_m(int L, int M, int r) {
  if (r <= L) return 0;
  r -= L + 1;
  for (int a = 1; a <= M; ++a) {
    const int n = L + 1 - a;
    if (r < n) return a;
    r -= n;
    if (r < n) return -a;
    r -= n;
  }
  return 0;
}

// compact index of D^l[m, col] is row_base(r) + col
__host__ __device__ constexpr int row_base(int L, int M, int r) {
  return k_off(row_l(L, M, r), M) +
         (row_m(L, M, r) + mclip(row_l(L, M, r), M)) * (2 * row_l(L, M, r) + 1);
}

// the grid tables in shared memory: to_g [P][S_t] and from_g transposed, [P][S_t]
__device__ __forceinline__ void stage_grid(const float* __restrict__ tog,
                                           const float* __restrict__ fromg, int P, int ST,
                                           float* tab) {
  for (int idx = threadIdx.x; idx < P * ST; idx += blockDim.x) {
    const int q = idx / ST, r = idx - q * ST;
    tab[idx] = tog[idx];
    tab[P * ST + idx] = fromg[r * P + q];
  }
  __syncthreads();
}

// silu on the truncated S2 grid of one channel's m-major stack m (tab as stage_grid
// leaves it): m2 += from_g silu(to_g m)
template <int ST>
__device__ __forceinline__ void grid_silu(const float* tab, int P, const float (&m)[ST],
                                          float (&m2)[ST]) {
  const float* fT = tab + P * ST;
  for (int q = 0; q < P; ++q) {
    float z = 0.f;
#pragma unroll
    for (int r = 0; r < ST; ++r) z = fmaf(tab[q * ST + r], m[r], z);
    const float a = silu(z);
#pragma unroll
    for (int r = 0; r < ST; ++r) m2[r] = fmaf(fT[q * ST + r], a, m2[r]);
  }
}

// its transpose, given the cotangent gm2 of its output: gm += to_g^T (silu'(to_g m) *
// from_g^T gm2), the grid's pre-activations recomputed from m
template <int ST>
__device__ __forceinline__ void grid_silu_bwd(const float* tab, int P, const float (&m)[ST],
                                              const float (&gm2)[ST], float (&gm)[ST]) {
  const float* fT = tab + P * ST;
  for (int q = 0; q < P; ++q) {
    float z = 0.f, gp = 0.f;
#pragma unroll
    for (int r = 0; r < ST; ++r) {
      z = fmaf(tab[q * ST + r], m[r], z);
      gp = fmaf(fT[q * ST + r], gm2[r], gp);
    }
    const float gpre = gp * dsilu(z);
#pragma unroll
    for (int r = 0; r < ST; ++r) gm[r] = fmaf(tab[q * ST + r], gpre, gm[r]);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps, problem lists and their launches
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (the library links no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a float32 (or `dt`) tensor map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1..), boxes of `box`, zeros outside the tensor; false if refused
bool make_map(CUtensorMap* m, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box, bool swizzle,
              CUtensorMapDataType dt = CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  const EncodeTiledFn f = encode_tiled();
  const cuuint32_t es[3] = {1, 1, 1};
  return f && f(m, dt, (cuuint32_t)rank, const_cast<void*>(base),
                dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

// a bf16 [rows, cols] view (row stride ld values) as a 2-D tensor map of boxes
// [box_rows][box_cols], 128-byte swizzle, zeros outside the view; false if refused
bool map16(CUtensorMap* m, const void* base, long long cols, long long rows, long long ld,
           int box_cols, int box_rows) {
  const cuuint64_t d[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t st[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t bx[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return make_map(m, base, 2, d, st, bx, true, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// what every launch of the engine shares: the row list and the scratch
struct Engine {
  long long max_rows;  // row slots (the live rows are a prefix of the list)
  const int* n_rows;   // on the card: the live count
  const int* eidx;     // on the card: the row list
  float* prep;         // the weights' TF32 halves (prep_cap floats)
  long long prep_cap;
  float* part;         // weight-gradient partials (part_cap floats)
  long long part_cap;
  int rbf16;           // every segment of its launches in the bf16-rounding mode
  int b16;             // every product and weight gradient in the bf16 operand mode: A (and
                       // a weight gradient's B) bf16 values at the segments' pointers
};

Seg seg(const float* a, int lda, const float* b, int ldb, int k, bool btrans = false,
        float sign = 1.f) {
  return Seg{a, b, lda, ldb, k, btrans ? 1 : 0, sign, 0, 0, 0};
}

NNProb prob(std::initializer_list<Seg> segs, int n, int epi, float* c, int ldc,
            float* c2 = nullptr, int ldc2 = 0) {
  NNProb p{};
  for (const Seg& s : segs) p.seg[p.nseg++] = s;
  p.n = n;
  p.epi = epi;
  p.c = c;
  p.ldc = ldc;
  p.c2 = c2;
  p.ldc2 = ldc2;
  return p;
}

NNProb gated(NNProb p, const float* gate, int ldg) {
  p.gate = gate;
  p.ldg = ldg;
  return p;
}

// the products over rows 0..*n_rows-1 of at most max_rows: per batch of NN_MAXP problems,
// the B halves of each distinct segment (the bf16 operand mode: one bf16 copy), then the
// tiles (those past the count exit). A persistent launch runs one block per SM over all the
// tiles (for products of small K, whose blocks would otherwise be mostly set-up and
// epilogue; not in the bf16 operand mode).
cudaError_t launch_products(const Engine& en, const std::vector<NNProb>& probs, cudaStream_t st,
                            bool persistent = false) {
  if (en.max_rows <= 0) return cudaSuccess;
  if (en.b16 && persistent) return cudaErrorInvalidValue;
  const auto kernel = en.b16        ? so2_mma16_kernel
                      : persistent ? so2_mma_kernel<true>
                                   : so2_mma_kernel<false>;
  const int smem = en.b16 ? MMA16_SMEM : MMA_SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (int)((en.max_rows + BM - 1) / BM);
  for (size_t i0 = 0; i0 < probs.size(); i0 += NN_MAXP) {
    MMBatch bt{};
    PrepBatch pb{};
    bt.np = (int)std::min(probs.size() - i0, (size_t)NN_MAXP);
    long long off = 0;
    int ptiles = 0;
    for (int q = 0; q < bt.np; ++q) {
      const NNProb& src = probs[i0 + q];
      MMProb& P = bt.p[q];
      P.nseg = src.nseg;
      P.gather = src.gather;
      P.scatter = src.scatter;
      P.epi = src.epi;
      P.n = src.n;
      P.ldc = src.ldc;
      P.ldc2 = src.ldc2;
      P.ldg = src.ldg;
      P.c = src.c;
      P.c2 = src.c2;
      P.bias = src.bias;
      P.gate = src.gate;
      if (P.n % 4 || P.ldc % 4 || P.ldc2 % 4 || P.ldg % 4) return cudaErrorInvalidValue;
      for (int s = 0; s < src.nseg; ++s) {
        const Seg& S = src.seg[s];
        const int rnd = !en.b16 && (S.rbf16 || en.rbf16);
        if (en.b16) {  // bf16 A, rows of 16-byte multiples, by TMA or 16-byte cp.async chunks
          if (S.k % 8 || S.lda % 8 || !aligned16(S.a) || S.abf16 || S.one || S.rbf16)
            return cudaErrorInvalidValue;
        } else if (S.k % 4 || S.lda % 4 ||  // bf16 A: gathered rows only, 8-byte aligned (the
                                            // gather's chunks); rounding: fp32 A
                   (S.abf16 ? !P.gather || !aligned8(S.a) : !aligned16(S.a)) || (rnd && S.abf16)) {
          return cudaErrorInvalidValue;
        }
        // one prep job per distinct (b, ldb, btrans, K, N, rounding)
        float* dst = nullptr;
        for (int j = 0; j < pb.nj; ++j) {
          const PrepJob& J = pb.j[j];
          if (J.src == S.b && J.ld == S.ldb && J.btrans == S.btrans && J.k == S.k &&
              J.n == P.n && J.rnd == rnd)
            dst = J.dst;
        }
        if (!dst) {
          dst = en.prep + off;
          // bf16 copies: n k / 2 floats, 16-byte multiples (K % 8 == 0)
          off += en.b16 ? (long long)P.n * S.k / 2 : 2LL * P.n * S.k;
          if (off > en.prep_cap) return cudaErrorInvalidValue;
          PrepJob& J = pb.j[pb.nj++];
          J = PrepJob{S.b, dst, S.ldb, S.k, P.n, S.btrans, (S.k + 31) / 32, ptiles, rnd, en.b16};
          ptiles += J.tiles_k * ((P.n + 31) / 32);
        }
        MMSeg& M = P.seg[s];
        M.a = S.a;
        M.lda = S.lda;
        M.k = S.k;
        M.sign = S.sign;
        if (en.b16) {
          if (!map16(&M.bmap, dst, S.k, P.n, S.k, BK16, BN) ||
              (!P.gather && !map16(&M.amap, S.a, S.k, en.max_rows, S.lda, BK16, BM)))
            return cudaErrorInvalidValue;
          continue;
        }
        M.abf16 = S.abf16;
        M.one = S.one || rnd;
        M.rbf16 = rnd;
        const cuuint64_t bd[3] = {(cuuint64_t)S.k, (cuuint64_t)P.n, 2};
        const cuuint64_t bs[2] = {(cuuint64_t)S.k * 4, (cuuint64_t)S.k * P.n * 4};
        const cuuint32_t bb[3] = {BK, BN, 1};
        if (!make_map(&M.bmap, dst, 3, bd, bs, bb, true)) return cudaErrorInvalidValue;
        if (!P.gather) {
          const cuuint64_t ad[2] = {(cuuint64_t)S.k, (cuuint64_t)en.max_rows};
          const cuuint64_t as[1] = {(cuuint64_t)S.lda * 4};
          const cuuint32_t ab[2] = {BK, BM};
          if (!make_map(&M.amap, S.a, 2, ad, as, ab, true)) return cudaErrorInvalidValue;
        }
      }
      bt.tile0[q] = bt.tiles;
      bt.tiles += (P.n + BN - 1) / BN;
    }
    bt.tile0[bt.np] = bt.tiles;
    so2_prep_kernel<<<ptiles, 256, 0, st>>>(pb);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long blocks = (long long)(row_tiles + GROUP - 1) / GROUP * GROUP * bt.tiles;
    bt.jobs = (int)blocks;
    kernel<<<(unsigned)(persistent ? std::min(blocks, (long long)SMS) : blocks), GT, smem, st>>>(
        bt, en.n_rows, en.eidx);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

TNProb tprob(std::initializer_list<TSeg> segs, int amode, int m, int n, float* out, int ldo) {
  TNProb p{};
  for (const TSeg& s : segs) p.seg[p.nseg++] = s;
  p.amode = amode;
  p.m = m;
  p.n = n;
  p.out = out;
  p.ldo = ldo;
  return p;
}

long long out_tiles(long long m, long long n) { return ((m + BM - 1) / BM) * ((n + BN - 1) / BN); }

// the row split of a weight-gradient launch of `tiles` output tiles: of the splits with at
// most MAX_SPLIT_BLOCKS blocks and 16 k tiles of rows each, the one whose blocks fill the
// last wave of the SMs best (the smallest at a tie); shapes only, never timing
int wgrad_split(long long tiles, long long max_rows) {
  const long long cap = std::max(1LL, std::min(max_rows / (16 * BK), MAX_SPLIT_BLOCKS / tiles));
  int best = 1;
  double best_fill = 0.;
  for (long long spl = 1; spl <= cap; ++spl) {
    const long long blocks = tiles * spl, waves = (blocks + SMS - 1) / SMS;
    const double fill = (double)blocks / (double)(waves * SMS);
    if (fill > best_fill + 1e-9) {
      best = (int)spl;
      best_fill = fill;
    }
  }
  return best;
}
int colsum_split(long long max_rows) {
  return (int)std::max(1LL, std::min((long long)CS_SPLIT, max_rows / 1024));
}

// partial floats that launch_wgrads needs for `probs` over max_rows row slots
long long wgrad_part_floats(long long max_rows, const std::vector<TNProb>& probs) {
  long long need = 0, cols = 0;
  std::vector<TNProb> mats;
  for (const TNProb& p : probs) {
    if (p.amode == A_ONES) cols += p.n;
    else mats.push_back(p);
  }
  need = std::max(need, (long long)colsum_split(max_rows) * cols);
  for (size_t i0 = 0; i0 < mats.size(); i0 += TN_MAXP) {
    long long t = 0;
    for (size_t k = i0; k < std::min(mats.size(), i0 + TN_MAXP); ++k)
      t += out_tiles(mats[k].m, mats[k].n);
    const int spl = wgrad_split(t, max_rows);
    if (spl > 1) need = std::max(need, t * spl * BM * BN);
  }
  return need;
}

// an upper bound of wgrad_part_floats for column sums of at most `cols` columns (a split
// launch has at most MAX_SPLIT_BLOCKS partial tiles)
long long part_bound(long long cols) {
  return std::max((long long)MAX_SPLIT_BLOCKS * BM * BN, (long long)CS_SPLIT * cols);
}

// the column sums (A_ONES) first, then the products in batches of TN_MAXP problems
cudaError_t launch_wgrads(const Engine& en, const std::vector<TNProb>& probs, cudaStream_t st) {
  if (wgrad_part_floats(en.max_rows, probs) > en.part_cap) return cudaErrorInvalidValue;
  cudaError_t err;
  std::vector<TNProb> mats, ones;
  for (const TNProb& p : probs) (p.amode == A_ONES ? ones : mats).push_back(p);
  for (size_t i0 = 0; i0 < ones.size(); i0 += TN_MAXP) {
    CSBatch cb{};
    cb.np = (int)std::min(ones.size() - i0, (size_t)TN_MAXP);
    cb.spl = colsum_split(en.max_rows);
    long long off = 0;
    int blk = 0;
    for (int k = 0; k < cb.np; ++k) {
      const TNProb& p = ones[i0 + k];
      cb.p[k] = CSProb{p.seg[0].b, p.out, p.seg[0].ldb, p.n, p.seg[0].sign, off};
      off += (long long)cb.spl * p.n;
      cb.blk0[k] = blk;
      blk += (p.n + 255) / 256;
    }
    cb.blk0[cb.np] = blk;
    so2_colsum_kernel<<<dim3(blk, cb.spl), 256, 0, st>>>(cb, en.n_rows, en.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    so2_colsum_reduce_kernel<<<blk, 256, 0, st>>>(cb, en.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (mats.empty() || en.max_rows <= 0) return cudaSuccess;
  if ((err = en.b16 ? cudaFuncSetAttribute(so2_mmw16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           MMW16_SMEM)
                    : cudaFuncSetAttribute(so2_mmw_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           MMW_SMEM)) != cudaSuccess)
    return err;
  for (size_t i0 = 0; i0 < mats.size(); i0 += TN_MAXP) {
    MWBatch bt{};
    bt.np = (int)std::min(mats.size() - i0, (size_t)TN_MAXP);
    int t = 0;
    for (int k = 0; k < bt.np; ++k) t += (int)out_tiles(mats[i0 + k].m, mats[i0 + k].n);
    bt.spl = wgrad_split(t, en.max_rows);
    t = 0;
    for (int k = 0; k < bt.np; ++k) {
      const TNProb& src = mats[i0 + k];
      MWProb& P = bt.p[k];
      P.nseg = src.nseg;
      P.gather = src.amode == A_GATHER;
      P.m = src.m;
      P.n = src.n;
      P.ldo = src.ldo;
      P.tiles_n = (src.n + BN - 1) / BN;
      P.out = src.out;
      P.part = (long long)t * bt.spl * BM * BN;
      if (src.n % 4 || src.m % 4 || src.ldo % 2) return cudaErrorInvalidValue;
      for (int s = 0; s < src.nseg; ++s) {
        const TSeg& S = src.seg[s];
        P.seg[s].a = S.a;
        P.seg[s].lda = S.lda;
        P.seg[s].sign = S.sign;
        if (en.b16) {  // bf16 A and B rows, both by TMA: no gather
          if (P.gather || S.lda % 8 || S.ldb % 8 || !aligned16(S.a) || !aligned16(S.b) ||
              S.abf16 || S.rbf16 ||
              !map16(&P.seg[s].amap, S.a, src.m, en.max_rows, S.lda, 64, BK16) ||
              !map16(&P.seg[s].bmap, S.b, src.n, en.max_rows, S.ldb, 64, BK16))
            return cudaErrorInvalidValue;
          continue;
        }
        const int rnd = S.rbf16 || en.rbf16;
        if (S.lda % 4 || S.ldb % 4 || !(S.abf16 ? aligned8(S.a) : aligned16(S.a)) ||
            !aligned16(S.b) || (rnd && S.abf16))
          return cudaErrorInvalidValue;
        P.seg[s].abf16 = S.abf16;
        P.seg[s].rbf16 = rnd;
        const cuuint64_t d[2] = {(cuuint64_t)src.n, (cuuint64_t)en.max_rows};
        const cuuint64_t sb[1] = {(cuuint64_t)S.ldb * 4};
        const cuuint32_t bx[2] = {BN, BK};
        if (!make_map(&P.seg[s].bmap, S.b, 2, d, sb, bx, false)) return cudaErrorInvalidValue;
      }
      bt.tile0[k] = t;
      t += (int)out_tiles(src.m, src.n);
    }
    bt.tile0[bt.np] = t;
    if (en.b16)
      so2_mmw16_kernel<<<dim3(t, bt.spl), GT, MMW16_SMEM, st>>>(bt, en.n_rows, en.part);
    else
      so2_mmw_kernel<<<dim3(t, bt.spl), GTW, MMW_SMEM, st>>>(bt, en.n_rows, en.eidx, en.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (bt.spl > 1) {
      int chunks = 1;  // of each tile (a power of two dividing BM * BN), for >= 2 blocks an SM
      while (chunks < 64 && (long long)t * chunks < 2 * SMS) chunks *= 2;
      so2_reduce_kernel<<<dim3(t, chunks), 256, 0, st>>>(bt, en.part);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

int receiver_threads(int C) { return C >= RT ? RT : (C + 31) / 32 * 32; }

}  // namespace
