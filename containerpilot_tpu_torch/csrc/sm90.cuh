// Hopper (sm_90a) building blocks shared by the flash kernels (K1, K3, K4)
// and the int8 dequant GEMM (K2): TMA tensor maps and copies, mbarriers,
// warpgroup register budgets and wgmma on bf16 tiles with float32
// accumulators. Raw PTX, no CUTLASS, so a kernel that includes this
// builds in seconds.
//
// Tiles live in shared memory exactly as a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes them: a [rows][64] bf16 box is rows
// of 128 bytes, the 16-byte chunks of row r XOR-swizzled by r % 8, and a
// [rows][128] tile is two such boxes one after the other. Every box
// starts on a 1024-byte boundary. One tile serves two products:
//   - K-major (the contraction runs along the 128-byte rows), as A or B:
//     k-step kk of 16 columns starts at box kk / 4, byte (kk % 4) * 32;
//   - MN-major (the contraction runs down the rows), as B with wgmma's
//     transpose flag: k-step kk of 16 rows starts at byte kk * 16 * 128,
//     and the next 64 columns lie one box further (the descriptor's
//     leading byte offset).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once through the runtime
// so that the library needs no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A map over a contiguous [B, S, H, HD] bf16 tensor seen as B*S rows of
// H*HD values: box 64 x 64, 128-byte swizzle. The box at
// (h * HD + 64 * c, b * S + s0) is head h's columns 64c..64c+63 at
// positions s0..s0+63 of batch b. Returns cudaSuccess or an error.
inline cudaError_t make_bshd_map(CUtensorMap* map, const void* base, int B,
                                 int S, int H, int HD) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)H * HD, (cuuint64_t)B * S};
  const cuuint64_t strides[1] = {(cuuint64_t)H * HD * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    const_cast<void*>(base), dims, strides, box, elem,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a contiguous row-major [rows][cols] matrix, 128-byte
// swizzle, box [box_rows][128 bytes]. A box reaching past the last row
// reads zeros there (TMA's out-of-bounds fill), and still completes its
// full byte count on the mbarrier.
inline cudaError_t make_rows_map(CUtensorMap* map, const void* base,
                                 CUtensorMapDataType type, int elem_bytes,
                                 long rows, long cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult res = fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
                    elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// [rows][cols] int8 (e.g. a quantized weight [k, n]), box [box_rows][128]
inline cudaError_t make_int8_map(CUtensorMap* map, const void* base, long rows,
                                 long cols, int box_rows) {
  return make_rows_map(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, cols,
                       box_rows);
}

// [rows][cols] bf16 (e.g. activations x[m, k]), box [box_rows][64]: a
// K-major wgmma operand of box_rows rows
inline cudaError_t make_bf16_map(CUtensorMap* map, const void* base, long rows,
                                 long cols, int box_rows) {
  return make_rows_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows,
                       cols, box_rows);
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of copies completing on `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts ~2^35 cycles (about 20 s) traps, so a lost copy or arrival
// faults the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0, c1) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// device: warpgroup register budgets
// ---------------------------------------------------------------------------

// Whole warpgroups only: with a producer of one warp (a block of 160
// threads) the consumers' increase waited forever on the card.
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. `lbo` and `sbo` in
// bytes: K-major tiles use sbo = 1024 (8 rows of 128 bytes) and ignore
// lbo; MN-major tiles use lbo = the byte stride between 64-column boxes
// and sbo = 1024 (8 rows along the contraction).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// a descriptor moved `bytes` further into shared memory
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (uint64_t)(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until every committed group of this warpgroup has completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
// (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for the A fragments of register-A products: a product reads
// them asynchronously, so they must stay untouched (and allocated) from
// before it is issued until its wgmma_wait
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define SM90_F8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A from registers, B MN-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24),
        SM90_F8(d, 32), SM90_F8(d, 40), SM90_F8(d, 48), SM90_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define SM90_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d[64 x N] (+)= A[64 x 16] . B[16 x N]: A from registers, B K-major in
// shared memory (stored [N][16..] along the contraction, as x[m, k] is),
// N in {8, 16, 32, 64}. The dequant GEMM (K2) uses it with the weights
// as A and the activations as B. Larger N is left out: K2 issues two
// products a warpgroup, and two 64 x 128 float32 accumulators would take
// all 128 registers a thread has at two blocks an SM (ptxas caps the
// whole kernel there; setmaxnreg does not lift it), which spilled.
template <int N>
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  if constexpr (N == 8) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : SM90_F4(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 16) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : SM90_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : SM90_F8(d, 0), SM90_F8(d, 8), SM90_F8(d, 16), SM90_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    static_assert(N == 8 || N == 16 || N == 32 || N == 64,
                  "wgmma_rs_kb: N must be 8, 16, 32 or 64");
  }
}

#undef SM90_F4
#undef SM90_F8

// d[64 x HD] += A . B with B MN-major, HD in {64, 128}
template <int HD>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[HD / 2],
                                            const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) {
    wgmma_rs_n64_tb(d, a, db);
  } else {
    wgmma_rs_n128_tb(d, a, db);
  }
}

// Two float32 values as one register of two bf16 (lo in the low half):
// how a 64 x N accumulator becomes the A operand of the next product.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 64 x 64 bf16 operand held as a float32 m64n64
// accumulator: k-step kk takes accumulator columns 16kk..16kk+15.
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// Where accumulator value i of thread t (of the warpgroup) sits in an
// m64nN tile: row (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2),
// column (i / 4) * 8 + (t % 4) * 2 + i % 2.
__device__ __forceinline__ int acc_row(int t, int i) {
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return (i >> 2) * 8 + (t % 4) * 2 + (i & 1);
}

}  // namespace sm90
