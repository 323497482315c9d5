// Hopper (sm_90a) building blocks of the flash-attention kernels, as
// inline PTX: mbarriers, TMA tile loads and bulk copies, wgmma with its
// shared-memory descriptors, and setmaxnreg; plus the host-side encoding
// of TMA tensor maps.  Raw PTX rather than CUTLASS/CuTe keeps each build
// at a few seconds (the kernels are built at first use on every run).
//
// Shared-memory tiles are rows of 64 bf16 (128 bytes) written by TMA with
// the 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
// of that row, in 1024-byte atoms of 8 rows.  Every tile starts on a
// 1024-byte boundary.  wgmma reads such a tile through a descriptor with
// layout "128B swizzle" and a stride of 1024 bytes between 8-row groups:
//   - K-major (rows along M or N, the 64 columns along K): the k-th slice
//     of 16 columns starts 32 * k bytes into the tile (desc + 2 * k);
//   - MN-major (rows along K, the 64 columns along N): the k-th slice of
//     16 rows starts 2048 * k bytes into the tile (desc + 128 * k), with
//     the transpose flag set.
// With 64 columns a tile is one swizzle atom wide, so the leading-byte
// offset is unused; both offsets are set to 1024 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// First 1024-byte boundary of shared memory at or after p.
__device__ __forceinline__ uint8_t *align1024(uint8_t *p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count of this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts parity 1 as completed).  Waiting ~2^34 cycles (seconds) can only
// be a fault of the protocol, so the thread traps: the launch then fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      __trap();
    }
  }
}

// ------------------------------------------------------- TMA and bulk copies
// Box of a 4-d tensor map at coordinates (c0 innermost .. c3) -> shared
// memory; completion is counted in bytes on `bar`.  Boxes that reach past
// the tensor's end are filled with zeros, and count in full.
__device__ __forceinline__ void tma_load_4d(void *dst, const CUtensorMap *map,
                                            uint64_t *bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) -> shared.
__device__ __forceinline__ void bulk_load(void *dst, const void *src,
                                          uint32_t bytes, uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -------------------------------------------------------------- registers
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ------------------------------------------------------------------ wgmma
// Descriptor of a 128B-swizzled tile at `tile` (see the top of the file).
__device__ __forceinline__ uint64_t desc_sw128(const void *tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// wgmma reads and writes its registers asynchronously: pin them at the
// issue and at the wait, so the compiler neither moves their uses across
// nor reuses them in between.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// The accumulator of a m64nN product: thread `lane` of warp w of the
// warpgroup holds, in register i, element (16 w + acc_row(i, lane),
// acc_col(i, lane)) of the 64 x N tile.
__device__ __forceinline__ int acc_row(int i, int lane) {
  return (lane >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

// Columns [16 k, 16 k + 16) of an fp32 accumulator, as the bf16 A operand
// of a register-sourced wgmma (the two layouts agree element for element).
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&c)[N],
                                       int k) {
  a[0] = pack_bf16(c[8 * k + 0], c[8 * k + 1]);
  a[1] = pack_bf16(c[8 * k + 2], c[8 * k + 3]);
  a[2] = pack_bf16(c[8 * k + 4], c[8 * k + 5]);
  a[3] = pack_bf16(c[8 * k + 6], c[8 * k + 7]);
}

// d (m64 x n128, fp32) = A * B^T (+ d if accumulate): A is 64 x 16 and B is
// 128 x 16, both K-major bf16 tiles in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64 x n64, fp32) = A * B^T (+ d if accumulate): A is 64 x 16 and B is
// 64 x 16, both K-major bf16 tiles in shared memory (descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64 x n64, fp32) += A * B: A is 64 x 16 bf16 in registers (the
// accumulator layout, see a_frag), B is 16 x 64, MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------------- host
// Tensor map of a bf16 [B, T, H, 64] tensor with element strides (b, t, h)
// and a unit d stride (so also a column slice of the fused qkv), whose
// box is `rows` consecutive t of one (b, h): a [rows][64] tile with the
// 128-byte swizzle.  Rows at or past T read as zeros.  Returns 0 or a
// cudaError_t.
inline int encode_bthd(CUtensorMap *map, const void *base, long long B,
                       long long T, long long H, const long long *strides,
                       int rows) {
  using Encode = CUresult (*)(
      CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
      const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
      const cuuint32_t *, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void *fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess) return (int)rc;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  // Byte strides of dims 1..3 (h, t, b); the d stride is the element.
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void *>(base),
      dims, bytes, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
