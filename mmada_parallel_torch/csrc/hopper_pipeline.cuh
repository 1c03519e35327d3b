// Building blocks of the warp-specialised attention kernels on Hopper
// (sm_90a): the forward body (attention_ws.cuh) and the backward's two
// passes (attention_mma_bwd.cuh).  Each block is a producer warpgroup that
// feeds a ring of shared-memory tiles by TMA and two consumer warpgroups
// that run wgmma on the tiles that have landed:
//
// * the register split between them (setmaxnreg): a consumer's gain comes
//   only from what the producer gives back of the launch's 168 a thread,
//   128 x (168 - 40) = 256 x (232 - 168).  A producer at 32 with consumers
//   at 240 leaves the consumers' setmaxnreg.inc waiting forever (seen on the
//   card); at 24 / 240 ptxas spilled in the producer;
// * mbarriers (one per stage and direction: full, completed by TMA's byte
//   count; empty, by the consumers' arrivals), TMA loads from 3-D tensor
//   maps, and the named barriers on which the two consumer warpgroups take
//   turns (ids 1 and 2; 0 is __syncthreads);
// * wgmma with both operands in shared memory, and the descriptors of a
//   [rows][D] bf16 tile stored as 64-column blocks of 128-byte swizzled rows
//   (attention_mma.cuh's kv_off layout, which TMA's 128-byte swizzle writes
//   when a box of 64 columns lands at a 1024-byte aligned address);
// * on the host, cuTensorMapEncodeTiled through the runtime's
//   cudaGetDriverEntryPoint (the library links no libcuda) and 3-D maps over
//   [batch, rows, cols] tensors, whose zero fill past `rows` keeps a tile at
//   a batch boundary from reading the next batch row.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver library is not
                   // linked: cuTensorMapEncodeTiled comes through the
                   // runtime's cudaGetDriverEntryPoint

#include "attention_mma.cuh"

namespace {
namespace tc {

constexpr int kWsThreads = 3 * 128;  // 2 consumer warpgroups + the producer
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may use
constexpr int kMaxStages = 4;

#define TC_F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += A[64 x 16] . B[16 x 64], both from shared memory through
// their descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_F8(0), TC_F8(8), TC_F8(16), TC_F8(24)
      : "l"(da), "l"(db));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], as wgmma_ss_n64.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TC_F8(0), TC_F8(8), TC_F8(16), TC_F8(24), TC_F8(32), TC_F8(40),
        TC_F8(48), TC_F8(56)
      : "l"(da), "l"(db));
}

#undef TC_F8

// d[64 x N] += A . B for N = 64 or 128 keys
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db);
  else
    wgmma_ss_n64(d, da, db);
}

// Descriptor of the 16-wide k step kk of a [kTileRows][D] tile read as a
// K-major operand (rows are M or N, columns the contraction), and of the
// 16-row k step kk of one read as an MN-major operand (rows are the
// contraction).  A 64-column block of the tile is kTileRows x 128 bytes.
template <int kTileRows = kKeys>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * (kTileRows * 128) + (kk & 3) * 32, 0,
                    1024);
}

template <int kTileRows = kKeys>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, kTileRows * 128, 1024);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- mbarriers, TMA, named barriers, register reallocation ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

// this thread's arrival, and `bytes` more to come from TMA in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory at dst, completing its bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the consumer warpgroups' turn-taking (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- host: tensor maps ----

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda); null when the driver does not have it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [batch, rows, cols] tensor (cols innermost)
// of elem-byte elements: boxes of box_cols x box_rows x 1, 128-byte swizzle,
// zeros past every edge.  False if it cannot be encoded.
inline bool encode_3d(CUtensorMap* map, const void* base,
                      CUtensorMapDataType type, int elem, long long cols,
                      long long rows, long long batch, int box_cols,
                      int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * elem),
                                 (cuuint64_t)(rows * cols * elem)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace
