// The pieces of the bf16 attention bodies on Hopper's tensor cores (sm_90a,
// head dim D in {64, 128}) that the forward (attention_ws.cuh, the body of
// K1-K4) and the backward (attention_mma_bwd.cuh) share: the tile sizes,
// the 128-byte swizzled layout of a K/V tile and its wgmma descriptors, the
// wgmma wrappers with A from registers (P . V), the online softmax's
// helpers, the bias fragment loads, the split-K combine of K2 and the
// arguments of one forward call.
//
// Numerics, which every body keeps: scores and the softmax in f32 (with a
// bias, scores scaled with a rounded multiply and the bias added, as the
// plain chain does); p is exp(x - m) with the running row max m, taken as
// 2^(x log2 e - m log2 e) on the SFU (relative error ~1e-6, far below the
// bf16 rounding of p), rounded to bf16 for p.v, which accumulates in f32;
// the unrounded p are summed into the row sum, which is divided out at the
// end.  Key columns >= Lk get -inf before the max and are never scored, and
// K/V rows past Lk arrive as zeros in shared memory (so 0 * garbage cannot
// make a NaN): a row whose bias is -1e30 everywhere gives mean(v) over the
// Lk real keys, as the plain reference does.  Given an lse pointer (only
// when a gradient is wanted), a body also writes each row's (m, log2 l) for
// the backward: kept apart rather than as one log-sum-exp, because a fully
// masked row's m is ~-1.44e30, where m + log2 l rounds to m and would lose
// the row's 1/Lk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int kRows = 128;              // q rows per work item: 2 warpgroups
constexpr int kKeys = 64;               // keys per K/V tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `chunk` of key row `row` in a K or V tile:
// 64-column blocks of [kKeys][64], 128-byte swizzle (wgmma's SW128 layout).
__device__ __forceinline__ int kv_off(int row, int chunk) {
  return ((chunk >> 3) * kKeys + row) * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major operand
// (K): stride 1024 bytes between 8-row groups, the leading offset unused.
// MN-major operand (V): leading offset = the 64-column block stride, stride
// 1024 bytes between groups of 8 key rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers in place around an asynchronous wgmma: the
// compiler sees a read and a write of each here, so it neither reads them
// before the wait nor moves their updates across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TC_F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += a[64 x 16] . B, this warp's 16 rows of a in registers (the
// mma.m16n8k16 A layout), B [16 x 64] from shared memory via its descriptor;
// kTrans: B is MN-major (else K-major).
template <int kTrans>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : TC_F8(0), TC_F8(8), TC_F8(16), TC_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(kTrans));
}

// d[64 x 128] += a[64 x 16] . B, B [16 x 128] MN-major in shared memory.
__device__ __forceinline__ void wgmma_n128_trans(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : TC_F8(0), TC_F8(8), TC_F8(16), TC_F8(24), TC_F8(32), TC_F8(40),
        TC_F8(48), TC_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

#undef TC_F8

// O += P . V for one 16-key step: V's [16 x D] slice is MN-major.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (D == 128)
    wgmma_n128_trans(o, a, desc);
  else
    wgmma_n64<1>(o, a, desc);
}

// 2^x, the SFU's approximation (relative error 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bias of one key tile in the accumulator's layout (that of wgmma
// m64nN: for warp w of a warpgroup and lane = 4 * gid + tig, d[4 * j + e]
// sits at row 16 * w + gid + 8 * (e >> 1), column 8 * j + 2 * tig +
// (e & 1)): for n8 block jn of kNb, bz[4 jn + e] is the bias of row (e >> 1 ? hi : lo) at
// key k0 + 8 jn + 2 tig + (e & 1), 0 at keys >= Lk.  float2 loads when Lk
// is even (the row starts and the key are even, so the pair is aligned and
// key + 1 < Lk with key), scalar loads of the same positions when it is odd.
template <int kNb>
__device__ __forceinline__ void load_bias(float (&bz)[kNb * 4],
                                          const float* lo_row,
                                          const float* hi_row, int k0,
                                          int tig, int Lk) {
  const bool vec = (Lk & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < kNb; ++jn) {
    const int col = k0 + jn * 8 + 2 * tig;
    float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
    if (vec) {
      if (col < Lk) {
        lo = *reinterpret_cast<const float2*>(lo_row + col);
        hi = *reinterpret_cast<const float2*>(hi_row + col);
      }
    } else {
      if (col < Lk) {
        lo.x = lo_row[col];
        hi.x = hi_row[col];
      }
      if (col + 1 < Lk) {
        lo.y = lo_row[col + 1];
        hi.y = hi_row[col + 1];
      }
    }
    bz[4 * jn] = lo.x;
    bz[4 * jn + 1] = lo.y;
    bz[4 * jn + 2] = hi.x;
    bz[4 * jn + 3] = hi.y;
  }
}

// The split-K combine: for each of the n_rows = B*Lq*H rows r (out's
// [B, Lq, H*D] memory is [n_rows, D]), m* = max_s m_s[r] and
// out[r] = sum_s 2^(m_s - m*) o_s[r] / sum_s 2^(m_s - m*) l_s[r], rounded
// to bf16.  Each m_s is finite (every split holds a real key of every row).
// One thread per 4 dims of a row, so a row's (m, l) reads are a broadcast.
template <int D>
__global__ void __launch_bounds__(256)
split_combine_kernel(const float* __restrict__ o_part,
                     const float2* __restrict__ ml, bf16* __restrict__ out,
                     float2* __restrict__ lse, long long n_rows, int n_split,
                     int Lq, int H) {
  constexpr int kPer = D / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * kPer) return;
  const long long r = i / kPer;
  const int d0 = (int)(i % kPer) * 4;
  float m_max = -INFINITY;
  for (int s = 0; s < n_split; ++s) m_max = fmaxf(m_max, ml[s * n_rows + r].x);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 p = ml[s * n_rows + r];
    const float w = ex2(p.x - m_max);
    const float4 os =
        *reinterpret_cast<const float4*>(o_part + (s * n_rows + r) * D + d0);
    den += w * p.y;
    acc[0] += w * os.x;
    acc[1] += w * os.y;
    acc[2] += w * os.z;
    acc[3] += w * os.w;
  }
  __nv_bfloat162 res[2] = {__floats2bfloat162_rn(acc[0] / den, acc[1] / den),
                           __floats2bfloat162_rn(acc[2] / den, acc[3] / den)};
  *reinterpret_cast<uint2*>(out + r * D + d0) =
      *reinterpret_cast<const uint2*>(res);
  if (lse != nullptr && d0 == 0) {  // r = (b * Lq + i) * H + h
    const long long bi = r / H;
    lse[(bi / Lq * H + r % H) * Lq + bi % Lq] = make_float2(m_max, log2f(den));
  }
}

// Host side: the arguments of one call.  kv_hi only with kPrefix; o_part
// and ml (f32 scratch, n_split x [B*Lq*H, D] and n_split x [B*Lq*H, 2]) only
// with n_split > 1.  lse, where not null, receives each row's softmax
// statistics for the backward (attention_mma_bwd.cuh): f32 [B, H, Lq, 2],
// (m, log2 l), the row max of the base-2 scores and the log2 of the row sum
// of 2^(x - m), written by the body or, split, by the combine.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const int* kv_hi;
  void* out;
  float* o_part;
  float* ml;
  float* lse;
  int B, Lq, Lk, H, KV, n_split;
  float scale;
};

}  // namespace tc
}  // namespace
