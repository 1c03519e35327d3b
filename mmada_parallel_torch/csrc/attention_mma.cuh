// Packed bidirectional flash attention on Hopper's tensor cores (sm_90a),
// bf16 only, head dim D in {64, 128}.  The bf16 body of all four attention
// kernels; their f32 paths stay on the FMA template of attention_kernel.cuh
// (tensor cores would compute f32 in TF32).
//
//   flash_attention.cu               K3  q, k, v as stored
//   flash_attention_rope.cu          K1  q and k rotated once per call by the
//                                        pre-pass (rope_rotate.cuh)
//   flash_attention_rope_qonly.cu    K2  q rotated by the pre-pass, k/v the
//                                        pre-rotated caches; kSplit (split-K
//                                        grid) when the grid is small
//   flash_attention_rope_prefix.cu   K4  q and k rotated by the pre-pass;
//                                        kPrefix (per-row key bounds)
//
// Contract (that of attention_kernel.cuh without the rotation flags):
//
//   q [B, Lq, H*D], k/v [B, Lk, KV*D] bf16, contiguous, 16-byte aligned (a
//   contiguous BLHD [B, L, H, D] tensor is the same memory);
//   optional additive f32 bias [B, 1, Lq, Lk], 8-byte aligned (any Lk:
//   float2 loads when Lk is even, scalar loads of the same fragment
//   positions when it is odd);
//   out[b, i, h*D:(h+1)*D] = softmax(q_h . k_g^T * scale + bias) . v_g,
//   g = h / (H / KV) (any GQA ratio).
//
// Two compile-time flags, both off for K1 and K3:
//
//   kPrefix  (K4) int32 bounds kv_hi [B, Lq] in place of a bias: row i
//            attends to keys kv < clamp(kv_hi[b, i], 1, Lk) (rows >= Lq to
//            key 0).  The block reduces its rows' bounds to their maximum and
//            loops over only ceil(max / 64) key tiles; a column at or past a
//            row's bound gets -inf where a column >= Lk does.  The q tiles
//            are issued last one first: under a causal mask they are the
//            longest, so the heaviest blocks start first.
//   kSplit   (K2) split-K: the key tiles of each (head, q tile, batch row) are
//            cut into n_split contiguous, non-empty ranges, tiles
//            [s*n/S, (s+1)*n/S) for split s of S over n tiles, one block
//            each (grid y = q tile * S + s).  A block writes its unnormalised
//            f32 o and its rows' (m, l) (max and sum, base 2) to scratch, and
//            split_combine_kernel forms out = sum_s 2^(m_s - m*) o_s /
//            sum_s 2^(m_s - m*) l_s with m* = max_s m_s.  The planner
//            (rope_attention.py plan_splits) takes it when B*H*ceil(Lq/128)
//            blocks would leave SMs idle: a cached partial step (Lq = 16)
//            has 32 blocks on 132 SMs.
//
// Numerics are the template's: scores and the softmax in f32 (with a bias,
// scores scaled with a rounded multiply and the bias added, as the plain
// chain does); p is exp(x - m) with the running row max m, taken as
// 2^(x log2 e - m log2 e) on the SFU (relative error ~1e-6, far below the
// bf16 rounding of p), rounded to bf16 for p.v, which accumulates in f32;
// the unrounded p are summed into the row sum, which is divided out at the
// end.  Key columns >= Lk get -inf before the max and are
// never scored, and K/V rows past Lk are zero-filled in shared memory (so
// 0 * garbage cannot make a NaN): a row whose bias is -1e30 everywhere gives
// mean(v) over the Lk real keys, as the plain reference does (across splits
// too: every split of such a row has the same m, so each weight is 2^0).
// Rows >= Lq are computed on zero q and never written.
//
// What bounds it: at the edit shape (B=1, L=2424, H=32, D=128) the two
// products are 4*B*H*Lq*Lk*D = 96 GFLOP against ~40 MB of q/k/v/out, so it is
// bound by the tensor cores' 989 TFLOP/s (bf16 dense): 0.097 ms.  At K2's
// partial shapes (Lq = 16 against Lk ~ 2400) it is bound by reading K/V once
// (40 MB: 0.012 ms), which only a grid that covers the SMs can do.  The
// design, FlashAttention-2's dataflow on Hopper's warpgroup MMA:
//
// * one block per (head, 128-row q tile, batch row), head the fastest grid
//   index, so the H heads of one (b, q tile) run side by side and share the
//   bias rows through L2;
// * two warpgroups of 4 warps, each warp owning 16 q rows.  The Q tile is
//   copied once (cp.async) into XOR-swizzled shared memory and held in
//   registers as the A fragments of both products' first operand (ldmatrix);
// * K/V stream through a ring of 3 stages of 64-key bf16 tiles, copied with
//   16-byte cp.async (zero-filled past Lk): tile t+2's copy is in flight
//   while tiles t and t+1 are read.  The tiles are stored in the 128-byte
//   swizzled layout wgmma reads: 64-column blocks of 128-byte rows, 16-byte
//   chunk c of row r at chunk c ^ (r & 7);
// * S = Q.K^T (wgmma m64n64k16, K as a K-major operand) and O += P.V
//   (wgmma m64nDk16, V as an MN-major operand) run on the tensor cores with
//   f32 accumulators, A from registers, B read by the tensor cores straight
//   from shared memory, so a K/V tile is read from shared memory once per
//   warpgroup instead of once per warp (with mma.sync and ldmatrix the first
//   version of this body was bound by those reads: 0.48 ms at the edit
//   shape on an H100, against 0.36 ms now).  The S accumulator is
//   exponentiated in place and repacked as P's A fragments, so P never
//   leaves registers;
// * software pipelining: S_{t+1} = Q.K_{t+1}^T is issued before tile t's
//   softmax, so the tensor cores work while the softmax runs (one wgmma
//   wait per tile, for S_{t+1} and P_t.V_t together);
// * the online softmax keeps each row's max and sum in the 4 lanes of a quad
//   (__shfl_xor_sync over lanes 1 and 2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int kRows = 128;              // q rows per block: 2 warpgroups
constexpr int kWarps = kRows / 16;      // 16 q rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;               // keys per K/V tile
constexpr int kStages = 3;              // K/V ring depth
constexpr int kBlockBytes = kKeys * 128;  // one 64-column block of a tile
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `chunk` of row `row` in the [kRows][D] Q
// tile, chunks XOR-swizzled within each group of 8 (conflict-free ldmatrix).
template <int D>
__device__ __forceinline__ int q_off(int row, int chunk) {
  return (row * (D / 8) + (chunk ^ (row & 7))) * 8;
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

// 16-byte global -> shared copy; with valid == false nothing is read and the
// 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's cp.async writes visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// Accumulator layout of wgmma m64nN (and of mma.m16n8 per n8 block): for
// warp w of the warpgroup and lane = 4 * gid + tig, d[4 * j + e] sits at row
// 16 * w + gid + 8 * (e >> 1), column 8 * j + 2 * tig + (e & 1).
//
// kSplit: o_part [S, B*Lq*H, D] f32 and ml [S, B*Lq*H] (m, l) float2, row
// (b * Lq + i) * H + h of split s, written for rows < Lq; out unused.
template <int D, bool kBias, bool kPrefix, bool kSplit>
__global__ void __launch_bounds__(kThreads)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ kv_hi, bf16* __restrict__ out,
                     float* __restrict__ o_part, float2* __restrict__ ml,
                     int Lq, int Lk, int H, int KV, int n_split,
                     float scale) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(!(kPrefix && (kBias || kSplit)),
                "prefix bounds take no bias and no split");
  constexpr int kChunks = D / 8;        // 16-byte chunks per row
  constexpr int kTile = kKeys * D;      // elements of one K or V tile
  constexpr int kN = kKeys / 8;         // n8 blocks of S
  constexpr int kDn = D / 8;            // n8 blocks of O

  // the K/V tiles must start on 1024-byte boundaries (the swizzle atom)
  extern __shared__ unsigned char tc_smem[];
  bf16* KVs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(tc_smem) + 1023) & ~uintptr_t(1023));
  bf16* Qs = KVs + kStages * 2 * kTile;           // [kRows][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  int q_tile = blockIdx.y, split = 0;
  if constexpr (kSplit) {
    q_tile = blockIdx.y / n_split;
    split = blockIdx.y % n_split;
  }
  if constexpr (kPrefix) q_tile = gridDim.y - 1 - blockIdx.y;
  const int q0 = q_tile * kRows;
  const int g = h / (H / KV);
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const bf16* qb = q + (long long)b * Lq * q_row + (long long)h * D;
  const bf16* kb = k + (long long)b * Lk * kv_row + (long long)g * D;
  const bf16* vb = v + (long long)b * Lk * kv_row + (long long)g * D;

  // the Q tile: one cp.async group
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = q0 + r < Lq;
    cp_async16(smem_u32(Qs + q_off<D>(r, c)),
               ok ? qb + (q0 + r) * q_row + c * 8 : qb, ok);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    bf16* Ks = KVs + stage * 2 * kTile;
    bf16* Vs = Ks + kTile;
    const int k0 = tile * kKeys;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = k0 + r < Lk;
      const long long off = ok ? (k0 + r) * kv_row + c * 8 : 0;
      cp_async16(smem_u32(Ks + kv_off(r, c)), kb + off, ok);
      cp_async16(smem_u32(Vs + kv_off(r, c)), vb + off, ok);
    }
  };

  // this thread's two q rows
  const int row_lo = q0 + warp * 16 + gid, row_hi = row_lo + 8;

  // the key tiles this block reads: [t_begin, t_end)
  int t_begin = 0, t_end = (Lk + kKeys - 1) / kKeys;
  // kPrefix: the rows' key bounds, clamped to [1, Lk] (rows >= Lq are never
  // written; bound 1 keeps them defined), and the block's highest bound
  int lim_lo = Lk, lim_hi = Lk;
  if constexpr (kPrefix) {
    __shared__ int hi_max;
    auto bound = [&](int row) {
      return row < Lq ? min(max(kv_hi[(long long)b * Lq + row], 1), Lk) : 1;
    };
    lim_lo = bound(row_lo);
    lim_hi = bound(row_hi);
    if (tid == 0) hi_max = 1;
    __syncthreads();
    const int mx = __reduce_max_sync(0xffffffffu, max(lim_lo, lim_hi));
    if (lane == 0) atomicMax(&hi_max, mx);
    __syncthreads();
    t_end = (hi_max + kKeys - 1) / kKeys;
  }
  if constexpr (kSplit) {  // n_split <= t_end: every range is non-empty
    const int n = t_end;
    t_begin = split * n / n_split;
    t_end = (split + 1) * n / n_split;
  }
  const int n_tiles = t_end - t_begin;

  load_kv(t_begin, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(t_begin + 1, 1);
  cp_async_commit();

  // bias rows clamped into range (rows >= Lq are never written, their bias
  // is read only to keep them finite)
  const float* bias_lo = nullptr;
  const float* bias_hi = nullptr;
  if constexpr (kBias) {
    bias_lo = bias + ((long long)b * Lq + min(row_lo, Lq - 1)) * Lk;
    bias_hi = bias + ((long long)b * Lq + min(row_hi, Lq - 1)) * Lk;
  }
  const bool bias_vec = (Lk & 1) == 0;
  const float scale_log2 = scale * kLog2e;

  uint32_t qf[D / 16][4];
  float o[kDn * 4];
#pragma unroll
  for (int i = 0; i < kDn * 4; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, rows lo / hi
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums

  // S = Q . K^T for the tile in `stage`, issued and committed, not waited
  // for: K-major K, 16 dims per step (a 32-byte step inside a 64-column
  // block, then the next block)
  auto issue_s = [&](float (&acc)[kN * 4], int stage) {
    const uint32_t ks = smem_u32(KVs + stage * 2 * kTile);
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n64<0>(acc, qf[kk],
                   desc_sw128(ks + (kk >> 2) * kBlockBytes + (kk & 3) * 32,
                              0, 1024));
    wgmma_commit();
  };

  // prologue: Q and the first tile landed, its S
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(smem_u32(Qs + q_off<D>(warp * 16 + (lane & 15),
                                   kk * 2 + (lane >> 4))),
            qf[kk]);
  float s[kN * 4];
  issue_s(s, 0);
  wgmma_wait<0>();
  fence_regs(s);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (t_begin + j) * kKeys;
    const bool next = j + 1 < n_tiles;

    // the bias of this tile in the accumulator's layout, issued first so
    // that its latency hides behind the barrier and the next S
    float bz[kN * 4];
    if constexpr (kBias) {
#pragma unroll
      for (int jn = 0; jn < kN; ++jn) {
        const int col = k0 + jn * 8 + 2 * tig;
        float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
        if (bias_vec) {
          if (col < Lk) {  // Lk even and col even: col + 1 < Lk as well
            lo = *reinterpret_cast<const float2*>(bias_lo + col);
            hi = *reinterpret_cast<const float2*>(bias_hi + col);
          }
        } else {
          if (col < Lk) {
            lo.x = bias_lo[col];
            hi.x = bias_hi[col];
          }
          if (col + 1 < Lk) {
            lo.y = bias_lo[col + 1];
            hi.y = bias_hi[col + 1];
          }
        }
        bz[4 * jn] = lo.x;
        bz[4 * jn + 1] = lo.y;
        bz[4 * jn + 2] = hi.x;
        bz[4 * jn + 3] = hi.y;
      }
    }

    // Tile j+1 has landed (its group is the newest); after the barrier
    // every warp is done with tile j-1, whose stage takes tile j+2.
    if (next) cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (j + 2 < n_tiles) load_kv(t_begin + j + 2, (j + 2) % kStages);
    cp_async_commit();

    // S_{j+1} runs on the tensor cores while tile j's softmax runs here
    float sn[kN * 4];
    if (next) issue_s(sn, (j + 1) % kStages);

    // online softmax of tile j in f32, on x * log2(e) (exp(x - m) =
    // 2^(x log2 e - m log2 e)).  Columns >= Lk (only in the sequence's last
    // tile) and, with kPrefix, at or past the row's bound get -inf.
    bool edge;
    if constexpr (kPrefix)
      edge = k0 + kKeys > min(lim_lo, lim_hi);
    else
      edge = k0 + kKeys > Lk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) {
      float x;
      if constexpr (kBias)   // the plain chain's score, then the base change
        x = __fmul_rn(__fadd_rn(__fmul_rn(s[i], scale), bz[i]), kLog2e);
      else
        x = __fmul_rn(s[i], scale_log2);
      const int col = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
      if constexpr (kPrefix) {
        if (edge && col >= ((i >> 1) & 1 ? lim_hi : lim_lo)) x = -INFINITY;
      } else {
        if (edge && col >= Lk) x = -INFINITY;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    // a block's first tile holds a key with a finite score for every row
    // (a split starts below Lk; under kPrefix key 0 is in tile 0 and every
    // bound is >= 1), so m is finite from it on (alpha = exp(-inf) = 0
    // there); a later tile whose columns are all -1e30 or all masked for a
    // row leaves its m as it is
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kDn * 4; ++i) o[i] *= alpha[(i >> 1) & 1];
    // p = 2^(x - m): the difference first, so that equal -1e30 scores give
    // exactly 1 and a -inf column exactly 0
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) {
      const float p = ex2(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
    // P as the A operand of P.V: k step kk covers keys 16kk..16kk+15, the
    // n8 blocks 2kk and 2kk+1 of S
    uint32_t pf[kN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P . V: MN-major V, 16 keys (two 8-row groups) per step
    const uint32_t vs =
        smem_u32(KVs + (j % kStages) * 2 * kTile + kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk)
      wgmma_pv<D>(o, pf[kk], desc_sw128(vs + kk * 2048, kBlockBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();  // S_{j+1} and P_j . V_j
    fence_regs(o);
    if (next) {
      fence_regs(sn);
#pragma unroll
      for (int i = 0; i < kN * 4; ++i) s[i] = sn[i];
    }
  }
  cp_async_wait<0>();

  const float l_lo = quad_sum(l[0]), l_hi = quad_sum(l[1]);
  if constexpr (kSplit) {
    // unnormalised o and (m, l) of this split, for split_combine_kernel
    const long long n_rows = (long long)gridDim.z * Lq * H;
    const long long r_lo =
        split * n_rows + ((long long)b * Lq + row_lo) * H + h;
    const long long r_hi = r_lo + 8LL * H;
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      const int col = n * 8 + 2 * tig;
      if (row_lo < Lq)
        *reinterpret_cast<float2*>(o_part + r_lo * D + col) =
            make_float2(o[4 * n], o[4 * n + 1]);
      if (row_hi < Lq)
        *reinterpret_cast<float2*>(o_part + r_hi * D + col) =
            make_float2(o[4 * n + 2], o[4 * n + 3]);
    }
    if (tig == 0) {
      if (row_lo < Lq) ml[r_lo] = make_float2(m[0], l_lo);
      if (row_hi < Lq) ml[r_hi] = make_float2(m[1], l_hi);
    }
    return;
  }
  bf16* ob = out + (long long)b * Lq * q_row + (long long)h * D;
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int col = n * 8 + 2 * tig;
    if (row_lo < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * q_row + col) =
          __floats2bfloat162_rn(o[4 * n] / l_lo, o[4 * n + 1] / l_lo);
    if (row_hi < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * q_row + col) =
          __floats2bfloat162_rn(o[4 * n + 2] / l_hi, o[4 * n + 3] / l_hi);
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
                     long long n_rows, int n_split) {
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
}

// Host side: the arguments of one call.  kv_hi only with kPrefix; o_part
// and ml (f32 scratch, n_split x [B*Lq*H, D] and n_split x [B*Lq*H, 2]) only
// with n_split > 1.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const int* kv_hi;
  void* out;
  float* o_part;
  float* ml;
  int B, Lq, Lk, H, KV, n_split;
  float scale;
};

template <int D, bool kBias, bool kPrefix, bool kSplit>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // + 1024 bytes to align the K/V ring to the swizzle atom
  const int smem =
      (kStages * 2 * kKeys + kRows) * D * (int)sizeof(bf16) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      attention_mma_kernel<D, kBias, kPrefix, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_q = (a.Lq + kRows - 1) / kRows;
  const dim3 grid(a.H, kSplit ? n_q * a.n_split : n_q, a.B);
  attention_mma_kernel<D, kBias, kPrefix, kSplit>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), a.bias, a.kv_hi,
          static_cast<bf16*>(a.out), a.o_part,
          reinterpret_cast<float2*>(a.ml), a.Lq, a.Lk, a.H, a.KV, a.n_split,
          a.scale);
  err = cudaGetLastError();
  if (!kSplit || err != cudaSuccess) return err;
  const long long n_rows = (long long)a.B * a.Lq * a.H;
  const long long n_threads = n_rows * (D / 4);
  split_combine_kernel<D><<<(unsigned)((n_threads + 255) / 256), 256, 0,
                            stream>>>(
      a.o_part, reinterpret_cast<const float2*>(a.ml),
      static_cast<bf16*>(a.out), n_rows, a.n_split);
  return cudaGetLastError();
}

template <int D, bool kPrefix, bool kSplit>
cudaError_t launch_bias(const Args& a, cudaStream_t stream) {
  if constexpr (kPrefix)
    return launch<D, false, true, false>(a, stream);
  else
    return a.bias ? launch<D, true, false, kSplit>(a, stream)
                  : launch<D, false, false, kSplit>(a, stream);
}

// bf16 q/k/v/out; D in {64, 128}; bias may be null.  Returns the
// cudaError_t of the first failing launch (0 on success).
template <bool kPrefix = false, bool kSplit = false>
int run(const Args& a, int D, cudaStream_t stream) {
  if (D == 128) return (int)launch_bias<128, kPrefix, kSplit>(a, stream);
  if (D == 64) return (int)launch_bias<64, kPrefix, kSplit>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// K1 and K3: no bounds, no split.
inline int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, void* out, int B, int Lq, int Lk, int H,
                    int KV, int D, float scale, cudaStream_t stream) {
  const Args a{q, k, v, bias, nullptr, out, nullptr, nullptr,
               B, Lq, Lk, H, KV, 1, scale};
  return run(a, D, stream);
}

}  // namespace tc
}  // namespace
