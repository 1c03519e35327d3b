// The gradient of the bf16 tensor-core attention (attention_ws.cuh) on
// Hopper's tensor cores (sm_90a), head dim D in {64, 128}.  K1, K2 and K3's
// backward (attention_bwd.cu); K1 and K2 first rotate q (and K1 k) with the
// forward's pre-pass and afterwards send dq (and dk) back through the
// transposed rotation (rope_rotate.cuh).
//
// Replaces the backward of the JAX package's custom VJPs
// (mmada_parallel_tpu/ops/attention.py _flash_diff_fn, _packed_diff_fn,
// _packed_qonly_diff_fn), which recompute the plain chain and leave it to
// XLA to fuse.  For out = softmax(q.k^T * scale + bias).v with GQA
// (g = h / (H / KV)), given dout, the forward's out and its row statistics
// (m, log2 l) (attention_ws.cuh's lse), it computes
//
//   delta = rowsum(dout o out)                          (f32; bwd_delta_kernel)
//   P     = 2^((x - m) - log2 l),  x the forward's base-2 score
//   dV    = sum over the group's heads of P^T . dout
//   dP    = dout . V^T,   dS = P o (dP - delta)
//   dK    = sum over the group's heads of dS^T . Q * scale
//   dQ    = dS . K * scale
//
// FlashAttention-2's backward dataflow, in two passes with plain stores: no
// atomics, so a gradient is bitwise the same from run to run (the mesh and
// ring training gates compare ranks with the solo step and rely on that).
//
// * dK/dV pass (attention_bwd_dkdv_kernel): one block per (kv head, 128-key
//   tile, batch row).  K and V stay in shared memory as the A operands of
//   S^T = K.Q^T and dP^T = V.dout^T, 64 keys per consumer warpgroup; the
//   block loops over the group's query heads and their 64-row q tiles (head
//   outside), which stream through a ring of stages: Q and dout, the rows'
//   (m, log2 l) and delta and, with a bias, its [64 q x 128 key] f32 tile.
//   P^T and dS^T are formed in the accumulators and repacked as bf16 A
//   fragments for dV += P^T.dout and dK += dS^T.Q, which read dout and Q
//   from the same stage as MN-major operands.
// * dQ pass (attention_bwd_dq_kernel): one block per (head, 128-row q tile,
//   batch row), Q and dout in shared memory as A operands, 64 rows per
//   consumer warpgroup; the key tiles stream through the ring (K, V and,
//   with a bias, its [128 q x 64 key] tile): S = Q.K^T, dP = dout.V^T, dS,
//   then dQ += dS.K (K as an MN-major operand).
//
// Every product is a wgmma with f32 accumulators; P and dS are rounded to
// bf16 as the A operand of their products (as the forward rounds P).  The
// bf16 tiles sit in shared memory in the forward's 128-byte swizzled layout
// (kv_off), so the same descriptors read a tile as a K-major or an MN-major
// operand.
//
// Conventions kept from the forward: the score x is recomputed with the
// forward's rounding (with a bias, ((s * scale) + bias) * log2 e, each step
// rounded); key columns >= Lk are -inf in the dQ pass, K/V rows past Lk are
// zero-filled and never written in the dK/dV pass, q rows past Lq are
// zero-filled, their P forced to 0 there and never written in the dQ pass.
// A row masked everywhere (bias -1e30) has x == m on every real key, so P =
// 2^-log2(Lk) = 1/Lk: the plain chain's uniform softmax and its gradients.
//
// What bounds it: the least work is five products of 2*B*H*Lq*Lk*D FLOPs
// (S, dP, dV, dK, dQ) against reading q, k, v, out, dout once and writing
// dq, dk, dv: at the A train step's shape (B=1, L=5120, H=32, D=128) 1.07
// TFLOP, at the tensor cores' 989 TFLOP/s 1.086 ms.  The two passes each
// recompute S and dP, seven products in all, so the kernel can reach at
// most 5/7 of that bound at the tensor cores' peak.
//
// The design, a warp-specialised Hopper kernel (FlashAttention-3's shape)
// in both passes:
//
// * 384 threads: two consumer warpgroups (warps 0-7) run the wgmmas and the
//   softmax; the producer warpgroup (warps 8-11) keeps the ring full (the
//   pieces are hopper_pipeline.cuh's, shared with the forward body).
//   setmaxnreg gives the consumers 232 registers a thread and the
//   producer 40.  A consumer's gain comes only from what the producer gives
//   back of the launch's 168 a thread: 128 x (168 - 40) = 256 x (232 -
//   168).  A producer at 32 with consumers at 240 leaves the consumers'
//   setmaxnreg.inc waiting forever (seen on the card); at 24 / 240 ptxas
//   spilled 4-48 bytes in the producer; at 40 / 232 nothing spills.
//   The D=128 dK/dV consumer holds dK and dV (128 f32), S^T and dP^T (64)
//   and, while they are repacked, P^T and dS^T as bf16 (32); the statistics
//   and the bias come from shared memory at 32-bit addresses.
// * The ring is a full/empty pair of mbarriers a stage.  Thread 0 of the
//   producer copies the bf16 tiles with TMA (cp.async.bulk.tensor, 3-D maps
//   over [B, L, heads*D] with boxes of 64 columns x 64 rows and the 128-byte
//   swizzle, which writes exactly the kv_off layout at a 1024-byte aligned
//   address; rows past Lq or Lk are past the map's L and come back as zeros,
//   never the next batch row's).  The producer's 128 threads copy the rows'
//   statistics (8- and 4-byte cp.async, zero past Lq) and, on the cp.async
//   route of the bias, the bias tile; their completion arrives on the same
//   full barrier (cp.async.mbarrier.arrive.noinc: 128 arrivals + thread 0's
//   expect_tx).  The consumers release a stage after their last product of
//   it has completed (256 arrivals on the empty barrier).  No __syncthreads
//   after the barriers are set up.  The resident tiles (K, V or Q, dout)
//   come on a barrier of their own.
// * Stages per (D, bias), the largest count <= 4 that fits 232,448 bytes
//   (bwd_smem below: 1,024 bytes of alignment slack, 8 bytes a barrier):
//     dK/dV: K and V resident, 512 D bytes; a stage holds Q and dout (256 D),
//       the statistics (768) and, with a bias, 32,768 bytes of bias.
//       D=128: 65,536 + 4 x 33,536 = 199,680 -> 4 stages; with a bias
//       65,536 + 2 x 66,304 = 198,144 -> 2 (3 would need 264,448).
//       D=64: 32,768 + 4 x 17,152 -> 4; with a bias 32,768 + 3 x 49,920 =
//       182,528 -> 3 (4 would need 232,448 + 1,096).
//     dQ: Q and dout resident, 512 D bytes; a stage holds K and V (256 D)
//       and, with a bias, 32,768.  D=128: 4 stages, with a bias 2; D=64: 4,
//       with a bias 4 (32,768 + 4 x 49,152 = 229,376).
// * The bias tile is staged in shared memory by the producer as boxes of 32
//   keys (128 bytes) x the tile's rows, in TMA's 128-byte swizzle (16-byte
//   chunk c of row r at c ^ (r & 7); bias_off).  With Lk % 4 == 0 (the row
//   stride a multiple of 16 bytes) and a 16-byte aligned bias, TMA copies it
//   from a 3-D map over [B, Lq, Lk]; otherwise (the M trainer's Lk = 2565)
//   the producer's threads copy it with 4-byte cp.async, 32 consecutive keys
//   of a row a warp, into the same layout.  The swizzle makes both readers
//   conflict-free: the dK/dV pass reads it transposed (a thread's 2 keys
//   against 16 q rows; for one register the 8 lanes of a quad row read 8
//   keys of one row and the 4 quads 4 rows of one parity, whose chunks
//   the XOR spreads over all 32 banks), the dQ pass as float2 along keys.
// * Ping-pong: the two consumer warpgroups take turns on two named barriers
//   to issue their products (S and dP; then dV and dK, or dQ), so one
//   warpgroup's exponentials and repacking run while the other's products
//   run on the tensor cores.  FlashAttention-3's other overlap, issuing
//   tile i+1's S and dP before tile i's exponentials, would hold a second
//   S/dP pair: 128 + 64 + 64 f32 in the D=128 dK/dV pass, more than the
//   232 registers a consumer has.  Within a warpgroup each group of products
//   is waited for before the next.
//
// What bounds it now (measured on an H100 by chip_smoke.py's
// phase_kernel_bwd): each pass runs its products at about 590 TFLOP/s, 60 %
// of the tensor cores' peak, which puts the seven products at about 40 % of
// the five-product bound.  A bias adds the staged tile's shared-memory
// traffic beside the products' operands: about +45 % by TMA, about twice
// that on the cp.async route, whose 4-byte copies are many instructions.
// Tried on the card and not kept: a separate 3-stage bias ring a tile ahead
// of the main ring (no gain); Q and dout held as register A fragments in
// the dQ pass (slower without a bias); and TMA for an odd Lk, by a map
// that sees the bias as one long row with a box a tile row, whose starts
// are 4-byte aligned: the card raised an illegal instruction (a TMA box
// must start on a 16-byte boundary, so the cp.async route stays).
//
// What the redesign changed (the first version waited for every product
// before the next step, issued 16-byte cp.async copies from all 256 threads
// into a 2-deep ring with a __syncthreads a tile, read the dK/dV pass's bias
// transposed from global memory one scalar at a time (and the dQ pass's as
// scalars at an odd Lk), and spilled 28-64 bytes at D=128): products now
// overlap with the other warpgroup's softmax; the copies are TMA and one
// producer warpgroup's cp.async into a 2-4 deep mbarrier ring; the bias is
// staged in shared memory; the consumers have 232 registers and no global
// address arithmetic.

#pragma once

#include "hopper_pipeline.cuh"

namespace {
namespace tc {

constexpr int kBiasTileBytes = 64 * 128 * 4;  // [64 q][128 keys] or [128][64]
constexpr int kStatsBytes = 64 * 12;          // 64 rows' (m, log2 l), delta

// Dynamic shared memory of one pass at `stages`: the resident tiles (K and
// V, or Q and dout: 2 x 128 rows x D bf16), a stage's streamed tiles (Q and
// dout, or K and V: 2 x 64 rows x D), its bias tile and (dK/dV) its rows'
// statistics, the barriers, and 1024 bytes to align to the swizzle atom.
template <int D, bool kBias, bool kDkdv>
__host__ __device__ constexpr int bwd_smem(int stages) {
  return 1024 + 4 * kKeys * D * 2 +
         stages * (2 * kKeys * D * 2 + (kBias ? kBiasTileBytes : 0) +
                   (kDkdv ? kStatsBytes : 0)) +
         (2 * stages + 1) * 8;
}

template <int D, bool kBias, bool kDkdv>
__host__ __device__ constexpr int bwd_stages() {
  int s = kMaxStages;
  while (s > 2 && bwd_smem<D, kBias, kDkdv>(s) > kSmemMax) --s;
  return s;
}

static_assert(bwd_smem<128, true, true>(bwd_stages<128, true, true>()) <=
                  kSmemMax &&
              bwd_smem<128, true, false>(bwd_stages<128, true, false>()) <=
                  kSmemMax &&
              bwd_smem<64, true, true>(bwd_stages<64, true, true>()) <=
                  kSmemMax &&
              bwd_smem<64, true, false>(bwd_stages<64, true, false>()) <=
                  kSmemMax,
              "a backward pass's ring does not fit in shared memory");

// an arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// N-byte (4 or 8) global -> shared copy, zero-filled when !valid
template <int N>
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(valid ? N : 0)
               : "memory");
}

// Byte offset of f32 element (row r, key c) of a staged bias tile: boxes of
// kBoxRows rows x 32 keys (128-byte rows), 16-byte chunk c/4 of row r at
// chunk (c/4) ^ (r & 7), as TMA's 128-byte swizzle writes a box.
template <int kBoxRows>
__device__ __forceinline__ uint32_t bias_off(int r, int c) {
  return (c >> 5) * (kBoxRows * 128) + r * 128 +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The cp.async route of the bias: rows [q0, q0 + kR) x keys [k0, k0 + kC)
// of one batch row's [Lq, Lk] bias (src) into the staged layout at dst,
// zero past Lq and Lk; 4-byte copies by the producer's 128 threads.  Thread
// pt copies key pt % kC of every (128 / kC)-th row, so a warp reads 32
// consecutive keys of a row.
template <int kR, int kC>
__device__ __forceinline__ void copy_bias(uint32_t dst, const float* src,
                                          int Lq, int Lk, int q0, int k0,
                                          int pt) {
  constexpr int kStep = 128 / kC;
  const int c = pt % kC;
  const int rows = k0 + c < Lk ? Lq - q0 : 0;  // rows to copy, none past Lk
  const float* tile = src + (long long)q0 * Lk + k0 + c;
#pragma unroll 4
  for (int r = pt / kC; r < kR; r += kStep) {
    const bool ok = r < rows;
    cp_async_n<4>(dst + bias_off<kR>(r, c), ok ? tile + r * Lk : src, ok);
  }
}

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d] in f32, for the
// n_rows = B*Lq*H rows of the packed [B, Lq, H*D] tensors; D/8 threads a
// row, 16 bytes each, summed across them with shuffles.
template <int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int Lq, int H, long long n_rows) {
  constexpr int kPer = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = i / kPer;
  const int d0 = (int)(i % kPer) * 8;
  float acc = 0.f;
  if (r < n_rows) {
    const uint4 o_raw = *reinterpret_cast<const uint4*>(out + r * D + d0);
    const uint4 g_raw = *reinterpret_cast<const uint4*>(dout + r * D + d0);
    const bf16* o = reinterpret_cast<const bf16*>(&o_raw);
    const bf16* g = reinterpret_cast<const bf16*>(&g_raw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc += __bfloat162float(o[e]) * __bfloat162float(g[e]);
  }
#pragma unroll
  for (int off = kPer / 2; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < n_rows && d0 == 0) {  // r = (b * Lq + i) * H + h
    const long long bi = r / H;
    delta[(bi / Lq * H + r % H) * Lq + bi % Lq] = acc;
  }
}

// The dK/dV pass.  Accumulator layout as in the forward: for warp w of the
// warpgroup and lane = 4 * gid + tig, d[4 * j + e] sits at row 16 * w + gid
// + 8 * (e >> 1) (a key of this warpgroup's 64) and column 8 * j + 2 * tig +
// (e & 1) (a q row of the tile, or a dim of dK/dV).
template <int D, bool kBias>
__global__ void __launch_bounds__(kWsThreads, 1)
attention_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_bias,
                          const float* __restrict__ bias, int bias_tma,
                          const float2* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Lq, int Lk, int H, int KV, float scale) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  constexpr int kS = bwd_stages<D, kBias, true>();
  constexpr int kTile = kKeys * D;  // elements of one [64][D] tile
  constexpr uint32_t kTileBytes = kTile * 2;
  constexpr int kN = kKeys / 8;     // n8 blocks of S^T: 64 q columns
  constexpr int kDn = D / 8;

  // byte offsets in shared memory: K and V [2][64][D] each, the ring
  // [kS][Q, dout][64][D], the bias tiles [kS][4 boxes][64][32] f32, the
  // rows' (m, log2 l) [kS][64] and delta [kS][64], the barriers (full[kS],
  // empty[kS], the resident tiles')
  constexpr uint32_t kRing = 4 * kTileBytes, kStage = 2 * kTileBytes;
  constexpr uint32_t kBiasAt = kRing + kS * kStage;
  constexpr uint32_t kStAt = kBiasAt + (kBias ? kS * kBiasTileBytes : 0);
  constexpr uint32_t kDlAt = kStAt + kS * kKeys * 8;
  constexpr uint32_t kBarAt = kDlAt + kS * kKeys * 4;
  extern __shared__ unsigned char tc_smem[];
  unsigned char* base = align_1024(tc_smem);
  const uint32_t sb = smem_u32(base);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, wg = warp >> 2;
  const int g = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kRows;
  const int G = H / KV;
  const int n_qt = (Lq + kKeys - 1) / kKeys;
  const int n_it = G * n_qt;  // (query head of the group, q tile) pairs
  const uint32_t full0 = sb + kBarAt, empty0 = full0 + 8 * kS;
  const uint32_t kv_bar = full0 + 16 * kS;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 129);
      mbar_init(empty0 + 8 * s, 256);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: shared memory at constant offsets from one 32-bit
    // base, the head and q tile stepped (few live registers) ----
    setmaxnreg_dec<kProducerRegs>();
    const int pt = tid - 256;
    if (pt == 0) {
      mbar_expect_tx(kv_bar, 4 * kTileBytes);
      for (int t = 0; t < 2; ++t)
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(sb + t * kTileBytes + cb * 8192, &tm_k, kv_bar,
                   g * D + cb * 64, k0 + t * kKeys, b);
          tma_load(sb + (2 + t) * kTileBytes + cb * 8192, &tm_v, kv_bar,
                   g * D + cb * 64, k0 + t * kKeys, b);
        }
    }
    int stage = 0, hq = g * G, q0 = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_it; ++it) {
      const uint32_t full = full0 + 8 * stage;
      mbar_wait(full + 8 * kS, phase ^ 1);  // the stage's empty barrier
      if (pt == 0) {
        mbar_expect_tx(full, 2 * kTileBytes +
                                 (kBias && bias_tma ? kBiasTileBytes : 0));
        const uint32_t qs = sb + kRing + stage * kStage;
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(qs + cb * 8192, &tm_q, full, hq * D + cb * 64, q0, b);
          tma_load(qs + kTileBytes + cb * 8192, &tm_do, full,
                   hq * D + cb * 64, q0, b);
        }
        if (kBias && bias_tma)
          for (int box = 0; box < 4; ++box)
            tma_load(sb + kBiasAt + stage * kBiasTileBytes + box * 8192,
                     &tm_bias, full, k0 + box * 32, q0, b);
      }
      if (pt < kKeys) {  // the rows' statistics; 0 past Lq (masked there)
        const int row = q0 + pt;
        const bool ok = row < Lq;
        const long long i = ((long long)b * H + hq) * Lq + row;
        cp_async_n<8>(sb + kStAt + (stage * kKeys + pt) * 8,
                      ok ? lse + i : lse, ok);
        cp_async_n<4>(sb + kDlAt + (stage * kKeys + pt) * 4,
                      ok ? delta + i : delta, ok);
      }
      if (kBias && !bias_tma)
        copy_bias<kKeys, kRows>(sb + kBiasAt + stage * kBiasTileBytes,
                                bias + (long long)b * Lq * Lk, Lq, Lk, q0,
                                k0, pt);
      cp_async_mbar_arrive(full);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
      if ((q0 += kKeys) >= Lq) {  // the next query head of the group
        q0 = 0;
        ++hq;
      }
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 ----
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = tid & 31, w = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const int key_lo = k0 + wg * 64 + w * 16 + gid, key_hi = key_lo + 8;
    const uint32_t ka = sb + wg * kTileBytes;
    const uint32_t va = sb + (2 + wg) * kTileBytes;
    const float scale_log2 = scale * kLog2e;
    // bias_off<64>(8 j + 2 tig + e, key - k0) = boff[key is hi][e] + 1024 j
    uint32_t boff[2][2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        boff[hi][e] = bias_off<kKeys>(2 * tig + e, wg * 64 + w * 16 + gid +
                                                       8 * hi);

    float dka[kDn * 4], dva[kDn * 4];
#pragma unroll
    for (int i = 0; i < kDn * 4; ++i) dka[i] = dva[i] = 0.f;

    if (wg == 1) named_arrive(1);  // warpgroup 0 issues first
    mbar_wait(kv_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (it % n_qt) * kKeys;
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t qs = sb + kRing + stage * kStage;
      const uint32_t ds = qs + kTileBytes;
      float s[kN * 4], dp[kN * 4];
#pragma unroll
      for (int i = 0; i < kN * 4; ++i) s[i] = dp[i] = 0.f;
      named_sync(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_kmajor(ka, kk), desc_kmajor(qs, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor(va, kk), desc_kmajor(ds, kk));
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T, q columns past Lq with P = 0, repacked 16 q rows at
      // a time as the A fragments of dV += P^T . dout and dK += dS^T . Q
      // (k step kk covers q rows 16kk..16kk+15, the n8 blocks 2kk, 2kk+1)
      const bool edge = q0 + kKeys > Lq;
      const float2* st_s =
          reinterpret_cast<const float2*>(base + kStAt) + stage * kKeys;
      const float* dl_s =
          reinterpret_cast<const float*>(base + kDlAt) + stage * kKeys;
      const unsigned char* bz_s = base + kBiasAt + stage * kBiasTileBytes;
      uint32_t pf[kN / 2][4], sf[kN / 2][4];
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = 8 * kk + u;
          const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
          float x;
          if constexpr (kBias) {
            const float bz = *reinterpret_cast<const float*>(
                bz_s + boff[(i >> 1) & 1][i & 1] + (i >> 2) * 1024);
            x = __fmul_rn(__fadd_rn(__fmul_rn(s[i], scale), bz), kLog2e);
          } else {
            x = __fmul_rn(s[i], scale_log2);
          }
          const float2 ml = st_s[col];
          float p = ex2((x - ml.x) - ml.y);
          if (edge && q0 + col >= Lq) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl_s[col]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          sf[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
        }
      }
      named_sync(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk)
        wgmma_pv<D>(dva, pf[kk], desc_mnmajor(ds, kk));
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk)
        wgmma_pv<D>(dka, sf[kk], desc_mnmajor(qs, kk));
      wgmma_commit();
      if (wg == 0 || it + 1 < n_it) named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(empty0 + 8 * stage);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long long kv_row = (long long)KV * D;
    bf16* dkb = dk + (long long)b * Lk * kv_row + (long long)g * D;
    bf16* dvb = dv + (long long)b * Lk * kv_row + (long long)g * D;
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      const int col = n * 8 + 2 * tig;
      if (key_lo < Lk) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key_lo * kv_row + col) =
            __floats2bfloat162_rn(dka[4 * n] * scale, dka[4 * n + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key_lo * kv_row + col) =
            __floats2bfloat162_rn(dva[4 * n], dva[4 * n + 1]);
      }
      if (key_hi < Lk) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key_hi * kv_row + col) =
            __floats2bfloat162_rn(dka[4 * n + 2] * scale,
                                  dka[4 * n + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key_hi * kv_row + col) =
            __floats2bfloat162_rn(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

// The dQ pass: accumulator rows are this warpgroup's q rows, columns keys
// of the tile (S, dP) or dims (dQ).
template <int D, bool kBias>
__global__ void __launch_bounds__(kWsThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_bias,
                        const float* __restrict__ bias, int bias_tma,
                        const float2* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Lq, int Lk, int H, int KV,
                        float scale) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  constexpr int kS = bwd_stages<D, kBias, false>();
  constexpr int kTile = kKeys * D;
  constexpr uint32_t kTileBytes = kTile * 2;
  constexpr int kN = kKeys / 8;
  constexpr int kDn = D / 8;

  // byte offsets in shared memory: Q and dout [2][64][D] each, the ring
  // [kS][K, V][64][D], the bias tiles [kS][2 boxes][128][32] f32, the
  // barriers (full[kS], empty[kS], the resident tiles')
  constexpr uint32_t kRing = 4 * kTileBytes, kStage = 2 * kTileBytes;
  constexpr uint32_t kBiasAt = kRing + kS * kStage;
  constexpr uint32_t kBarAt = kBiasAt + (kBias ? kS * kBiasTileBytes : 0);
  extern __shared__ unsigned char tc_smem[];
  unsigned char* base = align_1024(tc_smem);
  const uint32_t sb = smem_u32(base);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, wg = warp >> 2;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = blockIdx.y * kRows;
  const int g = h / (H / KV);
  const int n_tiles = (Lk + kKeys - 1) / kKeys;
  const uint32_t full0 = sb + kBarAt, empty0 = full0 + 8 * kS;
  const uint32_t q_bar = full0 + 16 * kS;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 129);
      mbar_init(empty0 + 8 * s, 256);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer (as in the dK/dV pass) ----
    setmaxnreg_dec<kProducerRegs>();
    const int pt = tid - 256;
    if (pt == 0) {
      mbar_expect_tx(q_bar, 4 * kTileBytes);
      for (int t = 0; t < 2; ++t)
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(sb + t * kTileBytes + cb * 8192, &tm_q, q_bar,
                   h * D + cb * 64, q0 + t * kKeys, b);
          tma_load(sb + (2 + t) * kTileBytes + cb * 8192, &tm_do, q_bar,
                   h * D + cb * 64, q0 + t * kKeys, b);
        }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < Lk; k0 += kKeys) {
      const uint32_t full = full0 + 8 * stage;
      mbar_wait(full + 8 * kS, phase ^ 1);  // the stage's empty barrier
      if (pt == 0) {
        mbar_expect_tx(full, 2 * kTileBytes +
                                 (kBias && bias_tma ? kBiasTileBytes : 0));
        const uint32_t ks = sb + kRing + stage * kStage;
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(ks + cb * 8192, &tm_k, full, g * D + cb * 64, k0, b);
          tma_load(ks + kTileBytes + cb * 8192, &tm_v, full, g * D + cb * 64,
                   k0, b);
        }
        if (kBias && bias_tma)
          for (int box = 0; box < 2; ++box)
            tma_load(sb + kBiasAt + stage * kBiasTileBytes + box * 16384,
                     &tm_bias, full, k0 + box * 32, q0, b);
      }
      if (kBias && !bias_tma)
        copy_bias<kRows, kKeys>(sb + kBiasAt + stage * kBiasTileBytes,
                                bias + (long long)b * Lq * Lk, Lq, Lk, q0,
                                k0, pt);
      cp_async_mbar_arrive(full);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = tid & 31, w = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    // this thread's two q rows and their statistics (0 past Lq: those rows
    // are computed on zero q and dout and never written)
    const int row_lo = q0 + wg * 64 + w * 16 + gid, row_hi = row_lo + 8;
    float m[2], lg[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_hi : row_lo;
      const long long i = ((long long)b * H + h) * Lq + row;
      const float2 ml = row < Lq ? lse[i] : make_float2(0.f, 0.f);
      m[r] = ml.x;
      lg[r] = ml.y;
      dlt[r] = row < Lq ? delta[i] : 0.f;
    }
    // bias_off<128>(row - q0, 8 jn + 2 tig) = (jn >> 2) * 16384 + brow[r]
    // + ((2 (jn & 3) ^ bxor) << 4): row & 7 == gid, the chunk of key 8 jn +
    // 2 tig in its box 2 (jn & 3) + (tig >> 1)
    const uint32_t brow0 = (wg * 64 + w * 16 + gid) * 128 + 8 * (tig & 1);
    const uint32_t bxor = (tig >> 1) ^ gid;
    const float scale_log2 = scale * kLog2e;
    const uint32_t qa = sb + wg * kTileBytes;
    const uint32_t da = sb + (2 + wg) * kTileBytes;

    float dqa[kDn * 4];
#pragma unroll
    for (int i = 0; i < kDn * 4; ++i) dqa[i] = 0.f;

    if (wg == 1) named_arrive(1);  // warpgroup 0 issues first
    mbar_wait(q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kKeys;
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t ks = sb + kRing + stage * kStage;
      const uint32_t vs = ks + kTileBytes;
      float s[kN * 4], dp[kN * 4];
#pragma unroll
      for (int i = 0; i < kN * 4; ++i) s[i] = dp[i] = 0.f;
      named_sync(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_kmajor(qa, kk), desc_kmajor(ks, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor(da, kk), desc_kmajor(vs, kk));
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const bool edge = k0 + kKeys > Lk;
      const unsigned char* bz_s = base + kBiasAt + stage * kBiasTileBytes;
#pragma unroll
      for (int jn = 0; jn < kN; ++jn) {
        float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
        if constexpr (kBias) {
          const uint32_t off =
              (jn >> 2) * 16384 + (((2 * (jn & 3)) ^ bxor) << 4) + brow0;
          lo = *reinterpret_cast<const float2*>(bz_s + off);
          hi = *reinterpret_cast<const float2*>(bz_s + off + 8 * 128);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          const int r = e >> 1;
          float x;
          if constexpr (kBias) {
            const float bz = e == 0 ? lo.x : e == 1 ? lo.y : e == 2 ? hi.x
                                                                    : hi.y;
            x = __fmul_rn(__fadd_rn(__fmul_rn(s[i], scale), bz), kLog2e);
          } else {
            x = __fmul_rn(s[i], scale_log2);
          }
          const int col = k0 + jn * 8 + 2 * tig + (e & 1);
          if (edge && col >= Lk) x = -INFINITY;
          const float p = ex2((x - m[r]) - lg[r]);
          s[i] = p * (dp[i] - dlt[r]);
        }
      }
      uint32_t sf[kN / 2][4];
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      }
      named_sync(1 + wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk)
        wgmma_pv<D>(dqa, sf[kk], desc_mnmajor(ks, kk));
      wgmma_commit();
      if (wg == 0 || j + 1 < n_tiles) named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(dqa);
      mbar_arrive(empty0 + 8 * stage);
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long long q_row = (long long)H * D;
    bf16* dqb = dq + (long long)b * Lq * q_row + (long long)h * D;
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      const int col = n * 8 + 2 * tig;
      if (row_lo < Lq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + row_lo * q_row + col) =
            __floats2bfloat162_rn(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
      if (row_hi < Lq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + row_hi * q_row + col) =
            __floats2bfloat162_rn(dqa[4 * n + 2] * scale,
                                  dqa[4 * n + 3] * scale);
    }
  }
}

// Host side of one backward: bf16 q/k/v/out/dout, dq/dk/dv (dq shaped as
// q, dk/dv as k), lse f32 [B, H, Lq, 2] from the forward, delta f32 scratch
// [B, H, Lq]; bias f32 [B, 1, Lq, Lk] or null.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Lq, Lk, H, KV;
  float scale;
};

template <int D, bool kBias>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const long long n_rows = (long long)a.B * a.Lq * a.H;
  const long long n_threads = n_rows * (D / 8);
  bwd_delta_kernel<D><<<(unsigned)((n_threads + 255) / 256), 256, 0,
                        stream>>>(static_cast<const bf16*>(a.out),
                                  static_cast<const bf16*>(a.dout), a.delta,
                                  a.Lq, a.H, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* lse = reinterpret_cast<const float2*>(a.lse);

  // the bf16 tensors as [B, L, heads*D] with [64 rows][64 columns] boxes;
  // the bias as [B, Lq, Lk] f32 with boxes of 32 keys x 64 (dK/dV) or 128
  // (dQ) rows, where TMA can read it: a row stride (Lk * 4 bytes) and a
  // start on 16-byte boundaries
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_bkv{}, tm_bq{};
  const CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long qc = (long long)a.H * D, kc = (long long)a.KV * D;
  bool ok = encode_3d(&tm_q, a.q, kBf16, 2, qc, a.Lq, a.B, 64, 64) &&
            encode_3d(&tm_do, a.dout, kBf16, 2, qc, a.Lq, a.B, 64, 64) &&
            encode_3d(&tm_k, a.k, kBf16, 2, kc, a.Lk, a.B, 64, 64) &&
            encode_3d(&tm_v, a.v, kBf16, 2, kc, a.Lk, a.B, 64, 64);
  const int bias_tma = kBias && a.Lk % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(a.bias) % 16 == 0;
  if (bias_tma)
    ok = ok &&
         encode_3d(&tm_bkv, a.bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.Lk,
                   a.Lq, a.B, 32, kKeys) &&
         encode_3d(&tm_bq, a.bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.Lk,
                   a.Lq, a.B, 32, kRows);
  if (!ok) return cudaErrorInvalidValue;

  const int smem_kv =
      bwd_smem<D, kBias, true>(bwd_stages<D, kBias, true>());
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D, kBias>
      <<<dim3(a.KV, (a.Lk + kRows - 1) / kRows, a.B), kWsThreads, smem_kv,
         stream>>>(tm_q, tm_do, tm_k, tm_v, tm_bkv, a.bias, bias_tma, lse,
                   a.delta, static_cast<bf16*>(a.dk),
                   static_cast<bf16*>(a.dv), a.Lq, a.Lk, a.H, a.KV, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = bwd_smem<D, kBias, false>(bwd_stages<D, kBias, false>());
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<D, kBias>
      <<<dim3(a.H, (a.Lq + kRows - 1) / kRows, a.B), kWsThreads, smem_q,
         stream>>>(tm_q, tm_do, tm_k, tm_v, tm_bq, a.bias, bias_tma, lse,
                   a.delta, static_cast<bf16*>(a.dq), a.Lq, a.Lk, a.H, a.KV,
                   a.scale);
  return cudaGetLastError();
}

// Returns the cudaError_t of the first failing launch (0 on success).
inline int run_bwd(const BwdArgs& a, int D, cudaStream_t stream) {
  if (D == 128)
    return (int)(a.bias ? launch_bwd<128, true>(a, stream)
                        : launch_bwd<128, false>(a, stream));
  if (D == 64)
    return (int)(a.bias ? launch_bwd<64, true>(a, stream)
                        : launch_bwd<64, false>(a, stream));
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace
