// The gradient of the bf16 tensor-core attention (attention_mma.cuh) on
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
// (m, log2 l) (attention_mma.cuh's lse), it computes
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
//   tile, batch row), two warpgroups of 64 keys.  K and V stay in shared
//   memory as the A operands of S^T = K.Q^T and dP^T = V.dout^T; the block
//   loops over the group's query heads and their 64-row q tiles, which
//   stream through a 2-stage cp.async ring (Q and dout, with the rows' (m,
//   log2 l) and delta).  P^T and dS^T are formed in the accumulators and
//   repacked as bf16 A fragments for dV += P^T.dout and dK += dS^T.Q, which
//   read Q and dout from the same tiles as MN-major operands.
// * dQ pass (attention_bwd_dq_kernel): one block per (head, 128-row q tile,
//   batch row), two warpgroups of 64 rows, Q and dout in shared memory as
//   A operands; the key tiles stream through the ring: S = Q.K^T,
//   dP = dout.V^T, dS, then dQ += dS.K (K as an MN-major operand).
//
// Every product is a wgmma with f32 accumulators; P and dS are rounded to
// bf16 as the A operand of their products (as the forward rounds P).  Tiles
// sit in shared memory in the forward's 128-byte swizzled layout (kv_off),
// so the same descriptors read a tile as a K-major or an MN-major operand.
//
// Conventions kept from the forward: the score x is recomputed with the
// forward's rounding (with a bias, scale and bias added and then the base
// change); key columns >= Lk are -inf in the dQ pass, K/V rows past Lk are
// zero-filled and never written in the dK/dV pass, q rows past Lq are
// zero-filled, their P forced to 0 there and never written in the dQ pass;
// the bias is read as float2 where the forward reads it so (the dQ pass,
// even Lk) and as scalars elsewhere.  A row masked everywhere (bias -1e30)
// has x == m on every real key, so P = 2^-log2(Lk) = 1/Lk: the plain chain's
// uniform softmax and its gradients.
//
// What bounds it: the least work is five products of 2*B*H*Lq*Lk*D FLOPs
// (S, dP, dV, dK, dQ) against reading q, k, v, out, dout once and writing
// dq, dk, dv: at the A train step's shape (B=1, L=5120, H=32, D=128) 1.07
// TFLOP, at the tensor cores' 989 TFLOP/s 1.085 ms.  The two passes each
// recompute S and dP (seven products in all), and this first version waits
// for each product before the next, without TMA or ping-pong warpgroups
// (ROADMAP).

#pragma once

#include "attention_mma.cuh"

namespace {
namespace tc {

constexpr int kBwdStages = 2;  // ring depth of the streamed tiles

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

#undef TC_F8

// Descriptor of the 16-wide k step kk of a [64][D] tile read as a K-major
// operand (rows are M or N, columns the contraction), and of the 16-row k
// step kk of one read as an MN-major operand (rows are the contraction).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * kBlockBytes + (kk & 3) * 32, 0, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, kBlockBytes, 1024);
}

__device__ __forceinline__ bf16* align_1024(unsigned char* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                 ~uintptr_t(1023));
}

// Copy D columns of rows [r0, r0 + 64 * n_tiles) of a [rows, stride] bf16
// tensor (src: row 0, first column) into n_tiles [64][D] swizzled tiles,
// zero-filling rows >= limit.  Issued by all kThreads threads, not
// committed.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int r0,
                                          int n_tiles, int limit) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < n_tiles * kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < limit;
    cp_async16(smem_u32(dst + (r >> 6) * kKeys * D + kv_off(r & 63, c)),
               ok ? src + (r0 + r) * stride + c * 8 : src, ok);
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
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          const bf16* __restrict__ dout,
                          const float2* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Lq, int Lk, int H, int KV, float scale) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  constexpr int kTile = kKeys * D;  // elements of one [64][D] tile
  constexpr int kN = kKeys / 8;     // n8 blocks of S^T: 64 q columns
  constexpr int kDn = D / 8;

  extern __shared__ unsigned char tc_smem[];
  bf16* Ks = align_1024(tc_smem);               // [2][64][D]
  bf16* Vs = Ks + 2 * kTile;                    // [2][64][D]
  bf16* ring = Vs + 2 * kTile;                  // [stages][Q, dout][64][D]
  float2* st = reinterpret_cast<float2*>(ring + kBwdStages * 2 * kTile);
  float* dl = reinterpret_cast<float*>(st + kBwdStages * kKeys);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;
  const int g = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * kRows;
  const int G = H / KV;
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const bf16* kb = k + (long long)b * Lk * kv_row + (long long)g * D;
  const bf16* vb = v + (long long)b * Lk * kv_row + (long long)g * D;

  load_rows<D>(Ks, kb, kv_row, k0, 2, Lk);
  load_rows<D>(Vs, vb, kv_row, k0, 2, Lk);
  cp_async_commit();

  const int n_qt = (Lq + kKeys - 1) / kKeys;
  const int n_it = G * n_qt;  // (query head of the group, q tile) pairs
  auto load_q = [&](int it, int stage) {
    const int hq = g * G + it / n_qt, q0 = (it % n_qt) * kKeys;
    const long long off = (long long)b * Lq * q_row + (long long)hq * D;
    bf16* Qs = ring + stage * 2 * kTile;
    load_rows<D>(Qs, q + off, q_row, q0, 1, Lq);
    load_rows<D>(Qs + kTile, dout + off, q_row, q0, 1, Lq);
    if (tid < kKeys) {  // the rows' statistics; 0 past Lq (masked there)
      const int row = q0 + tid;
      const long long i = ((long long)b * H + hq) * Lq + row;
      st[stage * kKeys + tid] =
          row < Lq ? lse[i] : make_float2(0.f, 0.f);
      dl[stage * kKeys + tid] = row < Lq ? delta[i] : 0.f;
    }
  };
  load_q(0, 0);
  cp_async_commit();

  // this thread's two keys
  const int key_lo = k0 + warp * 16 + gid, key_hi = key_lo + 8;
  const uint32_t ka = smem_u32(Ks + wg * kTile);
  const uint32_t va = smem_u32(Vs + wg * kTile);
  const float scale_log2 = scale * kLog2e;

  float dka[kDn * 4], dva[kDn * 4];
#pragma unroll
  for (int i = 0; i < kDn * 4; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it % kBwdStages;
    const int q0 = (it % n_qt) * kKeys;
    // tile it has landed (and K/V with the first); after the barrier every
    // warp is done with tile it-1, whose stage takes tile it+1
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1, (it + 1) % kBwdStages);
    cp_async_commit();

    const uint32_t qs = smem_u32(ring + stage * 2 * kTile);
    const uint32_t ds = qs + kTile * (uint32_t)sizeof(bf16);
    float s[kN * 4], dp[kN * 4];
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(ka, kk), desc_kmajor(qs, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(va, kk), desc_kmajor(ds, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place; q columns past Lq get P = 0
    const bool edge = q0 + kKeys > Lq;
    const float* bias_b = kBias ? bias + (long long)b * Lq * Lk : nullptr;
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) {
      const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
      const int key = (i >> 1) & 1 ? key_hi : key_lo;
      float x;
      if constexpr (kBias) {
        const float bz = (q0 + col < Lq && key < Lk)
                             ? bias_b[(long long)(q0 + col) * Lk + key]
                             : 0.f;
        x = __fmul_rn(__fadd_rn(__fmul_rn(s[i], scale), bz), kLog2e);
      } else {
        x = __fmul_rn(s[i], scale_log2);
      }
      const float2 ml = st[stage * kKeys + col];
      float p = ex2((x - ml.x) - ml.y);
      if (edge && q0 + col >= Lq) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - dl[stage * kKeys + col]);
    }
    // the A fragments of dV += P^T . dout and dK += dS^T . Q: k step kk
    // covers q rows 16kk..16kk+15, the n8 blocks 2kk and 2kk+1
    uint32_t pf[kN / 2][4], sf[kN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        sf[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk)
      wgmma_pv<D>(dva, pf[kk], desc_mnmajor(ds, kk));
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk)
      wgmma_pv<D>(dka, sf[kk], desc_mnmajor(qs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait<0>();

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

// The dQ pass: accumulator rows are this warpgroup's q rows, columns keys
// of the tile (S, dP) or dims (dQ).
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const bf16* __restrict__ dout,
                        const float2* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Lq, int Lk, int H, int KV,
                        float scale) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  constexpr int kTile = kKeys * D;
  constexpr int kN = kKeys / 8;
  constexpr int kDn = D / 8;

  extern __shared__ unsigned char tc_smem[];
  bf16* Qs = align_1024(tc_smem);               // [2][64][D]
  bf16* Ds = Qs + 2 * kTile;                    // dout, [2][64][D]
  bf16* ring = Ds + 2 * kTile;                  // [stages][K, V][64][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = blockIdx.y * kRows;
  const int g = h / (H / KV);
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const long long q_off = (long long)b * Lq * q_row + (long long)h * D;
  const bf16* kb = k + (long long)b * Lk * kv_row + (long long)g * D;
  const bf16* vb = v + (long long)b * Lk * kv_row + (long long)g * D;

  load_rows<D>(Qs, q + q_off, q_row, q0, 2, Lq);
  load_rows<D>(Ds, dout + q_off, q_row, q0, 2, Lq);
  cp_async_commit();
  auto load_kv = [&](int tile, int stage) {
    bf16* Kt = ring + stage * 2 * kTile;
    load_rows<D>(Kt, kb, kv_row, tile * kKeys, 1, Lk);
    load_rows<D>(Kt + kTile, vb, kv_row, tile * kKeys, 1, Lk);
  };
  load_kv(0, 0);
  cp_async_commit();

  // this thread's two q rows and their statistics (0 past Lq: those rows
  // are computed on zero q and dout and never written)
  const int row_lo = q0 + warp * 16 + gid, row_hi = row_lo + 8;
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
  const float* bias_lo = nullptr;
  const float* bias_hi = nullptr;
  if constexpr (kBias) {
    bias_lo = bias + ((long long)b * Lq + min(row_lo, Lq - 1)) * Lk;
    bias_hi = bias + ((long long)b * Lq + min(row_hi, Lq - 1)) * Lk;
  }
  const bool bias_vec = (Lk & 1) == 0;
  const float scale_log2 = scale * kLog2e;
  const uint32_t qa = smem_u32(Qs + wg * kTile);
  const uint32_t da = smem_u32(Ds + wg * kTile);

  float dqa[kDn * 4];
#pragma unroll
  for (int i = 0; i < kDn * 4; ++i) dqa[i] = 0.f;

  const int n_tiles = (Lk + kKeys - 1) / kKeys;
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kBwdStages;
    const int k0 = j * kKeys;
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) % kBwdStages);
    cp_async_commit();

    const uint32_t ks = smem_u32(ring + stage * 2 * kTile);
    const uint32_t vs = ks + kTile * (uint32_t)sizeof(bf16);
    float s[kN * 4], dp[kN * 4];
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(qa, kk), desc_kmajor(ks, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(da, kk), desc_kmajor(vs, kk));
    wgmma_commit();

    // the bias of this tile, read as the forward reads it, while the
    // products run
    float bz[kN * 4];
    if constexpr (kBias) {
#pragma unroll
      for (int jn = 0; jn < kN; ++jn) {
        const int col = k0 + jn * 8 + 2 * tig;
        float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
        if (bias_vec) {
          if (col < Lk) {
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
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = k0 + kKeys > Lk;
#pragma unroll
    for (int i = 0; i < kN * 4; ++i) {
      const int r = (i >> 1) & 1;
      float x;
      if constexpr (kBias)
        x = __fmul_rn(__fadd_rn(__fmul_rn(s[i], scale), bz[i]), kLog2e);
      else
        x = __fmul_rn(s[i], scale_log2);
      const int col = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
      if (edge && col >= Lk) x = -INFINITY;
      const float p = ex2((x - m[r]) - lg[r]);
      s[i] = p * (dp[i] - dlt[r]);
    }
    uint32_t sf[kN / 2][4];
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk)
      wgmma_pv<D>(dqa, sf[kk], desc_mnmajor(ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
  }
  cp_async_wait<0>();

  bf16* dqb = dq + q_off;
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

  // K and V (2 tiles each) and the ring's Q and dout tiles, the rows'
  // statistics, + 1024 bytes to align to the swizzle atom
  const int smem_kv = (4 + 2 * kBwdStages) * kKeys * D * (int)sizeof(bf16) +
                      kBwdStages * kKeys * (int)(sizeof(float2) + sizeof(float)) +
                      1024;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D, kBias>
      <<<dim3(a.KV, (a.Lk + kRows - 1) / kRows, a.B), kThreads, smem_kv,
         stream>>>(static_cast<const bf16*>(a.q),
                   static_cast<const bf16*>(a.k),
                   static_cast<const bf16*>(a.v), a.bias,
                   static_cast<const bf16*>(a.dout), lse, a.delta,
                   static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Lq,
                   a.Lk, a.H, a.KV, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = (4 + 2 * kBwdStages) * kKeys * D * (int)sizeof(bf16) +
                     1024;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<D, kBias>
      <<<dim3(a.H, (a.Lq + kRows - 1) / kRows, a.B), kThreads, smem_q,
         stream>>>(static_cast<const bf16*>(a.q),
                   static_cast<const bf16*>(a.k),
                   static_cast<const bf16*>(a.v), a.bias,
                   static_cast<const bf16*>(a.dout), lse, a.delta,
                   static_cast<bf16*>(a.dq), a.Lq, a.Lk, a.H, a.KV, a.scale);
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
