// Packed bidirectional flash attention for Hopper (sm_90a) in f32 on the
// FMA pipes: the f32 path of the four attention kernels of the port (their
// bf16 path is the warp-specialised tensor-core body of attention_ws.cuh;
// tensor cores would compute f32 in TF32).  One template, three compile-time flags:
//
//   kRopeQ    rotate q on load (f32 Neox RoPE from sin_q/cos_q tables);
//   kRopeK    rotate k on load (from sin_k/cos_k tables);
//   kPrefix   mask with per-row key bounds kv_hi [B, Lq] in place of a bias:
//             row i attends to keys kv < clamp(kv_hi[b, i], 1, Lk), and key
//             tiles past the q tile's highest bound are never loaded.
//
//   flash_attention_rope.cu         K1  kRopeQ, kRopeK     (pre-RoPE q and k)
//   flash_attention_rope_qonly.cu   K2  kRopeQ             (k pre-rotated)
//   flash_attention.cu              K3  none               (BLHD, no RoPE)
//   flash_attention_rope_prefix.cu  K4  kRopeQ, kRopeK, kPrefix
//
// Contract of the template:
//
//   q [B, Lq, H*D], k/v [B, Lk, KV*D], f32 (a contiguous BLHD [B, L, H, D]
//   tensor is the same memory as packed [B, L, H*D]);
//   sin/cos f32 tables [L, D] (shared) or [B, L, D] (per-row positions);
//   optional additive f32 bias [B, 1, Lq, Lk], or with kPrefix int32 bounds
//   kv_hi [B, Lq] (no bias);
//   out[b, i, h*D:(h+1)*D] = softmax(q'_h . k'_g^T * D^-1/2 + bias) . v_g
//   with g = h / (H / KV) (GQA), q' / k' rotated or read as stored.
//
// Numerics follow the TPU kernels: a rotation is done in f32 with no FMA
// contraction (rope_attention.py _rope_rows); scores and the softmax run in
// f32; p.v accumulates in f32; the row sum is divided out at the end.  Key
// columns >= Lk are skipped by bounds checks, so a row whose bias is -1e30
// everywhere returns mean(v) over the Lk real keys, exactly as the plain
// reference does (the TPU kernels pad keys to 128).  With kPrefix a masked
// key is skipped the same way (p = 0); a row's bound is at least 1, so key 0
// is always in its first tile and no row is fully masked.  That is the dense
// reference with bias 0 / -1e30 exactly, since exp(-1e30 - m) is 0 in f32.
//
// What bounds it on this card: the f32 products on the FMA pipes (67
// TFLOP/s; 4*B*H*Lq*Lk*D flops).  f32 is the precision of the tests and the
// small models, not of serving, so the design stays simple: one thread
// block per (b*h, 64 q rows), 256 threads; the (rotated) Q tile stays in
// shared memory, K/V stream through shared memory in 64-key tiles with the
// online-softmax recurrence (no L x L scores anywhere, no length cap, any
// GQA ratio), and each thread keeps a 4x4 score tile and a 4x(D/16) output
// tile in registers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;    // q rows per thread block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16 threads, each owning 4 q rows

// Element d of the f32 Neox rotation of one head row x[0:D]:
// x*cos + rotate_half(x)*sin with rotate_half([x1, x2]) = [-x2, x1], as two
// rounded products and a rounded sum (no FMA contraction).
template <int D>
__device__ __forceinline__ float rope_elem(const float* __restrict__ x,
                                           const float* __restrict__ s,
                                           const float* __restrict__ c,
                                           int d) {
  const float rot = d < D / 2 ? -x[d + D / 2] : x[d - D / 2];
  return __fadd_rn(__fmul_rn(x[d], c[d]), __fmul_rn(rot, s[d]));
}

// Element d of one head row, rotated at table row `pos` when kRope, else as
// stored (the tables are then never read).
template <int D, bool kRope>
__device__ __forceinline__ float load_elem(const float* __restrict__ x,
                                           const float* __restrict__ s,
                                           const float* __restrict__ c,
                                           long long pos, int d) {
  if constexpr (kRope) {
    return rope_elem<D>(x, s + pos * D, c + pos * D, d);
  } else {
    return x[d];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D, bool kRopeQ, bool kRopeK, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ sin_q,
                 const float* __restrict__ cos_q,
                 const float* __restrict__ sin_k,
                 const float* __restrict__ cos_k,
                 const float* __restrict__ bias,
                 const int* __restrict__ kv_hi, float* __restrict__ out,
                 int Lq, int Lk, int H, int KV, long long tq_bstride,
                 long long tk_bstride, float scale) {
  constexpr int P = D + 1;            // padded row: conflict-free column reads
  constexpr int kCols = D / 16;       // output columns per thread
  constexpr int PS = kBlockK + 1;     // padded row of the probability tile
  static_assert(kBlockQ * PS <= kBlockK * P, "P tile must fit in the K tile");

  extern __shared__ float smem[];
  __shared__ int his[kBlockQ];        // kPrefix: clamped bound of each row
  __shared__ int hi_max;              // kPrefix: the tile's highest bound
  float* Qs = smem;                   // [kBlockQ][P] q (rotated if kRopeQ)
  float* Ks = Qs + kBlockQ * P;       // [kBlockK][P] k (rotated if kRopeK)
  float* Vs = Ks + kBlockK * P;       // [kBlockK][P] v
  float* Ps = Ks;                     // [kBlockQ][PS] p, reuses the K tile

  const int tid = threadIdx.x;
  const int ty = tid / 16;            // owns q rows ty*4 .. ty*4+3
  const int tx = tid % 16;            // owns columns tx + 16*j
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * kBlockQ;

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)KV * D;
  const float* qb = q + (long long)b * Lq * q_row + (long long)h * D;
  const float* kb = k + (long long)b * Lk * kv_row + (long long)g * D;
  const float* vb = v + (long long)b * Lk * kv_row + (long long)g * D;
  // tables: only dereferenced when the matching flag is on
  const float* sq = kRopeQ ? sin_q + b * tq_bstride : nullptr;
  const float* cq = kRopeQ ? cos_q + b * tq_bstride : nullptr;
  const float* sk = kRopeK ? sin_k + b * tk_bstride : nullptr;
  const float* ck = kRopeK ? cos_k + b * tk_bstride : nullptr;
  const float* bias_b = bias ? bias + (long long)b * Lq * Lk : nullptr;

  // keys this tile reads: all Lk, or up to its highest prefix bound
  int k_end = Lk;
  if constexpr (kPrefix) {
    if (tid == 0) hi_max = 1;
    __syncthreads();
    if (tid < kBlockQ) {
      const int row = q0 + tid;
      // rows past Lq are never written; bound 1 keeps them defined
      const int hi = row < Lq
          ? min(max(kv_hi[(long long)b * Lq + row], 1), Lk) : 1;
      his[tid] = hi;
      atomicMax(&hi_max, hi);
    }
    __syncthreads();
    k_end = hi_max;
  }

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * P + d] = row < Lq
        ? load_elem<D, kRopeQ>(qb + row * q_row, sq, cq, row, d)
        : 0.f;
  }

  float o[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // previous tile's P/V reads are done (and Q is loaded)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int row = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (row < Lk) {
        kv = load_elem<D, kRopeK>(kb + row * kv_row, sk, ck, row, d);
        vv = vb[row * kv_row + d];
      }
      Ks[r * P + d] = kv;
      Vs[r * P + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    __syncthreads();  // every K read is done before P overwrites the tile

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      // key columns of this row: < Lk, or < its bound (which is <= Lk)
      const int col_end = kPrefix ? his[ty * 4 + i] : Lk;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col < col_end) {
          float x = s[i][j] * scale;
          if (bias_b && row < Lq) x += bias_b[(long long)row * Lk + col];
          s[i][j] = x;
          tile_max = fmaxf(tile_max, x);
        }
      }
      // the first tile holds key 0, which every row attends to, so m_new is
      // finite from the first tile on (a later tile may be all masked for
      // this row: its max is -inf and m_new stays m[i])
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = col < col_end ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = Vs[kk * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
      }
    }
  }

  float* ob = out + (long long)b * Lq * q_row + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[row * q_row + tx + 16 * c] = o[i][c] / l[i];
  }
}

template <int D, bool kRopeQ, bool kRopeK, bool kPrefix>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* sin_q, const float* cos_q, const float* sin_k,
                   const float* cos_k, const float* bias, const int* kv_hi,
                   void* out, int B, int Lq, int Lk, int H, int KV,
                   long long tq_bstride, long long tk_bstride, float scale,
                   cudaStream_t stream) {
  const int smem = (kBlockQ + 2 * kBlockK) * (D + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D, kRopeQ, kRopeK, kPrefix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  attention_kernel<D, kRopeQ, kRopeK, kPrefix>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), sin_q, cos_q, sin_k, cos_k, bias,
          kv_hi, static_cast<float*>(out), Lq, Lk, H, KV, tq_bstride,
          tk_bstride, scale);
  return cudaGetLastError();
}

// dtype must be 0 (float32; bf16 runs the tensor-core body); D in {64,
// 128}.  kv_hi is read only with kPrefix, bias only without it.  Returns the
// cudaError_t of the launch (0 on success).
template <bool kRopeQ, bool kRopeK, bool kPrefix = false>
int dispatch(const void* q, const void* k, const void* v, const float* sin_q,
             const float* cos_q, const float* sin_k, const float* cos_k,
             const float* bias, const int* kv_hi, void* out, int B, int Lq,
             int Lk, int H, int KV, int D, long long tq_bstride,
             long long tk_bstride, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128)
    return (int)launch<128, kRopeQ, kRopeK, kPrefix>(
        q, k, v, sin_q, cos_q, sin_k, cos_k, bias, kv_hi, out, B, Lq, Lk, H,
        KV, tq_bstride, tk_bstride, scale, s);
  if (dtype == 0 && D == 64)
    return (int)launch<64, kRopeQ, kRopeK, kPrefix>(
        q, k, v, sin_q, cos_q, sin_k, cos_k, bias, kv_hi, out, B, Lq, Lk, H,
        KV, tq_bstride, tk_bstride, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
