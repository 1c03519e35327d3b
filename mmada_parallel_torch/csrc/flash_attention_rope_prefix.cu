// K4: prefix-masked fused-RoPE packed attention for Hopper (sm_90a).
//
// Replaces the TPU kernel mmada_parallel_tpu/ops/rope_attention.py ::
// flash_attention_rope_prefix / _prefix_kernel: pre-RoPE packed q [B, Lq, H*D]
// and k/v [B, Lk, KV*D], q and k rotated in f32 as in K1, and in place
// of a bias a per-row key bound kv_hi [B, Lq] (int32): row i of batch b
// attends to keys kv < clamp(kv_hi[b, i], 1, Lk).  Every task mask of the
// training family (causal, mmu full prefix, t2i bidirectional image spans,
// their mixed batch; ops/masks.py prefix_bounds) is such a prefix.
//
// What bounds it on this card: the tensor cores, as K1, but only up to each
// q tile's highest bound; a causal mask at the A-train shape (L = 5120,
// H = 32, D = 128) needs about half of K1's 4*H*L*L*D flops, with no [L, L]
// bias read from memory.  What its design does about it: bf16 rotates q and
// k once with the pre-pass (rope_rotate.cuh), then runs the tensor-core body
// (attention_mma.cuh) with kPrefix: each block clamps its rows' bounds,
// takes their maximum and loops over 64-key tiles only up to it (the Pallas
// kernel's chunk skip); inside a tile, columns at or past a row's bound get
// p = 0; the longest (last) q tiles are issued first.  f32 runs the FMA
// template (attention_kernel.cuh, kRopeQ = kRopeK = kPrefix = true), since
// tensor cores would compute f32 in TF32.

#include "attention_kernel.cuh"
#include "attention_mma.cuh"
#include "rope_rotate.cuh"

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// tq_bstride / tk_bstride: batch stride of the q / k rope tables in floats
// (0 for shared [L, D] tables, L*D for per-row [B, L, D] tables).  kv_hi:
// int32 [B, Lq], any values (clamped to [1, Lk] here).  q_rot / k_rot: bf16
// scratch shaped as q / k (bf16 only; null for f32).  scale is D^-1/2.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int mmada_flash_attention_rope_prefix(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* sin_k, const float* cos_k,
    const int* kv_hi, void* q_rot, void* k_rot, void* out, int B, int Lq,
    int Lk, int H, int KV, int D, long long tq_bstride, long long tk_bstride,
    float scale, int dtype, void* stream) {
  if (dtype != 1)
    return dispatch<true, true, true>(q, k, v, sin_q, cos_q, sin_k, cos_k,
                                      nullptr, kv_hi, out, B, Lq, Lk, H, KV,
                                      D, tq_bstride, tk_bstride, scale, dtype,
                                      stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rope_rotate(q, sin_q, cos_q, q_rot, B, Lq, H, D,
                                tq_bstride, s);
  if (err != cudaSuccess) return (int)err;
  err = rope_rotate(k, sin_k, cos_k, k_rot, B, Lk, KV, D, tk_bstride, s);
  if (err != cudaSuccess) return (int)err;
  const tc::Args a{q_rot, k_rot, v, nullptr, kv_hi, out, nullptr, nullptr,
                   B, Lq, Lk, H, KV, 1, scale};
  return tc::run<true, false>(a, D, s);
}
