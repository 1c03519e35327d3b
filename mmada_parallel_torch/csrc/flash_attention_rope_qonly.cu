// K2: packed attention with pre-rotated K/V (the feature-cache hot path) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mmada_parallel_tpu/ops/rope_attention.py ::
// flash_attention_rope_qonly (the same Pallas _kernel with rope_k=False): q
// [B, Lq, H*D] is pre-RoPE and rotated on load in f32 at its true positions
// (sin_q/cos_q [Lq, D] or per-row [B, Lq, D]); k/v [B, Lk, KV*D] are the
// packed caches, k already rotated, read as stored; Lq and Lk are independent.
// The kernel body, its numerics and what bounds it are in
// attention_kernel.cuh (template flags kRopeQ = true, kRopeK = false).  At the
// partial-step shapes (Lq = 16..308, Lk ~ 2400) the 64-row q tiles leave most
// of the card idle: B*H*ceil(Lq/64) blocks on 132 SMs.

#include "attention_kernel.cuh"

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// tq_bstride: batch stride of the q tables in floats (0 for shared [Lq, D],
// Lq*D for per-row [B, Lq, D]).  bias may be null.  scale is D^-1/2.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mmada_flash_attention_rope_qonly(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* bias, void* out, int B, int Lq, int Lk,
    int H, int KV, int D, long long tq_bstride, float scale, int dtype,
    void* stream) {
  return dispatch<true, false>(q, k, v, sin_q, cos_q, nullptr, nullptr, bias,
                               nullptr, out, B, Lq, Lk, H, KV, D, tq_bstride,
                               0, scale, dtype, stream);
}
