// K1: fused-RoPE packed bidirectional attention for Hopper (sm_90a).
//
// Replaces the TPU kernel mmada_parallel_tpu/ops/rope_attention.py ::
// flash_attention_rope / _kernel (the Pallas body reached through _launch with
// rope_k=True): pre-RoPE packed q [B, Lq, H*D] and k/v [B, Lk, KV*D], both q
// and k rotated on load in f32.  The kernel body, its numerics and what bounds
// it are in attention_kernel.cuh (template flags kRopeQ = kRopeK = true).

#include "attention_kernel.cuh"

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// tq_bstride / tk_bstride: batch stride of the q / k rope tables in floats
// (0 for shared [L, D] tables, L*D for per-row [B, L, D] tables).  bias may be
// null.  scale is D^-1/2, rounded by the caller as the reference rounds it.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mmada_flash_attention_rope(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* sin_k, const float* cos_k,
    const float* bias, void* out, int B, int Lq, int Lk, int H, int KV, int D,
    long long tq_bstride, long long tk_bstride, float scale, int dtype,
    void* stream) {
  return dispatch<true, true>(q, k, v, sin_q, cos_q, sin_k, cos_k, bias,
                              nullptr, out, B, Lq, Lk, H, KV, D, tq_bstride,
                              tk_bstride, scale, dtype, stream);
}
