// K1: fused-RoPE packed bidirectional attention for Hopper (sm_90a).
//
// Replaces the TPU kernel mmada_parallel_tpu/ops/rope_attention.py ::
// flash_attention_rope / _kernel (the Pallas body reached through _launch with
// rope_k=True): pre-RoPE packed q [B, Lq, H*D] and k/v [B, Lk, KV*D], both q
// and k rotated in f32.
//
// bf16: the rotation is done once per call, not once per q tile.  A pre-pass
// (rope_rotate_kernel, rope_rotate.cuh) rotates q and k into bf16 scratch
// tensors that the caller allocates, then the warp-specialised tensor-core
// body (attention_ws.cuh) runs on them.  The rotated k is read from L2/HBM by
// every q tile instead of being recomputed from two f32 tables per tile;
// the pre-pass moves ~2x the bytes of q and k once (memory bound, a few
// percent of the attention's time).
// f32: the FMA template (attention_kernel.cuh, kRopeQ = kRopeK = true)
// rotates on load, since tensor cores would compute f32 in TF32.

#include <stdint.h>

#include "attention_kernel.cuh"
#include "attention_ws.cuh"
#include "rope_rotate.cuh"

// The bf16 pre-pass alone (K1 runs it inside mmada_flash_attention_rope): x
// [B, L, NH*D] bf16 -> out, the same shape.  Returns the cudaError_t.
extern "C" int mmada_rope_rotate(const void* x, const float* sin_t,
                                 const float* cos_t, void* out, int B, int L,
                                 int NH, int D, long long t_bstride,
                                 void* stream) {
  return (int)rope_rotate(x, sin_t, cos_t, out, B, L, NH, D, t_bstride,
                          static_cast<cudaStream_t>(stream));
}

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// tq_bstride / tk_bstride: batch stride of the q / k rope tables in floats
// (0 for shared [L, D] tables, L*D for per-row [B, L, D] tables).  bias may be
// null.  q_rot / k_rot: bf16 scratch shaped as q / k, written by the pre-pass
// (unused, and may be null, for f32).  lse (bf16 only, may be null): f32
// [B, H, Lq, 2] row statistics for the backward (attention_mma_bwd.cuh).
// scale is D^-1/2, rounded by the caller
// as the reference rounds it.  Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int mmada_flash_attention_rope(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* sin_k, const float* cos_k,
    const float* bias, void* q_rot, void* k_rot, void* out, float* lse,
    int B, int Lq, int Lk, int H, int KV, int D, long long tq_bstride,
    long long tk_bstride, float scale, int dtype, void* stream) {
  if (dtype != 1)
    return dispatch<true, true>(q, k, v, sin_q, cos_q, sin_k, cos_k, bias,
                                nullptr, out, B, Lq, Lk, H, KV, D, tq_bstride,
                                tk_bstride, scale, dtype, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rope_rotate(q, sin_q, cos_q, q_rot, B, Lq, H, D,
                                tq_bstride, s);
  if (err != cudaSuccess) return (int)err;
  err = rope_rotate(k, sin_k, cos_k, k_rot, B, Lk, KV, D, tk_bstride, s);
  if (err != cudaSuccess) return (int)err;
  return tc::dispatch(q_rot, k_rot, v, bias, out, lse, B, Lq, Lk, H, KV, D,
                      scale, s);
}
