// K2: packed attention with pre-rotated K/V (the feature-cache hot path) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mmada_parallel_tpu/ops/rope_attention.py ::
// flash_attention_rope_qonly (the same Pallas _kernel with rope_k=False): q
// [B, Lq, H*D] is pre-RoPE and rotated in f32 at its true positions
// (sin_q/cos_q [Lq, D] or per-row [B, Lq, D]); k/v [B, Lk, KV*D] are the
// packed caches, k already rotated, read as stored; Lq and Lk are independent.
//
// What bounds it: a cached sampler's full refresh (Lq = Lk ~ 2400) is bound
// by the tensor cores, as K1 is; its partial steps (Lq = 16..308 against
// Lk ~ 2400) by reading K/V once.  bf16: the pre-pass (rope_rotate.cuh)
// rotates q once into bf16 scratch, then the tensor-core body
// (attention_mma.cuh) runs on (q_rot, k, v, bias).  Where B*H*ceil(Lq/128)
// blocks would leave SMs idle, the caller's planner (rope_attention.py
// plan_splits) asks for n_split > 1: the body runs split-K into f32 scratch
// and split_combine_kernel merges the splits.  f32: the FMA template
// (attention_kernel.cuh, kRopeQ = true, kRopeK = false) rotates on load,
// since tensor cores would compute f32 in TF32.

#include "attention_kernel.cuh"
#include "attention_mma.cuh"
#include "rope_rotate.cuh"

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// tq_bstride: batch stride of the q tables in floats (0 for shared [Lq, D],
// Lq*D for per-row [B, Lq, D]).  bias may be null.  bf16 only: q_rot is bf16
// scratch shaped as q; with n_split > 1 (at most ceil(Lk/64)), o_part and
// ml are f32 scratch of n_split*B*Lq*H*D and n_split*B*Lq*H*2 floats (null,
// and n_split 1, for f32).  scale is D^-1/2.  Returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int mmada_flash_attention_rope_qonly(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* bias, void* q_rot, float* o_part,
    float* ml, void* out, int B, int Lq, int Lk, int H, int KV, int D,
    int n_split, long long tq_bstride, float scale, int dtype,
    void* stream) {
  if (dtype != 1)
    return dispatch<true, false>(q, k, v, sin_q, cos_q, nullptr, nullptr,
                                 bias, nullptr, out, B, Lq, Lk, H, KV, D,
                                 tq_bstride, 0, scale, dtype, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = rope_rotate(q, sin_q, cos_q, q_rot, B, Lq, H, D,
                                      tq_bstride, s);
  if (err != cudaSuccess) return (int)err;
  const tc::Args a{q_rot, k, v, bias, nullptr, out, o_part, ml,
                   B, Lq, Lk, H, KV, n_split, scale};
  return n_split > 1 ? tc::run<false, true>(a, D, s)
                     : tc::run<false, false>(a, D, s);
}
