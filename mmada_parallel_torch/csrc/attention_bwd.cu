// The attention gradient of K1, K2 and K3 in bf16, for Hopper (sm_90a).
//
// Replaces the backward of the JAX package's custom VJPs
// (mmada_parallel_tpu/ops/attention.py: _flash_diff_fn for K3,
// _packed_diff_fn for K1, _packed_qonly_diff_fn for K2), which recompute the
// plain chain.  The body is attention_mma_bwd.cuh (a delta pre-pass, the
// dK/dV pass, the dQ pass); K1 and K2 rotate q (K1 also k) with the
// forward's pre-pass (rope_rotate.cuh) into scratch first, and afterwards
// send dq (K1 also dk) back through the transposed rotation in place.  The
// row statistics come from the forward (its lse output).  f32 inputs and
// K4 keep the plain-chain recompute (ops/attention.py).

#include "attention_mma_bwd.cuh"
#include "rope_rotate.cuh"

// The rotation's backward alone, in place: dx [B, L, NH*D] bf16 (the
// gradient of the rotated tensor in, of the tensor before rotation out).
// Returns the cudaError_t.
extern "C" int mmada_rope_rotate_bwd(void* dx, const float* sin_t,
                                     const float* cos_t, int B, int L,
                                     int NH, int D, long long t_bstride,
                                     void* stream) {
  return (int)rope_rotate_bwd(dx, sin_t, cos_t, B, L, NH, D, t_bstride,
                              static_cast<cudaStream_t>(stream));
}

// K3's backward: q [B, Lq, H*D], k/v [B, Lk, KV*D] (a contiguous BLHD tensor
// is the same memory), out and dout shaped as q, bf16; bias f32
// [B, 1, Lq, Lk] or null; lse f32 [B, H, Lq, 2] from the forward; delta f32
// scratch [B, H, Lq]; dq shaped as q, dk/dv as k.  scale is D^-1/2.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int mmada_flash_attention_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H, int KV, int D,
    float scale, void* stream) {
  const tc::BwdArgs a{q,  k,  v,  bias, out, dout, lse, delta,
                      dq, dk, dv, B,    Lq,  Lk,   H,   KV,    scale};
  return tc::run_bwd(a, D, static_cast<cudaStream_t>(stream));
}

// K1's backward: pre-RoPE q and k as the forward took them, the f32 tables
// (t*_bstride: 0 for [L, D], L*D for per-row [B, L, D]), q_rot / k_rot bf16
// scratch shaped as q / k; the rest as for K3.
extern "C" int mmada_flash_attention_rope_bwd(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* sin_k, const float* cos_k,
    const float* bias, const void* out, const void* dout, const float* lse,
    float* delta, void* q_rot, void* k_rot, void* dq, void* dk, void* dv,
    int B, int Lq, int Lk, int H, int KV, int D, long long tq_bstride,
    long long tk_bstride, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rope_rotate(q, sin_q, cos_q, q_rot, B, Lq, H, D,
                                tq_bstride, s);
  if (err != cudaSuccess) return (int)err;
  err = rope_rotate(k, sin_k, cos_k, k_rot, B, Lk, KV, D, tk_bstride, s);
  if (err != cudaSuccess) return (int)err;
  const tc::BwdArgs a{q_rot, k_rot, v,  bias, out, dout, lse, delta,
                      dq,    dk,    dv, B,    Lq,  Lk,   H,   KV,    scale};
  const int e = tc::run_bwd(a, D, s);
  if (e != 0) return e;
  err = rope_rotate_bwd(dq, sin_q, cos_q, B, Lq, H, D, tq_bstride, s);
  if (err != cudaSuccess) return (int)err;
  return (int)rope_rotate_bwd(dk, sin_k, cos_k, B, Lk, KV, D, tk_bstride, s);
}

// K2's backward: pre-RoPE q with its f32 tables, k/v the pre-rotated caches
// as the forward took them, q_rot bf16 scratch shaped as q; the rest as for
// K3.  The statistics of a split forward come from its combine.
extern "C" int mmada_flash_attention_rope_qonly_bwd(
    const void* q, const void* k, const void* v, const float* sin_q,
    const float* cos_q, const float* bias, const void* out, const void* dout,
    const float* lse, float* delta, void* q_rot, void* dq, void* dk, void* dv,
    int B, int Lq, int Lk, int H, int KV, int D, long long tq_bstride,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rope_rotate(q, sin_q, cos_q, q_rot, B, Lq, H, D,
                                tq_bstride, s);
  if (err != cudaSuccess) return (int)err;
  const tc::BwdArgs a{q_rot, k,  v,  bias, out, dout, lse, delta,
                      dq,    dk, dv, B,    Lq,  Lk,   H,   KV,    scale};
  const int e = tc::run_bwd(a, D, s);
  if (e != 0) return e;
  return (int)rope_rotate_bwd(dq, sin_q, cos_q, B, Lq, H, D, tq_bstride, s);
}
