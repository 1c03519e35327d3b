// K3: BLHD bidirectional flash attention, no RoPE, for Hopper (sm_90a).
//
// Replaces the TPU kernel mmada_parallel_tpu/ops/flash_attention.py ::
// flash_attention / _kernel: q [B, Lq, H, D], k/v [B, Lk, KV, D], optional f32
// bias [B, 1, Lq, Lk], GQA.  A contiguous BLHD tensor is the packed
// [B, L, H*D] layout.  bf16 runs the warp-specialised tensor-core body
// (attention_ws.cuh); f32 runs the FMA template with both rotation flags off
// (attention_kernel.cuh), since tensor cores would compute it in TF32.  One
// difference from the Pallas kernel: it pads keys to its block size with
// -1e30 and returns zeros only when the row sum is 0, so a fully masked row
// averages v over the padding too; here columns >= Lk are never scored and
// such a row is mean(v) over the real keys, as the plain reference
// (_xla_attention) gives.

#include "attention_kernel.cuh"
#include "attention_ws.cuh"

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.  bias
// may be null.  lse (bf16 only, may be null): f32 [B, H, Lq, 2] row
// statistics for the backward (attention_mma_bwd.cuh).  scale is D^-1/2.
// Returns the cudaError_t of the launch.
extern "C" int mmada_flash_attention(const void* q, const void* k,
                                     const void* v, const float* bias,
                                     void* out, float* lse, int B, int Lq,
                                     int Lk, int H, int KV, int D,
                                     float scale, int dtype, void* stream) {
  if (dtype == 1)
    return tc::dispatch(q, k, v, bias, out, lse, B, Lq, Lk, H, KV, D, scale,
                        static_cast<cudaStream_t>(stream));
  return dispatch<false, false>(q, k, v, nullptr, nullptr, nullptr, nullptr,
                                bias, nullptr, out, B, Lq, Lk, H, KV, D, 0, 0,
                                scale, dtype, stream);
}
