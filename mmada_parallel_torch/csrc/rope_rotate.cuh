// The bf16 rotation pre-pass of the tensor-core paths (sm_90a): K1 and K4
// rotate q and k with it, K2 rotates q, each into bf16 scratch that the
// caller allocates, once per call; the body (attention_mma.cuh) then reads
// the rotated tensors.  Memory bound: it moves ~2x the bytes of the tensor
// it rotates, a few percent of the attention's time at the main shapes.
// The C entry point that runs it alone, mmada_rope_rotate, is defined in
// flash_attention_rope.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// out = Neox RoPE of x, one head row at a time: x [B, L, NH*D] bf16, tables
// sin/cos f32 [L, D] (t_bstride 0) or [B, L, D] (t_bstride L*D).  Each thread
// owns 8 consecutive dims d0..d0+7 of the first half of one head row and
// their partners d0+D/2..: x*cos + rotate_half(x)*sin with rotate_half([x1,
// x2]) = [-x2, x1], as two rounded products and a rounded sum (no FMA
// contraction), rounded to bf16: the f32 rope_elem of attention_kernel.cuh
// rounded, and the plain rope_tensor(full_precision=True) bit for bit.
// 16-byte loads/stores.
template <int D>
__global__ void __launch_bounds__(256)
rope_rotate_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ sin_t,
                   const float* __restrict__ cos_t,
                   __nv_bfloat16* __restrict__ out, int L, int NH,
                   long long t_bstride, long long n_items) {
  constexpr int kPer = D / 16;  // threads per head row
  constexpr int kHalf = D / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int d0 = (int)(i % kPer) * 8;
  const long long row = i / kPer;  // (b * L + l) * NH + head
  const long long bl = row / NH;
  const long long b = bl / L;
  const int l = (int)(bl % L);
  const __nv_bfloat16* xr = x + row * D;
  const float* s = sin_t + b * t_bstride + (long long)l * D;
  const float* c = cos_t + b * t_bstride + (long long)l * D;

  const uint4 lo_raw = *reinterpret_cast<const uint4*>(xr + d0);
  const uint4 hi_raw = *reinterpret_cast<const uint4*>(xr + d0 + kHalf);
  const __nv_bfloat16* lo = reinterpret_cast<const __nv_bfloat16*>(&lo_raw);
  const __nv_bfloat16* hi = reinterpret_cast<const __nv_bfloat16*>(&hi_raw);
  float s_lo[8], s_hi[8], c_lo[8], c_hi[8];
  *reinterpret_cast<float4*>(s_lo) = *reinterpret_cast<const float4*>(s + d0);
  *reinterpret_cast<float4*>(s_lo + 4) =
      *reinterpret_cast<const float4*>(s + d0 + 4);
  *reinterpret_cast<float4*>(s_hi) =
      *reinterpret_cast<const float4*>(s + d0 + kHalf);
  *reinterpret_cast<float4*>(s_hi + 4) =
      *reinterpret_cast<const float4*>(s + d0 + kHalf + 4);
  *reinterpret_cast<float4*>(c_lo) = *reinterpret_cast<const float4*>(c + d0);
  *reinterpret_cast<float4*>(c_lo + 4) =
      *reinterpret_cast<const float4*>(c + d0 + 4);
  *reinterpret_cast<float4*>(c_hi) =
      *reinterpret_cast<const float4*>(c + d0 + kHalf);
  *reinterpret_cast<float4*>(c_hi + 4) =
      *reinterpret_cast<const float4*>(c + d0 + kHalf + 4);

  uint4 out_lo, out_hi;
  __nv_bfloat16* ol = reinterpret_cast<__nv_bfloat16*>(&out_lo);
  __nv_bfloat16* oh = reinterpret_cast<__nv_bfloat16*>(&out_hi);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float x1 = __bfloat162float(lo[e]);
    const float x2 = __bfloat162float(hi[e]);
    ol[e] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(x1, c_lo[e]), __fmul_rn(-x2, s_lo[e])));
    oh[e] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(x2, c_hi[e]), __fmul_rn(x1, s_hi[e])));
  }
  __nv_bfloat16* orow = out + row * D;
  *reinterpret_cast<uint4*>(orow + d0) = out_lo;
  *reinterpret_cast<uint4*>(orow + d0 + kHalf) = out_hi;
}

cudaError_t rope_rotate(const void* x, const float* sin_t,
                        const float* cos_t, void* out, int B, int L, int NH,
                        int D, long long t_bstride, cudaStream_t stream) {
  const long long n_items = (long long)B * L * NH * (D / 16);
  const unsigned blocks = (unsigned)((n_items + 255) / 256);
  const auto* xi = static_cast<const __nv_bfloat16*>(x);
  auto* xo = static_cast<__nv_bfloat16*>(out);
  if (D == 128)
    rope_rotate_kernel<128><<<blocks, 256, 0, stream>>>(
        xi, sin_t, cos_t, xo, L, NH, t_bstride, n_items);
  else if (D == 64)
    rope_rotate_kernel<64><<<blocks, 256, 0, stream>>>(
        xi, sin_t, cos_t, xo, L, NH, t_bstride, n_items);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
