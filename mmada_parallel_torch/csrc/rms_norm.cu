// RMSNorm over the last dimension, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves RMSNorm to XLA
// (mmada_parallel_tpu/models/llada.py :: _rms_norm), which fuses it.  The
// port's plain chain (ops/rms_norm.py :: rms_norm_reference) runs it as
// eight PyTorch launches: an f32 copy, the square, the mean, + eps, rsqrt,
// the multiply, the cast back and the weight's multiply, about 36 bytes an
// element of a bf16 input.  The backbone's inference forwards call it twice
// a layer and once for ln_f (65 calls a LLaDA-8B forward), and
// SDAR-30B-A3B's also on each head of q and k.
//
// What bounds it: bytes.  One read of x and one write of the output, 4
// bytes an element in bf16 (the weight is one row, read by every row
// through L1 and L2): at B=1 L=2424 d=4096, 39.7 MB, 11.9 us at 3.35 TB/s.
// The arithmetic is three operations an element.
//
// Design: a row lives in registers.  Each thread loads its vectors of the
// row at once (16 bytes each, neighbouring lanes on neighbouring vectors)
// and its vectors of the weight, sums the f32 squares of its elements in
// order, and the row's threads add their sums by a shuffle butterfly (every
// lane ends with the same sum) and, where a row spans warps, through shared
// memory, every thread adding the warps' sums in warp order.  Each thread
// then scales its own registers and writes them: one read and one write of
// x.  The planner (ops/rms_norm.py :: plan_rms_norm) takes the threads a
// row and the vectors a thread from the width alone: a sub-warp a row and
// many rows a block for the per-head q/k norms (width 128), one block of
// 128 threads a row for the model widths (2048, 4096).  The order of the
// sum therefore depends on the width alone: a row's output is the same in
// any batch, on a repeat and inside a CUDA graph.
//
// It rounds where the JAX package and the plain chain round: f32 squares
// summed in f32, the mean as the sum times 1 / width, rsqrtf(mean + eps),
// x * r in f32 rounded to x's type, times the weight rounded to x's type,
// in f32, rounded to x's type.  No product is contracted into an FMA (the
// __f*_rn intrinsics), so the output is the plain chain's bit for bit
// wherever the two f32 sums of squares agree; they differ only in order.
//
// The backward (rms_norm_bwd_kernel, rms_norm_dw_kernel) replaces the
// chain's autograd: 14 full-size launches, most of them reading or writing
// the row in f32.  Its least bytes: x and dy read, dx written, the weight
// read and dw written once.  A persistent grid (sized from the SM count by
// ops/rms_norm.py :: backward_grid) walks the rows with the forward's plan,
// the weight held in registers across them.  Each row: load x and dy,
// recompute the statistics from x and, in the same reduction, sum g * x
// (g = dy * w), then dx = r g - x r^3 sum(g x) / width.  Each row slot of a
// block keeps f32 dw partials of its columns in registers over its rows and
// writes them once, [slots, width]; a second pass sums the slots of a
// column in a fixed order.  No atomics: dx and dw are the same run to run.
// It rounds where the chain's autograd rounds: g in x's type; r g, the sum
// of g x, (-0.5 sum) (r r r) / width times x, added to r g twice in f32;
// dx rounded to x's type; each dy * round(x r) rounded to x's type before
// it joins dw, dw rounded to x's type and then to the weight's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmsn {

constexpr int kMaxThreads = 512;      // a block, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float f) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(f);
  } else {
    return f;
  }
}

// f rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float rounded(float f) {
  return to_f32(from_f32<T>(f));
}

// The weight's elements beside one 16-byte vector of x, rounded to x's
// type as the plain chain's weight.to(x.dtype) and held as one 16-byte
// vector of it (loaded as one 16-byte load for W = T, two for f32 W beside
// bf16 x, one 8-byte load for bf16 W beside f32 x).
template <typename T, typename W>
struct WeightVec {
  static constexpr int N = 16 / sizeof(T);
  uint4 u;

  __device__ __forceinline__ void load(const W* __restrict__ w) {
    T* t = reinterpret_cast<T*>(&u);
    if constexpr (sizeof(W) == sizeof(T)) {
      u = __ldg(reinterpret_cast<const uint4*>(w));
    } else if constexpr (sizeof(W) < sizeof(T)) {     // bf16 W, f32 x
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(w));
      const W* e = reinterpret_cast<const W*>(&a);
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = from_f32<T>(to_f32(e[k]));
    } else {                                          // f32 W, bf16 x
      const uint4 a[2] = {__ldg(reinterpret_cast<const uint4*>(w)),
                          __ldg(reinterpret_cast<const uint4*>(w) + 1)};
      const W* e = reinterpret_cast<const W*>(a);
#pragma unroll
      for (int k = 0; k < N; ++k) t[k] = from_f32<T>(to_f32(e[k]));
    }
  }

  __device__ __forceinline__ float get(int k) const {
    return to_f32(reinterpret_cast<const T*>(&u)[k]);
  }
};

template <typename T, typename W, int kVecs>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ out, int64_t rows, int width,
                int row_threads, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float warp_sum[kMaxThreads / 32];
  const int t = threadIdx.x % row_threads;
  const int64_t row = static_cast<int64_t>(blockIdx.x)
                      * (blockDim.x / row_threads)
                      + threadIdx.x / row_threads;
  const bool live = row < rows;
  const int nvec = width / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * width);

  uint4 v[kVecs];
  WeightVec<T, W> wv[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = t + j * row_threads;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (live && c < nvec) {
      v[j] = __ldg(xr + c);
      wv[j].load(w + static_cast<int64_t>(c) * N);
    }
  }

  // this thread's f32 sum of squares, in order; absent vectors add 0
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = to_f32(e[k]);
      s = __fadd_rn(s, __fmul_rn(f, f));
    }
  }
  // the row's lanes of a warp (all 32 lanes take part: the block is whole
  // warps), then the row's warps through shared memory
  const int lanes = row_threads < 32 ? row_threads : 32;
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  if (row_threads > 32) {               // one row a block
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
    __syncthreads();
    s = 0.f;
    for (int i = 0; i < (row_threads >> 5); ++i) {
      s = __fadd_rn(s, warp_sum[i]);
    }
  }
  if (!live) return;
  const float mean = __fmul_rn(s, 1.f / static_cast<float>(width));
  const float r = rsqrtf(__fadd_rn(mean, eps));

  uint4* orow = reinterpret_cast<uint4*>(out + row * width);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = t + j * row_threads;
    if (c < nvec) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float y = rounded<T>(__fmul_rn(to_f32(e[k]), r));
        oe[k] = from_f32<T>(__fmul_rn(y, wv[j].get(k)));
      }
      orow[c] = o;
    }
  }
}

// The row's sum of a and b over its row_threads threads: a shuffle
// butterfly over the row's lanes (the whole warp takes part), then, where a
// row spans warps (one row a block), the warps' sums through shared
// memory, every thread adding them in warp order.  Every thread of the
// block calls it; the caller syncs before the next call reuses `sums`.
__device__ __forceinline__ void row_sum2(float& a, float& b, int row_threads,
                                         float (*sums)[kMaxThreads / 32]) {
  const int lanes = row_threads < 32 ? row_threads : 32;
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (row_threads > 32) {
    if ((threadIdx.x & 31) == 0) {
      sums[0][threadIdx.x >> 5] = a;
      sums[1][threadIdx.x >> 5] = b;
    }
    __syncthreads();
    a = 0.f;
    b = 0.f;
    for (int i = 0; i < (row_threads >> 5); ++i) {
      a = __fadd_rn(a, sums[0][i]);
      b = __fadd_rn(b, sums[1][i]);
    }
  }
}

// dx of rows [rows, width] and f32 dw partials [gridDim.x * slots, width],
// slots = blockDim.x / row_threads rows a block at a time.
template <typename T, typename W, int kVecs>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const T* __restrict__ dy, T* __restrict__ dx,
                    float* __restrict__ dw_part, int64_t rows, int width,
                    int row_threads, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float sums[2][kMaxThreads / 32];
  const int t = threadIdx.x % row_threads;
  const int slot = threadIdx.x / row_threads;
  const int slots = blockDim.x / row_threads;
  const int nvec = width / N;
  const float inv_width = 1.f / static_cast<float>(width);

  WeightVec<T, W> wv[kVecs];
  float dwp[kVecs][N];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = t + j * row_threads;
    wv[j].u = make_uint4(0u, 0u, 0u, 0u);
    if (c < nvec) wv[j].load(w + static_cast<int64_t>(c) * N);
#pragma unroll
    for (int k = 0; k < N; ++k) dwp[j][k] = 0.f;
  }

  // the same trip count for every thread of the block: the reduction syncs
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * slots; base < rows;
       base += static_cast<int64_t>(gridDim.x) * slots) {
    const int64_t row = base + slot;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * width);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + row * width);
    uint4 v[kVecs], d[kVecs];
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int c = t + j * row_threads;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      d[j] = make_uint4(0u, 0u, 0u, 0u);
      if (live && c < nvec) {
        v[j] = __ldg(xr + c);
        d[j] = __ldg(gr + c);
      }
    }
    // this thread's sums of x^2 and of g x, in order; absent vectors add 0
    float sxx = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const T* e = reinterpret_cast<const T*>(&v[j]);
      const T* de = reinterpret_cast<const T*>(&d[j]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float f = to_f32(e[k]);
        const float g = rounded<T>(__fmul_rn(to_f32(de[k]), wv[j].get(k)));
        sxx = __fadd_rn(sxx, __fmul_rn(f, f));
        sgx = __fadd_rn(sgx, __fmul_rn(g, f));
      }
    }
    if (row_threads > 32) __syncthreads();      // the last row's sums read
    row_sum2(sxx, sgx, row_threads, sums);
    if (live) {
      const float r = rsqrtf(__fadd_rn(__fmul_rn(sxx, inv_width), eps));
      const float q = __fdiv_rn(
          __fmul_rn(__fmul_rn(-0.5f, sgx), __fmul_rn(__fmul_rn(r, r), r)),
          static_cast<float>(width));
      uint4* dr = reinterpret_cast<uint4*>(dx + row * width);
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
        const int c = t + j * row_threads;
        if (c < nvec) {
          const T* e = reinterpret_cast<const T*>(&v[j]);
          const T* de = reinterpret_cast<const T*>(&d[j]);
          uint4 o;
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float f = to_f32(e[k]);
            const float dyk = to_f32(de[k]);
            const float n = rounded<T>(__fmul_rn(f, r));
            dwp[j][k] = __fadd_rn(dwp[j][k], rounded<T>(__fmul_rn(dyk, n)));
            const float g = rounded<T>(__fmul_rn(dyk, wv[j].get(k)));
            const float tq = __fmul_rn(q, f);
            oe[k] = from_f32<T>(
                __fadd_rn(__fadd_rn(__fmul_rn(g, r), tq), tq));
          }
          dr[c] = o;
        }
      }
    }
  }

  float* pr = dw_part + (static_cast<int64_t>(blockIdx.x) * slots + slot)
                        * width;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int c = t + j * row_threads;
    if (c < nvec) {
      float4* p = reinterpret_cast<float4*>(pr + static_cast<int64_t>(c) * N);
#pragma unroll
      for (int k = 0; k < N; k += 4) {
        p[k / 4] = make_float4(dwp[j][k], dwp[j][k + 1], dwp[j][k + 2],
                               dwp[j][k + 3]);
      }
    }
  }
}

constexpr int kDwWarps = 8;           // the dw pass: warps a block

// dw[c] = the slots' partials of column c summed in a fixed order (warp i
// the slots i, i + kDwWarps, ... in order, then the warps in order),
// rounded to x's type T and then to the weight's W.  32 columns a block.
template <typename T, typename W>
__global__ void __launch_bounds__(32 * kDwWarps)
rms_norm_dw_kernel(const float* __restrict__ part, W* __restrict__ dw,
                   int slots, int width) {
  __shared__ float acc[kDwWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < width) {
    const float* p = part + c;
    int i = warp;
    for (; i + 3 * kDwWarps < slots; i += 4 * kDwWarps) {
      const float a0 = __ldg(p + static_cast<int64_t>(i) * width);
      const float a1 = __ldg(p + static_cast<int64_t>(i + kDwWarps) * width);
      const float a2 =
          __ldg(p + static_cast<int64_t>(i + 2 * kDwWarps) * width);
      const float a3 =
          __ldg(p + static_cast<int64_t>(i + 3 * kDwWarps) * width);
      s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, a0), a1), a2), a3);
    }
    for (; i < slots; i += kDwWarps) {
      s = __fadd_rn(s, __ldg(p + static_cast<int64_t>(i) * width));
    }
  }
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < width) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kDwWarps; ++k) total = __fadd_rn(total, acc[k][lane]);
    dw[c] = from_f32<W>(rounded<T>(total));
  }
}

template <typename T, typename W, int kVecs>
void launch(const void* x, const void* w, void* out, int64_t rows, int width,
            float eps, int row_threads, int rows_per_block,
            cudaStream_t stream) {
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  rms_norm_kernel<T, W, kVecs>
      <<<static_cast<unsigned>(blocks), row_threads * rows_per_block, 0,
         stream>>>(static_cast<const T*>(x), static_cast<const W*>(w),
                   static_cast<T*>(out), rows, width, row_threads, eps);
}

template <typename T, typename W>
cudaError_t launch_vecs(const void* x, const void* w, void* out,
                        int64_t rows, int width, float eps, int row_threads,
                        int vecs, int rows_per_block, cudaStream_t stream) {
  switch (vecs) {
    case 1:
      launch<T, W, 1>(x, w, out, rows, width, eps, row_threads,
                      rows_per_block, stream);
      break;
    case 2:
      launch<T, W, 2>(x, w, out, rows, width, eps, row_threads,
                      rows_per_block, stream);
      break;
    case 4:
      launch<T, W, 4>(x, w, out, rows, width, eps, row_threads,
                      rows_per_block, stream);
      break;
    case 8:
      launch<T, W, 8>(x, w, out, rows, width, eps, row_threads,
                      rows_per_block, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename T, typename W, int kVecs>
void launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                float* dw_part, void* dw, int64_t rows, int width, float eps,
                int row_threads, int rows_per_block, int grid,
                cudaStream_t stream) {
  rms_norm_bwd_kernel<T, W, kVecs>
      <<<grid, row_threads * rows_per_block, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const W*>(w),
          static_cast<const T*>(dy), static_cast<T*>(dx), dw_part, rows,
          width, row_threads, eps);
  rms_norm_dw_kernel<T, W><<<(width + 31) / 32, 32 * kDwWarps, 0, stream>>>(
      dw_part, static_cast<W*>(dw), grid * rows_per_block, width);
}

template <typename T, typename W>
cudaError_t launch_bwd_vecs(const void* x, const void* w, const void* dy,
                            void* dx, float* dw_part, void* dw, int64_t rows,
                            int width, float eps, int row_threads, int vecs,
                            int rows_per_block, int grid,
                            cudaStream_t stream) {
  switch (vecs) {
    case 1:
      launch_bwd<T, W, 1>(x, w, dy, dx, dw_part, dw, rows, width, eps,
                          row_threads, rows_per_block, grid, stream);
      break;
    case 2:
      launch_bwd<T, W, 2>(x, w, dy, dx, dw_part, dw, rows, width, eps,
                          row_threads, rows_per_block, grid, stream);
      break;
    case 4:
      launch_bwd<T, W, 4>(x, w, dy, dx, dw_part, dw, rows, width, eps,
                          row_threads, rows_per_block, grid, stream);
      break;
    case 8:
      launch_bwd<T, W, 8>(x, w, dy, dx, dw_part, dw, rows, width, eps,
                          row_threads, rows_per_block, grid, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The plan's checks, shared by the forward and the backward entry points.
inline bool plan_ok(long long rows, int width, int x_dtype, int w_dtype,
                    int row_threads, int vecs, int rows_per_block) {
  const int n = x_dtype == 1 ? 8 : 4;           // elements a 16-byte vector
  const int threads = row_threads * rows_per_block;
  const bool sub_warp = row_threads <= 32
                        && (row_threads & (row_threads - 1)) == 0;
  return !(rows <= 0 || width <= 0 || width % n || row_threads <= 0
           || rows_per_block <= 0 || threads > kMaxThreads || threads % 32
           || !(sub_warp || (row_threads % 32 == 0 && rows_per_block == 1))
           || static_cast<long long>(row_threads) * vecs < width / n
           || (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL
           || (x_dtype != 0 && x_dtype != 1)
           || (w_dtype != 0 && w_dtype != 1));
}

}  // namespace rmsn

// out[r, :] = rmsnorm(x[r, :]) * w over contiguous [rows, width] x and out
// of one type (dtype code 0 f32, 1 bf16) and a [width] weight (either
// type), with a block of row_threads x rows_per_block threads a
// rows_per_block rows, each thread holding vecs 16-byte vectors of its
// row.  Returns the launch's cudaError_t (cudaErrorInvalidValue for a plan
// the kernel cannot run).
extern "C" int mmada_rms_norm(const void* x, const void* w, void* out,
                              long long rows, int width, float eps,
                              int x_dtype, int w_dtype, int row_threads,
                              int vecs, int rows_per_block, void* stream) {
  if (!rmsn::plan_ok(rows, width, x_dtype, w_dtype, row_threads, vecs,
                     rows_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1) {
    err = w_dtype == 1
        ? rmsn::launch_vecs<__nv_bfloat16, __nv_bfloat16>(
              x, w, out, rows, width, eps, row_threads, vecs,
              rows_per_block, s)
        : rmsn::launch_vecs<__nv_bfloat16, float>(
              x, w, out, rows, width, eps, row_threads, vecs,
              rows_per_block, s);
  } else {
    err = w_dtype == 1
        ? rmsn::launch_vecs<float, __nv_bfloat16>(
              x, w, out, rows, width, eps, row_threads, vecs,
              rows_per_block, s)
        : rmsn::launch_vecs<float, float>(
              x, w, out, rows, width, eps, row_threads, vecs,
              rows_per_block, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward of mmada_rms_norm: dx [rows, width] in x's type and dw
// [width] in the weight's from x, the weight and dy (dy of x's type), over
// a persistent grid of `grid` blocks of the forward's plan; dw_part is f32
// scratch of [grid * rows_per_block, width], 16-byte aligned.  Two
// launches (the rows, then dw's fixed-order sum).  Returns the launches'
// cudaError_t (cudaErrorInvalidValue for a plan or grid it cannot run).
extern "C" int mmada_rms_norm_bwd(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw_part,
                                  void* dw, long long rows, int width,
                                  float eps, int x_dtype, int w_dtype,
                                  int row_threads, int vecs,
                                  int rows_per_block, int grid,
                                  void* stream) {
  if (!rmsn::plan_ok(rows, width, x_dtype, w_dtype, row_threads, vecs,
                     rows_per_block)
      || grid <= 0 || static_cast<long long>(grid) * rows_per_block
                          > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dw_part);
  cudaError_t err;
  if (x_dtype == 1) {
    err = w_dtype == 1
        ? rmsn::launch_bwd_vecs<__nv_bfloat16, __nv_bfloat16>(
              x, w, dy, dx, part, dw, rows, width, eps, row_threads, vecs,
              rows_per_block, grid, s)
        : rmsn::launch_bwd_vecs<__nv_bfloat16, float>(
              x, w, dy, dx, part, dw, rows, width, eps, row_threads, vecs,
              rows_per_block, grid, s);
  } else {
    err = w_dtype == 1
        ? rmsn::launch_bwd_vecs<float, __nv_bfloat16>(
              x, w, dy, dx, part, dw, rows, width, eps, row_threads, vecs,
              rows_per_block, grid, s)
        : rmsn::launch_bwd_vecs<float, float>(
              x, w, dy, dx, part, dw, rows, width, eps, row_threads, vecs,
              rows_per_block, grid, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
