// GroupNorm over NCHW with an optional swish, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm and swish to XLA
// (mmada_parallel_tpu/models/vqgan_common.py :: group_norm, swish), which
// fuses them.  The port's plain chain (models/vqgan_common.py) runs them as
// PyTorch's separate passes over a 5-D view: a mean, a variance, the
// broadcast subtract, multiply, scale and bias, a sigmoid and a product,
// about 15 tensor-sized transfers a call.  The tokenizers call it 42 times
// an encode on f32 tensors of up to 537 MB (MagViT-v2, 4 images at 512x512):
// on an H100 the M fine-tuning step's two such encodes, in series with the
// step, took 408 ms of a 0.89 s step, and the chain 54.8 ms of each encode's
// 203 ms; fused, it takes 7.5 ms.
//
// What bounds it: bytes.  One read of the input and one write of the output,
// 2 x input bytes at 3.35 TB/s; the arithmetic is a few operations an element.
// A batch of 4 at G = 32 has only 128 groups, under one wave of 132 SMs, so
// both routes split a group over many blocks and take it in two passes, a
// statistics pass writing each block's (count, mean, M2) and an apply pass
// after the group's merge: 3 transfers, nearer 2 where the tensor fits in
// the 50 MB L2 and the apply's read hits it.
//
// * contiguous route (NCHW memory, where a group is one run of (C/G)*H*W
//   elements): blocks own chunks of a group, 2 kernels;
// * channels-last route ([batch, hw, channels] memory: the tokenizers'
//   convolutions give it after the NHWC pixels' permute, and the plain chain
//   keeps it, so this route does too): blocks own tiles of pixels of one
//   image and every group's channels in them, 3 kernels (statistics, one
//   merge a group, apply).
//
// A third route, one thread-block cluster a group holding it in shared
// memory (2 transfers, the bound), was built and measured on an H100 at the
// tokenizers' groups of 64 KB to 1.5 MB: it was slower than two passes at
// five of eight shapes (210 against 155 us at MagViT-v2's 1 MB groups, B=4)
// and at most 14 % faster at the others, since a block's load, merge and
// store run in turn; and the tokenizers' inputs are all channels-last, which
// it does not read.  It is not kept.
//
// Accesses are 16-byte vectors where a range covers them whole, single
// elements at its ragged ends.  Statistics are f32, merged by Chan's
// formula (count, mean, M2), never as E[x^2] - E[x]^2: a convolution's
// output with a bias can have a mean far from 0.  They are taken of x - k,
// k the group's first element, so that the mean keeps the resolution of the
// spread and not of the offset; the normalised value is then
// ((x - k) - mean) * rstd * scale + bias in f32, one rounding at a time as
// the plain chain rounds, a cast to the input type, then the swish in the
// input type (x * sigmoid(x), the sigmoid rounded to that type first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

constexpr int kThreads = 256;         // a contiguous route's block
constexpr int kUnroll = 4;            // 16-byte loads in flight a thread

struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// Chan's merge of two (count, mean, M2) summaries.
__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  if (b.n == 0.f) return a;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float w = b.n / n;
  return {n, a.mean + d * w, a.m2 + b.m2 + d * d * a.n * w};
}

// Lane 0 ends with the merge of the warp's 32 summaries.
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stat t = {__shfl_down_sync(0xffffffffu, s.n, o),
                    __shfl_down_sync(0xffffffffu, s.mean, o),
                    __shfl_down_sync(0xffffffffu, s.m2, o)};
    s = merge(s, t);
  }
  return s;
}

// Thread 0 ends with the merge of the block's summaries; sh holds a
// summary a warp.
template <int kWarps>
__device__ __forceinline__ Stat block_merge(Stat s, Stat* sh) {
  s = warp_merge(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? sh[lane] : Stat{0.f, 0.f, 0.f};
    s = warp_merge(s);
  }
  return s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The normalised element in the input type, then the swish in that type.
template <bool kSwish>
__device__ __forceinline__ void store_out(float y, float* o) {
  *o = kSwish ? y * (1.f / (1.f + expf(-y))) : y;
}
template <bool kSwish>
__device__ __forceinline__ void store_out(float y, __nv_bfloat16* o) {
  const __nv_bfloat16 yb = __float2bfloat16_rn(y);
  if (!kSwish) {
    *o = yb;
    return;
  }
  const float yf = __bfloat162float(yb);
  const __nv_bfloat16 sg = __float2bfloat16_rn(1.f / (1.f + expf(-yf)));
  *o = __float2bfloat16_rn(yf * __bfloat162float(sg));
}

// The group's statistics: its first element k, the mean of x - k, rstd.
struct Norm {
  float k, mean, rstd;
};

__device__ __forceinline__ float normalise(float x, const Norm& nm, float sc,
                                           float bi) {
  return __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fsub_rn(x, nm.k), nm.mean), nm.rstd),
                sc),
      bi);
}

// (count, mean, M2) of one 16-byte vector, less k.
template <typename T>
__device__ __forceinline__ Stat vec_stat(const uint4& u, float k) {
  constexpr int N = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  float f[N], sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = to_f32(e[i]) - k;
    sum += f[i];
  }
  const float m = sum * (1.f / N);
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = f[i] - m;
    m2 += d * d;
  }
  return {float(N), m, m2};
}

// A thread's summary of elements [s, t) less k, element e at base[e - off]
// (base[-off] 16-byte aligned, off a multiple of the vector width): the
// 16-byte vectors that lie whole inside the range, thread tid taking vectors
// tid, tid + nthreads, ..., and the single elements at the ragged ends.
template <typename T>
__device__ __forceinline__ Stat range_stats(const T* base, int64_t off,
                                            int64_t s, int64_t t, float k,
                                            int tid, int nthreads) {
  constexpr int N = 16 / sizeof(T);
  const int64_t vs = (s + N - 1) / N, ve = t / N;
  const int64_t head_end = lmin(t, vs * N), tail = lmax(head_end, ve * N);
  Stat st = {0.f, 0.f, 0.f};
  int64_t v = vs + tid;
  for (; v + (kUnroll - 1) * nthreads < ve; v += kUnroll * nthreads) {
    uint4 u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      u[j] = *reinterpret_cast<const uint4*>(base + ((v + j * nthreads) * N
                                                     - off));
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) st = merge(st, vec_stat<T>(u[j], k));
  }
  for (; v < ve; v += nthreads)
    st = merge(st, vec_stat<T>(
        *reinterpret_cast<const uint4*>(base + (v * N - off)), k));
  if (s + tid < head_end)
    st = merge(st, {1.f, to_f32(base[s + tid - off]) - k, 0.f});
  if (tail + tid < t)
    st = merge(st, {1.f, to_f32(base[tail + tid - off]) - k, 0.f});
  return st;
}

// Normalise elements [s, t) of the group starting at element g0 (whose first
// channel is c0; hw elements a channel) from src[e - off] into y[e].
template <typename T, bool kSwish>
__device__ __forceinline__ void range_apply(
    const T* src, int64_t off, T* __restrict__ y, int64_t s, int64_t t,
    int64_t g0, int c0, int hw, const float* __restrict__ scale,
    const float* __restrict__ bias, const Norm& nm, int tid, int nthreads) {
  constexpr int N = 16 / sizeof(T);
  const int64_t vs = (s + N - 1) / N, ve = t / N;
  const int64_t head_end = lmin(t, vs * N), tail = lmax(head_end, ve * N);
  for (int64_t v = vs + tid; v < ve; v += nthreads) {
    const uint4 u = *reinterpret_cast<const uint4*>(src + (v * N - off));
    const T* e = reinterpret_cast<const T*>(&u);
    uint4 o;
    T* r = reinterpret_cast<T*>(&o);
    const int l = static_cast<int>(v * N - g0);
    int ch = l / hw, rem = l - ch * hw;
    float sc = scale[c0 + ch], bi = bias[c0 + ch];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (rem == hw) {            // the vector crosses into the next channel
        ++ch;
        rem = 0;
        sc = scale[c0 + ch];
        bi = bias[c0 + ch];
      }
      store_out<kSwish>(normalise(to_f32(e[i]), nm, sc, bi), r + i);
      ++rem;
    }
    *reinterpret_cast<uint4*>(y + v * N) = o;
  }
  for (int k = 0; k < 2; ++k) {
    const int64_t i = (k == 0 ? s : tail) + tid;
    if (i < (k == 0 ? head_end : t)) {
      const int ch = static_cast<int>(i - g0) / hw;
      store_out<kSwish>(normalise(to_f32(src[i - off]), nm, scale[c0 + ch],
                                  bias[c0 + ch]), y + i);
    }
  }
}

// ---------------------------------------------------------------------------
// Contiguous route: grid (chunks, groups), block (c, g) owns elements
// [g * group_elems + c * chunk_elems, ...) of its group.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, Stat* __restrict__ part,
                    int64_t group_elems, int64_t chunk_elems) {
  __shared__ Stat sh[kThreads / 32];
  const int64_t g = blockIdx.y, c = blockIdx.x;
  const int64_t s = g * group_elems + c * chunk_elems;
  const int64_t t = lmin(s + chunk_elems, (g + 1) * group_elems);
  const float k = to_f32(x[g * group_elems]);
  const Stat st = block_merge<kThreads / 32>(
      range_stats(x, 0, s, t, k, threadIdx.x, kThreads), sh);
  if (threadIdx.x == 0) part[g * gridDim.x + c] = st;
}

template <typename T, bool kSwish>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const Stat* __restrict__ part,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, int64_t group_elems,
                    int64_t chunk_elems, int groups, int cpg, int hw,
                    float eps) {
  __shared__ Norm nm;
  const int64_t g = blockIdx.y, c = blockIdx.x;
  const int64_t g0 = g * group_elems, s = g0 + c * chunk_elems;
  if (threadIdx.x < 32) {
    Stat st = {0.f, 0.f, 0.f};
    for (int j = threadIdx.x; j < gridDim.x; j += 32)
      st = merge(st, part[g * gridDim.x + j]);
    st = warp_merge(st);
    if (threadIdx.x == 0)
      nm = {to_f32(x[g0]), st.mean, rsqrtf(st.m2 / st.n + eps)};
  }
  __syncthreads();
  range_apply<T, kSwish>(x, 0, y, s, lmin(s + chunk_elems, g0 + group_elems),
                         g0, static_cast<int>(g % groups) * cpg, hw, scale,
                         bias, nm, threadIdx.x, kThreads);
}

// ---------------------------------------------------------------------------
// Channels-last route: x and y in [batch, hw, channels] memory (a
// convolution's output after a channels-last input; the plain chain keeps
// that layout, and so does this route).  A block of cols x rows threads
// (cols = channels / vector width) takes a tile of pixels of one image:
// thread (r, col) reads the vector of channels [col * N, col * N + N) of
// pixels r, r + rows, ..., so every vector lies in one group (the group's
// channel count a multiple of N) and a thread keeps its channels' scale and
// bias.  Three kernels: each tile's summary of each group, one merge a
// group, the apply.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(1024)
    gn_cl_stats_kernel(const T* __restrict__ x, Stat* __restrict__ part,
                       int hw, int channels, int cpg, int groups, int ppt) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ Stat tile_sh[];
  const int cols = channels / N, rows = blockDim.x / cols;
  const int r = threadIdx.x / cols, col = threadIdx.x % cols;
  const int b = blockIdx.y, g = col * N / cpg;
  const int64_t img = static_cast<int64_t>(b) * hw * channels;
  const float k = to_f32(x[img + g * cpg]);     // pixel 0 of the group
  const int p0 = static_cast<int>(blockIdx.x) * ppt, p1 = min(p0 + ppt, hw);
  const T* px = x + img + col * N;
  Stat st = {0.f, 0.f, 0.f};
  int p = p0 + r;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    uint4 u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      u[j] = *reinterpret_cast<const uint4*>(
          px + static_cast<int64_t>(p + j * rows) * channels);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) st = merge(st, vec_stat<T>(u[j], k));
  }
  for (; p < p1; p += rows)
    st = merge(st, vec_stat<T>(*reinterpret_cast<const uint4*>(
                                   px + static_cast<int64_t>(p) * channels),
                               k));
  tile_sh[threadIdx.x] = st;
  __syncthreads();
  const int vpg = cpg / N;            // vector columns a group
  for (int gg = threadIdx.x; gg < groups; gg += blockDim.x) {
    Stat a = {0.f, 0.f, 0.f};
    for (int rr = 0; rr < rows; ++rr)
      for (int c = gg * vpg; c < (gg + 1) * vpg; ++c)
        a = merge(a, tile_sh[rr * cols + c]);
    part[(static_cast<int64_t>(b) * groups + gg) * gridDim.x + blockIdx.x] = a;
  }
}

// One block a (image, group): its tiles' summaries merged into its Norm.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_cl_merge_kernel(const T* __restrict__ x, const Stat* __restrict__ part,
                       Norm* __restrict__ norms, int tiles, int hw,
                       int channels, int cpg, int groups, float eps) {
  __shared__ Stat sh[kThreads / 32];
  const int bg = blockIdx.x, b = bg / groups, g = bg % groups;
  Stat st = {0.f, 0.f, 0.f};
  for (int j = threadIdx.x; j < tiles; j += kThreads)
    st = merge(st, part[static_cast<int64_t>(bg) * tiles + j]);
  st = block_merge<kThreads / 32>(st, sh);
  if (threadIdx.x == 0)
    norms[bg] = {to_f32(x[static_cast<int64_t>(b) * hw * channels + g * cpg]),
                 st.mean, rsqrtf(st.m2 / st.n + eps)};
}

template <typename T, bool kSwish>
__global__ void __launch_bounds__(1024)
    gn_cl_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const Norm* __restrict__ norms,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, int hw, int channels,
                       int cpg, int groups, int ppt) {
  constexpr int N = 16 / sizeof(T);
  const int cols = channels / N, rows = blockDim.x / cols;
  const int r = threadIdx.x / cols, col = threadIdx.x % cols;
  const int b = blockIdx.y;
  const Norm nm = norms[b * groups + col * N / cpg];
  float sc[N], bi[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = scale[col * N + i];
    bi[i] = bias[col * N + i];
  }
  const int64_t off = static_cast<int64_t>(b) * hw * channels + col * N;
  const int p0 = static_cast<int>(blockIdx.x) * ppt, p1 = min(p0 + ppt, hw);
  for (int p = p0 + r; p < p1; p += rows) {
    const int64_t e = off + static_cast<int64_t>(p) * channels;
    const uint4 u = *reinterpret_cast<const uint4*>(x + e);
    const T* v = reinterpret_cast<const T*>(&u);
    uint4 o;
    T* w = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < N; ++i)
      store_out<kSwish>(normalise(to_f32(v[i]), nm, sc[i], bi[i]), w + i);
    *reinterpret_cast<uint4*>(y + e) = o;
  }
}

template <typename T, bool kSwish>
int launch_cl(const void* x, void* y, void* part, void* norms,
              const float* scale, const float* bias, int batch, int channels,
              int hw, int groups, float eps, int threads, int tiles, int ppt,
              cudaStream_t stream) {
  const int cpg = channels / groups;
  const T* xi = static_cast<const T*>(x);
  Stat* pt = static_cast<Stat*>(part);
  Norm* nm = static_cast<Norm*>(norms);
  const dim3 grid(tiles, batch);
  gn_cl_stats_kernel<T><<<grid, threads, threads * sizeof(Stat), stream>>>(
      xi, pt, hw, channels, cpg, groups, ppt);
  gn_cl_merge_kernel<T><<<batch * groups, kThreads, 0, stream>>>(
      xi, pt, nm, tiles, hw, channels, cpg, groups, eps);
  gn_cl_apply_kernel<T, kSwish><<<grid, threads, 0, stream>>>(
      xi, static_cast<T*>(y), nm, scale, bias, hw, channels, cpg, groups,
      ppt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSwish>
int launch(const void* x, void* y, void* part, const float* scale,
           const float* bias, int batch, int channels, int hw, int groups,
           float eps, int chunks, long long chunk_elems, cudaStream_t stream) {
  const int cpg = channels / groups;
  const int64_t ge = static_cast<int64_t>(cpg) * hw;
  const T* xi = static_cast<const T*>(x);
  const dim3 grid(chunks, batch * groups);
  gn_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      xi, static_cast<Stat*>(part), ge, chunk_elems);
  gn_apply_kernel<T, kSwish><<<grid, kThreads, 0, stream>>>(
      xi, static_cast<T*>(y), static_cast<const Stat*>(part), scale, bias, ge,
      chunk_elems, groups, cpg, hw, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn

// C entry point, bound with ctypes.  x, y: contiguous [batch, channels, hw]
// (16-byte aligned); dtype 0 = float32, 1 = bfloat16; scale, bias: f32
// [channels]; chunks a group of chunk_elems elements; part = f32 scratch of
// batch * groups * chunks * 3.  Returns the cudaError_t of the launches.
extern "C" int mmada_group_norm(const void* x, void* y, void* part,
                                const float* scale, const float* bias,
                                int batch, int channels, int hw, int groups,
                                float eps, int swish, int dtype, int chunks,
                                long long chunk_elems, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_LAUNCH(T, S)                                                      \
  return gn::launch<T, S>(x, y, part, scale, bias, batch, channels, hw,      \
                          groups, eps, chunks, chunk_elems, st)
  if (dtype == 1) {
    if (swish) GN_LAUNCH(__nv_bfloat16, true);
    GN_LAUNCH(__nv_bfloat16, false);
  }
  if (swish) GN_LAUNCH(float, true);
  GN_LAUNCH(float, false);
#undef GN_LAUNCH
}

// The channels-last route's entry point: x, y [batch, hw, channels] in
// memory (16-byte aligned; channels / groups a multiple of 16 / element
// size); threads = (channels / vector width) x rows, at most 1024; tiles of
// ppt pixels an image; part = f32 scratch of batch * groups * tiles * 3,
// norms of batch * groups * 3.  Returns the cudaError_t of the launches.
extern "C" int mmada_group_norm_cl(const void* x, void* y, void* part,
                                   void* norms, const float* scale,
                                   const float* bias, int batch,
                                   int channels, int hw, int groups,
                                   float eps, int swish, int dtype,
                                   int threads, int tiles, int ppt,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_LAUNCH_CL(T, S)                                                   \
  return gn::launch_cl<T, S>(x, y, part, norms, scale, bias, batch,         \
                             channels, hw, groups, eps, threads, tiles, ppt, \
                             st)
  if (dtype == 1) {
    if (swish) GN_LAUNCH_CL(__nv_bfloat16, true);
    GN_LAUNCH_CL(__nv_bfloat16, false);
  }
  if (swish) GN_LAUNCH_CL(float, true);
  GN_LAUNCH_CL(float, false);
#undef GN_LAUNCH_CL
}
