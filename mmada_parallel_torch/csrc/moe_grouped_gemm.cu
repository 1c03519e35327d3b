// Grouped GEMM of a mixture-of-experts MLP, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts.  Added
// for SDAR-30B-A3B (Qwen3-MoE's block: 128 experts of width 768, top-8 of a
// softmax router), whose experts hold 58 GB of its 61 GB of bf16 weights.
// One launch computes every expert that has rows, over the rows sorted by
// expert (ops/moe.py sorts them on the device and passes the offsets):
//
// * glu:  h[s] = silu(x[t(s)] @ gate[e]) * (x[t(s)] @ up[e]), bf16 out in
//         sorted order; x's rows are gathered through the sorted slots'
//         assignments (t = assignment / top_k), so no permuted copy of x is
//         made.  gate and up tiles share the shared-memory ring, and the
//         SwiGLU product is the epilogue, so gate/up never reach memory.
// * down: y[a(s)] = w[a(s)] * (h[s] @ down[e]), f32 out at the assignment's
//         own row, so the combine back to token order is a plain sum over a
//         token's top_k rows in a fixed order (no atomics anywhere).
//
// What bounds it: at decode (16 rows x a block of 4 = 64 tokens, 512
// assignments over 128 experts, ~4 rows an expert) the bytes of the touched
// experts' weights, 9.4 MB an expert, read once at 3.35 TB/s; at prefill
// (65,536 tokens, ~4,096 rows an expert) the tensor cores.  So the rows of a
// tile follow the rows an expert gets: 16 rows (one m16 slab, 4 warps side
// by side in N) where the experts average at most 32 rows, else 128 rows (8
// warps, 4 x 2).  Tiles of 64 in K stream through a ring of cp.async stages
// (16-byte copies, rows past the expert's end zero-filled); the products are
// mma.sync m16n8k16 bf16 with f32 sums, fed by ldmatrix (B transposed on the
// load, as the weights are [K, N] with N contiguous).  Shared-memory rows
// are padded by 16 bytes, which keeps ldmatrix free of bank conflicts.
//
// The grid is (N tiles, a bound on the row tiles): row tile y belongs to the
// expert e with tiles[e] <= y < tiles[e + 1] (a binary search over the
// device-side tile offsets); blocks past tiles[E] return at once.  The bound
// comes from the shapes alone, so nothing waits on the host.  N tiles are the
// fastest grid axis, so a row tile's activations are read from L2 by all of
// its N tiles, and an expert's weights (6.3 MB gate/up, 3.1 MB down) by all
// of its row tiles while they sit in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moe {

constexpr int kBK = 64;               // K of a stage
constexpr int kPad = 8;               // bf16 of padding a shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const __nv_bfloat16* a;   // glu: x [T, K]; down: h [A, K] in sorted order
  const int* rows;          // [A] sorted slot -> assignment (t * top_k + j)
  const int* offsets;       // [E + 1] first sorted slot of each expert
  const int* tiles;         // [E + 1] first row tile of each expert
  const __nv_bfloat16* w0;  // glu: gate; down: down.  [E, K, N]
  const __nv_bfloat16* w1;  // glu: up [E, K, N]; down: unused
  const float* scale;       // down: [A] routing weight of each assignment
  void* out;                // glu: h [A, N] bf16; down: y [A, N] f32
  int n_experts, K, N, top_k;
};

// BM rows x BN output columns a tile, WARPS_M x WARPS_N warps.
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool GLU>
struct Tile {
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kHalves = GLU ? 2 : 1;     // gate and up side by side
  static constexpr int kBCols = BN * kHalves;
  static constexpr int kWarpRows = BM / WARPS_M;
  static constexpr int kMI = kWarpRows / 16;
  static constexpr int kWarpCols = BN / WARPS_N;  // output columns a warp
  static constexpr int kNI = kWarpCols / 8;
  static constexpr int kAStride = kBK + kPad;
  static constexpr int kBStride = kBCols + kPad;
  static constexpr int kAStage = BM * kAStride;   // bf16 elements
  static constexpr int kBStage = kBK * kBStride;
  static constexpr int kSmemBytes = STAGES * (kAStage + kBStage) * 2;
  static constexpr int kAIters = BM * (kBK / 8) / kThreads;
  static constexpr int kBChunksRow = kBCols / 8;
  static constexpr int kBIters = kBK * kBChunksRow / kThreads;
  static_assert(kWarpRows % 16 == 0 && kWarpCols % 16 == 0, "warp tile");
  static_assert(BM * (kBK / 8) % kThreads == 0, "A copies");
  static_assert(kBK * kBChunksRow % kThreads == 0, "B copies");
  static_assert(kAIters >= 1 && kBIters >= 1, "copies a thread");
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool GLU>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    grouped_gemm_kernel(const Args args) {
  using T = Tile<BM, BN, WARPS_M, WARPS_N, STAGES, GLU>;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* As = smem;
  __nv_bfloat16* Bs = smem + STAGES * T::kAStage;

  const int E = args.n_experts;
  const int y = blockIdx.y;
  if (y >= __ldg(args.tiles + E)) return;
  int lo = 0, hi = E;                       // tiles[lo] <= y < tiles[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(args.tiles + mid) <= y) lo = mid; else hi = mid;
  }
  const int e = lo;
  const int row0 = __ldg(args.offsets + e) + (y - __ldg(args.tiles + e)) * BM;
  const int n_rows = min(BM, __ldg(args.offsets + e + 1) - row0);
  const int n0 = blockIdx.x * BN;
  const int K = args.K, N = args.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  // this thread's A rows (fixed over K): the source row, or none
  const __nv_bfloat16* a_src[T::kAIters];
  int a_dst[T::kAIters];
#pragma unroll
  for (int i = 0; i < T::kAIters; ++i) {
    const int c = tid + i * T::kThreads;
    const int r = c / (kBK / 8), cc = c % (kBK / 8);
    a_dst[i] = r * T::kAStride + cc * 8;
    if (r < n_rows) {
      const int slot = row0 + r;
      const long long src_row =
          GLU ? __ldg(args.rows + slot) / args.top_k : slot;
      a_src[i] = args.a + src_row * K + cc * 8;
    } else {
      a_src[i] = nullptr;
    }
  }
  const size_t w_base = (size_t)e * K * N + n0;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    __nv_bfloat16* as = As + stage * T::kAStage;
#pragma unroll
    for (int i = 0; i < T::kAIters; ++i) {
      const __nv_bfloat16* src = a_src[i] ? a_src[i] + k0 : args.a;
      cp_async16(as + a_dst[i], src, a_src[i] ? 16 : 0);
    }
    __nv_bfloat16* bs = Bs + stage * T::kBStage;
#pragma unroll
    for (int i = 0; i < T::kBIters; ++i) {
      const int c = tid + i * T::kThreads;
      const int kr = c / T::kBChunksRow, cc = c % T::kBChunksRow;
      const int half = cc * 8 / BN, col = cc * 8 - half * BN;
      const __nv_bfloat16* w = (GLU && half) ? args.w1 : args.w0;
      cp_async16(bs + kr * T::kBStride + cc * 8,
                 w + w_base + (size_t)(k0 + kr) * N + col, 16);
    }
  };

  float acc[T::kHalves][T::kMI][T::kNI][4];
#pragma unroll
  for (int h = 0; h < T::kHalves; ++h)
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][mi][ni][q] = 0.f;

  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();          // stage kt landed; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < KT) load_stage(next % STAGES, next);
    cp_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * T::kAStage;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * T::kBStage;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[T::kMI][4];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi) {
        const int r = wm * T::kWarpRows + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], as + r * T::kAStride + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int h = 0; h < T::kHalves; ++h) {
#pragma unroll
        for (int nj = 0; nj < T::kNI / 2; ++nj) {
          uint32_t bf[4];
          const int col =
              h * BN + wn * T::kWarpCols + nj * 16 + (lane >> 4) * 8;
          ldsm_x4_t(bf, bs + (ks * 16 + (lane & 15)) * T::kBStride + col);
#pragma unroll
          for (int mi = 0; mi < T::kMI; ++mi) {
            mma16816(acc[h][mi][2 * nj], af[mi], bf[0], bf[1]);
            mma16816(acc[h][mi][2 * nj + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * T::kWarpRows + mi * 16 + (lane >> 2) + hr * 8;
      if (r >= n_rows) continue;
      const int slot = row0 + r;
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni) {
        const int col = n0 + wn * T::kWarpCols + ni * 8 + (lane & 3) * 2;
        const float v0 = acc[0][mi][ni][2 * hr], v1 = acc[0][mi][ni][2 * hr + 1];
        if constexpr (GLU) {
          const float u0 = acc[T::kHalves - 1][mi][ni][2 * hr];
          const float u1 = acc[T::kHalves - 1][mi][ni][2 * hr + 1];
          const float h0 = v0 / (1.f + __expf(-v0)) * u0;
          const float h1 = v1 / (1.f + __expf(-v1)) * u1;
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(args.out) + (size_t)slot * N + col) =
              __floats2bfloat162_rn(h0, h1);
        } else {
          const int a = __ldg(args.rows + slot);
          const float w = __ldg(args.scale + a);
          *reinterpret_cast<float2*>(static_cast<float*>(args.out) +
                                     (size_t)a * N + col) =
              make_float2(v0 * w, v1 * w);
        }
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool GLU>
int launch(const Args& args, int tile_bound, cudaStream_t stream) {
  using T = Tile<BM, BN, WARPS_M, WARPS_N, STAGES, GLU>;
  auto kernel = grouped_gemm_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, GLU>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(args.N / BN, tile_bound);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe

// One grouped launch.  a, w0, w1 bf16 and 16-byte aligned; K a multiple of
// 64 and N of the tile's BN (64 small, 64 glu / 128 down large); rows,
// offsets, tiles int32 on the device, tiles counted in rows of 16 (small)
// or 128 (large); tile_bound >= tiles[E], at most 65535.  Returns the
// cudaError_t of the launch.
extern "C" int mmada_moe_grouped_gemm(const void* a, const int* rows,
                                      const int* offsets, const int* tiles,
                                      const void* w0, const void* w1,
                                      const float* scale, void* out,
                                      int n_experts, int K, int N, int top_k,
                                      int tile_bound, int glu, int small,
                                      void* stream) {
  const moe::Args args{static_cast<const __nv_bfloat16*>(a),
                       rows,
                       offsets,
                       tiles,
                       static_cast<const __nv_bfloat16*>(w0),
                       static_cast<const __nv_bfloat16*>(w1),
                       scale,
                       out,
                       n_experts,
                       K,
                       N,
                       top_k};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small) {
    if (glu) return moe::launch<16, 64, 1, 4, 5, true>(args, tile_bound, st);
    return moe::launch<16, 64, 1, 4, 5, false>(args, tile_bound, st);
  }
  if (glu) return moe::launch<128, 64, 4, 2, 3, true>(args, tile_bound, st);
  return moe::launch<128, 128, 4, 2, 3, false>(args, tile_bound, st);
}
