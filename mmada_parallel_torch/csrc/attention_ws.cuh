// The warp-specialised forward attention body on Hopper's tensor cores
// (sm_90a), bf16, head dim D in {64, 128}: the bf16 body of all four
// forward kernels.
//
//   flash_attention.cu               K3  q, k, v as stored
//   flash_attention_rope.cu          K1  q and k rotated once per call by
//                                        the pre-pass (rope_rotate.cuh)
//   flash_attention_rope_qonly.cu    K2  q rotated by the pre-pass, k/v the
//                                        pre-rotated caches; kSplit (split-K
//                                        and split_combine_kernel) where the
//                                        caller's planner asks for it
//   flash_attention_rope_prefix.cu   K4  q and k rotated by the pre-pass;
//                                        kPrefix (per-row key bounds)
//
// With the pre-pass it replaces the TPU kernels' bodies: _kernel of
// mmada_parallel_tpu/ops/flash_attention.py (K3), _kernel of
// mmada_parallel_tpu/ops/rope_attention.py after the rotation (K1, and K2
// with rope_k=False) and its _prefix_kernel (K4).  Contract: q [B, Lq,
// H*D], k/v [B, Lk, KV*D] bf16 (any GQA ratio); an optional f32 bias
// [B, 1, Lq, Lk] at any Lk; scores and the softmax in f32, with a bias the
// score scaled by a rounded multiply and the bias added, as the plain chain
// does; key columns >= Lk at -inf; a row at -1e30 everywhere gives mean(v)
// over the Lk real keys (across splits too: every split of such a row has
// the same m, so each weight is 2^0); rows >= Lq never written; given lse,
// each row's (m, log2 l) in base 2, kept apart (a fully masked row's m is
// ~-1.44e30, where m + log2 l would round to m), for the backward.
//
// Two compile-time flags:
//
//   kSplit   (K2) split-K: the key tiles of each (head, q tile, batch row)
//            are cut into n_split contiguous, non-empty ranges, tiles
//            [s*n/S, (s+1)*n/S) for split s of S over n tiles, each range a
//            work item of its own.  Its epilogue writes the unnormalised f32
//            o and its rows' (m, l) (max and sum, base 2) to scratch, and
//            split_combine_kernel (attention_mma.cuh) forms out = sum_s
//            2^(m_s - m*) o_s / sum_s 2^(m_s - m*) l_s with m* = max_s m_s,
//            and the statistics.  The planner (rope_attention.py
//            plan_splits) takes it when B*H*ceil(Lq/128) items would leave
//            SMs idle: a cached partial step (Lq = 16) has 32 on 132 SMs.
//   kPrefix  (K4) int32 bounds kv_hi [B, Lq] in place of a bias: row i
//            attends to keys kv < clamp(kv_hi[b, i], 1, Lk) (rows >= Lq to
//            key 0).  Each warp reduces the item's 128 bounds to their
//            maximum, and the item loops over only ceil(max / 64) key tiles
//            (the Pallas kernel's chunk skip); a column at or past a row's
//            bound gets -inf in every tile that reaches past the smaller of
//            the thread's two rows' bounds.  The last q tiles, the longest
//            under a causal mask, are walked first.
//
// What bounds it: the tensor cores at Lq ~ Lk (the edit shape's 96 GFLOP
// take 0.097 ms at 989 TFLOP/s); reading K/V once at K2's partial shapes
// (Lq = 16 against Lk = 2424: 40 MB, 0.012 ms), which only a grid that
// covers the SMs can do, and then the split's f32 partials (written once,
// read once by the combine), which the planner weighs against the idle SMs.
// The cp.async body the four kernels ran before this one (a block per item,
// every warp issuing its own 16-byte cp.async copies in the instruction
// stream of its wgmmas and its softmax, a __syncthreads a tile, both
// warpgroups at the softmax together) reached 23-24 % of that bound on an
// H100.  This body takes 0.21 ms of device time at the edit shape, 46 %
// of the bound (chip_ab.py; cuDNN's SDPA 0.18 ms, chip_smoke.py).  The
// design, FlashAttention-3's forward on the pieces of hopper_pipeline.cuh:
//
// * 384 threads: two consumer warpgroups (warps 0-7, setmaxnreg 232), each
//   owning 64 rows of a 128-row q tile, and the producer warpgroup (warps
//   8-11, setmaxnreg 40), one thread of which issues every copy (warp 8
//   with kPrefix, whose lanes reduce the bounds); the others leave at once.
// * Persistent: min(work items, SMs) blocks of one per SM; block i takes the
//   (head, 128-row q tile, split, batch row) items i, i + gridDim.x, ... in
//   the order of a grid with the head fastest, so the H heads of one (b, q
//   tile) still run side by side and share the bias rows and a GQA group's
//   K/V through L2.  The producer loads an item's Q once the consumers' last
//   S of the previous item has completed (a Q full/empty barrier pair), and
//   its K/V tiles while they finish that item's last product and epilogue.
// * TMA from 3-D maps over [B, L, heads*D] with 64-column boxes in the
//   128-byte swizzle (attention_mma.cuh's kv_off layout): Q, then K and V
//   tiles of kN keys into a ring of kS stages with a full and an empty
//   mbarrier a stage for K and for V, so S_t can start before V_t lands and
//   a K stage is released as soon as its S has completed.  The kv head g =
//   h / (H / KV) is the map's column coordinate.  Rows past Lq or Lk, also
//   at a batch boundary and from a split's first tile on, arrive as zeros
//   (a 2-D map would read the next batch row there).
// * S = Q.K^T is a wgmma with both operands in shared memory (K-major);
//   O += P.V one with P's bf16 A fragments repacked from the S accumulator
//   in registers and V an MN-major operand.  Accumulators are f32.
// * Within a warpgroup, turn t issues S_t and P_{t-1}.V_{t-1} together; the
//   softmax of S_t runs while P_{t-1}.V_{t-1} is on the tensor cores, and O
//   is rescaled by 2^(m_{t-1} - m_t) once that product has completed.  Alive
//   across a turn: S (kN / 2 f32), P (kN / 4 bf16x2), O (D / 2 f32).
// * Between the warpgroups, the turns alternate on named barriers 1 and 2
//   (warpgroup 0 first), so one warpgroup's exponentials run while the
//   other's products do.  Every consumer thread arrives on a stage's empty
//   barrier once its warpgroup's products have read it.  Only the last key
//   tile masks columns >= Lk, in a loop of its own.
// * kSolo (K2 at Lq <= 64: a cached partial step, Lq = 16-22): every item's
//   rows lie in its first 64, so warpgroup 0 computes each item alone,
//   without turns, and warpgroup 1 leaves at once (its turns on rows past
//   Lq would hold the tensor cores for nothing; the barriers count 128
//   arrivals).  Warpgroup 0's arithmetic is unchanged, so the output is
//   too.  It is a compile-time flag: deciding item by item at run time
//   (warpgroup 1 waiting out each tile of such an item) slowed the
//   ping-pong of every other launch by 2-7 % (chip_ab.py).
// * The bias (with one) is read from global memory straight into the
//   accumulator's layout (attention_mma.cuh's load_bias: float2 at an even
//   Lk, scalars at an odd one) one tile ahead: tile t+1's loads are issued
//   in turn t and land while tile t's softmax runs.  Staging it by TMA is
//   not open to the biased shapes of the main path: their rows (Lk = 2565 in
//   the M trainer, 1090 in the T2I server) do not start on the 16 bytes a
//   box must start on.
// * Key tiles of 64 keys (ws_keys), and the most stages up to 4 that fit
//   232,448 bytes (ws_smem): 4 at D=128 and 64.  With 64-key tiles the
//   output is that of the cp.async body before it bit for bit (the same
//   running max a 64-key tile, the same roundings of p and of O's rescale,
//   the same k-steps in the same order; chip_ab.py --against compares a
//   checkout of that body's commit), so the redesign moves no result
//   downstream.  128-key tiles without a bias are faster (chip_ab.py) but
//   round p against another running max, which moves some outputs by one
//   bf16 ulp, and the bf16 training gate of chip_smoke.py's [train-a-ring]
//   (its bound is one sample of the solo step's bf16 noise) refused the
//   moved solo step on the card.
// * Epilogue: O divided by the row sum, bf16, plain stores, and the
//   statistics; with kSplit the unnormalised O and (m, l) instead.  No
//   atomics: the output is bitwise the same from run to run.
// * Host side: every launch encodes its three tensor maps and asks for the
//   SM count and the shared-memory attribute.  A cache of encoded maps
//   (keyed by base pointer, shape and box: a cached sampler's K/V caches
//   recur at every step) moved the host's time a queued K2 call by less
//   than its spread from run to run, 50-80 us (chip_ab.py), and was left
//   out.
//
// Measured by chip_ab.py on an H100 80GB HBM3 at 700 W (each variant built
// apart and timed twice in one run of the card; medians of the device time
// of one call, this build first: 211 us at the edit shape, B=1 L=2424 H=32
// D=128; 798 us at the A train step's, L=5120; 391 us at the M trainer's
// with its bias; 263 us at the T2I server's; 12.4 us of K2's body at its
// partial step, Lq=16 against 2424 keys in 4 splits): 128-key tiles
// without a bias 188 and 718 us, faster, left out for the reason above;
// both warpgroups taking turns at Lq <= 64, 13.8 us at the partial step.
// Variants an earlier chip_ab.py measured on the same card, each slower
// (edit / A-train / with a bias, us): 6 stages 211, 448 and 292 with a
// bias; the bias loaded in its own turn, not a tile ahead, 434 and 316;
// one block an item, not the persistent grid, 213 / 810 / 280 (380 at the
// M trainer's); a stage released by one lane a warp, not every thread, 214
// / 809; O's rescale skipped where a warp's alphas are exactly 1, 216 /
// 809; the past-Lk masks inside the main loop, 222 / 843.

#pragma once

#include "hopper_pipeline.cuh"

namespace {
namespace tc {

// keys per K/V tile (see above): the previous body's, so that the output
// is that body's bit for bit
template <int D, bool kBias>
__host__ __device__ constexpr int ws_keys() {
  return kKeys;
}

// Dynamic shared memory at `stages`: Q (128 rows x D bf16), the K and V
// rings, 4 barriers a stage and Q's 2, and 1024 bytes to align to the
// swizzle atom.
template <int D, bool kBias>
__host__ __device__ constexpr int ws_smem(int stages) {
  return 1024 + kRows * D * 2 + stages * 2 * ws_keys<D, kBias>() * D * 2 +
         (4 * stages + 2) * 8;
}

template <int D, bool kBias>
__host__ __device__ constexpr int ws_stages() {
  int s = kMaxStages;
  while (s > 2 && ws_smem<D, kBias>(s) > kSmemMax) --s;
  return s;
}

static_assert(ws_smem<128, false>(ws_stages<128, false>()) <= kSmemMax &&
                  ws_smem<128, true>(ws_stages<128, true>()) <= kSmemMax &&
                  ws_smem<64, false>(ws_stages<64, false>()) <= kSmemMax &&
                  ws_smem<64, true>(ws_stages<64, true>()) <= kSmemMax,
              "the forward's ring does not fit in shared memory");

// Keep the A fragments of an asynchronous wgmma alive up to its wait: the
// compiler sees them read and written here, so it gives their registers to
// nothing else before.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}


// kPrefix: row `row` of batch row b attends to keys [0, its bound), the
// bound clamped to [1, Lk]; rows >= Lq (never written) to key 0.
__device__ __forceinline__ int row_bound(const int* __restrict__ kv_hi,
                                         int b, int row, int Lq, int Lk) {
  return row < Lq ? min(max(kv_hi[(long long)b * Lq + row], 1), Lk) : 1;
}

// One work item: its head, batch row, split, first q row and key tiles
// [lo, hi).
struct Item {
  int h, b, s, q0, lo, hi;
};

// The items of one launch, which every warp of a block derives alike from
// an item's index: head fastest, then q tile (with kPrefix the last first),
// split, batch row.
template <bool kSplit, bool kPrefix>
struct Walk {
  int H, Lq, Lk, n_qt, n_split, n_tiles, n_work;

  __device__ int q0(int wi) const {
    const int i = wi / H % n_qt;
    return (kPrefix ? n_qt - 1 - i : i) * kRows;
  }
  // item wi; with kPrefix every lane of the calling warp must call it (the
  // warp reduces the 128 rows' bounds to the item's last key tile)
  __device__ Item item(int wi, const int* __restrict__ kv_hi, int lane,
                       int kN) const {
    Item it;
    it.h = wi % H;
    const int r = wi / (H * n_qt);
    it.s = kSplit ? r % n_split : 0;
    it.b = kSplit ? r / n_split : r;
    it.q0 = q0(wi);
    it.lo = it.s * n_tiles / n_split;
    it.hi = (it.s + 1) * n_tiles / n_split;
    if constexpr (kPrefix) {
      int mx = 1;
#pragma unroll
      for (int i = lane; i < kRows; i += 32)
        mx = max(mx, row_bound(kv_hi, it.b, it.q0 + i, Lq, Lk));
      it.hi = (__reduce_max_sync(0xffffffffu, mx) + kN - 1) / kN;
    }
    return it;
  }
};

// Accumulator layout as in attention_mma.cuh: for warp w of a warpgroup and
// lane = 4 * gid + tig, d[4 * j + e] sits at row 16 * w + gid + 8 * (e >> 1)
// of the warpgroup's 64, column 8 * j + 2 * tig + (e & 1).
//
// Persistent: block i takes work items i, i + gridDim.x, ... of the
// H * ceil(Lq / 128) * n_split * B items (Walk).  kSplit: o_part
// [n_split, B*Lq*H, D] f32 and ml [n_split, B*Lq*H] (m, l) float2, row
// (b * Lq + i) * H + h of split s, written for rows < Lq; out and lse
// unused.
template <int D, bool kBias, bool kSplit, bool kPrefix, bool kSolo>
__global__ void __launch_bounds__(kWsThreads, 1)
attention_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ bias,
                    const int* __restrict__ kv_hi, bf16* __restrict__ out,
                    float* __restrict__ o_part, float2* __restrict__ ml,
                    float2* __restrict__ lse, int B, int Lq, int Lk, int H,
                    int KV, int n_split, float scale) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(!(kPrefix && (kBias || kSplit || kSolo)),
                "prefix bounds take no bias, no split and both warpgroups");
  constexpr int kN = ws_keys<D, kBias>();      // keys per tile
  constexpr int kConsumers = kSolo ? 128 : 256;  // threads that release
  constexpr int kS = ws_stages<D, kBias>();
  constexpr int kNb = kN / 8;                  // n8 blocks of S
  constexpr int kDn = D / 8;                   // n8 blocks of O
  constexpr uint32_t kQBytes = 64 * D * 2;     // a warpgroup's Q rows
  constexpr uint32_t kTileBytes = kN * D * 2;  // a K or V tile
  constexpr uint32_t kBlock = kN * 128;        // its 64-column block
  // byte offsets in shared memory: Q [2][64][D], the K ring [kS][kN][D], the
  // V ring [kS][kN][D], the barriers (K full[kS], V full[kS], K empty[kS],
  // V empty[kS], Q full, Q empty)
  constexpr uint32_t kKAt = 2 * kQBytes;
  constexpr uint32_t kVAt = kKAt + kS * kTileBytes;
  constexpr uint32_t kBarAt = kVAt + kS * kTileBytes;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t sb = smem_u32(align_1024(tc_smem));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, wg = warp >> 2, lane = tid & 31;
  const int n_qt = (Lq + kRows - 1) / kRows;
  const int n_tiles = (Lk + kN - 1) / kN;
  const int splits = kSplit ? n_split : 1;
  const Walk<kSplit, kPrefix> walk{H,      Lq,      Lk, n_qt,
                                   splits, n_tiles, H * n_qt * splits * B};
  const uint32_t kfull0 = sb + kBarAt, vfull0 = kfull0 + 8 * kS;
  const uint32_t kempty0 = vfull0 + 8 * kS, vempty0 = kempty0 + 8 * kS;
  const uint32_t q_full = vempty0 + 8 * kS, q_empty = q_full + 8;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(kempty0 + 8 * s, kConsumers);  // every consumer thread
      mbar_init(vempty0 + 8 * s, kConsumers);  // arrives
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy (with kPrefix its warp's
    // lanes reduce each item's bounds first); the ring's position and Q's
    // phase run on across work items ----
    setmaxnreg_dec<kProducerRegs>();
    if (kPrefix ? warp == 8 : tid == 256) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int wi = blockIdx.x; wi < walk.n_work; wi += gridDim.x) {
        const Item it = walk.item(wi, kv_hi, lane, kN);
        if (lane == 0) {
          const int g = it.h / (H / KV);
          // Q, once the consumers' last S of the previous item has completed
          mbar_wait(q_empty, q_phase ^ 1);
          mbar_expect_tx(q_full, 2 * kQBytes);
          for (int w = 0; w < 2; ++w)
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load(sb + w * kQBytes + cb * 8192, &tm_q, q_full,
                       it.h * D + cb * 64, it.q0 + 64 * w, it.b);
          q_phase ^= 1;
          for (int t = it.lo; t < it.hi; ++t) {
            const uint32_t kf = kfull0 + 8 * stage, vf = vfull0 + 8 * stage;
            mbar_wait(kempty0 + 8 * stage, phase ^ 1);
            mbar_expect_tx(kf, kTileBytes);
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load(sb + kKAt + stage * kTileBytes + cb * kBlock, &tm_k,
                       kf, g * D + cb * 64, t * kN, it.b);
            mbar_wait(vempty0 + 8 * stage, phase ^ 1);
            mbar_expect_tx(vf, kTileBytes);
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load(sb + kVAt + stage * kTileBytes + cb * kBlock, &tm_v,
                       vf, g * D + cb * 64, t * kN, it.b);
            if (++stage == kS) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        if constexpr (kPrefix) __syncwarp();
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 of each
    // work item (kSolo: warpgroup 0 all of them) ----
    setmaxnreg_inc<kConsumerRegs>();
    if (kSolo && wg == 1) return;
    const int w = warp & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const uint32_t qa = sb + wg * kQBytes;
    const float scale_log2 = scale * kLog2e;
    const long long q_row = (long long)H * D;

    float o[kDn * 4], s[kNb * 4], bz[kNb * 4], bzn[kNb * 4], alpha[2];
    uint32_t pf[kNb / 2][4];
    float m[2], l[2];  // running max and this lane's share of the row sums
    const float* bias_lo = nullptr;
    const float* bias_hi = nullptr;
    int lim_lo = Lk, lim_hi = Lk;  // kPrefix: this thread's rows' bounds

    // S = Q . K^T for the K tile at ks, issued and committed (the fence
    // also covers O and P, written before it, for the P . V that follows)
    auto issue_s = [&](uint32_t ks) {
#pragma unroll
      for (int i = 0; i < kNb * 4; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN>(s, desc_kmajor<64>(qa, kk), desc_kmajor<kN>(ks, kk));
      wgmma_commit();
    };
    // O += P . V for the V tile at vs, 16 keys a step, committed
    auto issue_pv = [&](uint32_t vs) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_pv<D>(o, pf[kk], desc_mnmajor<kN>(vs, kk));
      wgmma_commit();
    };
    // the online softmax of the tile at key k0 in f32, on x * log2(e)
    // (exp(x - m) = 2^(x log2 e - m log2 e)); columns >= Lk, and with
    // kPrefix at or past the row's bound, get -inf.  An item's first tile
    // holds a key with a finite score for every row (a split starts below
    // Lk; with kPrefix key 0 is in tile 0 and every bound is >= 1), so m is
    // finite from it on (alpha = 2^-inf = 0 there).  Leaves p in s and each
    // row's rescale of O in alpha.
    auto softmax = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kNb * 4; ++i) {
        if constexpr (kBias)   // the plain chain's score, then the base change
          s[i] = __fmul_rn(__fadd_rn(__fmul_rn(s[i], scale), bz[i]), kLog2e);
        else
          s[i] = __fmul_rn(s[i], scale_log2);
      }
      if constexpr (kPrefix) {
        if (k0 + kN > min(lim_lo, lim_hi)) {  // past a row's bound
#pragma unroll
          for (int i = 0; i < kNb * 4; ++i)
            if (k0 + (i >> 2) * 8 + 2 * tig + (i & 1) >=
                ((i >> 1) & 1 ? lim_hi : lim_lo))
              s[i] = -INFINITY;
        }
      } else if (k0 + kN > Lk) {  // the last tile
#pragma unroll
        for (int i = 0; i < kNb * 4; ++i)
          if (k0 + (i >> 2) * 8 + 2 * tig + (i & 1) >= Lk) s[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kNb * 4; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // p = 2^(x - m): the difference first, so that equal -1e30 scores
      // give exactly 1 and a -inf column exactly 0
#pragma unroll
      for (int i = 0; i < kNb * 4; ++i) {
        const float p = ex2(s[i] - m[(i >> 1) & 1]);
        s[i] = p;
        l[(i >> 1) & 1] += p;
      }
    };
    // this thread is done with a stage (or Q): its warpgroup's wgmmas that
    // read it have completed
    auto release = [&](uint32_t bar) { mbar_arrive(bar); };
    // P as the A operand of P . V: k step kk covers keys 16kk..16kk+15, the
    // n8 blocks 2kk and 2kk+1 of S
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kNb / 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };

    if (!kSolo && wg == 1) named_arrive(1);  // warpgroup 0 takes the first turn
    int stage = 0;                 // the ring's position, run on as the
    uint32_t phase = 0, q_phase = 0;  // producer's
    for (int wi = blockIdx.x; wi < walk.n_work; wi += gridDim.x) {
      const Item it = walk.item(wi, kv_hi, lane, kN);
      const int n_t = it.hi - it.lo;
      // the turns between the warpgroups (warpgroup 1's very last turn has
      // no turn to hand on)
      const bool more = wi + (int)gridDim.x < walk.n_work;
      auto turn_begin = [&]() {
        if constexpr (!kSolo) named_sync(1 + wg);
      };
      auto turn_end = [&](bool last) {
        if constexpr (!kSolo)
          if (wg == 0 || !last || more) named_arrive(2 - wg);
      };
      const int h = it.h, b = it.b;
      const int row_lo = it.q0 + wg * 64 + w * 16 + gid, row_hi = row_lo + 8;
      // bias rows clamped into range (rows >= Lq are never written, their
      // bias is read only to keep them finite)
      if constexpr (kBias) {
        bias_lo = bias + ((long long)b * Lq + min(row_lo, Lq - 1)) * Lk;
        bias_hi = bias + ((long long)b * Lq + min(row_hi, Lq - 1)) * Lk;
      }
      if constexpr (kPrefix) {
        lim_lo = row_bound(kv_hi, b, row_lo, Lq, Lk);
        lim_hi = row_bound(kv_hi, b, row_hi, Lq, Lk);
      }
#pragma unroll
      for (int i = 0; i < kDn * 4; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;

      // turn 0: S of the item's first tile
      mbar_wait(kfull0 + 8 * stage, phase);
      turn_begin();
      issue_s(sb + kKAt + stage * kTileBytes);
      turn_end(false);
      if constexpr (kBias) {
        load_bias<kNb>(bz, bias_lo, bias_hi, it.lo * kN, tig, Lk);
        load_bias<kNb>(bzn, bias_lo, bias_hi, (it.lo + 1) * kN, tig, Lk);
      }
      wgmma_wait<0>();
      fence_regs(s);
      release(kempty0 + 8 * stage);
      if (n_t == 1) release(q_empty);  // the item's last S is done
      softmax(it.lo * kN);
      pack_p();
      int pstage = stage;  // tile t-1's stage and phase
      uint32_t pphase = phase;
      if (++stage == kS) {
        stage = 0;
        phase ^= 1;
      }

      // turn t: S_t and P_{t-1} . V_{t-1}
      for (int t = 1; t < n_t; ++t) {
        const int k0 = (it.lo + t) * kN;
        mbar_wait(kfull0 + 8 * stage, phase);
        mbar_wait(vfull0 + 8 * pstage, pphase);
        turn_begin();
        issue_s(sb + kKAt + stage * kTileBytes);
        issue_pv(sb + kVAt + pstage * kTileBytes);
        turn_end(false);
        if constexpr (kBias) {
#pragma unroll
          for (int i = 0; i < kNb * 4; ++i) bz[i] = bzn[i];
          load_bias<kNb>(bzn, bias_lo, bias_hi, k0 + kN, tig, Lk);
        }
        wgmma_wait<1>();  // S_t; P_{t-1} . V_{t-1} runs on
        fence_regs(s);
        release(kempty0 + 8 * stage);
        if (t == n_t - 1) release(q_empty);
        softmax(k0);
        wgmma_wait<0>();  // P_{t-1} . V_{t-1}
        fence_regs(o);
        fence_frags(pf);
        release(vempty0 + 8 * pstage);
#pragma unroll
        for (int i = 0; i < kDn * 4; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p();
        pstage = stage;
        pphase = phase;
        if (++stage == kS) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the last turn: P_{n-1} . V_{n-1}
      mbar_wait(vfull0 + 8 * pstage, pphase);
      turn_begin();
      wgmma_fence();
      issue_pv(sb + kVAt + pstage * kTileBytes);
      turn_end(true);
      wgmma_wait<0>();
      fence_regs(o);
      fence_frags(pf);
      release(vempty0 + 8 * pstage);

      const float l_lo = quad_sum(l[0]), l_hi = quad_sum(l[1]);
      if constexpr (kSplit) {
        // unnormalised o and (m, l) of this split, for split_combine_kernel
        const long long n_rows = (long long)B * Lq * H;
        const long long r_lo =
            it.s * n_rows + ((long long)b * Lq + row_lo) * H + h;
        const long long r_hi = r_lo + 8LL * H;
#pragma unroll
        for (int n = 0; n < kDn; ++n) {
          const int col = n * 8 + 2 * tig;
          if (row_lo < Lq)
            *reinterpret_cast<float2*>(o_part + r_lo * D + col) =
                make_float2(o[4 * n], o[4 * n + 1]);
          if (row_hi < Lq)
            *reinterpret_cast<float2*>(o_part + r_hi * D + col) =
                make_float2(o[4 * n + 2], o[4 * n + 3]);
        }
        if (tig == 0) {
          if (row_lo < Lq) ml[r_lo] = make_float2(m[0], l_lo);
          if (row_hi < Lq) ml[r_hi] = make_float2(m[1], l_hi);
        }
        continue;
      }
      if (lse != nullptr && tig == 0) {  // the backward's row statistics
        float2* lb = lse + ((long long)b * H + h) * Lq;
        if (row_lo < Lq) lb[row_lo] = make_float2(m[0], log2f(l_lo));
        if (row_hi < Lq) lb[row_hi] = make_float2(m[1], log2f(l_hi));
      }
      bf16* ob = out + (long long)b * Lq * q_row + (long long)h * D;
#pragma unroll
      for (int n = 0; n < kDn; ++n) {
        const int col = n * 8 + 2 * tig;
        if (row_lo < Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * q_row + col) =
              __floats2bfloat162_rn(o[4 * n] / l_lo, o[4 * n + 1] / l_lo);
        if (row_hi < Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * q_row + col) =
              __floats2bfloat162_rn(o[4 * n + 2] / l_hi, o[4 * n + 3] / l_hi);
      }
    }
  }
}

// Host side: the maps of one call (q as [B, Lq, H*D] with boxes of 64
// columns x 64 rows, k and v as [B, Lk, KV*D] with boxes of 64 columns x kN
// rows), the launch, one block an SM (or one a work item, if fewer), and
// with kSplit the combine.  A map that cannot be encoded fails the call.
template <int D, bool kBias, bool kSplit, bool kPrefix, bool kSolo>
cudaError_t launch_ws(const Args& a, cudaStream_t stream) {
  constexpr int kN = ws_keys<D, kBias>();
  constexpr int smem = ws_smem<D, kBias>(ws_stages<D, kBias>());
  const int n_split = kSplit ? a.n_split : 1;
  // no key would leave the consumers waiting for a tile that never comes;
  // every split needs a tile of its own
  if (a.B < 1 || a.Lq < 1 || a.Lk < 1 || n_split < 1 ||
      n_split > (a.Lk + kN - 1) / kN)
    return cudaErrorInvalidValue;
  const CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long qc = (long long)a.H * D, kc = (long long)a.KV * D;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_3d(&tm_q, a.q, kBf16, 2, qc, a.Lq, a.B, 64, 64) ||
      !encode_3d(&tm_k, a.k, kBf16, 2, kc, a.Lk, a.B, 64, kN) ||
      !encode_3d(&tm_v, a.v, kBf16, 2, kc, a.Lk, a.B, 64, kN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        attention_ws_kernel<D, kBias, kSplit, kPrefix, kSolo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_work =
      (long long)a.H * ((a.Lq + kRows - 1) / kRows) * n_split * a.B;
  const unsigned grid = (unsigned)(n_work < sms ? n_work : sms);
  attention_ws_kernel<D, kBias, kSplit, kPrefix, kSolo>
      <<<grid, kWsThreads, smem, stream>>>(
          tm_q, tm_k, tm_v, a.bias, a.kv_hi, static_cast<bf16*>(a.out),
          a.o_part, reinterpret_cast<float2*>(a.ml),
          kSplit ? nullptr : reinterpret_cast<float2*>(a.lse), a.B, a.Lq,
          a.Lk, a.H, a.KV, n_split, a.scale);
  err = cudaGetLastError();
  if (!kSplit || err != cudaSuccess) return err;
  const long long n_rows = (long long)a.B * a.Lq * a.H;
  const long long n_threads = n_rows * (D / 4);
  split_combine_kernel<D><<<(unsigned)((n_threads + 255) / 256), 256, 0,
                            stream>>>(
      a.o_part, reinterpret_cast<const float2*>(a.ml),
      static_cast<bf16*>(a.out), reinterpret_cast<float2*>(a.lse), n_rows,
      n_split, a.Lq, a.H);
  return cudaGetLastError();
}

template <int D, bool kSplit, bool kSolo>
cudaError_t launch_bias(const Args& a, cudaStream_t stream) {
  return a.bias ? launch_ws<D, true, kSplit, false, kSolo>(a, stream)
                : launch_ws<D, false, kSplit, false, kSolo>(a, stream);
}

// The instances a caller may reach: K2 (kQonly) splits when n_split > 1 and
// runs warpgroup 0 alone at Lq <= 64; K4 (kPrefix) takes a.kv_hi and no
// bias; K1 and K3 the plain body with or without a bias.
template <bool kQonly, bool kPrefix, int D>
cudaError_t launch_mode(const Args& a, cudaStream_t stream) {
  if constexpr (kPrefix) {
    return a.bias != nullptr || a.kv_hi == nullptr
               ? cudaErrorInvalidValue
               : launch_ws<D, false, false, true, false>(a, stream);
  } else if constexpr (kQonly) {
    const bool solo = a.Lq <= 64;  // warpgroup 1 would hold no row
    if (a.n_split > 1)
      return solo ? launch_bias<D, true, true>(a, stream)
                  : launch_bias<D, true, false>(a, stream);
    return solo ? launch_bias<D, false, true>(a, stream)
                : launch_bias<D, false, false>(a, stream);
  } else {
    return launch_bias<D, false, false>(a, stream);
  }
}

// bf16 q/k/v/out, D in {64, 128}.  Returns the cudaError_t of the first
// failing step (0 on success).
template <bool kQonly = false, bool kPrefix = false>
int run(const Args& a, int D, cudaStream_t stream) {
  if (D == 128) return (int)launch_mode<kQonly, kPrefix, 128>(a, stream);
  if (D == 64) return (int)launch_mode<kQonly, kPrefix, 64>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// K1 and K3 in bf16: q/k/v/out bf16, D in {64, 128}, bias and lse may be
// null.
inline int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, void* out, float* lse, int B, int Lq,
                    int Lk, int H, int KV, int D, float scale,
                    cudaStream_t stream) {
  const Args a{q, k, v, bias, nullptr, out, nullptr, nullptr, lse,
               B, Lq, Lk, H, KV, 1, scale};
  return run(a, D, stream);
}

}  // namespace tc
}  // namespace
