// Flash attention for Hopper (sm_90a): forward (K3) and the two backward
// kernels (K4 dK/dV, K5 dQ). Built by gaiaseg_tpu_torch/ops/cuda/build.py
// with nvcc into a shared library with a plain C interface; bound with
// ctypes by gaiaseg_tpu_torch/ops/cuda/flash_attention.py.
//
// Replaces the Pallas kernels of the JAX package:
//   K3 flash_fwd     <- _fa_kernel (gaiaseg_tpu/ops/pallas/flash_attention.py,
//                       driven by _flash_fwd)
//   K4 flash_bwd_dkv <- _dkv_kernel (ops/pallas/flash_attention_bwd.py)
//   K5 flash_bwd_dq  <- _dq_kernel  (ops/pallas/flash_attention_bwd.py)
//
// What they compute. Non-causal softmax attention of one head of width 64,
// q pre-scaled by 1/sqrt(64), tensors in the model's [B, N, H, 64] layout
// (any strides with the head dim contiguous: q/k/v are views into the
// fused qkv projection). The forward keeps the row max m and the
// unnormalised row sum l ([B, H, N] float32) for the backward, which
// recomputes P = exp(S - m) / l tile by tile:
//   dV = P^T dO,  dS = P * (dO V^T - di),  dK = dS^T Q,  dQ = dS K,
// with di = rowsum(dO * O) computed by the caller.
//
// All three bf16 kernels share one shape (fwd_wgmma, bwd_dkv_wgmma,
// bwd_dq_wgmma). A block owns 128 rows of one (b, h) at a time (q rows in K3
// and K5, key rows in K4), 64 for each of two consumer warpgroups, loaded
// once by TMA; one producer warp streams the other side in 64-row tiles
// through a ring (TMA into 128-byte swizzled tiles, mbarriers full/empty),
// so copies overlap the products. Every product is a wgmma with float32
// accumulators (m64n64k16; K3's scores m64n128k16, two key tiles a stage):
// the score products read both operands from shared memory, K-major; P (K3),
// P^T and dS^T (K4) and dS (K5) stay in registers and, rounded to bf16, are
// the A operand of the last products, whose B tiles (V in K3, dO and Q in
// K4, K in K5) are read MN-major by the descriptor's transpose bit, so no
// tile is transposed by hand. Each block writes only its own rows: no
// atomics, bit-reproducible.
//
// Forward (K3). The grid is persistent: one block an SM, each taking work
// items (128 q rows of one (b, h)) in turn, so that a block's start, its
// wait for Q and its stores are not paid once per 128 rows: the producer
// runs on into the next item (a second Q buffer; the ring never drains)
// while the consumers finish this one. A stage of the ring is 128 keys (two
// tiles of K, two of V), so the loop's barriers, waits and turns come once
// per 128 keys. Online softmax in the log2 domain: per stage the row max m
// (natural units, as stored) and P = exp2(s log2e - m log2e) on the SFU, the
// row sum l and the output rescaled by exp2((m_old - m) log2e); one division
// by max(l, 1e-30) at the end. Keys past N are masked (-1e30) in the ragged
// last stage only. The next stage's score product is issued together with
// this stage's P V, and the softmax of the new scores runs under the P V:
// an item's first score product and last P V are peeled so that the loop
// issues a fixed sequence of commit groups, and the score accumulator is
// fresh in every iteration. A warp that issues wgmmas is held for about as
// long as they run, and the softmax's float32 arithmetic (not its
// exponentials) adds to the products' time instead of hiding under them
// (PERF.md, the K3 bring-up).
//
// Backward (K4, K5). The softmax is recomputed as exp2(s log2e - lse2),
// lse2 = (m + log max(l, 1e-30)) log2e once per row: no division or expf in
// the inner loop.
//
// For float32 inputs the same 64-row tiling runs with float32 FMA on the
// CUDA cores, one thread a row; that path exists for float32 checks.
//
// What bounds it on the H100. At the ViT shape (B 8, H 12, N 1024) K3 does
// 4*B*H*N^2*64 = 25.8 GFLOP (26 us at 989 TFLOP/s bf16) and moves ~51 MB
// (15 us at 3.35 TB/s); K4 8*B*H*N^2*64 (52 us), K5 6*B*H*N^2*64 (39 us). All
// three are bound by the tensor cores; at head dim 64 the forward's 32
// exponentials a thread and tile cost the SFUs about what its two products
// cost the tensor cores, which is why the two warpgroups take turns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of a streamed tile (a TMA box)
constexpr int kLdF = kD + 1;    // float smem row stride: conflict-free rows
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;                // [B, N, H, 64] contiguous outputs
  void* dq;
  void* dk;
  void* dv;
  float* m;               // [B, H, N]
  float* l;
  const float* di;
  long long s[4][3];      // element strides (b, n, h) of q, k, v, dout
  int B, N, H;
};

enum { kQ = 0, kK = 1, kV = 2, kDO = 3 };

__device__ __forceinline__ long long in_off(const Args& a, int t, int b,
                                            int n, int h) {
  return b * a.s[t][0] + n * a.s[t][1] + h * a.s[t][2];
}

__device__ __forceinline__ long long out_off(const Args& a, int b, int n,
                                             int h) {
  return ((long long)(b * a.N + n) * a.H + h) * kD;
}

__device__ __forceinline__ int stat_off(const Args& a, int b, int h, int n) {
  return (b * a.H + h) * a.N + n;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator fragments c (16 x 64 float32) rounded to bf16 as the A
// fragments of the next product (depth = c's 64 columns).
template <int kSteps>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[kSteps][4],
                                         const float (&c)[2 * kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Warp-quad (the 4 lanes sharing a fragment row) reductions
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store this warp's 16 x 64 float32 fragment rows as bf16 into a contiguous
// [B, N, H, 64] output, rows below N only; scale[r] multiplies fragment
// row r (g, g + 8).
__device__ __forceinline__ void store_rows(const Args& a, bf16* out, int b,
                                           int h, int row0,
                                           const float (&c)[8][4],
                                           const float (&scale)[2], int g,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.N) continue;
    bf16* dst = out + out_off(a, b, row, h);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
          pack(c[j][2 * r] * scale[r], c[j][2 * r + 1] * scale[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16 kernels (K3, K4, K5) on wgmma, fed by TMA (helpers in hopper.cuh)
//
// A block owns 128 rows of one (b, h), 64 for each of its two consumer
// warpgroups, and loads them once; one producer warp streams the other side
// through a ring of 64-row tiles (TMA, mbarriers full/empty). The two
// warpgroups take turns to start their products (named barriers 1 and 2, as
// FlashAttention-3 orders its warpgroups; K3 passes the turn on after its
// softmax, and on across its work items). In K4 and K5 a tile's products are
// retired before its softmax starts: starting the next tile's scores ahead
// gained 3-4% on K5 and pushed K4 past the 168 registers a thread of a
// 288-thread block can have (PERF.md, the K4/K5 bring-up). K3 carries one
// score and one output accumulator and does start the next tile's scores
// ahead.

constexpr int kBlockRows = 128;
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kBlockThreads = kConsumers + 32;   // + the producer warp
constexpr int kStages = 3;      // ring of K4 and K5: a tile pair per stage
constexpr int kFwdStages = 4;   // ring of K3: it holds V a tile longer than K
constexpr int kFwdKeys = 128;   // keys of a K3 stage: two tiles of K, two of V
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileB = hopper::kTileBytes;

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Shared memory of K4, byte offsets from a 1024-aligned base: own K and V
// (a tile per warpgroup), the Q and dO ring, the ring's log2-domain lse and
// di (64 float32 each), then the barriers own, full[kStages], empty[kStages].
struct DkvSmem {
  static constexpr int kOwnK = 0;
  static constexpr int kOwnV = kOwnK + 2 * kTileB;
  static constexpr int kRingQ = kOwnV + 2 * kTileB;
  static constexpr int kRingDO = kRingQ + kStages * kTileB;
  static constexpr int kLse = kRingDO + kStages * kTileB;
  static constexpr int kDi = kLse + kStages * kTile * 4;
  static constexpr int kBar = kDi + kStages * kTile * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
};

// Shared memory of K5: own Q and dO, the K and V ring, the barriers.
struct DqSmem {
  static constexpr int kOwnQ = 0;
  static constexpr int kOwnDO = kOwnQ + 2 * kTileB;
  static constexpr int kRingK = kOwnDO + 2 * kTileB;
  static constexpr int kRingV = kRingK + kStages * kTileB;
  static constexpr int kBar = kRingV + kStages * kTileB;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
};

// Shared memory of K3: two buffers of own Q (a tile per warpgroup each, so
// that the next work item's Q arrives while this one computes), the K and V
// ring (two tiles each a stage, the second right behind the first, so that
// the pair is one 128-row operand), then the barriers q_full[2], q_empty[2],
// full[kFwdStages], empty[kFwdStages].
struct FwdSmem {
  static constexpr int kOwnQ = 0;
  static constexpr int kRingK = kOwnQ + 4 * kTileB;
  static constexpr int kRingV = kRingK + kFwdStages * 2 * kTileB;
  static constexpr int kBar = kRingV + kFwdStages * 2 * kTileB;
  static constexpr int kBytes = kBar + (4 + 2 * kFwdStages) * 8;
};

// dynamic shared memory asked for: the layout plus room to align its base
constexpr int kFwdSmem = FwdSmem::kBytes + 1024;
constexpr int kDkvSmem = DkvSmem::kBytes + 1024;
constexpr int kDqSmem = DqSmem::kBytes + 1024;

__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (hopper::smem_addr(raw) + 1023) & ~1023u;
}

// Barriers of K4 and K5 at `bar`: own (1 arrival + the own tiles' bytes),
// full[s] (full_count arrivals + a tile pair's bytes), empty[s] (one arrival
// per consumer warp), s < kStages.
__device__ __forceinline__ void init_barriers(uint32_t bar, int full_count) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar + 8 * (1 + s), full_count);
      hopper::mbar_init(bar + 8 * (1 + kStages + s), kConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// The two score products of a tile, x = X Bx^T and y = Y By^T (m64n64,
// depth 64, one commit group): X and Y the warpgroup's own rows, Bx and By
// the ring's tiles, all K-major in shared memory.
__device__ __forceinline__ void score_pair(float (&x)[8][4], float (&y)[8][4],
                                           uint32_t xt, uint32_t yt,
                                           uint32_t bx, uint32_t by) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_ss(x, hopper::desc_kmajor(xt, kk),
                     hopper::desc_kmajor(bx, kk), kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_ss(y, hopper::desc_kmajor(yt, kk),
                     hopper::desc_kmajor(by, kk), kk);
  hopper::wgmma_commit();
}

// One stage's step of the online softmax on a score fragment s (the
// stage's 128 keys wide), in place: keys at or past n_valid are masked, the running row
// max mrow (natural units) is raised, s becomes P = exp2((s - mrow) log2e)
// in float32, and this thread's share of the row sum is added into lsum
// after scaling it by alpha = exp2((old max - new max) log2e), which the
// caller applies to the output rows. kFirst: no old max yet, alpha = 1.
template <bool kFirst>
__device__ __forceinline__ void softmax_tile(float (&s)[kFwdKeys / 8][4],
                                             float (&mrow)[2],
                                             float (&lsum)[2],
                                             float (&alpha)[2], int n_valid,
                                             int t) {
  constexpr int kGroups = kFwdKeys / 8;
  if (n_valid < kFwdKeys) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= n_valid) s[j][e] = kNegInf;
  }
  float mx[2] = {s[0][0], s[0][2]};
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    if (kFirst) {
      alpha[r] = 1.f;
    } else {
      mx[r] = fmaxf(mx[r], mrow[r]);
      alpha[r] = hopper::exp2_approx((mrow[r] - mx[r]) * kLog2e);
    }
    mrow[r] = mx[r];
    ms[r] = mx[r] * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = hopper::exp2_approx(fmaf(s[j][e], kLog2e, -ms[e >> 1]));
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lsum[r] = kFirst ? sum[r] : fmaf(lsum[r], alpha[r], sum[r]);
}

// s = X B^T (m64n128, depth 64, one commit group), X the warpgroup's own
// rows and B a stage's 128 key rows, both K-major in shared memory. The
// caller has fenced.
__device__ __forceinline__ void score(float (&s)[16][4], uint32_t xt,
                                      uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_ss_n128(s, hopper::desc_kmajor(xt, kk),
                          hopper::desc_kmajor(bt, kk), kk);
  hopper::wgmma_commit();
}

// o += P V (one commit group): P as register A operands, a stage's 128 rows
// of V read MN-major (its key rows are the depth). The caller has fenced.
__device__ __forceinline__ void add_pv(float (&o)[8][4],
                                       const uint32_t (&pa)[8][4],
                                       uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_rs_mn(o, pa[kk], hopper::desc_mnmajor(vt, kk));
  hopper::wgmma_commit();
}

// K3: a persistent grid, one block an SM at most; block x takes the work
// items x, x + gridDim.x, .. of the B * H * ceil(N / 128) blocks of 128 q
// rows (q block fastest, so blocks that run together share K and V in L2).
// The producer runs ahead across items: the next item's Q and first stages
// arrive while this item computes and stores. Per item, warpgroup wg owns q
// rows q0 + 64 wg .. Stage 0 (keys 0..127): S = Q K_0^T, softmax. Stage it >
// 0: S = Q K_it^T and O += P V_(it-1) are issued together; the softmax of S
// (mask, max, exp2, sums) runs while P V is in flight; then O is rescaled and
// P rounded to bf16 for the next turn. After the last stage: O += P V_last,
// O / max(l, 1e-30). q rows past N are zeros from TMA and are not stored.
struct FwdItem {
  int q0, h, b;
};

__device__ __forceinline__ FwdItem fwd_item(const Args& a, int item) {
  const int q_blocks = (a.N + kBlockRows - 1) / kBlockRows;
  FwdItem w;
  w.q0 = (item % q_blocks) * kBlockRows;
  w.h = (item / q_blocks) % a.H;
  w.b = item / (q_blocks * a.H);
  return w;
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    fwd_wgmma(const __grid_constant__ Maps maps, const Args a, int n_items) {
  extern __shared__ uint8_t dyn_smem[];
  const uint32_t base = aligned_base(dyn_smem);
  const uint32_t q_full = base + FwdSmem::kBar, q_empty = q_full + 16,
                 full = q_empty + 16, empty = full + 8 * kFwdStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (a.N + kFwdKeys - 1) / kFwdKeys;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(q_full + 8 * i, 1);
      hopper::mbar_init(q_empty + 8 * i, kConsumers / 32);
    }
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer (lane 0): per item its Q into the free buffer, then its K and
    // V stages; n counts the stages loaded so far, over all items
    if (lane != 0) return;
    hopper::tma_prefetch_map(&maps.q);
    hopper::tma_prefetch_map(&maps.k);
    hopper::tma_prefetch_map(&maps.v);
    int n = 0;
    for (int j = 0, item = blockIdx.x; item < n_items;
         ++j, item += gridDim.x) {
      const FwdItem w = fwd_item(a, item);
      const int buf = j & 1;
      hopper::mbar_wait(q_empty + 8 * buf, ((j >> 1) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(q_full + 8 * buf, 2 * kTileB);
      for (int i = 0; i < 2; ++i)
        hopper::tma_load_4d(base + FwdSmem::kOwnQ + (2 * buf + i) * kTileB,
                            &maps.q, q_full + 8 * buf, 0, w.h,
                            w.q0 + 64 * i, w.b);
      for (int it = 0; it < n_tiles; ++it, ++n) {
        const int s = n % kFwdStages;
        hopper::mbar_wait(empty + 8 * s, ((n / kFwdStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full + 8 * s, 4 * kTileB);
        for (int i = 0; i < 2; ++i) {
          hopper::tma_load_4d(base + FwdSmem::kRingK + (2 * s + i) * kTileB,
                              &maps.k, full + 8 * s, 0, w.h,
                              it * kFwdKeys + i * kTile, w.b);
          hopper::tma_load_4d(base + FwdSmem::kRingV + (2 * s + i) * kTileB,
                              &maps.v, full + 8 * s, 0, w.h,
                              it * kFwdKeys + i * kTile, w.b);
        }
      }
    }
    return;
  }

  // consumers: the two rows (g, g + 8 of the warp's 16) of this thread
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const uint32_t ring_k = base + FwdSmem::kRingK;
  const uint32_t ring_v = base + FwdSmem::kRingV;
  const int last = n_tiles - 1;
  int n = 0;                      // stages consumed before this item
  if (wg == 1) hopper::named_bar_arrive(1, kConsumers);   // warpgroup 0 first
  for (int j = 0, item = blockIdx.x; item < n_items;
       ++j, item += gridDim.x, n += n_tiles) {
    const int buf = j & 1;
    const bool more = item + gridDim.x < n_items;
    const uint32_t qt = base + FwdSmem::kOwnQ + (2 * buf + wg) * kTileB;
    float o[8][4], mrow[2], lsum[2], alpha[2];
    uint32_t pa[8][4];
    zero(o);
    hopper::mbar_wait(q_full + 8 * buf, (j >> 1) & 1);
    {
      const int st = n % kFwdStages;
      hopper::mbar_wait(full + 8 * st, (n / kFwdStages) & 1);
      float s[16][4];
      hopper::named_bar_sync(1 + wg, kConsumers);   // this warpgroup's turn
      hopper::wgmma_fence();
      score(s, qt, ring_k + st * 2 * kTileB);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(s);
      softmax_tile<true>(s, mrow, lsum, alpha, last == 0 ? a.N : kFwdKeys,
                         t);
      if (wg == 0 || last > 0 || more)
        hopper::named_bar_arrive(2 - wg, kConsumers);  // the other's turn
      acc_to_a(pa, s);
    }
    for (int it = 1; it <= last; ++it) {
      const int st = (n + it) % kFwdStages, sp = (n + it - 1) % kFwdStages;
      hopper::mbar_wait(full + 8 * st, ((n + it) / kFwdStages) & 1);
      float s[16][4];
      hopper::named_bar_sync(1 + wg, kConsumers);
      hopper::fence_acc(o);
      hopper::wgmma_fence();
      score(s, qt, ring_k + st * 2 * kTileB);           // S = Q K_it^T
      add_pv(o, pa, ring_v + sp * 2 * kTileB);          // O += P V_(it-1)
      hopper::wgmma_wait<1>();                      // S is there
      hopper::fence_acc(s);
      softmax_tile<false>(s, mrow, lsum, alpha,
                          it == last ? a.N - it * kFwdKeys : kFwdKeys, t);
      if (wg == 0 || it < last || more)
        hopper::named_bar_arrive(2 - wg, kConsumers);
      hopper::wgmma_wait<0>();                      // P V is done
      hopper::fence_acc(o);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + 8 * sp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jj][e] *= alpha[e >> 1];
      acc_to_a(pa, s);
    }
    const int sl = (n + last) % kFwdStages;
    hopper::fence_acc(o);
    hopper::wgmma_fence();
    add_pv(o, pa, ring_v + sl * 2 * kTileB);
    hopper::wgmma_wait<0>();
    hopper::fence_acc(o);
    __syncwarp();
    if (lane == 0) {              // every product of the item has completed
      hopper::mbar_arrive(q_empty + 8 * buf);
      hopper::mbar_arrive(empty + 8 * sl);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] = quad_sum(lsum[r]);
      inv[r] = 1.f / fmaxf(lsum[r], 1e-30f);
    }
    const FwdItem w = fwd_item(a, item);
    const int row0 = w.q0 + 64 * wg + 16 * (warp & 3);
    store_rows(a, static_cast<bf16*>(a.o), w.b, w.h, row0, o, inv, g, t);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < a.N) {
          a.m[stat_off(a, w.b, w.h, row)] = mrow[r];
          a.l[stat_off(a, w.b, w.h, row)] = lsum[r];
        }
      }
    }
  }
}

// K4: grid (128-row key blocks, H, B). Per q tile, warpgroup wg (key rows
// k0 + 64 wg ..): S^T = K Q^T and dP^T = V dO^T (both operands K-major in
// shared memory), P = exp2(S^T log2e - lse2) with lse2 = (m + log l) log2e
// of the tile's q columns, dS^T = P (dP^T - di); then dV += P^T dO and
// dK += dS^T Q with P^T, dS^T as register A operands and dO, Q read
// MN-major. Key rows past N need no mask: each feeds only its own unstored
// dK/dV row. Padded q rows (zeros from TMA, lse2 = di = 0) add nothing.
__global__ void __launch_bounds__(kBlockThreads, 1)
    bwd_dkv_wgmma(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t dyn_smem[];
  const uint32_t base = aligned_base(dyn_smem);
  uint8_t* gbase = dyn_smem + (base - hopper::smem_addr(dyn_smem));
  float* lse = reinterpret_cast<float*>(gbase + DkvSmem::kLse);
  float* dis = reinterpret_cast<float*>(gbase + DkvSmem::kDi);
  const uint32_t own = base + DkvSmem::kBar, full = own + 8,
                 empty = full + 8 * kStages;
  const int k0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (a.N + kTile - 1) / kTile;
  init_barriers(own, 32);

  if (warp == kConsumers / 32) {
    // producer: own K and V once, then per q tile its lse2 and di (all 32
    // lanes, one arrival each) and its Q and dO tiles (lane 0)
    if (lane == 0) {
      hopper::tma_prefetch_map(&maps.q);
      hopper::tma_prefetch_map(&maps.dout);
      hopper::mbar_arrive_expect_tx(own, 4 * kTileB);
      for (int w = 0; w < 2; ++w) {
        hopper::tma_load_4d(base + DkvSmem::kOwnK + w * kTileB, &maps.k,
                            own, 0, h, k0 + 64 * w, b);
        hopper::tma_load_4d(base + DkvSmem::kOwnV + w * kTileB, &maps.v,
                            own, 0, h, k0 + 64 * w, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, q0 = it * kTile;
      float l2[2], d[2];               // read before the slot is free
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + lane + 32 * i;
        l2[i] = d[i] = 0.f;
        if (row < a.N) {
          const int o = stat_off(a, b, h, row);
          l2[i] = (a.m[o] + logf(fmaxf(a.l[o], 1e-30f))) * kLog2e;
          d[i] = a.di[o];
        }
      }
      hopper::mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse[s * kTile + lane + 32 * i] = l2[i];
        dis[s * kTile + lane + 32 * i] = d[i];
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(full + 8 * s, 2 * kTileB);
        hopper::tma_load_4d(base + DkvSmem::kRingQ + s * kTileB, &maps.q,
                            full + 8 * s, 0, h, q0, b);
        hopper::tma_load_4d(base + DkvSmem::kRingDO + s * kTileB,
                            &maps.dout, full + 8 * s, 0, h, q0, b);
      } else {
        hopper::mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // consumers
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const uint32_t kt = base + DkvSmem::kOwnK + wg * kTileB;
  const uint32_t vt = base + DkvSmem::kOwnV + wg * kTileB;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  hopper::mbar_wait(own, 0);
  if (wg == 1) hopper::named_bar_arrive(1, kConsumers);   // warpgroup 0 first
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t qt = base + DkvSmem::kRingQ + s * kTileB;
    const uint32_t dt = base + DkvSmem::kRingDO + s * kTileB;
    hopper::mbar_wait(full + 8 * s, (it / kStages) & 1);
    float p[8][4], ds[8][4];
    hopper::named_bar_sync(1 + wg, kConsumers);    // this warpgroup's turn
    score_pair(p, ds, kt, vt, qt, dt);     // S^T = K Q^T, dP^T = V dO^T
    if (wg == 0 || it + 1 < n_tiles)
      hopper::named_bar_arrive(2 - wg, kConsumers);  // the other's turn
    hopper::wgmma_wait<0>();
    hopper::fence_acc(p);
    hopper::fence_acc(ds);
    const float* l2 = lse + s * kTile;
    const float* d2 = dis + s * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lj = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t);
      const float2 dj = *reinterpret_cast<const float2*>(d2 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = hopper::exp2_approx(
            fmaf(p[j][e], kLog2e, -((e & 1) ? lj.y : lj.x)));
        ds[j][e] = pe * (ds[j][e] - ((e & 1) ? dj.y : dj.x));
        p[j][e] = pe;
      }
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a(pa, p);
    acc_to_a(da, ds);
    hopper::fence_acc(dv);
    hopper::fence_acc(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)                 // dV += P^T dO
      hopper::wgmma_rs_mn(dv, pa[kk], hopper::desc_mnmajor(dt, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)                 // dK += dS^T Q
      hopper::wgmma_rs_mn(dk, da[kk], hopper::desc_mnmajor(qt, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dv);
    hopper::fence_acc(dk);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + 8 * s);
  }
  const float one[2] = {1.f, 1.f};
  const int row0 = k0 + 64 * wg + 16 * (warp & 3);
  store_rows(a, static_cast<bf16*>(a.dk), b, h, row0, dk, one, g, t);
  store_rows(a, static_cast<bf16*>(a.dv), b, h, row0, dv, one, g, t);
}

// K5: grid (128-row q blocks, H, B). Per key tile, warpgroup wg (q rows
// q0 + 64 wg ..): S = Q K^T and dP = dO V^T (K-major), P = exp2(S log2e -
// lse2) of the row, 0 for keys past N; dS = P (dP - di); dQ += dS K with
// dS as the register A operand and K read MN-major.
__global__ void __launch_bounds__(kBlockThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t dyn_smem[];
  const uint32_t base = aligned_base(dyn_smem);
  const uint32_t own = base + DqSmem::kBar, full = own + 8,
                 empty = full + 8 * kStages;
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (a.N + kTile - 1) / kTile;
  init_barriers(own, 1);

  if (warp == kConsumers / 32) {
    // producer (lane 0): own Q and dO once, then the K and V tiles
    if (lane != 0) return;
    hopper::tma_prefetch_map(&maps.k);
    hopper::tma_prefetch_map(&maps.v);
    hopper::mbar_arrive_expect_tx(own, 4 * kTileB);
    for (int w = 0; w < 2; ++w) {
      hopper::tma_load_4d(base + DqSmem::kOwnQ + w * kTileB, &maps.q, own,
                          0, h, q0 + 64 * w, b);
      hopper::tma_load_4d(base + DqSmem::kOwnDO + w * kTileB, &maps.dout,
                          own, 0, h, q0 + 64 * w, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(full + 8 * s, 2 * kTileB);
      hopper::tma_load_4d(base + DqSmem::kRingK + s * kTileB, &maps.k,
                          full + 8 * s, 0, h, it * kTile, b);
      hopper::tma_load_4d(base + DqSmem::kRingV + s * kTileB, &maps.v,
                          full + 8 * s, 0, h, it * kTile, b);
    }
    return;
  }

  // consumers: the two rows (g, g + 8 of the warp's 16) of this thread
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * (warp & 3);
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    l2[r] = dr[r] = 0.f;
    if (row < a.N) {
      const int o = stat_off(a, b, h, row);
      l2[r] = (a.m[o] + logf(fmaxf(a.l[o], 1e-30f))) * kLog2e;
      dr[r] = a.di[o];
    }
  }
  const uint32_t qt = base + DqSmem::kOwnQ + wg * kTileB;
  const uint32_t dt = base + DqSmem::kOwnDO + wg * kTileB;
  float dq[8][4];
  zero(dq);
  hopper::mbar_wait(own, 0);
  if (wg == 1) hopper::named_bar_arrive(1, kConsumers);   // warpgroup 0 first
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, k0 = it * kTile;
    const uint32_t kt = base + DqSmem::kRingK + s * kTileB;
    const uint32_t vt = base + DqSmem::kRingV + s * kTileB;
    hopper::mbar_wait(full + 8 * s, (it / kStages) & 1);
    float p[8][4], ds[8][4];
    hopper::named_bar_sync(1 + wg, kConsumers);    // this warpgroup's turn
    score_pair(p, ds, qt, dt, kt, vt);     // S = Q K^T, dP = dO V^T
    if (wg == 0 || it + 1 < n_tiles)
      hopper::named_bar_arrive(2 - wg, kConsumers);  // the other's turn
    hopper::wgmma_wait<0>();
    hopper::fence_acc(p);
    hopper::fence_acc(ds);
    const bool ragged = k0 + kTile > a.N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = hopper::exp2_approx(fmaf(p[j][e], kLog2e, -l2[e >> 1]));
        if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= a.N) pe = 0.f;
        ds[j][e] = pe * (ds[j][e] - dr[e >> 1]);
      }
    uint32_t da[4][4];
    acc_to_a(da, ds);
    hopper::fence_acc(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)                 // dQ += dS K
      hopper::wgmma_rs_mn(dq, da[kk], hopper::desc_mnmajor(kt, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dq);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + 8 * s);
  }
  const float one[2] = {1.f, 1.f};
  store_rows(a, static_cast<bf16*>(a.dq), b, h, row0, dq, one, g, t);
}

// ---------------------------------------------------------------------------
// float32 path: the same tiles, one thread a row, FMA on the CUDA cores

template <typename T>
__device__ __forceinline__ float f32(T x) {
  return static_cast<float>(x);
}

// thread x stages column x of rows [r0, r0 + 64) of tensor t (coalesced)
template <typename T>
__device__ __forceinline__ void stage_f32(const Args& a, int tsr, int b,
                                          int h, int r0, float* S, int ld) {
  const T* base = static_cast<const T*>(
      tsr == kQ ? a.q : tsr == kK ? a.k : tsr == kV ? a.v : a.dout);
  for (int r = 0; r < kTile; ++r)
    S[r * ld + threadIdx.x] =
        r0 + r < a.N ? f32(base[in_off(a, tsr, b, r0 + r, h) + threadIdx.x])
                     : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kTile) fwd_f32(Args a) {
  __shared__ float Ks[kTile * kLdF], Vs[kTile * kLdF];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + threadIdx.x;
  const bool in = row < a.N;
  stage_f32<T>(a, kQ, b, h, q0, Ks, kLdF);
  __syncthreads();
  float q[kD], o[kD], mrow = kNegInf, lrow = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    q[d] = Ks[threadIdx.x * kLdF + d];
    o[d] = 0.f;
  }
  for (int k0 = 0; k0 < a.N; k0 += kTile) {
    __syncthreads();
    stage_f32<T>(a, kK, b, h, k0, Ks, kLdF);
    stage_f32<T>(a, kV, b, h, k0, Vs, kLdF);
    __syncthreads();
    float s[kTile], mx = mrow;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc = fmaf(q[d], Ks[r * kLdF + d], acc);
      s[r] = k0 + r < a.N ? acc : kNegInf;
      mx = fmaxf(mx, s[r]);
    }
    const float alpha = expf(mrow - mx);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      s[r] = expf(s[r] - mx);
      sum += s[r];
    }
    lrow = alpha * lrow + sum;
    mrow = mx;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] *= alpha;
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int d = 0; d < kD; ++d) o[d] = fmaf(s[r], Vs[r * kLdF + d], o[d]);
  }
  if (!in) return;
  const float lsafe = fmaxf(lrow, 1e-30f);
  T* out = static_cast<T*>(a.o) + out_off(a, b, row, h);
#pragma unroll
  for (int d = 0; d < kD; ++d) out[d] = static_cast<T>(o[d] / lsafe);
  a.m[stat_off(a, b, h, row)] = mrow;
  a.l[stat_off(a, b, h, row)] = lrow;
}

constexpr int kF32Smem = 4 * kTile * kLdF * (int)sizeof(float);

// K4, float32: thread x owns key row k0 + x
template <typename T>
__global__ void __launch_bounds__(kTile) bwd_dkv_f32(Args a) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * kLdF;
  float* Qs = Vs + kTile * kLdF;
  float* Ds = Qs + kTile * kLdF;
  __shared__ float sm[kTile], sl[kTile], sdi[kTile];
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int x = threadIdx.x;
  stage_f32<T>(a, kK, b, h, k0, Ks, kLdF);
  stage_f32<T>(a, kV, b, h, k0, Vs, kLdF);
  float dk[kD], dv[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dk[d] = dv[d] = 0.f;
  for (int q0 = 0; q0 < a.N; q0 += kTile) {
    __syncthreads();
    stage_f32<T>(a, kQ, b, h, q0, Qs, kLdF);
    stage_f32<T>(a, kDO, b, h, q0, Ds, kLdF);
    const int row = q0 + x;
    const bool in = row < a.N;
    sm[x] = in ? a.m[stat_off(a, b, h, row)] : 0.f;
    sl[x] = in ? fmaxf(a.l[stat_off(a, b, h, row)], 1e-30f) : 1.f;
    sdi[x] = in ? a.di[stat_off(a, b, h, row)] : 0.f;
    __syncthreads();
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(Qs[i * kLdF + d], Ks[x * kLdF + d], s);
        dp = fmaf(Ds[i * kLdF + d], Vs[x * kLdF + d], dp);
      }
      const float p = expf(s - sm[i]) / sl[i];
      const float ds = p * (dp - sdi[i]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dv[d] = fmaf(p, Ds[i * kLdF + d], dv[d]);
        dk[d] = fmaf(ds, Qs[i * kLdF + d], dk[d]);
      }
    }
  }
  const int row = k0 + x;
  if (row >= a.N) return;
  T* odk = static_cast<T*>(a.dk) + out_off(a, b, row, h);
  T* odv = static_cast<T*>(a.dv) + out_off(a, b, row, h);
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    odk[d] = static_cast<T>(dk[d]);
    odv[d] = static_cast<T>(dv[d]);
  }
}

// K5, float32: thread x owns q row q0 + x
template <typename T>
__global__ void __launch_bounds__(kTile) bwd_dq_f32(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ds = Qs + kTile * kLdF;
  float* Ks = Ds + kTile * kLdF;
  float* Vs = Ks + kTile * kLdF;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int x = threadIdx.x, row = q0 + x;
  const bool in = row < a.N;
  stage_f32<T>(a, kQ, b, h, q0, Qs, kLdF);
  stage_f32<T>(a, kDO, b, h, q0, Ds, kLdF);
  const float mr = in ? a.m[stat_off(a, b, h, row)] : 0.f;
  const float lr = in ? fmaxf(a.l[stat_off(a, b, h, row)], 1e-30f) : 1.f;
  const float dr = in ? a.di[stat_off(a, b, h, row)] : 0.f;
  float dq[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dq[d] = 0.f;
  for (int k0 = 0; k0 < a.N; k0 += kTile) {
    __syncthreads();
    stage_f32<T>(a, kK, b, h, k0, Ks, kLdF);
    stage_f32<T>(a, kV, b, h, k0, Vs, kLdF);
    __syncthreads();
    const int n_keys = min(kTile, a.N - k0);   // masked keys add nothing
    for (int r = 0; r < n_keys; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(Qs[x * kLdF + d], Ks[r * kLdF + d], s);
        dp = fmaf(Ds[x * kLdF + d], Vs[r * kLdF + d], dp);
      }
      const float ds = expf(s - mr) / lr * (dp - dr);
#pragma unroll
      for (int d = 0; d < kD; ++d) dq[d] = fmaf(ds, Ks[r * kLdF + d], dq[d]);
    }
  }
  if (!in) return;
  T* out = static_cast<T*>(a.dq) + out_off(a, b, row, h);
#pragma unroll
  for (int d = 0; d < kD; ++d) out[d] = static_cast<T>(dq[d]);
}

// ---------------------------------------------------------------------------

enum { kFloat32 = 0, kBFloat16 = 1 };

bool fill(Args& a, int B, int N, int H, const long long* strides, int n_in) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || N < 1) return false;
  a.B = B;
  a.N = N;
  a.H = H;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) a.s[t][i] = t < n_in ? strides[3 * t + i] : 0;
  return true;
}

dim3 grid_of(const Args& a) {
  return dim3((a.N + kTile - 1) / kTile, a.H, a.B);
}

template <typename Kernel>
int launch_f32(Kernel kernel, const Args& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid_of(a), kTile, kF32Smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The tensor maps of the first n_maps of q, k, v, dO. Returns a cudaError_t.
int encode_maps(Maps& maps, const Args& a, int n_maps) {
  const void* ptr[4] = {a.q, a.k, a.v, a.dout};
  CUtensorMap* map[4] = {&maps.q, &maps.k, &maps.v, &maps.dout};
  for (int t = 0; t < n_maps; ++t) {
    const int e = hopper::encode_bnhd_map(map[t], ptr[t], a.B, a.N, a.H,
                                          a.s[t][0], a.s[t][1], a.s[t][2]);
    if (e != 0) return e;
  }
  return 0;
}

// K4 / K5 in bf16: the four tensor maps, the shared-memory limit raised to
// what the kernel asks for, one block per 128 rows. Any refusal is returned.
template <typename Kernel>
int launch_wgmma(Kernel kernel, int smem, const Args& a, cudaStream_t s) {
  Maps maps = {};
  const int e = encode_maps(maps, a, 4);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  kernel<<<dim3((a.N + kBlockRows - 1) / kBlockRows, a.H, a.B),
           kBlockThreads, smem, s>>>(maps, a);
  return (int)cudaGetLastError();
}

// K3 in bf16: maps of q, k, v; one block an SM of the current device, or
// fewer when there are fewer work items.
int launch_fwd(const Args& a, cudaStream_t s) {
  Maps maps = {};
  const int e = encode_maps(maps, a, 3);
  if (e != 0) return e;
  int device = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&device);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(
        fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (ce != cudaSuccess) return (int)ce;
  const long long items =
      (long long)((a.N + kBlockRows - 1) / kBlockRows) * a.H * a.B;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = items < sms ? (int)items : sms;
  fwd_wgmma<<<blocks, kBlockThreads, kFwdSmem, s>>>(maps, a, (int)items);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: o [B, N, H, 64] (contiguous), m and l [B, H, N] float32. strides: the
// (b, n, h) element strides of q, k, v. Returns a cudaError_t.
int flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
              float* m, float* l, int B, int N, int H,
              const long long* strides, void* stream) {
  Args a = {};
  if (!fill(a, B, N, H, strides, 3)) return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.m = m;
  a.l = l;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBFloat16) return launch_fwd(a, s);
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  fwd_f32<float><<<grid_of(a), kTile, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// K4: dk, dv [B, N, H, 64] (contiguous). strides: q, k, v, dout.
int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const float* m, const float* l,
                  const float* di, void* dk, void* dv, int B, int N, int H,
                  const long long* strides, void* stream) {
  Args a = {};
  if (!fill(a, B, N, H, strides, 4)) return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.m = const_cast<float*>(m);
  a.l = const_cast<float*>(l);
  a.di = di;
  a.dk = dk;
  a.dv = dv;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBFloat16)
    return launch_wgmma(bwd_dkv_wgmma, kDkvSmem, a, s);
  if (dtype == kFloat32) return launch_f32(bwd_dkv_f32<float>, a, s);
  return (int)cudaErrorInvalidValue;
}

// K5: dq [B, N, H, 64] (contiguous). strides: q, k, v, dout.
int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const float* m, const float* l,
                 const float* di, void* dq, int B, int N, int H,
                 const long long* strides, void* stream) {
  Args a = {};
  if (!fill(a, B, N, H, strides, 4)) return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.m = const_cast<float*>(m);
  a.l = const_cast<float*>(l);
  a.di = di;
  a.dq = dq;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kBFloat16)
    return launch_wgmma(bwd_dq_wgmma, kDqSmem, a, s);
  if (dtype == kFloat32) return launch_f32(bwd_dq_f32<float>, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
