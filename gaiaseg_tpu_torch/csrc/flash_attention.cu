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
// Forward (K3, bf16: fwd_mma). A block owns 64 q rows and loops over 64-row
// key tiles staged in shared memory, mma.sync m16n8k16 (bf16 operands,
// float32 accumulators), four warps of 16 rows. The S fragments, rounded to
// bf16, are the A fragments of P V: scores never leave registers. Keys past
// N are masked (-1e30 scores, as the TPU kernel does).
//
// Backward (K4, K5, bf16: bwd_dkv_wgmma, bwd_dq_wgmma). A block owns 128
// rows of one (b, h) (key rows in K4, q rows in K5), 64 for each of two
// consumer warpgroups, loaded once by TMA; one producer warp streams the
// other side in 64-row tiles through a 3-stage ring (TMA into 128-byte
// swizzled tiles, mbarriers), so copies overlap the products. Every product
// is a wgmma m64n64k16 with float32 accumulators: the first two of a tile
// read both operands from shared memory, K-major; P^T, dS^T (K4) and dS (K5)
// stay in registers and, rounded to bf16, are the A operand of the last
// products, whose B tiles (dO and Q in K4, K in K5) are read MN-major by the
// descriptor's transpose bit, so no tile is transposed by hand. The softmax
// is recomputed as exp2(s log2e - lse2), lse2 = (m + log max(l, 1e-30))
// log2e once per row: no division or expf in the inner loop. Each block
// writes only its own rows: no atomics, bit-reproducible.
//
// For float32 inputs the same 64-row tiling runs with float32 FMA on the
// CUDA cores, one thread a row; that path exists for float32 checks.
//
// What bounds it on the H100. At the ViT shape (B 8, H 12, N 1024) K3 does
// 4*B*H*N^2*64 = 25.8 GFLOP (26 us at 989 TFLOP/s bf16) and moves ~51 MB
// (15 us at 3.35 TB/s); K4 8*B*H*N^2*64 (52 us), K5 6*B*H*N^2*64 (39 us). All
// three are bound by the tensor cores. K3 is still the first, simple
// version (mma.sync, synchronous staging); its redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of a q tile and of a key tile
constexpr int kWarps = 4;       // tensor-core kernels: warp w owns 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;     // bf16 smem row stride: conflict-free frags
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

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16) of a row-major [row][k] smem tile; g = lane / 4,
// t = lane % 4
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* X,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(X + (r0 + g) * kLd + k0 + 2 * t);
  a[1] = ld32(X + (r0 + g + 8) * kLd + k0 + 2 * t);
  a[2] = ld32(X + (r0 + g) * kLd + k0 + 2 * t + 8);
  a[3] = ld32(X + (r0 + g + 8) * kLd + k0 + 2 * t + 8);
}

// The B fragment (16 x 8) of a product X * Y, from Yt = Y transposed, held
// row-major [n][k] in smem: columns n0.., depth k0..
__device__ __forceinline__ void mma_b(float (&c)[4], const uint32_t (&a)[4],
                                      const bf16* Yt, int n0, int k0, int g,
                                      int t) {
  const bf16* p = Yt + (n0 + g) * kLd + k0 + 2 * t;
  mma(c, a, ld32(p), ld32(p + 8));
}

// The 64 x 64 tile product C[16 rows of this warp][64] += A[16][64] * Y,
// A as four k-step fragments, Y given transposed.
__device__ __forceinline__ void tile_mma(float (&c)[8][4],
                                         const uint32_t (&a)[4][4],
                                         const bf16* Yt, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_b(c[j], a[kk], Yt, 8 * j, 16 * kk, g, t);
}

// The accumulator fragments c (16 x 64 float32) rounded to bf16 as the A
// fragments of the next product (depth = c's 64 columns).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
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

// Stage rows [r0, r0 + 64) of one (b, h) of tensor t into smem, row-major
// (S) and/or transposed (St, [d][row]); rows past N read as zeros. 16-byte
// loads: 8 chunks a row, 128 threads.
__device__ __forceinline__ void stage(const Args& a, int t, int b, int h,
                                      int r0, bf16* S, bf16* St) {
  const bf16* base = static_cast<const bf16*>(
      t == kQ ? a.q : t == kK ? a.k : t == kV ? a.v : a.dout);
#pragma unroll
  for (int i = 0; i < kTile * kD / 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < a.N)
      val = *reinterpret_cast<const uint4*>(base +
                                            in_off(a, t, b, r0 + row, h) + col);
    if (S) *reinterpret_cast<uint4*>(S + row * kLd + col) = val;
    if (St) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) St[(col + x) * kLd + row] = e[x];
    }
  }
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

// K3: grid (q tiles, H, B)
__global__ void __launch_bounds__(kThreads) fwd_mma(Args a) {
  __shared__ __align__(16) bf16 Ks[kTile * kLd];
  __shared__ __align__(16) bf16 Vt[kTile * kLd];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;

  uint32_t qf[4][4];
  stage(a, kQ, b, h, q0, Ks, nullptr);     // Q through the K buffer
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qf[kk], Ks, r0, 16 * kk, g, t);

  float o[8][4], mrow[2] = {kNegInf, kNegInf}, lrow[2] = {0.f, 0.f};
  zero(o);
  for (int k0 = 0; k0 < a.N; k0 += kTile) {
    __syncthreads();                      // the last tile is consumed
    stage(a, kK, b, h, k0, Ks, nullptr);
    stage(a, kV, b, h, k0, nullptr, Vt);
    __syncthreads();
    float s[8][4];
    zero(s);
    tile_mma(s, qf, Ks, g, t);            // S = Q K^T
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * j + 2 * t + (e & 1) >= a.N) s[j][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = expf(mrow[r] - mx[r]);
      mrow[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
        o[j][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = alpha[r] * lrow[r] + quad_sum(sum[r]);
    uint32_t pf[4][4];
    acc_to_a(pf, s);                      // P rounded to v's dtype
    tile_mma(o, pf, Vt, g, t);            // O += P V
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(lrow[r], 1e-30f);
  store_rows(a, static_cast<bf16*>(a.o), b, h, q0 + r0, o, inv, g, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      if (row < a.N) {
        a.m[stat_off(a, b, h, row)] = mrow[r];
        a.l[stat_off(a, b, h, row)] = lrow[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward (K4, K5) on wgmma, fed by TMA (helpers in hopper.cuh)
//
// A block owns 128 rows of one (b, h), 64 for each of its two consumer
// warpgroups, and loads them once; one producer warp streams the other side
// through a ring of kStages 64-row tiles (TMA, mbarriers full/empty). The
// two warpgroups take turns to start their score products (named barriers
// 1 and 2, as FlashAttention-3 orders its warpgroups), so one's softmax
// tends to run under the other's products. Inside a warpgroup a tile's
// products are retired before its softmax starts: starting the next tile's
// scores ahead gained 3-4% on K5 and pushed K4 past the 168 registers a
// thread of a 288-thread block can have (PERF.md, the K4/K5 bring-up).

constexpr int kBwdRows = 128;
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kBwdThreads = kConsumers + 32;     // + the producer warp
constexpr int kStages = 3;
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

// dynamic shared memory asked for: the layout plus room to align its base
constexpr int kDkvSmem = DkvSmem::kBytes + 1024;
constexpr int kDqSmem = DqSmem::kBytes + 1024;

__device__ __forceinline__ uint32_t aligned_base(const uint8_t* raw) {
  return (hopper::smem_addr(raw) + 1023) & ~1023u;
}

// Barriers at `bar`: own (1 arrival + the own tiles' bytes), full[s]
// (full_count arrivals + a tile pair's bytes), empty[s] (one arrival per
// consumer warp).
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

// K4: grid (128-row key blocks, H, B). Per q tile, warpgroup wg (key rows
// k0 + 64 wg ..): S^T = K Q^T and dP^T = V dO^T (both operands K-major in
// shared memory), P = exp2(S^T log2e - lse2) with lse2 = (m + log l) log2e
// of the tile's q columns, dS^T = P (dP^T - di); then dV += P^T dO and
// dK += dS^T Q with P^T, dS^T as register A operands and dO, Q read
// MN-major. Key rows past N need no mask: each feeds only its own unstored
// dK/dV row. Padded q rows (zeros from TMA, lse2 = di = 0) add nothing.
__global__ void __launch_bounds__(kBwdThreads, 1)
    bwd_dkv_wgmma(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t bwd_smem[];
  const uint32_t base = aligned_base(bwd_smem);
  uint8_t* gbase = bwd_smem + (base - hopper::smem_addr(bwd_smem));
  float* lse = reinterpret_cast<float*>(gbase + DkvSmem::kLse);
  float* dis = reinterpret_cast<float*>(gbase + DkvSmem::kDi);
  const uint32_t own = base + DkvSmem::kBar, full = own + 8,
                 empty = full + 8 * kStages;
  const int k0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
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
__global__ void __launch_bounds__(kBwdThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t bwd_smem[];
  const uint32_t base = aligned_base(bwd_smem);
  const uint32_t own = base + DqSmem::kBar, full = own + 8,
                 empty = full + 8 * kStages;
  const int q0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
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

// K4 / K5 in bf16: the four tensor maps, the shared-memory limit raised to
// what the kernel asks for, one block per 128 rows. Any refusal is returned.
template <typename Kernel>
int launch_wgmma(Kernel kernel, int smem, const Args& a, cudaStream_t s) {
  Maps maps;
  const void* ptr[4] = {a.q, a.k, a.v, a.dout};
  CUtensorMap* map[4] = {&maps.q, &maps.k, &maps.v, &maps.dout};
  for (int t = 0; t < 4; ++t) {
    const int e = hopper::encode_bnhd_map(map[t], ptr[t], a.B, a.N, a.H,
                                          a.s[t][0], a.s[t][1], a.s[t][2]);
    if (e != 0) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((a.N + kBwdRows - 1) / kBwdRows, a.H, a.B), kBwdThreads, smem,
           s>>>(maps, a);
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
  if (dtype == kBFloat16)
    fwd_mma<<<grid_of(a), kThreads, 0, s>>>(a);
  else if (dtype == kFloat32)
    fwd_f32<float><<<grid_of(a), kTile, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
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
