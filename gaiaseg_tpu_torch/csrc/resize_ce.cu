// Fused bilinear-upsample + softmax cross-entropy: forward sums (K1) and
// backward (K2) for Hopper (sm_90a). Built by gaiaseg_tpu_torch/ops/cuda/
// build.py with nvcc into a shared library with a plain C interface; bound
// with ctypes by gaiaseg_tpu_torch/ops/cuda/resize_ce.py.
//
// Replaces the Pallas kernels of gaiaseg_tpu/ops/pallas/resize_ce.py:
//   K1 resize_ce_fwd  <- _fwd_kernel (driven by _sums), the loss sums
//   K2 resize_ce_bwd  <- _bwd_kernel (driven by _frc_bwd), grad at mid rows
//
// What they compute. The caller has already interpolated the logits along
// the width (mid = logits @ A_W, [N, h, C, W] float32, a cuBLAS matmul as the
// JAX package left it to XLA). Output row Y of the H = f*h label rows is the
// half-pixel bilinear blend of mid rows floor(fy) and floor(fy)+1, edge
// clamped, fy = (Y + 0.5) / f - 0.5. The full-resolution logits are never
// written: each thread blends its rows in registers and reduces them to the
// softmax-CE terms at once.
//
// Rows with the same pair of mid rows form an "interval" j in [-1, h-1]
// (j = floor(fy)): f output rows, f/2 at the two edges, where both taps fall
// on the same mid row.
//
// No float atomics, bit-reproducible. The TPU kernel adds into one scalar
// across grid steps (resize_ce.py:123-125) and into overlapping gmid rows
// (:164), which is safe only because TPU grid steps run in order. Here every
// sum has one owner and a fixed order.
//
// Both kernels tile alike. A block owns a tile of one image: R consecutive
// mid rows by 32 columns, and has 32 x RY threads: thread (x, ry) takes the
// output rows ry, ry + RY, .. of each interval it evaluates, so the rows of
// an interval are spread over RY row lanes (warps) instead of being walked by
// one thread. The taps go to registers through L1 (load_taps: the block's
// lanes read the same taps at about the same time), and the upper taps of
// interval j, the lower taps of j + 1, are carried over. Labels are read
// ahead of their rows, and the next interval's taps and labels are
// prefetched into L2 while this one computes.
//
// K1 layout. Tile [r0, r0 + R) owns the intervals j in [r0, r0 + R), and the
// first tile also j = -1, so every pixel's CE is added once. A thread keeps
// the interval's taps in log2 units (a = lower row, d = upper - lower) and
// computes a pixel as u_c = a_c + w d_c, m = max u_c, lse = (m + lg2 sum
// 2^(u_c - m)) ln 2, the picked logit blended from its two taps (L1 hits),
// on the SFU's ex2/lg2. RY is the largest power of two up to min(4, f); R
// gives a thread up to 16 output rows a tile (at the flagship's losses R = 2
// and 4, 2048 blocks of 128 threads, 20 warps an SM at 96 registers: more
// rows of one interval a thread and smaller blocks measured faster than 8
// lanes, more warps or more labels ahead). Two instances: C = 19 with the
// classes in registers (fwd_tile), and any C up to 256 with an online
// logsumexp over the classes read from the L1-cached taps (fwd_tile_any).
// Each thread keeps float partial sums; the block adds them in a fixed order
// into its slot of a workspace, and the last block to finish (an integer
// ticket) adds the slots in block order in double, writes the two sums and
// sets the ticket back to 0: one launch. The workspace lives with the
// caller, one per stream.
//
// K2 layout, C = 19 (bwd_tile). R a divisor of h, at most 8, and RY up to
// min(8, f); thread (x, ry) works through each of the R + 1 intervals that
// touch the tile. Each
// pixel's softmax is computed once (max, sum and P in one go); (1-w) d and w
// d are added into the thread's own per-class accumulators for the
// interval's lower and upper mid row. The upper row of interval j is the
// lower row of interval j + 1, so the thread carries that accumulator over
// (and the taps it has already loaded), and after interval j mid row j is
// complete in the row lanes: they put their accumulators into shared memory,
// the block adds them in the fixed order ry = 0, 1, .. and writes the row
// coalesced. Only the two intervals on a tile's row border are evaluated by
// two blocks: (R + 1) / R of the exponentials, none twice when R = h.
// Ignored pixels skip the exponentials. The classes are unrolled in
// registers. At the flagship's losses the any-C design below, which takes
// 2C exponentials a pixel, measured 1.4-2.0x this one's time (at best
// 1.2-1.8x with its instances retuned for C = 19; PERF.md), so C = 19
// keeps its own.
//
// K2 layout, any other C up to 256 (bwd_tile_any; the comment above it has
// the steps). A tile of R mid rows (a divisor of h, at most 32) by 32
// columns; its mid rows and labels are staged in shared memory by cp.async
// two steps ahead, each mid row crossing HBM once a tile. A pixel's
// logsumexp comes from one pass over the staged taps (its sums taken against
// one of its own classes, split over up to 8 lanes and merged by shuffles),
// then each warp walks the interval's rows for its own classes of the tile's
// columns, with the taps and the two row adjoints in registers: no
// shared-memory accumulators, no reduction across lanes. 2C exponentials a
// pixel, 16 warps an SM at 150 classes (8-warp blocks, two an SM; 16-warp
// blocks above 152 classes).
//
// What bounds them on the H100. At the flagship loss (batch 8, 512x1024
// labels, C = 19) the function reads ~10-20 MB of mid plus 16.8 MB of int32
// labels (~8-11 us at 3.35 TB/s) and evaluates ~72 M exponentials (valid
// pixels x C), which issue on the SFUs (16/clk/SM: ~20 us at 1.98 GHz); the
// count against the 67 TFLOP/s float32 rate is ~8 us (K1). K1 needs one ex2
// a class and pixel and one lg2 a pixel beside ~4 CUDA-core instructions a
// class (blend, max, subtract, add), ~125 a pixel in all; it runs at about
// twice that SFU floor with the SFU ~half busy: each warp waits on its own
// dependent chains and loads, and neither more warps (fewer registers) nor
// more independent work a thread (more registers, fewer warps) measured
// faster (PERF.md, PR 5). K2's ~10 instructions per class and pixel (blend,
// max, exp2, sum, the label's class, two adjoint FMAs) on the CUDA cores are
// its real floor, ~30 us at full issue rate. At 150 classes (the ViT's
// losses, batch 16 of 512x512 labels) the any-C K2 reads 629 MB of mid (f =
// 4) or 157 MB (f = 16) and writes as much of gmid (0.38 / 0.10 ms at 3.35
// TB/s) and takes 2 x 150 ex2 for each of 3.8 M valid pixels, on the SFUs
// ~0.3 ms at 1.755 GHz whatever f: the decode loss sits between bytes and
// SFU, the aux loss on the SFU. It measured 1.07 / 0.72 ms a launch (36% /
// 17% of the bound): by instruction count near half the issue rate, the
// rest latency (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kCols = 32;      // columns of a tile: one warp per row lane
constexpr int kMaxLanes = 8;   // most row lanes (warps) of a block
constexpr int kRegClasses = 19;  // the instances with classes in registers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// bwd_tile_any: most output rows a step, most mid rows a tile, steps its
// copies run ahead, independent partial sums a lane in phase A, and the
// log2 headroom of those sums
constexpr int kAnyRows = 32;
constexpr int kAnyTileRows = 32;
constexpr int kAnyAhead = 2;
constexpr int kAnyChains = 4;
constexpr float kAnyLazy = 64.f;
constexpr int kFwdLanes = 4;   // K1: most row lanes of a block
constexpr int kFwdRows = 16;   // K1: output rows a thread takes in a tile
// K1's workspace, in 32-bit words: the ticket, a pad word (the slots start
// 8-byte aligned, read as float2), then each block's (loss, count) slot
constexpr int kWorkHeader = 2;

constexpr int kAhead = 4;      // labels read ahead of their rows

using hopper::exp2_approx;

struct Interval {
  int lo, hi;      // mid rows of the lower and upper tap (edge clamped)
  int y0, y1;      // output rows [y0, y1) whose floor(fy) is j
};

__device__ __forceinline__ Interval interval(int j, int h, int f) {
  Interval iv;
  iv.lo = max(j, 0);
  iv.hi = min(j + 1, h - 1);
  iv.y0 = j < 0 ? 0 : j * f + f / 2;
  iv.y1 = j == h - 1 ? h * f : (j + 1) * f + f / 2;
  return iv;
}

// weight of the upper tap for output row Y of interval j
__device__ __forceinline__ float upper_weight(int Y, int j, int f) {
  return (Y + 0.5f) / f - 0.5f - j;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// cp.async into shared memory: 16 bytes (both addresses 16-byte aligned,
// past L1) or 4 bytes; a thread's copies since the last commit form a group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// this thread's copies but those of its last N groups have landed (others'
// need a __syncthreads after)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One mid row's C taps of a column into registers (coalesced across the
// warp, shared through L1 by the block's row lanes).
template <int C>
__device__ __forceinline__ void load_taps(const float* __restrict__ mid, int n,
                                          int h, int W, int row, int X,
                                          float (&v)[C]) {
  const float* p = mid + ((size_t)(n * h + row) * C) * W + X;
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __ldg(p + (size_t)c * W);
}

// class c of a pixel: the blend of its two taps, columns a and b of mid
__device__ __forceinline__ float blend(const float* __restrict__ a,
                                       const float* __restrict__ b, int c,
                                       int W, float w) {
  return __ldg(a + (size_t)c * W) * (1.f - w) + __ldg(b + (size_t)c * W) * w;
}

// ---------------------------------------------------------------------------
// K1

// log2(x) on the SFU (lg2.approx, flushes denormals)
__device__ __forceinline__ float log2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The picked logit of a pixel (0 for a label outside [0, C), as the TPU
// kernel's one-hot gives): the blend of its two taps, columns lo and hi.
__device__ __forceinline__ float pick_logit(const float* __restrict__ lo,
                                            const float* __restrict__ hi,
                                            int lab, int C, int W, float w) {
  const bool in = (unsigned)lab < (unsigned)C;
  const float v = blend(lo, hi, in ? lab : 0, W, w);
  return in ? v : 0.f;
}

// The next interval's new taps and this thread's labels there: into L2
// while this interval computes.
__device__ __forceinline__ void prefetch_interval(
    const float* __restrict__ mid, const int* __restrict__ lab_col, int n,
    int h, int C, int W, int f, int j, int ry, int lanes) {
  const Interval nx = interval(j, h, f);
  if (nx.hi != nx.lo) {
    const float* p = mid + ((size_t)(n * h + nx.hi) * C) * W;
    for (int c = ry; c < C; c += lanes) prefetch_l2(p + (size_t)c * W);
  }
  for (int Y = nx.y0 + ry; Y < nx.y1; Y += lanes)
    prefetch_l2(lab_col + (size_t)Y * W);
}

// The block's (loss, count): each warp by shuffles, then the row lanes in
// the order ry = 0, 1, ..; thread (0, 0) writes them to the block's slot.
// The last block to take a ticket adds every slot in block order, in
// double, writes sums and sets the ticket back to 0 for the next launch on
// this workspace. Called by every thread of the block.
__device__ __forceinline__ void finish_sums(float loss, float count,
                                            unsigned* __restrict__ work,
                                            float* __restrict__ sums) {
  __shared__ float s_part[2][kMaxLanes];
  __shared__ double s_sum[2][kCols * kMaxLanes];
  __shared__ bool s_last;
  for (int o = 16; o > 0; o >>= 1) {
    loss += __shfl_down_sync(0xffffffffu, loss, o);
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  const int lanes = blockDim.y;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  if (threadIdx.x == 0) {
    s_part[0][threadIdx.y] = loss;
    s_part[1][threadIdx.y] = count;
  }
  __syncthreads();
  const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
  float* slot = reinterpret_cast<float*>(work + kWorkHeader);
  if (tid == 0) {
    float l = 0.f, c = 0.f;
    for (int r = 0; r < lanes; ++r) {
      l += s_part[0][r];
      c += s_part[1][r];
    }
    const unsigned b =
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    slot[2 * b] = l;
    slot[2 * b + 1] = c;
    __threadfence();                     // the slot is seen before the ticket
    s_last = atomicAdd(work, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int threads = kCols * lanes;     // a power of two
  // each thread's slots come from L2 (written by other SMs), eight loads in
  // flight, and are added in block order
  double l = 0.0, c = 0.0;
  const float2* slot2 = reinterpret_cast<const float2*>(slot);
  for (unsigned b0 = tid; b0 < blocks; b0 += 8 * threads) {
    float2 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned b = b0 + k * threads;
      v[k] = b < blocks ? __ldcg(slot2 + b) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      l += v[k].x;
      c += v[k].y;
    }
  }
  s_sum[0][tid] = l;
  s_sum[1][tid] = c;
  __syncthreads();
  for (int o = threads / 2; o > 0; o >>= 1) {
    if (tid < o) {
      s_sum[0][tid] += s_sum[0][tid + o];
      s_sum[1][tid] += s_sum[1][tid + o];
    }
    __syncthreads();
  }
  if (tid == 0) {
    sums[0] = (float)s_sum[0][0];
    sums[1] = (float)s_sum[1][0];
    work[0] = 0u;
  }
}

// grid (ceil(W / 32), ceil(h / R), N), block (32, RY): tile (x, rows r0 ..
// r0+R), the intervals j in [r0, r0+R) and, in the first tile, j = -1
template <int C>
__global__ void __launch_bounds__(kCols * kMaxLanes, 2)
fwd_tile(const float* __restrict__ mid, const int* __restrict__ label,
         unsigned* __restrict__ work, float* __restrict__ sums, int h, int W,
         int f, int R, int ignore_index) {
  const int X = blockIdx.x * kCols + threadIdx.x;
  const int ry = threadIdx.y, lanes = blockDim.y;
  const int r0 = blockIdx.y * R, r1 = min(r0 + R, h), n = blockIdx.z;
  const bool live = X < W;
  const int Xc = min(X, W - 1);          // idle lanes load in bounds
  const int* lab_col = label + (size_t)n * h * f * W + Xc;
  const float inv_f = 1.f / f;
  // interval j's taps in log2 units: a the lower row, d upper - lower
  float a[C], d[C];
  load_taps<C>(mid, n, h, W, r0, Xc, a);
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] *= kLog2e;
  float loss = 0.f, count = 0.f;
  for (int j = r0 == 0 ? -1 : r0; j < r1; ++j) {
    const Interval iv = interval(j, h, f);
    if (iv.hi != iv.lo) {
      load_taps<C>(mid, n, h, W, iv.hi, Xc, d);
#pragma unroll
      for (int c = 0; c < C; ++c) d[c] = fmaf(d[c], kLog2e, -a[c]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) d[c] = 0.f;
    }
    if (j + 1 < r1)
      prefetch_interval(mid + Xc, lab_col, n, h, C, W, f, j + 1, ry, lanes);
    const float* lo = mid + ((size_t)(n * h + iv.lo) * C) * W + Xc;
    const float* hi = mid + ((size_t)(n * h + iv.hi) * C) * W + Xc;
    for (int Y0 = iv.y0 + ry; live && Y0 < iv.y1; Y0 += kAhead * lanes) {
      int lab[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int Y = Y0 + i * lanes;
        lab[i] = Y < iv.y1 ? __ldcs(lab_col + (size_t)Y * W) : ignore_index;
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (lab[i] == ignore_index) continue;
        const float w =
            fmaf((float)(Y0 + i * lanes) + 0.5f, inv_f, -0.5f - (float)j);
        float u[C];
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          u[c] = fmaf(w, d[c], a[c]);
          if (c & 1)
            m1 = fmaxf(m1, u[c]);
          else
            m0 = fmaxf(m0, u[c]);
        }
        const float m = fmaxf(m0, m1);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float e = exp2_approx(u[c] - m);
          if (c & 1)
            s1 += e;
          else
            s0 += e;
        }
        loss += fmaf(m + log2_approx(s0 + s1), kLn2,
                     -pick_logit(lo, hi, lab[i], C, W, w));
        count += 1.f;
      }
    }
    // the upper taps are the next interval's lower ones
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] += d[c];
  }
  finish_sums(loss, count, work, sums);
}

// one class into an online logsumexp in log2 units (m the running max, s
// the sum scaled to it): one ex2, no branch
__device__ __forceinline__ void online_lse(float& m, float& s, float u) {
  const float gap = u - m;
  const float e = exp2_approx(-fabsf(gap));
  s = gap > 0.f ? fmaf(s, e, 1.f) : s + e;
  m = fmaxf(m, u);
}

// The same tiling for any C <= 256: the classes of a pixel are read from
// the L1-cached taps in one pass, into two online logsumexps (even and odd
// classes) merged at the end.
__global__ void __launch_bounds__(kCols * kMaxLanes)
fwd_tile_any(const float* __restrict__ mid, const int* __restrict__ label,
             unsigned* __restrict__ work, float* __restrict__ sums, int h,
             int C, int W, int f, int R, int ignore_index) {
  const int X = blockIdx.x * kCols + threadIdx.x;
  const int ry = threadIdx.y, lanes = blockDim.y;
  const int r0 = blockIdx.y * R, r1 = min(r0 + R, h), n = blockIdx.z;
  const bool live = X < W;
  const int Xc = min(X, W - 1);
  const int* lab_col = label + (size_t)n * h * f * W + Xc;
  const float inv_f = 1.f / f;
  float loss = 0.f, count = 0.f;
  for (int j = r0 == 0 ? -1 : r0; j < r1; ++j) {
    const Interval iv = interval(j, h, f);
    if (j + 1 < r1)
      prefetch_interval(mid + Xc, lab_col, n, h, C, W, f, j + 1, ry, lanes);
    const float* lo = mid + ((size_t)(n * h + iv.lo) * C) * W + Xc;
    const float* hi = mid + ((size_t)(n * h + iv.hi) * C) * W + Xc;
    for (int Y0 = iv.y0 + ry; live && Y0 < iv.y1; Y0 += kAhead * lanes) {
      int lab[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int Y = Y0 + i * lanes;
        lab[i] = Y < iv.y1 ? __ldcs(lab_col + (size_t)Y * W) : ignore_index;
      }
      for (int i = 0; i < kAhead; ++i) {
        if (lab[i] == ignore_index) continue;
        const float w =
            fmaf((float)(Y0 + i * lanes) + 0.5f, inv_f, -0.5f - (float)j);
        float m0 = -INFINITY, s0 = 0.f, m1 = -INFINITY, s1 = 0.f;
        int c = 0;
        for (; c + 1 < C; c += 2) {
          online_lse(m0, s0, blend(lo, hi, c, W, w) * kLog2e);
          online_lse(m1, s1, blend(lo, hi, c + 1, W, w) * kLog2e);
        }
        if (c < C) online_lse(m0, s0, blend(lo, hi, c, W, w) * kLog2e);
        const float m = fmaxf(m0, m1);
        const float s =
            s0 * exp2_approx(m0 - m) + s1 * exp2_approx(m1 - m);
        loss += fmaf(m + log2_approx(s), kLn2,
                     -pick_logit(lo, hi, lab[i], C, W, w));
        count += 1.f;
      }
    }
  }
  finish_sums(loss, count, work, sums);
}

// ---------------------------------------------------------------------------
// K2

// The block adds the row lanes' accumulators, red[c][ry][x], in the order
// ry = 0, 1, .. and writes mid row `out` (gmid + the row's offset), columns
// below W only. Called by every thread of the block.
__device__ __forceinline__ void reduce_lanes(const float* red, int C,
                                             int lanes, float* out, int W,
                                             int x0) {
  __syncthreads();
  const int tid = threadIdx.y * kCols + threadIdx.x;
  for (int i = tid; i < C * kCols; i += lanes * kCols) {
    const int c = i / kCols, x = i % kCols;
    if (x0 + x >= W) continue;
    float sum = 0.f;
    for (int r = 0; r < lanes; ++r) sum += red[(c * lanes + r) * kCols + x];
    out[(size_t)c * W + x0 + x] = sum;
  }
  __syncthreads();
}

// grid (ceil(W / 32), h / R, N), block (32, RY): tile (x, rows r0 .. r0+R)
template <int C>
__global__ void __launch_bounds__(kCols * kMaxLanes, 2)
bwd_tile(const float* __restrict__ mid, const int* __restrict__ label,
         const float* __restrict__ scale_ptr, float* __restrict__ gmid,
         int h, int W, int f, int R, int ignore_index) {
  __shared__ float red[C * kMaxLanes * kCols];
  const int x0 = blockIdx.x * kCols, X = x0 + threadIdx.x;
  const int ry = threadIdx.y, lanes = blockDim.y;
  const int r0 = blockIdx.y * R, r1 = r0 + R, n = blockIdx.z;
  const int H = h * f;
  const bool live = X < W;
  const int Xc = min(X, W - 1);          // idle lanes load in bounds
  const float scale = *scale_ptr;        // g / max(sum valid, 1)
  const int* lab_col = label + (size_t)n * H * W + Xc;
  // cur: mid row j (interval j's lower tap), nxt: mid row j + 1 (its upper)
  float a[C], b[C], cur[C], nxt[C];
#pragma unroll
  for (int c = 0; c < C; ++c) cur[c] = nxt[c] = 0.f;
  load_taps<C>(mid, n, h, W, max(r0 - 1, 0), Xc, b);
  for (int j = r0 - 1; j < r1; ++j) {
    const Interval iv = interval(j, h, f);
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = b[c];
    if (iv.hi != iv.lo) load_taps<C>(mid, n, h, W, iv.hi, Xc, b);
    if (j + 1 < r1) {
      // the next interval's new taps and this thread's labels there: into L2
      // while this interval computes
      const Interval nx = interval(j + 1, h, f);
      if (nx.hi != nx.lo) {
        const float* p = mid + ((size_t)(n * h + nx.hi) * C) * W + Xc;
        for (int c = ry; c < C; c += lanes) prefetch_l2(p + (size_t)c * W);
      }
      for (int Y = nx.y0 + ry; Y < nx.y1; Y += lanes)
        prefetch_l2(lab_col + (size_t)Y * W);
    }
    for (int Y0 = iv.y0 + ry; live && Y0 < iv.y1; Y0 += kAhead * lanes) {
      int lab[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int Y = Y0 + i * lanes;
        lab[i] = Y < iv.y1 ? lab_col[(size_t)Y * W] : ignore_index;
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (lab[i] == ignore_index) continue;
        const float w = upper_weight(Y0 + i * lanes, j, f);
        float p[C];
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          p[c] = a[c] * (1.f - w) + b[c] * w;
          if (c & 1)
            m1 = fmaxf(m1, p[c]);
          else
            m0 = fmaxf(m0, p[c]);
        }
        const float ml = fmaxf(m0, m1) * kLog2e;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          p[c] = exp2_approx(fmaf(p[c], kLog2e, -ml));
          s += p[c];
        }
        // d = (p / s - onehot) scale = (p - s onehot) (scale / s)
        const float inv = __fdividef(scale, s);
        const float wh = w * inv, wl = inv - wh;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float e = c == lab[i] ? p[c] - s : p[c];
          cur[c] = fmaf(wl, e, cur[c]);
          nxt[c] = fmaf(wh, e, nxt[c]);
        }
      }
    }
    if (j == h - 1) {                    // both taps on row h - 1
#pragma unroll
      for (int c = 0; c < C; ++c) cur[c] += nxt[c];
    }
    if (j >= r0) {                       // mid row j is complete: write it
#pragma unroll
      for (int c = 0; c < C; ++c)
        red[(c * lanes + ry) * kCols + threadIdx.x] = cur[c];
      reduce_lanes(red, C, lanes, gmid + ((size_t)(n * h + j) * C) * W, W, x0);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // j = -1 has both taps on row 0: its lower-tap sums stay with row 0
      cur[c] = j < 0 ? cur[c] + nxt[c] : nxt[c];
      nxt[c] = 0.f;
    }
  }
}

// K2 for any C <= 256 (bwd_tile_any). A block of NW warps owns a tile of R
// mid rows by 32 columns and walks the R + 1 intervals that touch it, in
// steps of at most kAnyRows output rows. Shared memory holds a ring of
// kAnyAhead + 2 mid rows ([NW K][32] floats each, the classes from C on
// unused) and one of kAnyAhead + 1 steps' labels, filled by cp.async
// kAnyAhead steps before they are used, and the step's softmax statistics.
// A step:
//   wait for its copies, sync; copy the labels kAnyAhead steps on (and, at
//   an interval's first step, its new mid row); phase A; sync; phase B.
// Phase A, per output pixel of the step, one pass over the staged taps: the
// logsumexp of the classes, split over S lanes of a warp (classes c = k mod
// S on lane slice k) and merged by shuffles; slice 0 keeps it (log2 units)
// in shared memory. Class c's columns are stored at x ^ (c mod S) * (32 /
// S), so the S slices of a warp read distinct banks. Phase B: warp g owns
// classes g, g + NW, .. (K of them) of the tile's 32 columns, with their two
// taps in registers (log2 units: a the lower row, d upper - lower), and
// walks the step's rows: p = 2^(a + w d - lse) - onehot, added times (1 - w)
// scale and w scale into two register accumulators, the lower and the upper
// mid row's. After interval j, mid row j is complete in the lower ones:
// written coalesced from registers; the upper ones carry to interval j + 1.
template <int NW, int K, int MinBlocks>
__global__ void __launch_bounds__(kCols * NW, MinBlocks)
bwd_tile_any(const float* __restrict__ mid, const int* __restrict__ label,
             const float* __restrict__ scale_ptr, float* __restrict__ gmid,
             int h, int C, int W, int f, int R, int slice_log2, bool vec,
             int ignore_index) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int tid = g * kCols + lane, threads = kCols * NW;
  const int x0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * R, r1 = r0 + R, n = blockIdx.z;
  const int H = h * f, tile = NW * K * kCols;
  const int S = 1 << slice_log2, cw = kCols >> slice_log2;
  constexpr int ring = kAnyAhead + 2, lab_ring = kAnyAhead + 1;
  const int rows_max = min(f, kAnyRows);
  float* rows = smem;                                      // [ring][NW K][32]
  int* labs = reinterpret_cast<int*>(rows + ring * tile);  // [lab_ring][..]
  float* lse = reinterpret_cast<float*>(labs + lab_ring * rows_max * kCols);
  const float scale = *scale_ptr, inv_f = 1.f / f;
  const bool live = x0 + lane < W;

  // copies of mid row `row` and of step (jj, qq)'s label rows
  auto stage_row = [&](int row) {
    float* dst = rows + (row % ring) * tile;
    const float* src = mid + ((size_t)(n * h + row) * C) * W + x0;
    const int per = vec ? kCols / 4 : kCols, w = vec ? 4 : 1;
    for (int i = tid; i < C * per; i += threads) {
      const int c = i / per, x = (i % per) * w;
      if (x0 + x >= W) continue;
      float* d = dst + c * kCols + (x ^ ((c & (S - 1)) * cw));
      if (vec)
        cp_async16(d, src + (size_t)c * W + x);
      else
        cp_async4(d, src + (size_t)c * W + x);
    }
  };
  auto issue = [&](int jj, int qq, int slot) {
    if (qq == 0 && jj >= 0 && jj + 1 < h) stage_row(jj + 1);
    const Interval v = interval(jj, h, f);
    const int ya = v.y0 + qq * rows_max, yb = min(ya + rows_max, v.y1);
    int* dst = labs + slot * rows_max * kCols;
    const int* src = label + ((size_t)n * H + ya) * W + x0;
    const int per = vec ? kCols / 4 : kCols, w = vec ? 4 : 1;
    for (int i = tid; i < (yb - ya) * per; i += threads) {
      const int y = i / per, x = (i % per) * w;
      if (x0 + x >= W) continue;
      if (vec)
        cp_async16(dst + y * kCols + x, src + (size_t)y * W + x);
      else
        cp_async4(dst + y * kCols + x, src + (size_t)y * W + x);
    }
  };
  // the step after (jj, qq)
  auto advance = [&](int& jj, int& qq) {
    const Interval v = interval(jj, h, f);
    if (v.y0 + (qq + 1) * rows_max >= v.y1) {
      ++jj;
      qq = 0;
    } else {
      ++qq;
    }
  };

  float a[K], d[K], cur[K], nxt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) cur[k] = nxt[k] = 0.f;

  int j = r0 - 1, q = 0;       // the step computed
  int ji = j, qi = 0;          // the step copied
  stage_row(max(j, 0));
  for (int t = 0; t < kAnyAhead; ++t) {
    if (ji < r1) {
      issue(ji, qi, t);
      advance(ji, qi);
    }
    cp_async_commit();
  }
  for (int step = 0; j < r1; ++step) {
    const Interval iv = interval(j, h, f);
    const int ya = iv.y0 + q * rows_max, yb = min(ya + rows_max, iv.y1);
    cp_async_wait<kAnyAhead - 1>();
    __syncthreads();
    if (ji < r1) {
      issue(ji, qi, (step + kAnyAhead) % lab_ring);
      advance(ji, qi);
    }
    cp_async_commit();
    const float* lo = rows + (iv.lo % ring) * tile;
    const float* hi = rows + (iv.hi % ring) * tile;
    const int* lab_s = labs + (step % lab_ring) * rows_max * kCols;

    // phase A: a step row's 32 pixels in S column blocks of cw, a warp one
    // (row, block) at a time, lane slice k taking the classes c = k mod S
    {
      const int k = lane / cw, xo = lane % cw;
      for (int u = g; u < (yb - ya) << slice_log2; u += NW) {
        const int y = u >> slice_log2, xb = u & (S - 1);
        const int x = xb * cw + xo;
        const int lab = x0 + x < W ? lab_s[y * kCols + x] : ignore_index;
        const bool valid = lab != ignore_index;
        float m = -INFINITY, s = 0.f;
        if (valid) {
          const float w =
              fmaf((float)(ya + y) + 0.5f, inv_f, -0.5f - (float)j);
          const float wh = w * kLog2e, wl = kLog2e - wh;
          const float* pa = lo + ((xb ^ k) * cw + xo);
          const float* pb = hi + ((xb ^ k) * cw + xo);
          // the sums are taken against m, one of the pixel's classes (so
          // m <= the max and the largest term >= 1), moved up only where a
          // class lies more than 2^kAnyLazy above it: no rescale a class
          auto u_of = [&](int c) {
            return fmaf(pb[c * kCols], wh, pa[c * kCols] * wl);
          };
          m = u_of(k);
          float sc[kAnyChains];
          sc[0] = 1.f;
#pragma unroll
          for (int i = 1; i < kAnyChains; ++i) sc[i] = 0.f;
          int c = k + S;
          for (; c + (kAnyChains - 1) * S < C; c += kAnyChains * S) {
            float u[kAnyChains];
            float top = -INFINITY;
#pragma unroll
            for (int i = 0; i < kAnyChains; ++i) {
              u[i] = u_of(c + i * S);
              top = fmaxf(top, u[i]);
            }
            if (top - m > kAnyLazy) {
#pragma unroll
              for (int i = 0; i < kAnyChains; ++i)
                sc[i] *= exp2_approx(m - top);
              m = top;
            }
#pragma unroll
            for (int i = 0; i < kAnyChains; ++i)
              sc[i] += exp2_approx(u[i] - m);
          }
          for (; c < C; c += S) {
            const float u = u_of(c);
            if (u - m > kAnyLazy) {
              sc[0] *= exp2_approx(m - u);
              sc[0] += 1.f;
#pragma unroll
              for (int i = 1; i < kAnyChains; ++i)
                sc[i] *= exp2_approx(m - u);
              m = u;
            } else {
              sc[0] += exp2_approx(u - m);
            }
          }
#pragma unroll
          for (int i = 0; i < kAnyChains; ++i) s += sc[i];
        }
        for (int o = cw; o < kCols; o <<= 1) {   // merge the slices
          const float mo = __shfl_xor_sync(0xffffffffu, m, o);
          const float so = __shfl_xor_sync(0xffffffffu, s, o);
          if (valid) {
            const float mm = fmaxf(m, mo);
            s = s * exp2_approx(m - mm) + so * exp2_approx(mo - mm);
            m = mm;
          }
        }
        if (valid && k == 0) lse[y * kCols + x] = m + log2_approx(s);
      }
    }
    __syncthreads();

    // phase B: warp g's classes (those from C on read unused rows of the
    // ring and are never written), the step's rows in order
    if (q == 0) {                            // the interval's taps
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = g + NW * k;
        const int i = c * kCols + (lane ^ ((c & (S - 1)) * cw));
        a[k] = lo[i] * kLog2e;
        d[k] = hi[i] * kLog2e - a[k];
      }
    }
    for (int y = 0; live && y < yb - ya; ++y) {
      const int lab = lab_s[y * kCols + lane];
      if (lab == ignore_index) continue;
      const float l = lse[y * kCols + lane];
      const float w = fmaf((float)(ya + y) + 0.5f, inv_f, -0.5f - (float)j);
      const float wh = w * scale, wl = scale - wh;
      const int own = lab - g;               // onehot at k with NW k == own
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float p = exp2_approx(fmaf(w, d[k], a[k]) - l);
        if (own == NW * k) p -= 1.f;
        cur[k] = fmaf(wl, p, cur[k]);
        nxt[k] = fmaf(wh, p, nxt[k]);
      }
    }
    if (yb == iv.y1) {                       // the interval's last step
      if (j == h - 1) {                      // both taps on row h - 1
#pragma unroll
        for (int k = 0; k < K; ++k) cur[k] += nxt[k];
      }
      if (j >= r0 && live) {                 // mid row j is complete
        float* out = gmid + ((size_t)(n * h + j) * C) * W + x0 + lane;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (g + NW * k < C) out[(size_t)(g + NW * k) * W] = cur[k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // j = -1 has both taps on row 0: its lower-row sums stay with row 0
        cur[k] = j < 0 ? cur[k] + nxt[k] : nxt[k];
        nxt[k] = 0.f;
      }
    }
    advance(j, q);
  }
}

// K2's tiling: R the largest divisor of h that is at most 8; RY the largest
// power of two that is at most min(8, f)
struct Tiling {
  int R, lanes;
};

Tiling tiling(int h, int f) {
  Tiling t = {1, 1};
  for (int r = 2; r <= 8; ++r)
    if (h % r == 0) t.R = r;
  while (2 * t.lanes <= f && 2 * t.lanes <= kMaxLanes) t.lanes *= 2;
  return t;
}

// K1's tiling: RY the largest power of two up to min(kFwdLanes, f); R the
// most mid rows that give a thread at most kFwdRows output rows (the last
// tile may be shorter)
Tiling fwd_tiling(int h, int f) {
  Tiling t = {1, 1};
  while (2 * t.lanes <= f && 2 * t.lanes <= kFwdLanes) t.lanes *= 2;
  t.R = max(1, min(h, kFwdRows * t.lanes / f));
  return t;
}

bool shapes_ok(int n, int h, int C, int W, int f) {
  return n > 0 && n <= 65535 && h >= 3 && h < 65535 && C > 0 && C <= 256 &&
         W > 0 && f >= 2 && f % 2 == 0;
}


// bwd_tile_any's launch: the tile's mid rows R from h (the largest divisor
// up to kAnyTileRows: (R + 1) / R of the exponentials), the slices S of
// phase A from f, so that a step's rows x S fill the warps (S <= 8, S <= C)
template <int NW, int K, int MinBlocks>
int launch_bwd_any_as(const float* mid, const int* label, const float* scale,
                      float* gmid, int n, int h, int C, int W, int f,
                      int ignore_index, cudaStream_t s) {
  const int rows_max = min(f, kAnyRows);
  int R = 1;
  for (int r = 2; r <= kAnyTileRows; ++r)
    if (h % r == 0) R = r;
  int slice_log2 = 0;
  while ((2 << slice_log2) * rows_max <= NW && (2 << slice_log2) <= C &&
         (2 << slice_log2) <= 8)
    ++slice_log2;
  const bool vec = W % 4 == 0 && (uintptr_t)mid % 16 == 0 &&
                   (uintptr_t)label % 16 == 0;
  // the mid-row ring, the label ring and the step's statistics
  const int smem = ((kAnyAhead + 2) * NW * K + (kAnyAhead + 2) * rows_max) *
                   kCols * (int)sizeof(float);
  auto kernel = bwd_tile_any<NW, K, MinBlocks>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kCols - 1) / kCols, h / R, n);
  kernel<<<grid, dim3(kCols, NW), smem, s>>>(mid, label, scale, gmid, h, C,
                                             W, f, R, slice_log2, vec,
                                             ignore_index);
  return (int)cudaGetLastError();
}

// the instance: NW warps and K classes a thread, the least NW K >= C among
// them (8 warps up to 152 classes, 16 above); blocks an SM by registers
int launch_bwd_any(const float* mid, const int* label, const float* scale,
                   float* gmid, int n, int h, int C, int W, int f,
                   int ignore_index, cudaStream_t s) {
#define ANY_CASE(NW, K, B)                                                   \
  if (C <= NW * K)                                                           \
    return launch_bwd_any_as<NW, K, B>(mid, label, scale, gmid, n, h, C, W, \
                                       f, ignore_index, s);
  ANY_CASE(8, 3, 4)
  ANY_CASE(8, 8, 3)
  ANY_CASE(8, 12, 2)
  ANY_CASE(8, 19, 2)
  ANY_CASE(16, 11, 1)
  ANY_CASE(16, 16, 1)
#undef ANY_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// 32-bit words of K1's workspace for any row factor: the ticket and one
// slot a block. The caller zeroes it once and keeps it for the launches of
// one stream; each launch leaves the ticket at 0 again.
int resize_ce_fwd_partials(int n, int h, int W) {
  return kWorkHeader + 2 * ((W + kCols - 1) / kCols) * h * n;
}

// K1: sums[0] = sum over valid pixels of the CE, sums[1] = number of valid
// pixels. Returns a cudaError_t (0 on success).
int resize_ce_fwd(const float* mid, const int* label, unsigned* work,
                  int n_work, float* sums, int n, int h, int C, int W, int f,
                  int ignore_index, void* stream) {
  if (!shapes_ok(n, h, C, W, f) || n_work < resize_ce_fwd_partials(n, h, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Tiling t = fwd_tiling(h, f);
  const dim3 grid((W + kCols - 1) / kCols, (h + t.R - 1) / t.R, n);
  const dim3 block(kCols, t.lanes);
  if (C == kRegClasses)
    fwd_tile<kRegClasses><<<grid, block, 0, s>>>(mid, label, work, sums, h, W,
                                                 f, t.R, ignore_index);
  else
    fwd_tile_any<<<grid, block, 0, s>>>(mid, label, work, sums, h, C, W, f,
                                        t.R, ignore_index);
  return (int)cudaGetLastError();
}

// K2: gmid [N, h, C, W] = row-interpolation adjoint of
// (softmax - onehot) * valid * scale[0]. Returns a cudaError_t.
int resize_ce_bwd(const float* mid, const int* label, const float* scale,
                  float* gmid, int n, int h, int C, int W, int f,
                  int ignore_index, void* stream) {
  if (!shapes_ok(n, h, C, W, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Tiling t = tiling(h, f);
  const dim3 grid((W + kCols - 1) / kCols, h / t.R, n);
  if (C == kRegClasses) {
    bwd_tile<kRegClasses><<<grid, dim3(kCols, t.lanes), 0, s>>>(
        mid, label, scale, gmid, h, W, f, t.R, ignore_index);
    return (int)cudaGetLastError();
  }
  return launch_bwd_any(mid, label, scale, gmid, n, h, C, W, f, ignore_index,
                        s);
}

}  // extern "C"
