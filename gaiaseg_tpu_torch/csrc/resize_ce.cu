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
// K1 layout. A thread owns one output column X of one interval, so
// neighbouring threads read neighbouring addresses of mid and label
// (coalesced); it loads the interval's two mid rows once, walks its rows with
// the C classes of a pixel in registers, and the block writes one partial
// sum, which a second, one-block launch reduces in a fixed order (in double).
//
// K2 layout. A block owns a tile of one image: R consecutive mid rows (R a
// divisor of h, at most 8) by 32 columns, and has 32 x RY threads: thread
// (x, ry) takes the output rows ry, ry + RY, .. of each of the R + 1
// intervals that touch the tile, so the rows of an interval are spread over
// RY row lanes (warps) instead of being walked by one thread. Each pixel's
// softmax is computed once (max, sum and P in one go); (1-w) d and w d are
// added into the thread's own per-class accumulators for the interval's lower
// and upper mid row. The upper row of interval j is the lower row of
// interval j + 1, so the thread carries that accumulator over (and the taps
// it has already loaded), and after interval j mid row j is complete in the
// row lanes: they put their accumulators into shared memory, the block adds
// them in the fixed order ry = 0, 1, .. and writes the row coalesced. Only
// the two intervals on a tile's row border are evaluated by two blocks:
// (R + 1) / R of the exponentials, none twice when R = h. Ignored pixels
// skip the exponentials. Two instances: C = 19 with the classes unrolled in
// registers (bwd_tile), and any C up to 256 with the accumulators in shared
// memory and the classes walked in three passes (max, sum, accumulate) from
// the cached mid rows (bwd_tile_any), so 150 classes run without spills.
//
// What bounds it on the H100. At the flagship loss (batch 8, 512x1024 labels,
// C = 19) the function reads ~10-20 MB of mid plus 16.8 MB of int32 labels
// (~8-11 us at 3.35 TB/s) and evaluates ~80 M exponentials (valid pixels x C),
// which issue on the SFUs (16/clk/SM, ~20 us at 1.98 GHz); the count against
// the 67 TFLOP/s float32 rate is ~9 us. Labels are read once per evaluation
// and mid rows once per interval; K2's ~10 instructions per class and pixel
// (blend, max, exp2, sum, the label's class, two adjoint FMAs) on the CUDA
// cores are its real floor, ~30 us at full issue rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // K1: threads per block, along the width
constexpr int kReduceThreads = 1024;

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

template <int CMAX>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int C, int W, float (&v)[CMAX]) {
#pragma unroll
  for (int c = 0; c < CMAX; ++c) v[c] = c < C ? row[(size_t)c * W] : 0.f;
}

// grid (ceil(W / kThreads), h + 1, N): block (x, j + 1, n)
template <int CMAX>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ mid, const int* __restrict__ label,
           float* __restrict__ partial, int h, int C, int W, int f,
           int ignore_index) {
  const int X = blockIdx.x * kThreads + threadIdx.x;
  const int j = (int)blockIdx.y - 1;
  const int n = blockIdx.z;
  const int H = h * f;
  float loss = 0.f, count = 0.f;
  if (X < W) {
    const Interval iv = interval(j, h, f);
    float a[CMAX], b[CMAX];
    load_row<CMAX>(mid + ((size_t)(n * h + iv.lo) * C) * W + X, C, W, a);
    load_row<CMAX>(mid + ((size_t)(n * h + iv.hi) * C) * W + X, C, W, b);
    const int* lab_col = label + (size_t)n * H * W + X;
    for (int Y = iv.y0; Y < iv.y1; ++Y) {
      const int lab = lab_col[(size_t)Y * W];
      if (lab == ignore_index) continue;
      const float w = upper_weight(Y, j, f);
      float up[CMAX];
      float m = -INFINITY, pick = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          up[c] = a[c] * (1.f - w) + b[c] * w;
          m = fmaxf(m, up[c]);
          if (c == lab) pick = up[c];
        }
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c)
        if (c < C) s += __expf(up[c] - m);
      loss += m + __logf(s) - pick;
      count += 1.f;
    }
  }
  // fixed-order block reduction: warp shuffles, then warp 0 over the warps
  for (int o = 16; o > 0; o >>= 1) {
    loss += __shfl_down_sync(0xffffffffu, loss, o);
    count += __shfl_down_sync(0xffffffffu, count, o);
  }
  __shared__ float s_loss[kThreads / 32], s_count[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_loss[warp] = loss;
    s_count[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f, c = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) {
      l += s_loss[i];
      c += s_count[i];
    }
    const size_t bid =
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[2 * bid] = l;
    partial[2 * bid + 1] = c;
  }
}

// one block: sums[0] = sum of loss partials, sums[1] = sum of counts
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ partial, int n_blocks,
              float* __restrict__ sums) {
  __shared__ double s_loss[kReduceThreads], s_count[kReduceThreads];
  double l = 0.0, c = 0.0;
  for (int i = threadIdx.x; i < n_blocks; i += kReduceThreads) {
    l += partial[2 * i];
    c += partial[2 * i + 1];
  }
  s_loss[threadIdx.x] = l;
  s_count[threadIdx.x] = c;
  __syncthreads();
  for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      s_loss[threadIdx.x] += s_loss[threadIdx.x + o];
      s_count[threadIdx.x] += s_count[threadIdx.x + o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[0] = (float)s_loss[0];
    sums[1] = (float)s_count[0];
  }
}

// ---------------------------------------------------------------------------
// K2

constexpr int kCols = 32;      // columns of a tile: one warp per row lane
constexpr int kMaxLanes = 8;   // most row lanes (warps) of a block
constexpr int kRegClasses = 19;  // the instance with classes in registers
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kAnySmemBudget = 96 * 1024;  // bwd_tile_any's accumulators

constexpr int kAhead = 4;      // labels read ahead of their rows

using hopper::exp2_approx;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
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

// class c of a pixel: the blend of its two taps, columns a and b of mid
__device__ __forceinline__ float blend(const float* __restrict__ a,
                                       const float* __restrict__ b, int c,
                                       int W, float w) {
  return __ldg(a + (size_t)c * W) * (1.f - w) + __ldg(b + (size_t)c * W) * w;
}

// The same tiling for any C <= 256: a thread's two accumulators live in
// shared memory, acc[which][c][ry][x] (the layout reduce_lanes reads), and a
// pixel's classes are walked three times from the cached mid rows.
__global__ void __launch_bounds__(kCols * kMaxLanes)
bwd_tile_any(const float* __restrict__ mid, const int* __restrict__ label,
             const float* __restrict__ scale_ptr, float* __restrict__ gmid,
             int h, int C, int W, int f, int R, int ignore_index) {
  extern __shared__ float acc[];
  const int x0 = blockIdx.x * kCols, X = x0 + threadIdx.x;
  const int ry = threadIdx.y, lanes = blockDim.y;
  const int r0 = blockIdx.y * R, r1 = r0 + R, n = blockIdx.z;
  const int H = h * f;
  const bool live = X < W;
  const int Xc = min(X, W - 1);
  const float scale = *scale_ptr;
  const int* lab_col = label + (size_t)n * H * W + Xc;
  const int stride = lanes * kCols;      // between classes
  float* cur = acc + ry * kCols + threadIdx.x;
  float* nxt = cur + C * stride;
  for (int c = 0; c < C; ++c) cur[c * stride] = nxt[c * stride] = 0.f;
  for (int j = r0 - 1; j < r1; ++j) {
    const Interval iv = interval(j, h, f);
    const float* a = mid + ((size_t)(n * h + iv.lo) * C) * W + Xc;
    const float* b = mid + ((size_t)(n * h + iv.hi) * C) * W + Xc;
    for (int Y = iv.y0 + ry; live && Y < iv.y1; Y += lanes) {
      const int lab = lab_col[(size_t)Y * W];
      if (lab == ignore_index) continue;
      const float w = upper_weight(Y, j, f);
      float m = -INFINITY;
      for (int c = 0; c < C; ++c)
        m = fmaxf(m, blend(a, b, c, W, w));
      const float ml = m * kLog2e;
      float s = 0.f;
      for (int c = 0; c < C; ++c)
        s += exp2_approx(fmaf(blend(a, b, c, W, w), kLog2e, -ml));
      const float inv = scale / s;
      const float wh = w * inv, wl = inv - wh;
      for (int c = 0; c < C; ++c) {
        float e = exp2_approx(fmaf(blend(a, b, c, W, w), kLog2e, -ml));
        if (c == lab) e -= s;
        cur[c * stride] = fmaf(wl, e, cur[c * stride]);
        nxt[c * stride] = fmaf(wh, e, nxt[c * stride]);
      }
    }
    if (j == h - 1)
      for (int c = 0; c < C; ++c) cur[c * stride] += nxt[c * stride];
    if (j >= r0)
      reduce_lanes(cur - (ry * kCols + threadIdx.x), C, lanes,
                   gmid + ((size_t)(n * h + j) * C) * W, W, x0);
    // the upper row becomes the lower one; j = -1 keeps its sums with row 0
    for (int c = 0; c < C; ++c) {
      if (j < 0) nxt[c * stride] += cur[c * stride];
      cur[c * stride] = 0.f;
    }
    float* swap = cur;
    cur = nxt;
    nxt = swap;
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

bool shapes_ok(int n, int h, int C, int W, int f) {
  return n > 0 && n <= 65535 && h >= 3 && h < 65535 && C > 0 && C <= 256 &&
         W > 0 && f >= 2 && f % 2 == 0;
}

dim3 fwd_grid(int n, int h, int W) {
  return dim3((W + kThreads - 1) / kThreads, h + 1, n);
}

}  // namespace

extern "C" {

// number of floats the caller allocates for K1's partial sums
int resize_ce_fwd_partials(int n, int h, int W) {
  const dim3 g = fwd_grid(n, h, W);
  return 2 * (int)(g.x * g.y * g.z);
}

// K1: sums[0] = sum over valid pixels of the CE, sums[1] = number of valid
// pixels. Returns a cudaError_t (0 on success).
int resize_ce_fwd(const float* mid, const int* label, float* partial,
                  int n_partial, float* sums, int n, int h, int C, int W,
                  int f, int ignore_index, void* stream) {
  if (!shapes_ok(n, h, C, W, f) ||
      n_partial < resize_ce_fwd_partials(n, h, W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = fwd_grid(n, h, W);
  if (C <= 32)
    fwd_kernel<32><<<grid, kThreads, 0, s>>>(mid, label, partial, h, C, W, f,
                                             ignore_index);
  else
    fwd_kernel<256><<<grid, kThreads, 0, s>>>(mid, label, partial, h, C, W,
                                              f, ignore_index);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      partial, (int)(grid.x * grid.y * grid.z), sums);
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
  // two accumulators a thread and class: fewer row lanes where C is large
  while (t.lanes > 1 && 2 * C * t.lanes * kCols * 4 > kAnySmemBudget)
    t.lanes /= 2;
  const int smem = 2 * C * t.lanes * kCols * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_tile_any, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bwd_tile_any<<<grid, dim3(kCols, t.lanes), smem, s>>>(
      mid, label, scale, gmid, h, C, W, f, t.R, ignore_index);
  return (int)cudaGetLastError();
}

}  // extern "C"
