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
// Layout. A thread owns one output column X, so neighbouring threads read
// neighbouring addresses of mid and label (coalesced), and loops over the C
// classes of its pixel in registers. Output rows with the same pair of mid
// rows form an "interval" j in [-1, h-1] (j = floor(fy)); a thread loads the
// interval's two mid rows once and walks its f (f/2 at the edges) rows.
//
// No float atomics, bit-reproducible. The TPU kernel adds into one scalar
// across grid steps (resize_ce.py:123-125) and into overlapping gmid rows
// (:164), which is safe only because TPU grid steps run in order. Here K1
// writes one partial sum per block and a second, one-block launch reduces
// the partials in a fixed order (in double). In K2 each thread OWNS one mid
// row y of its column and gathers from the two intervals that read row y
// (j = y-1 as the upper tap, j = y as the lower tap), recomputing their
// softmax: each output row is evaluated by two threads, about 2x the
// exponentials of a scatter, no atomics.
//
// What bounds it on the H100. At the flagship loss (batch 8, 512x1024 labels,
// C = 19) the function reads ~10-20 MB of mid plus 16.8 MB of int32 labels
// (~8-11 us at 3.35 TB/s) and evaluates ~80 M exponentials (valid pixels x C),
// which issue on the SFUs (16/clk/SM, ~20 us at 1.98 GHz); the count against
// the 67 TFLOP/s float32 rate is ~9 us. The design keeps both near one pass:
// mid rows are read once per interval and held in registers, labels once
// (twice in K2), and ignored pixels skip the exponentials.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block, along the output width
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

// grid (ceil(W / kThreads), h, N): block (x, y, n) owns gmid[n, y, :, x-range]
template <int CMAX>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ mid, const int* __restrict__ label,
           const float* __restrict__ scale_ptr, float* __restrict__ gmid,
           int h, int C, int W, int f, int ignore_index) {
  const int X = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (X >= W) return;
  const int H = h * f;
  const float scale = *scale_ptr;  // g / max(sum valid, 1)
  const int* lab_col = label + (size_t)n * H * W + X;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  // the two intervals that read mid row y: j = y-1 (upper tap), j = y (lower
  // tap); at the edges one interval has both taps on row y
  for (int j = y - 1; j <= y; ++j) {
    const Interval iv = interval(j, h, f);
    float a[CMAX], b[CMAX];
    load_row<CMAX>(mid + ((size_t)(n * h + iv.lo) * C) * W + X, C, W, a);
    load_row<CMAX>(mid + ((size_t)(n * h + iv.hi) * C) * W + X, C, W, b);
    for (int Y = iv.y0; Y < iv.y1; ++Y) {
      const int lab = lab_col[(size_t)Y * W];
      if (lab == ignore_index) continue;
      const float w = upper_weight(Y, j, f);
      const float wt = (iv.lo == y ? 1.f - w : 0.f) + (iv.hi == y ? w : 0.f);
      float up[CMAX];
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          up[c] = a[c] * (1.f - w) + b[c] * w;
          m = fmaxf(m, up[c]);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) {
          up[c] = __expf(up[c] - m);
          s += up[c];
        }
      }
      const float p_scale = wt * scale / s;
      const float pick_scale = wt * scale;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < C) acc[c] += up[c] * p_scale - (c == lab ? pick_scale : 0.f);
      }
    }
  }
  float* out = gmid + ((size_t)(n * h + y) * C) * W + X;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) out[(size_t)c * W] = acc[c];
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
  const dim3 grid((W + kThreads - 1) / kThreads, h, n);
  if (C <= 32)
    bwd_kernel<32><<<grid, kThreads, 0, s>>>(mid, label, scale, gmid, h, C, W,
                                             f, ignore_index);
  else
    bwd_kernel<256><<<grid, kThreads, 0, s>>>(mid, label, scale, gmid, h, C,
                                              W, f, ignore_index);
  return (int)cudaGetLastError();
}

}  // extern "C"
