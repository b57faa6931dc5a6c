// Class counts of RandomCrop's candidate windows, for cat_max_ratio.
//
// Replaces no TPU kernel. The JAX package counts the windows with XLA
// matmuls (gaiaseg_tpu/data/transforms.py `_trial_histograms`: one-hot rows
// weighted by the windows' row and column multiplicities); the port had
// gathered every window's labels and counted them with torch.histc, whose
// B x K x (C + 1) bins at 150 classes leave shared memory, so each crop
// pixel became one global atomic on an address the warp's neighbours share.
//
// The count is separable. Nearest resampling maps each valid crop row to a
// source row and each valid crop column to a source column, so the pixels of
// class c in window (b, k) are
//     sum over source (h, w) with label[h, w] == c of my[h] * mx[w],
// my[h] (mx[w]) being the number of valid crop rows (columns) whose nearest
// source row (column) is h (w). A block builds my and mx in shared memory
// from the window's `near` and `valid`, lists the rows and columns where
// they are not 0, and reads each footprint pixel once: a quarter of the crop
// at scale 2, no more than the valid crop below scale 1. Nothing crop-sized
// is written. Lanes holding one class add their weights with one reduction
// (__match_any_sync, __reduce_add_sync) and one shared atomic; the block's
// bins go out to the window's int64 counts with one global atomic each.
// Integer sums are exact and order-free: the counts are the same bits in
// every run, equal to the plain version's.
//
// Bound on the card: bytes. At the ADE20K cells (16 records of 512x683
// uint8 labels, 10 windows of 512x512, 150 classes) the labels, the windows'
// indices and masks and the counts are ~7.3 MB, ~2 us at 3.35 TB/s; the
// footprint's labels are read once per window, the windows of a record
// overlapping in L2.
//
// Grid: one block a (window, slice of the footprint's rows). The slices
// split each window's listed rows evenly; their number comes from the
// windows and the SMs, so that about four blocks an SM are in flight.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kRowsPerSlice = 16;   // fewest footprint rows worth a slice
constexpr int kMaxSmem = 232448;    // a block's shared memory on Hopper

// 32-bit words of shared memory a block takes: bins, my, mx, the row and
// column lists and the compaction's per-warp counts.
long long smem_words(int H, int W, int C) {
  return (long long)C + 2LL * H + 2LL * W + kWarps;
}

// Writes the indices i < n with m[i] > 0 to list[] in ascending order and
// returns how many there are. Called by every thread of the block.
__device__ int compact(const int* m, int n, int* list, int* warp_counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int start = 0; start < n; start += kThreads) {
    const int i = start + threadIdx.x;
    const bool keep = i < n && m[i] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int offset = base, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (keep) list[offset + __popc(ballot & ((1u << lane) - 1u))] = i;
    base += total;
    __syncthreads();  // the next chunk rewrites warp_counts
  }
  return base;
}

// counts[b, k, c] += pixels of class c in window (b, k) over the block's
// slice of footprint rows. label [n_rec, H, W]; rows [B]; near, valid
// [B, K, ch + cw] (crop rows first, then columns). Labels outside [0, C)
// and equal to pad are not counted.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_counts(const T* __restrict__ label, const long long* __restrict__ rows,
              const long long* __restrict__ near,
              const unsigned char* __restrict__ valid,
              unsigned long long* __restrict__ counts, int n_rec, int H,
              int W, int K, int ch, int cw, int C, long long pad) {
  extern __shared__ int smem[];
  int* bins = smem;
  int* my = bins + C;
  int* mx = my + H;
  int* row_list = mx + W;
  int* col_list = row_list + H;
  int* warp_counts = col_list + W;
  const int win = blockIdx.x;
  const long long* nr = near + (long long)win * (ch + cw);
  const unsigned char* vr = valid + (long long)win * (ch + cw);

  for (int i = threadIdx.x; i < C + H + W; i += kThreads) smem[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < ch + cw; i += kThreads) {
    if (!vr[i]) continue;
    const long long s = nr[i];
    if (i < ch) {
      if (s >= 0 && s < H) atomicAdd(&my[s], 1);
    } else if (s >= 0 && s < W) {
      atomicAdd(&mx[s], 1);
    }
  }
  __syncthreads();
  const int n_rows = compact(my, H, row_list, warp_counts);
  const int n_cols = compact(mx, W, col_list, warp_counts);
  const long long rec = rows[win / K];
  if (rec < 0 || rec >= n_rec) return;  // the whole block: rec is uniform

  const int r0 = (int)((long long)n_rows * blockIdx.y / gridDim.y);
  const int r1 = (int)((long long)n_rows * (blockIdx.y + 1) / gridDim.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* img = label + rec * H * W;
  for (int r = r0 + warp; r < r1; r += kWarps) {   // uniform in the warp
    const int h = row_list[r];
    const int wy = my[h];
    const T* line = img + (long long)h * W;
    for (int j0 = 0; j0 < n_cols; j0 += 32) {
      const int j = j0 + lane;
      unsigned key = 0xffffffffu;
      int weight = 0;
      if (j < n_cols) {
        const int w = col_list[j];
        const long long v = (long long)__ldg(line + w);
        if (v >= 0 && v < C && v != pad) {
          key = (unsigned)v;
          weight = wy * mx[w];
        }
      }
      const unsigned group = __match_any_sync(0xffffffffu, key);
      const int total = __reduce_add_sync(group, weight);
      if (key != 0xffffffffu && lane == __ffs(group) - 1)
        atomicAdd(&bins[key], total);
    }
  }
  __syncthreads();
  unsigned long long* out = counts + (long long)win * C;
  for (int c = threadIdx.x; c < C; c += kThreads)
    if (bins[c]) atomicAdd(out + c, (unsigned long long)bins[c]);
}

template <typename T>
int launch(const void* label, const long long* rows, const long long* near,
           const unsigned char* valid, unsigned long long* counts, int n_rec,
           int H, int W, int B, int K, int ch, int cw, int C, long long pad,
           int sms, cudaStream_t stream) {
  const int windows = B * K;
  const int most = (ch < H ? ch : H) / kRowsPerSlice;
  int slices = (kBlocksPerSm * sms + windows - 1) / windows;
  slices = slices < most ? slices : most;
  slices = slices > 1 ? slices : 1;
  const int bytes = (int)(4 * smem_words(H, W, C));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_counts<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  window_counts<T><<<dim3(windows, slices), kThreads, bytes, stream>>>(
      (const T*)label, rows, near, valid, counts, n_rec, H, W, K, ch, cw, C,
      pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory a block needs at these shapes (the wrapper refuses
// shapes above crop_counts_max_smem()).
int crop_counts_smem(int H, int W, int C) {
  return (int)(4 * smem_words(H, W, C));
}

int crop_counts_max_smem() { return kMaxSmem; }

// counts [B, K, C] int64, zeroed by the caller, += the class counts of the
// windows. label_bytes: 1 (uint8), 4 (int32) or 8 (int64). Returns a
// cudaError_t (0 on success).
int crop_counts(const void* label, int label_bytes, const long long* rows,
                const long long* near, const unsigned char* valid,
                long long* counts, int n_rec, int H, int W, int B, int K,
                int ch, int cw, int C, long long pad, int sms, void* stream) {
  if (n_rec < 1 || H < 1 || W < 1 || B < 1 || K < 1 || ch < 1 || cw < 1 ||
      C < 1 || sms < 1 || 4 * smem_words(H, W, C) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* out = (unsigned long long*)counts;
  switch (label_bytes) {
    case 1:
      return launch<unsigned char>(label, rows, near, valid, out, n_rec, H, W,
                                   B, K, ch, cw, C, pad, sms, s);
    case 4:
      return launch<int>(label, rows, near, valid, out, n_rec, H, W, B, K, ch,
                         cw, C, pad, sms, s);
    case 8:
      return launch<long long>(label, rows, near, valid, out, n_rec, H, W, B,
                               K, ch, cw, C, pad, sms, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
