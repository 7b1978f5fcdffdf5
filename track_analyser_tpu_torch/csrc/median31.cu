// Sliding median of 31 with numpy-style reflect boundaries, for Hopper
// (sm_90a). Serves both HPSS medians through one axis switch:
//   axis_time = 1: the window runs along the last (time) axis -- the
//     harmonic reference; replaces track_analyser_tpu/ops/pallas_median.py
//     _median31_kernel (median31_last_axis).
//   axis_time = 0: the window runs along the row (frequency) axis -- the
//     percussive reference; replaces _median31_rows_kernel
//     (median31_first_axis).
//
// What bounds it: not memory. One read and one write of the (1025 x 16385)
// f32 spectrogram is 134 MB, ~40 us at 3.35 TB/s; the kernel takes
// ~0.4-0.5 ms on an H100 (700 W). Each output costs 351 FMNMX (the
// bitonic network pruned to output 15 -- the same count as the TPU
// kernel's _median_ops; counted in the SASS), so the ~5.9 G min/max per
// spectrogram keep the min/max pipes busy for most of that time. What the
// design does about each cost:
//   - memory: threadIdx.x always runs along the contiguous time axis. For
//     the time median a warp's 31 window loads are neighbours (L1 serves
//     the overlap); for the frequency median each of the 31 loads is one
//     coalesced row read across the warp, and the block's threadIdx.y rows
//     share them through L1. No transpose, no padded copy.
//   - index arithmetic: reflect indices are computed only within 15 of an
//     edge; interior windows are plain strided loads (the reflect math on
//     every load tripled the instruction count and cost ~35% of the time).
//   - compute: the 31 values plus one +inf pad live in registers; a fully
//     unrolled bitonic network of 32 sorts them with compile-time
//     indices, and only element 15 is stored, so the compiler drops every
//     comparator that cannot reach it. Going faster needs fewer
//     comparisons per output (sharing sorted sub-windows between
//     neighbouring outputs), which is later work.
// The network only selects values, so the result is bit-identical to any
// exact median of the same 31 floats (the plain PyTorch version).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kSize = 31;
constexpr int kRadius = kSize / 2;
constexpr int kNet = 32;
constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

template <bool kAxisTime>
__global__ void __launch_bounds__(kBlockX * kBlockY)
median31_kernel(const float* __restrict__ x, float* __restrict__ y, int rows, int cols) {
  const int t = blockIdx.x * kBlockX + threadIdx.x;
  const int f = blockIdx.y * kBlockY + threadIdx.y;
  if (t >= cols || f >= rows) return;
  const size_t plane = static_cast<size_t>(rows) * cols;
  const float* src = x + blockIdx.z * plane;
  // The window runs along `len` elements `stride` apart, centred on `pos`.
  const int pos = kAxisTime ? t : f;
  const int len = kAxisTime ? cols : rows;
  const size_t stride = kAxisTime ? 1 : static_cast<size_t>(cols);
  const float* line = kAxisTime ? src + static_cast<size_t>(f) * cols : src + t;

  float v[kNet];
  if (pos >= kRadius && pos + kRadius < len) {
    // Interior: the whole window is in range -- plain strided loads.
    const float* w = line + static_cast<size_t>(pos - kRadius) * stride;
#pragma unroll
    for (int k = 0; k < kSize; ++k) v[k] = __ldg(w + k * stride);
  } else {
    // Within kRadius of an edge: reflect each index.
#pragma unroll
    for (int k = 0; k < kSize; ++k) {
      v[k] = __ldg(line + static_cast<size_t>(reflect_index(pos - kRadius + k, len)) * stride);
    }
  }
  v[kSize] = CUDART_INF_F;

  // Batcher's bitonic sorting network of 32, ascending.
#pragma unroll
  for (int k = 2; k <= kNet; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kNet; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const float a = v[i];
          const float b = v[p];
          const float lo = fminf(a, b);
          const float hi = fmaxf(a, b);
          if ((i & k) == 0) {
            v[i] = lo;
            v[p] = hi;
          } else {
            v[i] = hi;
            v[p] = lo;
          }
        }
      }
    }
  }

  // Median of 31 = ascending index 15 (the +inf pad sorts to index 31).
  y[blockIdx.z * plane + static_cast<size_t>(f) * cols + t] = v[kRadius];
}

}  // namespace

// x, y: contiguous f32 (batch, rows, cols). Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int median31_launch(const float* x, float* y, int batch, int rows, int cols,
                               int axis_time, void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((cols + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis_time) {
    median31_kernel<true><<<grid, block, 0, s>>>(x, y, rows, cols);
  } else {
    median31_kernel<false><<<grid, block, 0, s>>>(x, y, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
