// Fused |STFT| for Hopper (sm_90a): frame -> Hann window -> DFT -> |.|
// in one kernel, written as (channel, bins, frames) float32 with frames
// contiguous. Replaces track_analyser_tpu/ops/pallas_stft.py
// stft_magnitude (Pallas kernel `_kernel`).
//
// What it computes: for channel c, centred frame t and bin k,
//   out[c, k, t] = | sum_n  wcos[n, k] * x + i * wsin[n, k] * x |,
//   x = y[c, t*hop + n - pad]   (zero outside [0, n_samples)),
// where wcos/wsin is the (n_fft, bins_p) DFT basis with the periodic Hann
// window folded into its rows (built once per n_fft and device by the
// wrapper, zero columns past the last real bin). As in the TPU kernel,
// neither the framed signal nor the complex spectrum ever exists in
// device memory.
//
// What bounds it: operations. It is a direct DFT, a product of the
// (frames x n_fft) frame matrix with the (n_fft x 2*bins) basis: at the
// main path's shape (2 channels of 8,388,608 samples, 16,385 frames,
// 1,025 bins) 2.75e11 float32 flop, ~4.1 ms at the 67 TFLOP/s non-tensor
// float32 rate of NVIDIA's H100 SXM data sheet (700 W), while its bytes
// (read the signal once, write the magnitudes once: 201 MB) take ~60 us
// at its 3.35 TB/s. The sums are plain float32 FMAs: the reference holds
// its kernel to 2e-6 of the frame norm, which TF32 tensor cores would not
// meet. Measured on an H100 80GB HBM3 at a 700 W limit: 7.9 ms at 2
// channels and 30.9 ms at 8 (~35.6 TFLOP/s, 53% of the bound), against
// 1.1 / 4.3 ms for the cuFFT path.
//
// What the design does about it: it is tiled like a float32 GEMM so that
// the FMA pipes, not loads, are the limit. A block owns 64 frames x 64
// bins of one channel and walks the n_fft terms 16 at a time: the frame
// samples (a Toeplitz slice of the signal, read through L2 since frames
// overlap four-fold) and the cos/sin basis rows are staged in shared
// memory; each thread keeps a 4-frame x 4-bin register tile of re and im
// (32 accumulators) and does 32 FMAs per 6 shared loads. The epilogue
// writes sqrt(re^2 + im^2) straight into the (bins, frames) layout, with
// a warp's stores running along frames. Still an O(N^2) DFT: an FFT
// (cuFFT in ops/stft.magnitude) does ~100x fewer operations, and this
// kernel is expected to lose to it; a shared-memory FFT per frame or a
// 3xTF32 tensor-core product is the later redesign.
//
// Offsets into the signal and the output are 64-bit: channels * bins *
// frames passes 2^31 for long tracks at large batch.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;   // frames per block tile
constexpr int kBN = 64;   // bins per block tile
constexpr int kBK = 16;   // DFT terms per shared-memory step
constexpr int kTM = 4;    // frames per thread, strided by kThreadsX
constexpr int kTN = 4;    // bins per thread, contiguous
constexpr int kThreadsX = kBM / kTM;  // 16, along frames
constexpr int kThreadsY = kBN / kTN;  // 16, along bins
constexpr int kThreads = kThreadsX * kThreadsY;

__global__ void __launch_bounds__(kThreads)
stft_mag_kernel(const float* __restrict__ y, const float* __restrict__ wcos,
                const float* __restrict__ wsin, float* __restrict__ out,
                long long n_samples, int n_fft, int hop, int pad, int frames, int bins,
                int bins_p) {
  // +1 column: the global-load mapping stores 16 consecutive terms of one
  // frame per half-warp, which would otherwise hit one bank.
  __shared__ float a_tile[kBK][kBM + 1];
  __shared__ __align__(16) float c_tile[kBK][kBN];
  __shared__ __align__(16) float s_tile[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int k0 = blockIdx.x * kBN;
  const int f0 = blockIdx.y * kBM;
  const int c = blockIdx.z;
  const float* yc = y + static_cast<long long>(c) * n_samples;

  float re[kTM][kTN];
  float im[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      re[i][j] = 0.0f;
      im[i][j] = 0.0f;
    }
  }

  for (int n0 = 0; n0 < n_fft; n0 += kBK) {
    // Frame samples: kBK x kBM values, terms fastest so a half-warp reads
    // 16 consecutive samples of one frame.
#pragma unroll
    for (int r = 0; r < (kBK * kBM) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx % kBK;
      const int m = idx / kBK;
      const long long s =
          static_cast<long long>(f0 + m) * hop + n0 + kk - pad;
      float v = 0.0f;
      if (f0 + m < frames && s >= 0 && s < n_samples) v = __ldg(yc + s);
      a_tile[kk][m] = v;
    }
    // Basis rows n0 .. n0+kBK-1, columns k0 .. k0+kBN-1: one float4 of
    // cos and one of sin per thread (bins_p is a multiple of kBN).
    {
      const int kk = tid / (kBN / 4);
      const int q = tid % (kBN / 4);
      const long long off = static_cast<long long>(n0 + kk) * bins_p + k0 + 4 * q;
      *reinterpret_cast<float4*>(&c_tile[kk][4 * q]) =
          __ldg(reinterpret_cast<const float4*>(wcos + off));
      *reinterpret_cast<float4*>(&s_tile[kk][4 * q]) =
          __ldg(reinterpret_cast<const float4*>(wsin + off));
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = a_tile[kk][tx + kThreadsX * i];
      const float4 cv = *reinterpret_cast<const float4*>(&c_tile[kk][kTN * ty]);
      const float4 sv = *reinterpret_cast<const float4*>(&s_tile[kk][kTN * ty]);
      const float cb[kTN] = {cv.x, cv.y, cv.z, cv.w};
      const float sb[kTN] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          re[i][j] = fmaf(a[i], cb[j], re[i][j]);
          im[i][j] = fmaf(a[i], sb[j], im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int k = k0 + kTN * ty + j;
    if (k >= bins) continue;
    float* row = out + (static_cast<long long>(c) * bins + k) * frames;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int f = f0 + tx + kThreadsX * i;
      if (f < frames) row[f] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    }
  }
}

}  // namespace

// y: contiguous f32 (channels, n_samples); wcos, wsin: contiguous f32
// (n_fft, bins_p) with bins_p a multiple of 64 and n_fft a multiple of 16;
// out: contiguous f32 (channels, bins, frames). Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int stft_mag_launch(const float* y, const float* wcos, const float* wsin, float* out,
                               int channels, long long n_samples, int n_fft, int hop, int pad,
                               int frames, int bins, int bins_p, void* stream) {
  const dim3 block(kThreads, 1, 1);
  const dim3 grid((bins + kBN - 1) / kBN, (frames + kBM - 1) / kBM, channels);
  stft_mag_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      y, wcos, wsin, out, n_samples, n_fft, hop, pad, frames, bins, bins_p);
  return static_cast<int>(cudaGetLastError());
}
