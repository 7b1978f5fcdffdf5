// Fused |STFT| for Hopper (sm_90a): frame -> Hann window -> 2048-point
// real FFT -> |.| in one kernel, written as (channel, bins, frames) float32
// with frames contiguous. Replaces track_analyser_tpu/ops/pallas_stft.py
// stft_magnitude (Pallas kernel `_kernel`), which on the TPU is a windowed
// DFT on the matrix unit; here the transform is a hand-written FFT.
//
// What it computes: for channel c, frame t and bin k <= 1024,
//   out[c, k, t] = | sum_j  w[j] * y[c, t*512 + j - pad] * e^{-2 pi i jk/2048} |
// with w the periodic Hann window and y zero outside [0, n_samples). As in
// the TPU kernel, neither the framed signal nor the complex spectrum ever
// exists in device memory.
//
// What bounds it: bytes. The function must read the signal once and write
// the magnitudes once: 806 MB at the sweep's shape (8 channels of 8,388,608
// samples, 131,080 frames), 0.24 ms at the 3.35 TB/s of NVIDIA's H100 SXM
// data sheet; an FFT's arithmetic is below that (~70 kflop a frame, 0.14 ms
// at 67 TFLOP/s). Two things keep a kernel from that bound. Shared memory:
// every pass of an FFT that goes through it moves a frame's 8 KB there and
// back, and the SMs together move ~33 TB/s, so ten radix-2 passes would cost
// more than the bytes do. And the store: the output's rows (one per bin) are
// 16,385 floats long, an odd number, so the frames a block has ready never
// start on a 32-byte sector of a row; sectors written in parts, and 128-byte
// lines that leave L2 before they are whole, cost more than the transform.
//
// What the design does about it:
//  - A real FFT by a half-size complex one: the windowed frame is packed as
//    z[m] = x[2m] + i x[2m+1], m < 1024, transformed, and untangled:
//    X[k] = E[k] + e^{-2 pi i k/2048} O[k], E = (Z[k] + conj Z[1024-k])/2,
//    O = -i (Z[k] - conj Z[1024-k])/2; bins k and 1024 - k share E, O and the
//    factor and are untangled together.
//  - One warp owns one frame and 1024 = 32 x 32: lane n2 holds z[32*n1+n2]
//    in 32 register pairs and runs a 32-point FFT over n1 in registers (five
//    radix-2 passes with literal twiddles, bit-reversed out), multiplies by
//    the inner twiddles W_1024^(k1*n2), and the warp transposes through a
//    33-float-pitch plane of shared memory (no bank conflicts; real parts,
//    then imaginary parts through the same plane), after which lane k1 runs
//    the second 32-point FFT and holds Z[k1 + 32*k2]. That is ONE exchange
//    through shared memory per frame, warp-synchronous (__syncwarp only).
//  - The untangle needs Z[1024-k], which sits in lane (32 - lane) % 32: two
//    warp shuffles per pair of bins, no further pass through shared memory.
//  - The window (halved: the untangle's 1/2), the inner twiddles (laid out
//    [k1][n2], so a warp reads one row per register) and the untangle factors
//    are float64 values rounded once to float32 by the wrapper
//    (ops/fused_stft.fft_tables), copied to shared memory once per block. No
//    __sincosf, no fast-math; the one approximate instruction is the
//    magnitude's sqrt.approx (relative error <= 2^-23). The result is held to
//    2e-6 of each frame's spectral norm.
//  - A block (16 warps, one per SM: 114 registers a thread, 225 KB of shared
//    memory) owns a stretch of consecutive frames of one channel and walks
//    along it 16 frames (a run) at a time. The run's slab of (16 + 3) * 512
//    samples (frames overlap four-fold) is copied once, by cp.async, while
//    the run before it is transformed; zero outside the signal.
//  - The 1025 x 16 magnitudes of a run are staged in a shared-memory tile of
//    odd pitch (it reuses the exchange planes' memory). Each bin then stores
//    its next two WHOLE sectors: the frames of the run that lie past the
//    bin's last sector boundary (at most 7) are also written, by the warp
//    that untangles them, into a carry buffer in shared memory (two of them,
//    taking turns) and go out with the next run. Only the two ends of a
//    block's stretch write part sectors. The stores carry an L2 evict-last hint, so
//    that a line written half in this run and half in the next stays in L2
//    until it is whole. A store of one frame at a time would write 4-byte
//    pieces 65 KB apart.
//  - The launch cuts each channel into stretches of at least 16 runs and
//    picks the length with which the last wave of stretches ends soonest.
//
// Offsets into the signal and the output are 64-bit: channels * bins *
// frames passes 2^31 for long tracks at large batch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNfft = 2048;
constexpr int kHop = 512;
constexpr int kPoints = kNfft / 2;  // complex points of the packed frame
constexpr int kBins = kPoints + 1;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 1;
constexpr int kRun = kWarps;           // frames a block handles at a time, one per warp
constexpr int kSector = 8;             // floats in a 32-byte sector of device memory
constexpr int kRowsPerPass = kThreads / kRun;  // bins the block stores at a time, kRun threads each
static_assert(kRun % kSector == 0 && kRowsPerPass % kSector == 0,
              "a thread's place in its bin's sectors must not change from pass to pass");
constexpr int kTilePitch = kRun + 1;   // odd: a warp's 32 bins of one frame hit 32 banks
constexpr int kCarryPitch = kSector - 1;  // a row carries at most 7 frames to the next run
constexpr int kSlab = (kRun - 1) * kHop + kNfft;  // samples under a run of frames
constexpr int kPlanePitch = 33;        // odd: rows and columns of the 32 x 32 exchange both hit 32 banks
constexpr int kPlane = 32 * kPlanePitch;
constexpr int kTables = 2 * kNfft + kPoints;  // window/2 | inner twiddles re, im | untangle factors re, im
constexpr int kShared =
    (kWarps * kPlane > kBins * kTilePitch) ? kWarps * kPlane : kBins * kTilePitch;
constexpr int kCarry = kBins * kCarryPitch;
constexpr int kSmemBytes =
    (kTables + 2 * kSlab + kShared + 2 * kCarry) * static_cast<int>(sizeof(float));
static_assert(kSmemBytes <= 232448, "more shared memory than a block can have");

__host__ __device__ constexpr int brev5(int k) {
  return ((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) | ((k & 16) >> 4);
}

// (dr + i di) * e^{-2 pi i t/32}, t < 16 a compile-time value after unrolling.
__device__ __forceinline__ void mul_w32(float dr, float di, int t, float& outr, float& outi) {
  constexpr float kCos[16] = {1.0f,         0.98078525f,  0.9238795f,   0.8314696f,
                              0.70710677f,  0.55557024f,  0.38268343f,  0.19509032f,
                              0.0f,         -0.19509032f, -0.38268343f, -0.55557024f,
                              -0.70710677f, -0.8314696f,  -0.9238795f,  -0.98078525f};
  constexpr float kSin[16] = {0.0f,        0.19509032f, 0.38268343f, 0.55557024f,
                              0.70710677f, 0.8314696f,  0.9238795f,  0.98078525f,
                              1.0f,        0.98078525f, 0.9238795f,  0.8314696f,
                              0.70710677f, 0.55557024f, 0.38268343f, 0.19509032f};
  if (t == 0) {
    outr = dr;
    outi = di;
  } else if (t == 8) {  // times -i
    outr = di;
    outi = -dr;
  } else if (t == 4) {  // times (1 - i) / sqrt 2
    outr = (dr + di) * kCos[4];
    outi = (di - dr) * kCos[4];
  } else if (t == 12) {  // times (-1 - i) / sqrt 2
    outr = (di - dr) * kCos[4];
    outi = -(dr + di) * kCos[4];
  } else {
    outr = fmaf(dr, kCos[t], di * kSin[t]);
    outi = fmaf(di, kCos[t], -(dr * kSin[t]));
  }
}

// One radix-2 decimation-in-frequency pass over groups of 2 * HALF registers.
template <int HALF>
__device__ __forceinline__ void dif_pass(float (&re)[32], float (&im)[32]) {
#pragma unroll
  for (int g = 0; g < 32; g += 2 * HALF) {
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int a = g + j;
      const int b = a + HALF;
      const float dr = re[a] - re[b];
      const float di = im[a] - im[b];
      re[a] += re[b];
      im[a] += im[b];
      mul_w32(dr, di, j * (16 / HALF), re[b], im[b]);
    }
  }
}

// 32-point FFT over a thread's registers: natural order in, X[k] in
// register brev5(k) out.
__device__ __forceinline__ void fft32(float (&re)[32], float (&im)[32]) {
  dif_pass<16>(re, im);
  dif_pass<8>(re, im);
  dif_pass<4>(re, im);
  dif_pass<2>(re, im);
  dif_pass<1>(re, im);
}

// sqrt(x) without sqrtf's correction steps: one special-function instruction,
// relative error at most 2^-23 (PTX ISA); a subnormal x (a squared magnitude
// under 1.2e-38) gives 0.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// cp.async of 16 or 4 bytes from device to shared memory; with `inside`
// false nothing is read and the bytes are zero.
__device__ __forceinline__ void copy_async_16(float* dst, const float* src, bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(inside ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_async_4(float* dst, const float* src, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(inside ? 4 : 0)
               : "memory");
}

// Queue the copy of one run's slab of the signal into shared memory, zero
// outside [0, n_samples). With vector_loads the channel's base is 16-byte
// aligned and n_samples a multiple of 4, so a 16-byte piece lies wholly
// inside or outside.
__device__ __forceinline__ void queue_slab(float* slab, const float* yc, long long s0,
                                           long long n_samples, int vector_loads, int tid) {
  if (vector_loads) {
    for (int i = tid; i < kSlab / 4; i += kThreads) {
      const long long s = s0 + 4 * i;
      const bool inside = s >= 0 && s < n_samples;
      copy_async_16(slab + 4 * i, yc + (inside ? s : 0), inside);
    }
  } else {
    for (int i = tid; i < kSlab; i += kThreads) {
      const long long s = s0 + i;
      const bool inside = s >= 0 && s < n_samples;
      copy_async_4(slab + i, yc + (inside ? s : 0), inside);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A store that asks L2 to evict the line last: a bin's 128-byte line is
// written over two or three runs, and should stay in L2 until it is whole.
__device__ __forceinline__ unsigned long long keep_in_l2_policy() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void store_keep_in_l2(float* dst, float v, unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(dst), "f"(v), "l"(policy)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stft_mag_kernel(const float* __restrict__ y, const float* __restrict__ tables,
                float* __restrict__ out, long long n_samples, int pad, int frames, int runs,
                int parts, int runs_per_part, long long chunks, int vector_loads) {
  extern __shared__ __align__(16) float smem[];
  float* const s_win = smem;
  float* const s_twr = smem + kNfft;
  float* const s_twi = s_twr + kPoints;
  float* const s_unr = s_twi + kPoints;
  float* const s_uni = s_unr + kPoints / 2;
  float* const s_slab = smem + kTables;  // two buffers: this run's and the next one's
  float* const s_tile = s_slab + 2 * kSlab;  // also the warps' exchange planes
  float* const s_carry = s_tile + kShared;  // two buffers: read by this run's store, written for the next

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* const plane = s_tile + warp * kPlane;

  for (int i = tid; i < kTables / 4; i += kThreads) {
    reinterpret_cast<float4*>(smem)[i] = __ldg(reinterpret_cast<const float4*>(tables) + i);
  }

  // A chunk is a stretch of consecutive runs of one channel; the block walks
  // along it so that a row's frames past its last whole sector can wait in
  // s_carry for the next run.
  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int c = static_cast<int>(chunk / parts);
    const int run_lo = static_cast<int>(chunk % parts) * runs_per_part;
    const int run_hi = min(runs, run_lo + runs_per_part);
    const float* yc = y + static_cast<long long>(c) * n_samples;
    const long long row0 = static_cast<long long>(c) * kBins;

    for (int run = run_lo; run < run_hi; ++run) {
      const int f0 = run * kRun;
      const long long s0 = static_cast<long long>(f0) * kHop - pad;

      // This run's slab was queued during the last run, except at the head
      // of a chunk; the next run's is queued now and arrives during the FFT.
      float* const slab = s_slab + ((run - run_lo) & 1) * kSlab;
      if (run == run_lo) queue_slab(slab, yc, s0, n_samples, vector_loads, tid);
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();  // slab (and tables) ready; the last run's tile has been stored
      if (run + 1 < run_hi) {
        queue_slab(s_slab + ((run + 1 - run_lo) & 1) * kSlab, yc, s0 + kRun * kHop, n_samples,
                   vector_loads, tid);
      }

      const bool active = f0 + warp < frames;  // the same for a whole warp
      float re[32];
      float im[32];
      if (active) {
        // Lane n2 takes z[32*n1 + n2], n1 = register: window (halved) and pack.
        const float2* x2 = reinterpret_cast<const float2*>(slab + warp * kHop);
        const float2* w2 = reinterpret_cast<const float2*>(s_win);
#pragma unroll
        for (int n1 = 0; n1 < 32; ++n1) {
          const float2 x = x2[32 * n1 + lane];
          const float2 w = w2[32 * n1 + lane];
          re[n1] = x.x * w.x;
          im[n1] = x.y * w.y;
        }
        fft32(re, im);  // over n1: A[k1] in register brev5(k1)
#pragma unroll
        for (int k1 = 1; k1 < 32; ++k1) {  // times W_1024^(k1*n2); row 0 is all ones
          const int p = brev5(k1);
          const float tr = s_twr[32 * k1 + lane];
          const float ti = s_twi[32 * k1 + lane];
          const float r = re[p] * tr - im[p] * ti;
          im[p] = fmaf(re[p], ti, im[p] * tr);
          re[p] = r;
        }
        // Transpose: lane n2 writes row k1, lane k1 reads its row.
#pragma unroll
        for (int k1 = 0; k1 < 32; ++k1) plane[k1 * kPlanePitch + lane] = re[brev5(k1)];
        __syncwarp();
#pragma unroll
        for (int n2 = 0; n2 < 32; ++n2) re[n2] = plane[lane * kPlanePitch + n2];
        __syncwarp();
#pragma unroll
        for (int k1 = 0; k1 < 32; ++k1) plane[k1 * kPlanePitch + lane] = im[brev5(k1)];
        __syncwarp();
#pragma unroll
        for (int n2 = 0; n2 < 32; ++n2) im[n2] = plane[lane * kPlanePitch + n2];
        fft32(re, im);  // over n2: Z[lane + 32*k2] in register brev5(k2)
      }
      __syncthreads();  // every warp is done with its plane: the tile may overwrite them

      if (active) {
        // Bins k = lane + 32*k2 < 512 and 1024 - k in one step: with
        // E = Z[k] + conj Z[1024-k], O = -i (Z[k] - conj Z[1024-k]) (the
        // window carries the factor 1/2) and t = w_k O,
        // X[k] = E + t and X[1024-k] = conj(E - t).
        const int source = (32 - lane) & 31;
        float* const column = s_tile + warp;
        // A bin's frames past its last whole sector (the run's last d, see the
        // store below) also go into the next run's carry. d depends on the
        // row modulo 8, so it is one value for this lane's bins k and one for
        // its bins 1024 - k.
        float* const carry_next = s_carry + ((run - run_lo + 1) & 1) * kCarry;
        const int fm = frames % kSector;
        const int slot_lo = warp - kRun + static_cast<int>((row0 + lane) % kSector) * fm % kSector;
        const int slot_hi = warp - kRun + static_cast<int>((row0 + kPoints - lane) % kSector) * fm % kSector;
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2) {
          const float a = re[brev5(k2)];
          const float b = im[brev5(k2)];
          // The partner lane's Z[1024 - k] is register 31 - k2 here, but
          // register (32 - k2) % 32 in lane 0, its own partner.
          const float give_re = lane == 0 ? re[brev5((32 - k2) & 31)] : re[brev5(31 - k2)];
          const float give_im = lane == 0 ? im[brev5((32 - k2) & 31)] : im[brev5(31 - k2)];
          const float cr = __shfl_sync(0xffffffffu, give_re, source);
          const float ci = __shfl_sync(0xffffffffu, give_im, source);
          const int k = lane + 32 * k2;
          const float er = a + cr;
          const float ei = b - ci;
          const float o_r = b + ci;
          const float o_i = cr - a;
          const float wr = s_unr[k];
          const float wi = s_uni[k];
          const float tr = wr * o_r - wi * o_i;
          const float ti = fmaf(wr, o_i, wi * o_r);
          const float pr = er + tr, pi = ei + ti, mr = er - tr, mi = ei - ti;
          const float mag_lo = sqrt_approx(fmaf(pr, pr, pi * pi));
          const float mag_hi = sqrt_approx(fmaf(mr, mr, mi * mi));
          column[k * kTilePitch] = mag_lo;
          column[(kPoints - k) * kTilePitch] = mag_hi;
          if (slot_lo >= 0) carry_next[k * kCarryPitch + slot_lo] = mag_lo;
          if (slot_hi >= 0) carry_next[(kPoints - k) * kCarryPitch + slot_hi] = mag_hi;
        }
        if (lane == 0) {  // bin 512 is its own partner and w = -i: |X| = 2 |Z[512]|
          const float a = re[brev5(16)];
          const float b = im[brev5(16)];
          const float mag = 2.0f * sqrt_approx(fmaf(a, a, b * b));
          column[(kPoints / 2) * kTilePitch] = mag;
          if (slot_lo >= 0) carry_next[(kPoints / 2) * kCarryPitch + slot_lo] = mag;  // 512 % 8 == 0
        }
      }
      __syncthreads();  // the tile is whole

      // Store. Thread (k, j) of each group of kRun writes slot j of row k's
      // next whole 32-byte sectors: the row's sector boundaries trail the
      // run's first frame by d = (row * frames) % 8 frames, which
      // kRowsPerPass rows further down is the same, so d and j stay fixed
      // while the thread walks down the bins. Slots j < d come from the
      // carry that the last run's untangle left, the rest from the tile. The
      // first run of a chunk has no carry, and the last one also stores the
      // frames that would have been carried.
      {
        const bool first = run == run_lo;
        const bool last = run + 1 == run_hi;
        const int f1 = min(f0 + kRun, frames);
        const int j = tid % kRun;
        const int k0 = tid / kRun;
        const int d = static_cast<int>(((row0 + k0) % kSector) * (frames % kSector) % kSector);
        const int f = f0 - d + j;
        const bool from_carry = j < d;
        const bool write = f >= (first ? f0 : f0 - d) && f < (last ? f1 : f0 + kRun - d);
        const bool tail = last && from_carry && f + kRun < f1;
        const float* src = from_carry
                               ? s_carry + ((run - run_lo) & 1) * kCarry + k0 * kCarryPitch + j
                               : s_tile + k0 * kTilePitch + j - d;
        const int src_step = kRowsPerPass * (from_carry ? kCarryPitch : kTilePitch);
        const float* later = s_tile + k0 * kTilePitch + kRun - d + j;  // frame f + kRun, if j < d
        float* dst = out + (row0 + k0) * frames + f;
        const long long dst_step = static_cast<long long>(kRowsPerPass) * frames;
        const unsigned long long policy = keep_in_l2_policy();
#pragma unroll 4
        for (int k = k0; k < kBins; k += kRowsPerPass) {
          if (write) store_keep_in_l2(dst, *src, policy);
          if (tail) store_keep_in_l2(dst + kRun, *later, policy);
          src += src_step;
          later += kRowsPerPass * kTilePitch;
          dst += dst_step;
        }
      }
    }
  }
}

}  // namespace

// y: contiguous f32 (channels, n_samples); tables: the 5120 floats of
// ops/fused_stft.fft_tables, 16-byte aligned; out: contiguous f32
// (channels, 1025, frames). Takes n_fft 2048 and hop 512 only. Launches on
// ``stream`` and returns the first CUDA error (0 on success); does not
// synchronise.
extern "C" int stft_mag_launch(const float* y, const float* tables, float* out, int channels,
                               long long n_samples, int n_fft, int hop, int pad, int frames,
                               void* stream) {
  if (n_fft != kNfft || hop != kHop || (pad != 0 && pad != kNfft / 2) || channels < 1 ||
      frames < 1 || reinterpret_cast<uintptr_t>(tables) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(stft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(stft_mag_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // A channel's runs are cut into `parts` chunks of `runs_per_part`
  // consecutive runs, dealt to the resident blocks in turn. Of the chunk
  // lengths from 16 runs up (a chunk's two ends write part sectors), take the
  // one whose last wave of chunks ends soonest.
  const int runs = (frames + kRun - 1) / kRun;
  const long long resident = static_cast<long long>(sms) * kBlocksPerSm;
  int runs_per_part = runs;
  long long soonest = -1;
  for (int length = runs < 16 ? runs : 16; length <= runs; ++length) {
    const long long n_chunks = static_cast<long long>(channels) * ((runs + length - 1) / length);
    const long long makespan = (n_chunks + resident - 1) / resident * length;
    if (soonest < 0 || makespan <= soonest) {
      soonest = makespan;
      runs_per_part = length;
    }
  }
  const int parts = (runs + runs_per_part - 1) / runs_per_part;
  const long long chunks = static_cast<long long>(channels) * parts;
  const int grid = static_cast<int>(chunks < resident ? chunks : resident);
  const int vector_loads = reinterpret_cast<uintptr_t>(y) % 16 == 0 && n_samples % 4 == 0;
  stft_mag_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      y, tables, out, n_samples, pad, frames, runs, parts, runs_per_part, chunks, vector_loads);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel that fit one SM at a time, as the runtime reckons
// it from the built kernel's registers and shared memory (negative: a CUDA
// error code).
extern "C" int stft_mag_blocks_per_sm() {
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      stft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stft_mag_kernel, kThreads,
                                                        kSmemBytes);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
