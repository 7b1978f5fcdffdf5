// Native transport quantisers for track_analyser_tpu.
//
// The serving host is frequently a single vCPU; the numpy pad+quantise
// path costs several full passes over 16.8 MB per track (allocate, pad,
// block-max, scale, clip, cast). These fused kernels do the whole job in
// two tight passes and write straight into caller-owned buffers, and the
// GIL is released for the duration of the ctypes call, so quantisation
// overlaps the upload streams.
//
// Semantics mirror parallel/batch.py exactly:
//   int8:  per-block scale = max|x| (f32); out = nearest-int
//          (rounded clip(x * (127/scale), -127, 127)); empty/padded ->
//          scale from zeros = 0 -> inv uses 1.0, values 0.
//   int16: out = trunc(clip(x * 32768, -32768, 32767)).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline int8_t quantise_one_i8(float x, float inv) {
  float v = x * inv;
  if (v > 127.0f) v = 127.0f;
  if (v < -127.0f) v = -127.0f;
  // round-to-nearest-even (matches numpy rint): at 8 bits, truncation's
  // toward-zero bias costs ~0.1-0.3 dB of signal energy
  return static_cast<int8_t>(nearbyintf(v));
}

// f64 stereo sums over the valid range in ONE vector-friendly pass
// (4-lane accumulators; summation ORDER differs from a serial loop —
// stats are tolerance-consumed, never bit-compared, unlike the codes).
// The sub-byte kernels previously interleaved these 7 double
// accumulations into the per-sample quantise loop, which made the whole
// kernel scalar; hoisting them here cut ta_quantise_mid5 from ~19 to
// single-digit ns/sample on the 1-vCPU serving host (measured, round 5).
inline void stereo_stats_f64(const float* l, const float* r, int64_t n,
                             double* out_stats) {
  double a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0}, a2[4] = {0, 0, 0, 0},
         a3[4] = {0, 0, 0, 0}, a4[4] = {0, 0, 0, 0}, a5[4] = {0, 0, 0, 0},
         a6[4] = {0, 0, 0, 0};
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    for (int k = 0; k < 4; ++k) {
      const double lv = l[i + k];
      const double rv = r[i + k];
      a0[k] += lv;
      a1[k] += rv;
      a2[k] += lv * lv;
      a3[k] += rv * rv;
      a4[k] += lv * rv;
      a5[k] += std::fabs(lv);
      a6[k] += std::fabs(rv);
    }
  }
  double s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0, s5 = 0, s6 = 0;
  for (int k = 0; k < 4; ++k) {
    s0 += a0[k];
    s1 += a1[k];
    s2 += a2[k];
    s3 += a3[k];
    s4 += a4[k];
    s5 += a5[k];
    s6 += a6[k];
  }
  for (; i < n; ++i) {
    const double lv = l[i];
    const double rv = r[i];
    s0 += lv;
    s1 += rv;
    s2 += lv * lv;
    s3 += rv * rv;
    s4 += lv * rv;
    s5 += std::fabs(lv);
    s6 += std::fabs(rv);
  }
  out_stats[0] = static_cast<double>(n);
  out_stats[1] = s0;
  out_stats[2] = s1;
  out_stats[3] = s2;
  out_stats[4] = s3;
  out_stats[5] = s4;
  out_stats[6] = s5;
  out_stats[7] = s6;
}

// Sub-byte strip encoder: best-of {raw, delta-with-error-feedback}
// codes for LANES blocks at once. Bit-identical to the numpy fallback
// (_quantise_mid_subbyte_range): elementwise f32 ops in the same order;
// only the loop STRUCTURE differs — each block's base is the TRUE
// padded-mid sample preceding it (not the running reconstruction), so
// blocks are independent and the serial-within-a-block delta chains of
// a strip advance in lock-step as SIMD lanes (the host has AVX-512:
// 16 f32 lanes; the chain was the whole kernel's cost on delta-heavy
// dense music — every sample of the track in ONE dependent chain).
// ``shape`` noise-shapes the delta target (ms5 runs 0.5, ms6 runs 0).
// The decoder law (y = base + int-cumsum * step, shipped bases) is
// unchanged by the base choice.
constexpr int kSubbyteLanes = 16;

// Encode one strip: ``mid`` holds n_lanes contiguous padded blocks,
// ``tmid`` the same data transposed to (block, kSubbyteLanes) with
// unused lanes zeroed, ``prevs`` the base entering each lane. Writes
// scale (sign = mode), base and the SELECTED biased codes per lane.
inline void encode_subbyte_strip(const float* mid, const float* tmid,
                                 int64_t block, int n_lanes,
                                 const float* prevs, float fq, float bias,
                                 float shape, float* out_scales,
                                 float* out_bases, uint8_t* codes,
                                 uint8_t* dlt_t) {
  float peak[kSubbyteLanes], dpk[kSubbyteLanes], rerr[kSubbyteLanes];
  float rstep[kSubbyteLanes];

  // per-lane peak / diff-peak / raw candidate on the contiguous rows
  // (max reductions and the elementwise raw pass vectorise without
  // -ffast-math; pad samples are zeros, so the full-row diff peak
  // covers the valid->pad step and all-pad blocks reduce to |base|)
  for (int k = 0; k < n_lanes; ++k) {
    const float* row = mid + static_cast<int64_t>(k) * block;
    float pk = 0.0f;
    for (int64_t i = 0; i < block; ++i) {
      const float a = std::fabs(row[i]);
      if (a > pk) pk = a;
    }
    peak[k] = pk;
    float dp = std::fabs(row[0] - prevs[k]);
    for (int64_t i = 1; i < block; ++i) {
      const float ad = std::fabs(row[i] - row[i - 1]);
      if (ad > dp) dp = ad;
    }
    dpk[k] = dp;

    const float safe = pk > 0.0f ? pk : 1.0f;
    const float rs = safe / fq;
    const float ri = fq / safe;
    rstep[k] = rs;
    uint8_t* crow = codes + static_cast<int64_t>(k) * block;
    float re = 0.0f;
    for (int64_t i = 0; i < block; ++i) {
      float v = row[i] * ri;
      if (v > fq) v = fq;
      if (v < -fq) v = -fq;
      const float c = nearbyintf(v);
      crow[i] = static_cast<uint8_t>(c + bias);
      const float e = std::fabs(c * rstep[k] - row[i]);
      if (e > re) re = e;
    }
    rerr[k] = re;
  }

  // delta candidate: all lanes' error-feedback chains in lock-step over
  // the transposed strip (reads/writes are contiguous per iteration)
  float dstep[kSubbyteLanes], dinv[kSubbyteLanes];
  float prev[kSubbyteLanes], e_prev[kSubbyteLanes], derr[kSubbyteLanes];
  int32_t acc[kSubbyteLanes];
  for (int k = 0; k < kSubbyteLanes; ++k) {
    const float safe = (k < n_lanes && dpk[k] > 0.0f) ? dpk[k] : 1.0f;
    dstep[k] = safe / fq;
    dinv[k] = fq / safe;
    prev[k] = k < n_lanes ? prevs[k] : 0.0f;
    e_prev[k] = 0.0f;
    derr[k] = 0.0f;
    acc[k] = 0;
  }
  for (int64_t i = 0; i < block; ++i) {
    const float* x = tmid + i * kSubbyteLanes;
    uint8_t* d = dlt_t + i * kSubbyteLanes;
    for (int k = 0; k < kSubbyteLanes; ++k) {
      const float tgt = x[k] - shape * e_prev[k];
      float v = (tgt - prev[k]) * dinv[k];
      if (v > fq) v = fq;
      if (v < -fq) v = -fq;
      const float c = nearbyintf(v);
      d[k] = static_cast<uint8_t>(c + bias);
      acc[k] += static_cast<int32_t>(c);
      prev[k] = prevs[k] + static_cast<float>(acc[k]) * dstep[k];
      e_prev[k] = prev[k] - x[k];
      const float e = std::fabs(e_prev[k]);
      if (e > derr[k]) derr[k] = e;
    }
  }

  for (int k = 0; k < n_lanes; ++k) {
    out_bases[k] = prevs[k];
    const bool take = dpk[k] > 0.0f && derr[k] < 0.5f * rerr[k];
    if (take) {
      out_scales[k] = -dpk[k];
      uint8_t* crow = codes + static_cast<int64_t>(k) * block;
      for (int64_t i = 0; i < block; ++i) crow[i] = dlt_t[i * kSubbyteLanes + k];
    } else {
      out_scales[k] = peak[k];
    }
  }
}

// Shared strip driver for the sub-byte mid transports: computes the
// strip mid (padded), per-lane bases (true previous padded-mid sample;
// carry_in for the range's first block), the L1-tiled transpose the
// lock-step delta chains read, and hands each strip to
// encode_subbyte_strip. BITS selects the pack (6: 4-into-3 bytes,
// 5: 8-into-5). ``carry_in``/``out_carry`` thread the true-sample base
// law across independently-quantised chunks of one track (carry_out =
// the range's last padded mid sample).
template <int BITS>
inline void quantise_mid_subbyte(const float* in, int64_t n_ch_in,
                                 int64_t n_in, int64_t n_bucket,
                                 int64_t block, float carry_in, float fq,
                                 float bias, float shape, uint8_t* out_packed,
                                 float* out_mid_scales, float* out_bases,
                                 double* out_stats, float* out_carry) {
  const int64_t n_blocks = n_bucket / block;
  const float* lsrc = in;
  const float* rsrc = n_ch_in == 2 ? in + n_in : in;

  stereo_stats_f64(lsrc, rsrc, n_in, out_stats);

  const int64_t strip_n = kSubbyteLanes * block;
  float* smid = new float[strip_n];
  float* tmid = new float[strip_n];
  uint8_t* scode = new uint8_t[strip_n];
  uint8_t* dlt_t = new uint8_t[strip_n];
  float prevs[kSubbyteLanes];
  float last = carry_in;

  for (int64_t b0 = 0; b0 < n_blocks; b0 += kSubbyteLanes) {
    const int lanes = static_cast<int>(
        n_blocks - b0 < kSubbyteLanes ? n_blocks - b0 : kSubbyteLanes);
    const int64_t start = b0 * block;
    const int64_t len = static_cast<int64_t>(lanes) * block;
    const int64_t valid =
        n_in > start ? (n_in - start < len ? n_in - start : len) : 0;
    for (int64_t i = 0; i < valid; ++i)
      smid[i] = 0.5f * (lsrc[start + i] + rsrc[start + i]);
    for (int64_t i = valid; i < len; ++i) smid[i] = 0.0f;

    prevs[0] = last;
    for (int k = 1; k < kSubbyteLanes; ++k)
      prevs[k] = k < lanes ? smid[static_cast<int64_t>(k) * block - 1] : 0.0f;

    // L1-tiled transpose to (block, lanes); unused lanes zeroed so the
    // chain's lock-step reads stay defined (their outputs are dropped)
    for (int64_t i0 = 0; i0 < block; i0 += 256) {
      const int64_t i1 = i0 + 256 < block ? i0 + 256 : block;
      for (int k = 0; k < lanes; ++k) {
        const float* row = smid + static_cast<int64_t>(k) * block;
        for (int64_t i = i0; i < i1; ++i) tmid[i * kSubbyteLanes + k] = row[i];
      }
      if (lanes < kSubbyteLanes)
        for (int64_t i = i0; i < i1; ++i)
          for (int k = lanes; k < kSubbyteLanes; ++k)
            tmid[i * kSubbyteLanes + k] = 0.0f;
    }

    encode_subbyte_strip(smid, tmid, block, lanes, prevs, fq, bias, shape,
                         out_mid_scales + b0, out_bases + b0, scode, dlt_t);
    last = smid[len - 1];

    for (int k = 0; k < lanes; ++k) {
      const uint8_t* sel_code = scode + static_cast<int64_t>(k) * block;
      if (BITS == 6) {
        uint8_t* dst = out_packed + ((start + k * block) / 4) * 3;
        for (int64_t g = 0; g < block; g += 4) {
          const uint8_t c0 = sel_code[g], c1 = sel_code[g + 1];
          const uint8_t c2 = sel_code[g + 2], c3 = sel_code[g + 3];
          dst[0] = static_cast<uint8_t>((c0 << 2) | (c1 >> 4));
          dst[1] = static_cast<uint8_t>(((c1 & 15u) << 4) | (c2 >> 2));
          dst[2] = static_cast<uint8_t>(((c2 & 3u) << 6) | c3);
          dst += 3;
        }
      } else {
        uint8_t* dst = out_packed + ((start + k * block) / 8) * 5;
        for (int64_t g = 0; g < block; g += 8) {
          const uint8_t c0 = sel_code[g], c1 = sel_code[g + 1],
                        c2 = sel_code[g + 2], c3 = sel_code[g + 3],
                        c4 = sel_code[g + 4], c5 = sel_code[g + 5],
                        c6 = sel_code[g + 6], c7 = sel_code[g + 7];
          dst[0] = static_cast<uint8_t>((c0 << 3) | (c1 >> 2));
          dst[1] = static_cast<uint8_t>(((c1 & 3u) << 6) | (c2 << 1) | (c3 >> 4));
          dst[2] = static_cast<uint8_t>(((c3 & 15u) << 4) | (c4 >> 1));
          dst[3] = static_cast<uint8_t>(((c4 & 1u) << 7) | (c5 << 2) | (c6 >> 3));
          dst[4] = static_cast<uint8_t>(((c6 & 7u) << 5) | c7);
          dst += 5;
        }
      }
    }
  }
  delete[] smid;
  delete[] tmid;
  delete[] scode;
  delete[] dlt_t;

  *out_carry = last;
}

}  // namespace

extern "C" {

// Quantise one channel-major float32 signal into blockwise-scaled int8.
//
// in:        (n_ch_in, n_in) interleaved by channel (row-major)
// n_ch_in:   1 (duplicated into both output rows) or 2
// n_bucket:  padded output length (multiple of block)
// out_vals:  (2, n_bucket) int8
// out_scales:(2, n_bucket/block) float32
void ta_quantise_i8(const float* in, int64_t n_ch_in, int64_t n_in,
                    int64_t n_bucket, int64_t block, int8_t* out_vals,
                    float* out_scales) {
  const int64_t n_blocks = n_bucket / block;
  for (int64_t ch = 0; ch < 2; ++ch) {
    const float* src = in + (n_ch_in == 2 ? ch * n_in : 0);
    int8_t* vals = out_vals + ch * n_bucket;
    float* scales = out_scales + ch * n_blocks;
    for (int64_t b = 0; b < n_blocks; ++b) {
      const int64_t start = b * block;
      const int64_t valid = n_in > start ? (n_in - start < block ? n_in - start : block) : 0;
      float peak = 0.0f;
      for (int64_t i = 0; i < valid; ++i) {
        float a = std::fabs(src[start + i]);
        if (a > peak) peak = a;
      }
      scales[b] = peak;
      const float inv = 127.0f / (peak > 0.0f ? peak : 1.0f);
      int64_t i = 0;
      for (; i < valid; ++i) vals[start + i] = quantise_one_i8(src[start + i], inv);
      if (valid < block) std::memset(vals + start + valid, 0, block - valid);
    }
  }
}

// Quantise a mono float32 signal into zero-padded int16.
void ta_quantise_i16(const float* in, int64_t n_in, int64_t n_bucket,
                     int16_t* out) {
  for (int64_t i = 0; i < n_in; ++i) {
    float v = in[i] * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = static_cast<int16_t>(v);
  }
  if (n_bucket > n_in)
    std::memset(out + n_in, 0, (n_bucket - n_in) * sizeof(int16_t));
}

// Stereo variant of ta_quantise_i16: (n_ch_in, n_in) -> (2, n_bucket).
void ta_quantise_i16_stereo(const float* in, int64_t n_ch_in, int64_t n_in,
                            int64_t n_bucket, int16_t* out) {
  for (int64_t ch = 0; ch < 2; ++ch) {
    const float* src = in + (n_ch_in == 2 ? ch * n_in : 0);
    ta_quantise_i16(src, n_in, n_bucket, out + ch * n_bucket);
  }
}

// Fused mid/side transport quantiser + exact stereo statistics.
//
// One pass over the source produces everything parallel/batch.py's
// mid/side transport needs:
//   - mid  = (l+r)/2 quantised to blockwise int8 (scale = block peak)
//   - side = (l-r)/2 quantised to blockwise int4, two codes per byte
//     (code = q+8, low nibble = even sample), padded region = 0x88
//   - out_noise_power: mean over valid blocks of (side_scale/7)^2 / 12
//     (uniform quantisation-noise model; the device width computation
//     subtracts its expected spectrum)
//   - out_stats[8]: n, sum l, sum r, sum l^2, sum r^2, sum l*r,
//     sum |l|, sum |r| over the valid samples (f64) — the host computes
//     correlation/balance/mid_rms/side_rms exactly from these, so int4
//     coarseness never touches the time-domain stereo scalars.
//
// Semantics mirror the numpy path (_quantise_ms) exactly.
void ta_quantise_ms(const float* in, int64_t n_ch_in, int64_t n_in,
                    int64_t n_bucket, int64_t block, int8_t* out_mid,
                    float* out_mid_scales, uint8_t* out_side,
                    float* out_side_scales, float* out_noise_power,
                    double* out_stats) {
  const int64_t n_blocks = n_bucket / block;
  const int64_t valid_blocks =
      n_in > 0 ? (n_in + block - 1) / block : 1;
  const float* lsrc = in;
  const float* rsrc = n_ch_in == 2 ? in + n_in : in;

  double sl = 0.0, sr = 0.0, sll = 0.0, srr = 0.0, slr = 0.0, sal = 0.0,
         sar = 0.0;
  double noise_acc = 0.0;

  float* mid_buf = new float[2 * block];
  float* side_buf = mid_buf + block;

  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t start = b * block;
    const int64_t valid =
        n_in > start ? (n_in - start < block ? n_in - start : block) : 0;

    float mid_peak = 0.0f, side_peak = 0.0f;
    for (int64_t i = 0; i < valid; ++i) {
      const float l = lsrc[start + i];
      const float r = rsrc[start + i];
      const float m = 0.5f * (l + r);
      const float s = 0.5f * (l - r);
      mid_buf[i] = m;
      side_buf[i] = s;
      const float am = std::fabs(m), as = std::fabs(s);
      if (am > mid_peak) mid_peak = am;
      if (as > side_peak) side_peak = as;
      sl += l;
      sr += r;
      sll += static_cast<double>(l) * l;
      srr += static_cast<double>(r) * r;
      slr += static_cast<double>(l) * r;
      sal += std::fabs(l);
      sar += std::fabs(r);
    }

    out_mid_scales[b] = mid_peak;
    out_side_scales[b] = side_peak;
    if (b < valid_blocks) {
      const double step = side_peak / 7.0;
      noise_acc += step * step;
    }

    const float mid_inv = 127.0f / (mid_peak > 0.0f ? mid_peak : 1.0f);
    const float side_inv = 7.0f / (side_peak > 0.0f ? side_peak : 1.0f);
    int8_t* mid_out = out_mid + start;
    uint8_t* side_out = out_side + start / 2;
    for (int64_t i = 0; i < valid; ++i)
      mid_out[i] = quantise_one_i8(mid_buf[i], mid_inv);
    if (valid < block) std::memset(mid_out + valid, 0, block - valid);
    int64_t i = 0;
    for (; i + 1 < valid; i += 2) {
      float v0 = side_buf[i] * side_inv;
      float v1 = side_buf[i + 1] * side_inv;
      if (v0 > 7.0f) v0 = 7.0f;
      if (v0 < -7.0f) v0 = -7.0f;
      if (v1 > 7.0f) v1 = 7.0f;
      if (v1 < -7.0f) v1 = -7.0f;
      const uint8_t c0 = static_cast<uint8_t>(nearbyintf(v0) + 8.0f);
      const uint8_t c1 = static_cast<uint8_t>(nearbyintf(v1) + 8.0f);
      side_out[i / 2] = static_cast<uint8_t>(c0 | (c1 << 4));
    }
    if (i < valid) {  // odd tail sample pairs with a padded zero (code 8)
      float v0 = side_buf[i] * side_inv;
      if (v0 > 7.0f) v0 = 7.0f;
      if (v0 < -7.0f) v0 = -7.0f;
      const uint8_t c0 = static_cast<uint8_t>(nearbyintf(v0) + 8.0f);
      side_out[i / 2] = static_cast<uint8_t>(c0 | (8u << 4));
      i += 2;
    }
    if (i < block) std::memset(side_out + i / 2, 0x88, (block - i) / 2);
  }
  delete[] mid_buf;

  out_stats[0] = static_cast<double>(n_in);
  out_stats[1] = sl;
  out_stats[2] = sr;
  out_stats[3] = sll;
  out_stats[4] = srr;
  out_stats[5] = slr;
  out_stats[6] = sal;
  out_stats[7] = sar;
  *out_noise_power =
      static_cast<float>(noise_acc / static_cast<double>(valid_blocks) / 12.0);
}

// Mid-only variant of ta_quantise_ms: the production "ms" transport
// ships ONLY the mid channel (the side-derived scalars are host-exact
// from the stats), so the staging path should not pay the retired int4
// side quantise/packing/noise passes. Outputs are bitwise identical to
// the mid/scales/stats of ta_quantise_ms over the same range.
void ta_quantise_mid(const float* in, int64_t n_ch_in, int64_t n_in,
                     int64_t n_bucket, int64_t block, int8_t* out_mid,
                     float* out_mid_scales, double* out_stats) {
  const int64_t n_blocks = n_bucket / block;
  const float* lsrc = in;
  const float* rsrc = n_ch_in == 2 ? in + n_in : in;

  double sl = 0.0, sr = 0.0, sll = 0.0, srr = 0.0, slr = 0.0, sal = 0.0,
         sar = 0.0;

  float* mid_buf = new float[block];

  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t start = b * block;
    const int64_t valid =
        n_in > start ? (n_in - start < block ? n_in - start : block) : 0;

    float mid_peak = 0.0f;
    for (int64_t i = 0; i < valid; ++i) {
      const float l = lsrc[start + i];
      const float r = rsrc[start + i];
      const float m = 0.5f * (l + r);
      mid_buf[i] = m;
      const float am = std::fabs(m);
      if (am > mid_peak) mid_peak = am;
      sl += l;
      sr += r;
      sll += static_cast<double>(l) * l;
      srr += static_cast<double>(r) * r;
      slr += static_cast<double>(l) * r;
      sal += std::fabs(l);
      sar += std::fabs(r);
    }

    out_mid_scales[b] = mid_peak;
    const float mid_inv = 127.0f / (mid_peak > 0.0f ? mid_peak : 1.0f);
    int8_t* mid_out = out_mid + start;
    for (int64_t i = 0; i < valid; ++i)
      mid_out[i] = quantise_one_i8(mid_buf[i], mid_inv);
    if (valid < block) std::memset(mid_out + valid, 0, block - valid);
  }
  delete[] mid_buf;

  out_stats[0] = static_cast<double>(n_in);
  out_stats[1] = sl;
  out_stats[2] = sr;
  out_stats[3] = sll;
  out_stats[4] = srr;
  out_stats[5] = slr;
  out_stats[6] = sal;
  out_stats[7] = sar;
}

// int6 variant of ta_quantise_mid: codes in [-31, 31] biased to
// [1, 63], FOUR samples packed big-endian-bitwise into THREE bytes —
// 0.75 B per stereo sample pair on the wire. Blocks are multiples of 4
// (block is 65536 in production), so pack groups never straddle a block
// and the per-block scale applies to whole groups.
//
// Each block ships in whichever of two codings reconstructs with the
// smaller max error (the mode rides the SIGN of the per-block scale;
// out_bases carries the value entering the block — the TRUE previous
// padded-mid sample, making blocks independent — so the device decode
// stays block-parallel, no cross-block scan):
//   scale >= 0 (raw):   y_i = code_i * (scale / 31)
//   scale  < 0 (delta): y_i = base + cumsum(code)_i * (-scale / 31)
// Delta (one-tap prediction with error feedback) wins on dense music,
// where the residual peak is several times below the sample peak, and
// restores the full +-0.1 BPM gate; raw wins on click-like transients,
// where delta's high-pass-shaped error noise would smear onsets, so
// delta is only taken when its max error is under HALF of raw's.
// ``carry_in``/``out_carry`` thread the true-sample base law across
// independently-quantised chunks of one track.
void ta_quantise_mid6(const float* in, int64_t n_ch_in, int64_t n_in,
                      int64_t n_bucket, int64_t block, float carry_in,
                      uint8_t* out_packed, float* out_mid_scales,
                      float* out_bases, double* out_stats, float* out_carry) {
  quantise_mid_subbyte<6>(in, n_ch_in, n_in, n_bucket, block, carry_in, 31.0f,
                          32.0f, 0.0f, out_packed, out_mid_scales, out_bases,
                          out_stats, out_carry);
}

// int5 variant of ta_quantise_mid6: codes in [-15, 15] biased to
// [1, 31], EIGHT samples packed big-endian-bitwise into FIVE bytes —
// 0.625 B per stereo sample pair on the wire. Blocks are multiples of 8
// (block is 1024 in production: the finer scale grid keeps quiet
// clicks inside the beat-grid gate at 5 bits AND pushes the per-block
// noise-floor modulation far above the tempo range — at 4096-sample
// blocks a pure-tone fixture's BPM read 108.5 instead of 120). Same
// per-block best-of raw/delta-with-error-feedback coding and carry
// threading as mid6.
// ms5's delta candidate runs NOISE-SHAPED error feedback (shape 0.5 in
// encode_subbyte_block): the quantiser target is x[i] - 0.5*e[i-1], so
// reconstruction noise follows e[i] = -0.5*e[i-1] + eps[i] — a pole at
// -0.5 that pushes the noise spectrum toward Nyquist, away from the
// mel-flux bands the BPM regression reads. Measured
// (scripts/sweep_ms5_shaping.py): dense-mix BPM error 0.255 -> 0.011 on
// the agreement fixture, and the lowest p90/max perturbation of the
// float BPM estimate over a 24-draw randomised dense ensemble
// (0.38/0.52 vs plain ms5's 0.45/0.93 and shipped ms6's 0.65/4.5);
// click-grid, LUFS, true-peak and key gates unchanged. Encoder-only:
// the decoder law and payload format are identical to the unshaped
// coding.
void ta_quantise_mid5(const float* in, int64_t n_ch_in, int64_t n_in,
                      int64_t n_bucket, int64_t block, float carry_in,
                      uint8_t* out_packed, float* out_mid_scales,
                      float* out_bases, double* out_stats, float* out_carry) {
  quantise_mid_subbyte<5>(in, n_ch_in, n_in, n_bucket, block, carry_in, 15.0f,
                          16.0f, 0.5f, out_packed, out_mid_scales, out_bases,
                          out_stats, out_carry);
}

}  // extern "C"
