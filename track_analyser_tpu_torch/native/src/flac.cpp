// Native FLAC decoder fast path for track_analyser_tpu.
//
// Mirrors the pure-numpy decoder in io/flac.py (same spec subset:
// CONSTANT/VERBATIM/FIXED/LPC subframes, Rice/Rice2 partitions with
// escapes, wasted bits, all stereo decorrelation modes, 8-32 bps,
// frame-header CRC-8 verification) and must match it bit-for-bit — the
// test suite pins native-vs-python parity. The Python tier stays
// authoritative when this library isn't built.
//
// Exposed via the same minimal C ABI as decoder.cpp: interleaved float32
// frames in [-1, 1), caller frees with ta_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;       // bytes
  size_t pos = 0;    // bits

  bool ok(size_t nbits) const { return pos + nbits <= size * 8; }

  uint64_t read(int n) {  // n <= 57
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      size_t byte = (pos + i) >> 3;
      int bit = 7 - ((pos + i) & 7);
      v = (v << 1) | ((data[byte] >> bit) & 1);
    }
    pos += n;
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n > 0 && (v >> (n - 1)))
      return static_cast<int64_t>(v) - (int64_t(1) << n);
    return static_cast<int64_t>(v);
  }

  // zeros until the next set bit (consumed)
  int64_t read_unary() {
    int64_t q = 0;
    while (ok(1)) {
      size_t byte = pos >> 3;
      int bit = 7 - (pos & 7);
      ++pos;
      if ((data[byte] >> bit) & 1) return q;
      ++q;
    }
    return -1;  // truncated
  }

  void align() { pos = (pos + 7) & ~size_t(7); }
};

uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= d[i];
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x80) ? uint8_t((crc << 1) ^ 0x07) : uint8_t(crc << 1);
  }
  return crc;
}

const int kBlockSizes[16] = {0,    192,  576,  1152, 2304, 4608, -8, -16,
                             256,  512,  1024, 2048, 4096, 8192, 16384, 32768};
const int kRates[16] = {0,     88200, 176400, 192000, 8000,  16000,
                        22050, 24000, 32000,  44100,  48000, 96000,
                        -8,    -16,   -160,   -1};
const int kSampleSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};

bool read_utf8(BitReader& br, uint64_t* out) {
  uint64_t first = br.read(8);
  if (first < 0x80) { *out = first; return true; }
  int extra = 0;
  uint64_t mask = 0x40;
  while (first & mask) { ++extra; mask >>= 1; }
  uint64_t v = first & (mask - 1);
  for (int i = 0; i < extra; ++i) {
    uint64_t c = br.read(8);
    if ((c & 0xC0) != 0x80) return false;
    v = (v << 6) | (c & 0x3F);
  }
  *out = v;
  return true;
}

bool read_residual(BitReader& br, int block_size, int pred_order,
                   std::vector<int64_t>& out) {
  int method = int(br.read(2));
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  int escape = (1 << pbits) - 1;
  int porder = int(br.read(4));
  int nparts = 1 << porder;
  if (block_size % nparts) return false;
  out.clear();
  out.reserve(block_size - pred_order);
  for (int p = 0; p < nparts; ++p) {
    int count = (block_size >> porder) - (p == 0 ? pred_order : 0);
    if (count < 0) return false;
    int param = int(br.read(pbits));
    if (param == escape) {
      int raw = int(br.read(5));
      for (int i = 0; i < count; ++i)
        out.push_back(raw ? br.read_signed(raw) : 0);
    } else {
      for (int i = 0; i < count; ++i) {
        int64_t q = br.read_unary();
        if (q < 0) return false;
        uint64_t folded = (uint64_t(q) << param) | (param ? br.read(param) : 0);
        out.push_back(int64_t(folded >> 1) ^ -int64_t(folded & 1));
      }
    }
  }
  return true;
}

bool read_subframe(BitReader& br, int block_size, int bps,
                   std::vector<int64_t>& out) {
  if (br.read(1) != 0) return false;
  int type = int(br.read(6));
  int wasted = 0;
  if (br.read(1)) {
    int64_t u = br.read_unary();
    if (u < 0) return false;
    wasted = int(u) + 1;
  }
  int eff = bps - wasted;
  out.assign(block_size, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(eff);
    for (auto& s : out) s = v;
  } else if (type == 1) {  // VERBATIM
    for (auto& s : out) s = br.read_signed(eff);
  } else if (type >= 8 && type <= 12) {  // FIXED
    int order = type - 8;
    std::vector<int64_t> res;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(eff);
    if (!read_residual(br, block_size, order, res)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t r = res[i - order];
      switch (order) {
        case 0: out[i] = r; break;
        case 1: out[i] = r + out[i - 1]; break;
        case 2: out[i] = r + 2 * out[i - 1] - out[i - 2]; break;
        case 3: out[i] = r + 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        default:
          out[i] = r + 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
      }
    }
  } else if (type >= 32) {  // LPC
    int order = type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(eff);
    int precision = int(br.read(4)) + 1;
    if (precision == 16) return false;
    int64_t shift = br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    std::vector<int64_t> res;
    if (!read_residual(br, block_size, order, res)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& s : out) s <<= wasted;
  return true;
}

}  // namespace

extern "C" {

void ta_free(float* p);  // defined in decoder.cpp

// Decode a FLAC file. Returns 0 on success; *out is interleaved float32
// frames (caller frees via ta_free). bps is reported for subtype naming.
int ta_decode_flac(const char* path, float** out, long long* out_frames,
                   int* out_channels, int* out_rate, int* out_bps) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(static_cast<size_t>(fsize));
  if (fsize <= 0 || std::fread(raw.data(), 1, size_t(fsize), f) != size_t(fsize)) {
    std::fclose(f);
    return 1;
  }
  std::fclose(f);

  if (raw.size() < 8 || std::memcmp(raw.data(), "fLaC", 4) != 0) return 2;

  // Metadata blocks.
  size_t pos = 4;
  int sr = 0, channels = 0, bps = 0;
  uint64_t total = 0;
  bool have_info = false;
  while (pos + 4 <= raw.size()) {
    uint32_t hdr = (raw[pos] << 24) | (raw[pos + 1] << 16) | (raw[pos + 2] << 8) |
                   raw[pos + 3];
    bool last = hdr >> 31;
    int btype = (hdr >> 24) & 0x7F;
    uint32_t len = hdr & 0xFFFFFF;
    if (btype == 0 && len >= 34 && pos + 4 + len <= raw.size()) {
      const uint8_t* b = raw.data() + pos + 4;
      uint64_t packed = 0;
      for (int i = 10; i < 18; ++i) packed = (packed << 8) | b[i];
      sr = int(packed >> 44);
      channels = int((packed >> 41) & 0x7) + 1;
      bps = int((packed >> 36) & 0x1F) + 1;
      total = packed & ((uint64_t(1) << 36) - 1);
      have_info = true;
    }
    pos += 4 + len;
    if (last) break;
  }
  if (!have_info || sr == 0) return 3;

  BitReader br{raw.data(), raw.size()};
  br.pos = pos * 8;

  std::vector<std::vector<int64_t>> pcm(2);  // up to handled below for >2 ch
  std::vector<std::vector<int64_t>> chans;
  uint64_t decoded = 0;

  std::vector<int64_t> sub[8];
  while ((total == 0 || decoded < total) && br.ok(32)) {
    size_t header_start = br.pos / 8;
    if (br.read(14) != 0x3FFE) break;  // lost sync (or clean EOF padding)
    br.read(1);
    br.read(1);
    int bs_code = int(br.read(4));
    int sr_code = int(br.read(4));
    int ch_code = int(br.read(4));
    int ss_code = int(br.read(3));
    br.read(1);
    uint64_t dummy;
    if (!read_utf8(br, &dummy)) return 4;

    int block_size;
    if (bs_code == 6) block_size = int(br.read(8)) + 1;
    else if (bs_code == 7) block_size = int(br.read(16)) + 1;
    else if (kBlockSizes[bs_code] > 0) block_size = kBlockSizes[bs_code];
    else return 4;

    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    else if (kRates[sr_code] < 0) return 4;

    int frame_bps = ss_code == 0 ? bps : kSampleSizes[ss_code];
    if (frame_bps <= 0) return 4;

    if (br.pos % 8) return 4;
    size_t header_end = br.pos / 8;
    uint8_t expect = uint8_t(br.read(8));
    if (crc8(raw.data() + header_start, header_end - header_start) != expect)
      return 5;

    int nch = ch_code <= 7 ? ch_code + 1 : 2;
    if (size_t(nch) > chans.size()) chans.resize(nch);

    if (ch_code <= 7) {
      for (int c = 0; c < nch; ++c)
        if (!read_subframe(br, block_size, frame_bps, sub[c])) return 6;
    } else if (ch_code == 8) {  // left/side
      if (!read_subframe(br, block_size, frame_bps, sub[0])) return 6;
      if (!read_subframe(br, block_size, frame_bps + 1, sub[1])) return 6;
      for (int i = 0; i < block_size; ++i) sub[1][i] = sub[0][i] - sub[1][i];
    } else if (ch_code == 9) {  // right/side
      if (!read_subframe(br, block_size, frame_bps + 1, sub[0])) return 6;
      if (!read_subframe(br, block_size, frame_bps, sub[1])) return 6;
      for (int i = 0; i < block_size; ++i) sub[0][i] = sub[1][i] + sub[0][i];
    } else if (ch_code == 10) {  // mid/side
      if (!read_subframe(br, block_size, frame_bps, sub[0])) return 6;
      if (!read_subframe(br, block_size, frame_bps + 1, sub[1])) return 6;
      for (int i = 0; i < block_size; ++i) {
        int64_t side = sub[1][i];
        int64_t mid2 = (sub[0][i] << 1) | (side & 1);
        sub[0][i] = (mid2 + side) >> 1;
        sub[1][i] = (mid2 - side) >> 1;
      }
    } else {
      return 6;
    }

    for (int c = 0; c < nch; ++c)
      chans[c].insert(chans[c].end(), sub[c].begin(), sub[c].end());
    decoded += uint64_t(block_size);

    br.align();
    if (!br.ok(16)) break;
    br.read(16);  // footer CRC-16 (parsed, not verified — matches io/flac.py)
  }

  if (chans.empty() || chans[0].empty()) return 7;
  if (total && decoded < total) return 9;  // truncated: let Python report
  uint64_t frames = total ? total : decoded;
  int nch = int(chans.size()) < channels ? int(chans.size()) : channels;

  float* buf = static_cast<float*>(std::malloc(sizeof(float) * frames * nch));
  if (!buf) return 8;
  const float inv = 1.0f / float(uint64_t(1) << (bps - 1));
  for (uint64_t i = 0; i < frames; ++i)
    for (int c = 0; c < nch; ++c)
      buf[i * nch + c] = float(chans[c][i]) * inv;

  *out = buf;
  *out_frames = (long long)frames;
  *out_channels = nch;
  *out_rate = sr;
  *out_bps = bps;
  return 0;
}

}  // extern "C"
