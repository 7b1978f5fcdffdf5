// Native audio decode fast path for track_analyser_tpu.
//
// The host data pipeline (decode + frame assembly) is the one part of the
// framework that can never run on the TPU; this library keeps it off the
// Python interpreter. Exposed via a minimal C ABI consumed with ctypes
// (track_analyser_tpu/native/binding.py).
//
// Formats: RIFF/WAVE — PCM 8/16/24/32, IEEE float32/64, and
// WAVE_FORMAT_EXTENSIBLE wrapping either. Output is interleaved float32
// frames in [-1, 1), matching the numpy codec (io/codecs.py) bit-for-bit
// so the two tiers are interchangeable.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kFormatPcm = 0x0001;
constexpr uint16_t kFormatFloat = 0x0003;
constexpr uint16_t kFormatExtensible = 0xFFFE;

struct Reader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;

  bool read(void* out, size_t n) {
    if (pos + n > size) return false;
    std::memcpy(out, data + pos, n);
    pos += n;
    return true;
  }
  bool skip(size_t n) {
    if (pos + n > size) return false;
    pos += n;
    return true;
  }
};

uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t le16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

}  // namespace

extern "C" {

// Subtype codes shared with binding.py.
enum TaSubtype {
  TA_SUBTYPE_UNKNOWN = 0,
  TA_SUBTYPE_PCM16 = 1,
  TA_SUBTYPE_PCM24 = 2,
  TA_SUBTYPE_PCM32 = 3,
  TA_SUBTYPE_FLOAT = 4,
  TA_SUBTYPE_DOUBLE = 5,
  TA_SUBTYPE_PCMU8 = 6,
};

void ta_free(float* ptr) { std::free(ptr); }

// Returns 0 on success. On success *out holds malloc'd interleaved
// float32 (frames x channels); caller frees with ta_free.
int ta_decode_wav(const char* path, float** out, long long* out_frames,
                  int* out_channels, int* out_sample_rate, int* out_subtype) {
  if (!path || !out) return 1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 2;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 12) {
    std::fclose(f);
    return 3;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return 4;

  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    return 5;
  }

  uint16_t format_tag = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* data_ptr = nullptr;
  size_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* chunk_id = buf.data() + pos;
    uint32_t chunk_size = le32(buf.data() + pos + 4);
    size_t body = pos + 8;
    if (body + chunk_size > buf.size()) chunk_size = static_cast<uint32_t>(buf.size() - body);

    if (std::memcmp(chunk_id, "fmt ", 4) == 0 && chunk_size >= 16) {
      format_tag = le16(buf.data() + body);
      channels = le16(buf.data() + body + 2);
      sample_rate = le32(buf.data() + body + 4);
      bits = le16(buf.data() + body + 14);
      if (format_tag == kFormatExtensible && chunk_size >= 40) {
        format_tag = le16(buf.data() + body + 24);  // SubFormat GUID head
      }
    } else if (std::memcmp(chunk_id, "data", 4) == 0) {
      data_ptr = buf.data() + body;
      data_len = chunk_size;
    }
    pos = body + chunk_size + (chunk_size & 1);
  }

  if (!data_ptr || channels == 0 || sample_rate == 0) return 6;

  size_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) return 7;
  size_t n_samples = data_len / bytes_per_sample;
  size_t frames = n_samples / channels;
  n_samples = frames * channels;

  float* result = static_cast<float*>(std::malloc(n_samples * sizeof(float)));
  if (!result && n_samples > 0) return 8;

  int subtype = TA_SUBTYPE_UNKNOWN;
  if (format_tag == kFormatPcm && bits == 16) {
    subtype = TA_SUBTYPE_PCM16;
    const float k = 1.0f / 32768.0f;
    for (size_t i = 0; i < n_samples; ++i) {
      int16_t v;
      std::memcpy(&v, data_ptr + 2 * i, 2);
      result[i] = static_cast<float>(v) * k;
    }
  } else if (format_tag == kFormatPcm && bits == 24) {
    subtype = TA_SUBTYPE_PCM24;
    const float k = 1.0f / 8388608.0f;
    for (size_t i = 0; i < n_samples; ++i) {
      const uint8_t* p = data_ptr + 3 * i;
      int32_t v = static_cast<int32_t>(
          (static_cast<uint32_t>(p[0]) << 8) | (static_cast<uint32_t>(p[1]) << 16) |
          (static_cast<uint32_t>(p[2]) << 24));
      result[i] = static_cast<float>(v >> 8) * k;
    }
  } else if (format_tag == kFormatPcm && bits == 32) {
    subtype = TA_SUBTYPE_PCM32;
    const double k = 1.0 / 2147483648.0;
    for (size_t i = 0; i < n_samples; ++i) {
      int32_t v;
      std::memcpy(&v, data_ptr + 4 * i, 4);
      result[i] = static_cast<float>(v * k);
    }
  } else if (format_tag == kFormatPcm && bits == 8) {
    subtype = TA_SUBTYPE_PCMU8;
    const float k = 1.0f / 128.0f;
    for (size_t i = 0; i < n_samples; ++i) {
      result[i] = (static_cast<float>(data_ptr[i]) - 128.0f) * k;
    }
  } else if (format_tag == kFormatFloat && bits == 32) {
    subtype = TA_SUBTYPE_FLOAT;
    std::memcpy(result, data_ptr, n_samples * sizeof(float));
  } else if (format_tag == kFormatFloat && bits == 64) {
    subtype = TA_SUBTYPE_DOUBLE;
    for (size_t i = 0; i < n_samples; ++i) {
      double v;
      std::memcpy(&v, data_ptr + 8 * i, 8);
      result[i] = static_cast<float>(v);
    }
  } else {
    std::free(result);
    return 9;  // unsupported format — numpy codec ladder takes over
  }

  *out = result;
  *out_frames = static_cast<long long>(frames);
  *out_channels = channels;
  *out_sample_rate = static_cast<int>(sample_rate);
  if (out_subtype) *out_subtype = subtype;
  return 0;
}

}  // extern "C"
