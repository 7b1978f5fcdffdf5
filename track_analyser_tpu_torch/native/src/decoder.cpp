// Native audio decode fast path for track_analyser_tpu.
//
// The host data pipeline (decode + frame assembly) is the one part of the
// framework that can never run on the TPU; this library keeps it off the
// Python interpreter. Exposed via a minimal C ABI consumed with ctypes
// (track_analyser_tpu_torch/native/binding.py).
//
// Formats: RIFF/WAVE — PCM 8/16/24/32, IEEE float32/64, and
// WAVE_FORMAT_EXTENSIBLE wrapping either. A decode is two calls: the
// header first (ta_wav_info: shape, rate, format), so the caller can
// allocate, then one pass over the data chunk (ta_wav_read) that writes
// channel-major float32 planes in [-1, 1) and, on request, their mono
// downmix straight into the caller's arrays. The samples match the numpy
// codec (io/codecs.py) bit for bit, and the downmix numpy's
// planes.mean(axis=0): the channels summed in order in float32, then
// divided by float32(channels).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kFormatPcm = 0x0001;
constexpr uint16_t kFormatFloat = 0x0003;
constexpr uint16_t kFormatExtensible = 0xFFFE;

// Sources of at least this many frames split the pass over kThreads
// threads; shorter ones (a 30 s clip) take one, so concurrent decodes do
// not oversubscribe the host.
constexpr long long kThreadedFrames = 1LL << 21;
constexpr int kThreads = 4;
// Frames read and converted at a time: the raw bytes, the planes' and the
// downmix's slices of a block stay in cache between the steps.
constexpr long long kBlockFrames = 8192;

uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t le16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

struct Fd {
  int fd;
  explicit Fd(const char* path) : fd(::open(path, O_RDONLY | O_CLOEXEC)) {}
  ~Fd() {
    if (fd >= 0) ::close(fd);
  }
};

// pread until n bytes are in or the file ends; true when all n arrived.
bool read_at(int fd, void* out, size_t n, off_t offset) {
  auto* dst = static_cast<uint8_t*>(out);
  while (n > 0) {
    ssize_t got = ::pread(fd, dst, n, offset);
    if (got <= 0) return false;
    dst += got;
    offset += got;
    n -= static_cast<size_t>(got);
  }
  return true;
}

// One sample to float32, the numpy codec's law for each subtype.
struct Pcm16 {
  static constexpr size_t kBytes = 2;
  float operator()(const uint8_t* p) const {
    int16_t v;
    std::memcpy(&v, p, 2);
    return static_cast<float>(v) * (1.0f / 32768.0f);
  }
};
struct Pcm24 {
  static constexpr size_t kBytes = 3;
  float operator()(const uint8_t* p) const {
    int32_t v = static_cast<int32_t>((static_cast<uint32_t>(p[0]) << 8) |
                                     (static_cast<uint32_t>(p[1]) << 16) |
                                     (static_cast<uint32_t>(p[2]) << 24));
    return static_cast<float>(v >> 8) * (1.0f / 8388608.0f);
  }
};
struct Pcm32 {
  static constexpr size_t kBytes = 4;
  float operator()(const uint8_t* p) const {
    int32_t v;
    std::memcpy(&v, p, 4);
    return static_cast<float>(v * (1.0 / 2147483648.0));
  }
};
struct PcmU8 {
  static constexpr size_t kBytes = 1;
  float operator()(const uint8_t* p) const {
    return (static_cast<float>(p[0]) - 128.0f) * (1.0f / 128.0f);
  }
};
struct Float32 {
  static constexpr size_t kBytes = 4;
  float operator()(const uint8_t* p) const {
    float v;
    std::memcpy(&v, p, 4);
    return v;
  }
};
struct Float64 {
  static constexpr size_t kBytes = 8;
  float operator()(const uint8_t* p) const {
    double v;
    std::memcpy(&v, p, 8);
    return static_cast<float>(v);
  }
};

struct Job {
  int fd;
  off_t data_offset;
  long long frames;  // the planes' row length
  int channels;
  float* planes;
  float* mono;  // null: planes only
};

// Frames [f0, f1) of the data chunk into the planes (and the downmix).
template <class Conv>
bool convert(const Job& job, long long f0, long long f1) {
  const int channels = job.channels;
  const size_t frame_bytes = Conv::kBytes * static_cast<size_t>(channels);
  std::vector<uint8_t> raw(static_cast<size_t>(kBlockFrames) * frame_bytes);
  const Conv conv;
  for (long long f = f0; f < f1; f += kBlockFrames) {
    const long long n = std::min(kBlockFrames, f1 - f);
    if (!read_at(job.fd, raw.data(), static_cast<size_t>(n) * frame_bytes,
                 job.data_offset + static_cast<off_t>(f) * static_cast<off_t>(frame_bytes))) {
      return false;
    }
    for (int c = 0; c < channels; ++c) {
      const uint8_t* src = raw.data() + Conv::kBytes * static_cast<size_t>(c);
      float* out = job.planes + c * job.frames + f;
      for (long long i = 0; i < n; ++i) out[i] = conv(src + static_cast<size_t>(i) * frame_bytes);
    }
    if (job.mono) {
      float* m = job.mono + f;
      const float* first = job.planes + f;
      std::memcpy(m, first, static_cast<size_t>(n) * sizeof(float));
      for (int c = 1; c < channels; ++c) {
        const float* plane = job.planes + c * job.frames + f;
        for (long long i = 0; i < n; ++i) m[i] += plane[i];
      }
      const float k = static_cast<float>(channels);
      for (long long i = 0; i < n; ++i) m[i] = m[i] / k;
    }
  }
  return true;
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

// FLAC's interleaved output (flac.cpp) is malloc'd; the caller frees it.
void ta_free(float* ptr) { std::free(ptr); }

// Parse the RIFF/WAVE header of `path`. Returns 0 on success with the
// whole frames of the data chunk (a trailing partial frame is dropped),
// the channels, the rate, the subtype code and the data chunk's byte
// offset; non-zero where the file is no WAV this library converts.
int ta_wav_info(const char* path, long long* out_frames, int* out_channels,
                int* out_sample_rate, int* out_subtype, long long* out_data_offset) {
  if (!path) return 1;
  Fd file(path);
  if (file.fd < 0) return 2;
  struct stat st;
  if (::fstat(file.fd, &st) != 0) return 2;
  const size_t size = static_cast<size_t>(st.st_size);
  if (size < 12) return 3;
  uint8_t head[12];
  if (!read_at(file.fd, head, 12, 0)) return 4;
  if (std::memcmp(head, "RIFF", 4) != 0 || std::memcmp(head + 8, "WAVE", 4) != 0) return 5;

  uint16_t format_tag = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  bool has_data = false;
  size_t data_pos = 0, data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= size) {
    uint8_t chunk[8];
    if (!read_at(file.fd, chunk, 8, static_cast<off_t>(pos))) return 4;
    uint32_t chunk_size = le32(chunk + 4);
    size_t body = pos + 8;
    if (body + chunk_size > size) chunk_size = static_cast<uint32_t>(size - body);

    if (std::memcmp(chunk, "fmt ", 4) == 0 && chunk_size >= 16) {
      uint8_t fmt[40];
      if (!read_at(file.fd, fmt, std::min<size_t>(chunk_size, 40), static_cast<off_t>(body))) return 4;
      format_tag = le16(fmt);
      channels = le16(fmt + 2);
      sample_rate = le32(fmt + 4);
      bits = le16(fmt + 14);
      if (format_tag == kFormatExtensible && chunk_size >= 40) {
        format_tag = le16(fmt + 24);  // SubFormat GUID head
      }
    } else if (std::memcmp(chunk, "data", 4) == 0) {
      has_data = true;
      data_pos = body;
      data_len = chunk_size;
    }
    pos = body + chunk_size + (chunk_size & 1);
  }

  if (!has_data || channels == 0 || sample_rate == 0) return 6;
  const size_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) return 7;

  int subtype = TA_SUBTYPE_UNKNOWN;
  if (format_tag == kFormatPcm && bits == 16) subtype = TA_SUBTYPE_PCM16;
  else if (format_tag == kFormatPcm && bits == 24) subtype = TA_SUBTYPE_PCM24;
  else if (format_tag == kFormatPcm && bits == 32) subtype = TA_SUBTYPE_PCM32;
  else if (format_tag == kFormatPcm && bits == 8) subtype = TA_SUBTYPE_PCMU8;
  else if (format_tag == kFormatFloat && bits == 32) subtype = TA_SUBTYPE_FLOAT;
  else if (format_tag == kFormatFloat && bits == 64) subtype = TA_SUBTYPE_DOUBLE;
  else return 9;  // unsupported format — numpy codec ladder takes over

  *out_frames = static_cast<long long>(data_len / bytes_per_sample / channels);
  *out_channels = channels;
  *out_sample_rate = static_cast<int>(sample_rate);
  *out_subtype = subtype;
  *out_data_offset = static_cast<long long>(data_pos);
  return 0;
}

// One pass over the data chunk that ta_wav_info described: `planes`
// (channels x frames float32, channel-major) and, where `mono` is not
// null, `mono` (frames float32, the planes' mean over channels). Sources
// of kThreadedFrames or more split the frames over kThreads threads.
// Returns 0 on success; non-zero where the file no longer holds the data.
int ta_wav_read(const char* path, long long data_offset, long long frames, int channels,
                int subtype, float* planes, float* mono) {
  if (!path || channels <= 0 || frames < 0 || (frames > 0 && !planes)) return 1;
  Fd file(path);
  if (file.fd < 0) return 2;
  const Job job{file.fd, static_cast<off_t>(data_offset), frames, channels, planes, mono};
  bool (*run)(const Job&, long long, long long) = nullptr;
  switch (subtype) {
    case TA_SUBTYPE_PCM16: run = convert<Pcm16>; break;
    case TA_SUBTYPE_PCM24: run = convert<Pcm24>; break;
    case TA_SUBTYPE_PCM32: run = convert<Pcm32>; break;
    case TA_SUBTYPE_PCMU8: run = convert<PcmU8>; break;
    case TA_SUBTYPE_FLOAT: run = convert<Float32>; break;
    case TA_SUBTYPE_DOUBLE: run = convert<Float64>; break;
    default: return 9;
  }
  const int threads = frames >= kThreadedFrames ? kThreads : 1;
  if (threads == 1) return run(job, 0, frames) ? 0 : 4;
  std::atomic<bool> ok{true};
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    const long long f0 = frames * t / threads, f1 = frames * (t + 1) / threads;
    try {
      pool.emplace_back([&, f0, f1] {
        if (!run(job, f0, f1)) ok = false;
      });
    } catch (...) {  // no thread to be had: this one converts the range
      if (!run(job, f0, f1)) ok = false;
    }
  }
  for (auto& th : pool) th.join();
  return ok ? 0 : 4;
}

}  // extern "C"
