// libavformat/libavcodec catch-all decoder for track_analyser_tpu.
//
// The reference's decode ladder ends in audioread, which delegates to
// whatever backend the system has — in practice FFmpeg — so it decodes
// M4A/AAC/WMA/anything (reference io.py:91-116). This tier is the
// equivalent: the LAST rung of the codec ladder (io/codecs.py), reached
// only when the first-party WAV/AIFF/FLAC codecs and the
// libmpg123/libvorbisfile bindings all decline. Built as a SEPARATE
// shared library (libta_ffmpeg.so) so libta_native.so never depends on
// the FFmpeg runtime being installed.
//
// Output: interleaved float32 at the stream's native rate (sample-format
// conversion only — the host loader resamples afterwards, matching the
// rest of the ladder).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct DecodeState {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  ~DecodeState() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
  }
};

// Convert one decoded frame to interleaved f32 and append to out.
bool append_frame(DecodeState& s, std::vector<float>& out, int channels) {
  const int n = s.frame->nb_samples;
  if (n <= 0) return true;
  const size_t base = out.size();
  out.resize(base + static_cast<size_t>(n) * channels);
  uint8_t* dst = reinterpret_cast<uint8_t*>(out.data() + base);
  const int got = swr_convert(s.swr, &dst, n,
                              const_cast<const uint8_t**>(s.frame->extended_data),
                              n);
  if (got < 0) return false;
  out.resize(base + static_cast<size_t>(got) * channels);
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success; caller owns *out (free with ta_ffmpeg_free).
int ta_ffmpeg_decode(const char* path, float** out, int64_t* out_frames,
                     int* out_channels, int* out_sample_rate,
                     char* codec_name, int codec_name_len) {
  DecodeState s;
  av_log_set_level(AV_LOG_QUIET);
  if (avformat_open_input(&s.fmt, path, nullptr, nullptr) < 0) return 1;
  if (avformat_find_stream_info(s.fmt, nullptr) < 0) return 2;
  const int sidx =
      av_find_best_stream(s.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (sidx < 0) return 3;
  AVStream* st = s.fmt->streams[sidx];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) return 4;
  s.ctx = avcodec_alloc_context3(codec);
  if (!s.ctx || avcodec_parameters_to_context(s.ctx, st->codecpar) < 0) return 5;
  if (avcodec_open2(s.ctx, codec, nullptr) < 0) return 6;

  const int channels = s.ctx->ch_layout.nb_channels;
  const int sr = s.ctx->sample_rate;
  if (channels <= 0 || sr <= 0) return 7;

  AVChannelLayout out_layout;
  if (av_channel_layout_copy(&out_layout, &s.ctx->ch_layout) < 0) return 8;
  int rc = swr_alloc_set_opts2(&s.swr, &out_layout, AV_SAMPLE_FMT_FLT, sr,
                               &s.ctx->ch_layout, s.ctx->sample_fmt, sr, 0,
                               nullptr);
  av_channel_layout_uninit(&out_layout);
  if (rc < 0 || swr_init(s.swr) < 0) return 9;

  s.pkt = av_packet_alloc();
  s.frame = av_frame_alloc();
  if (!s.pkt || !s.frame) return 10;

  std::vector<float> samples;
  samples.reserve(static_cast<size_t>(sr) * channels);  // ~1 s head start

  // Corrupt packets must not be silently dropped: skipped audio shifts
  // every later beat/boundary time while still reporting success. A tiny
  // tolerance absorbs the odd mangled packet real-world streams carry;
  // past it the decode fails so the ladder raises its RuntimeError.
  // Both SEND-side rejections and RECEIVE-side decode errors count —
  // many codecs accept the packet and only report corruption when the
  // frame is retrieved.
  int64_t audio_packets = 0;
  int64_t bad_packets = 0;

  // Drain available frames; returns false on the append-failure hard
  // error, increments bad_packets on a receive-side decode error.
  auto drain = [&]() -> bool {
    for (;;) {
      const int rret = avcodec_receive_frame(s.ctx, s.frame);
      if (rret == 0) {
        if (!append_frame(s, samples, channels)) return false;
        continue;
      }
      if (rret != AVERROR(EAGAIN) && rret != AVERROR_EOF) ++bad_packets;
      return true;
    }
  };

  while (av_read_frame(s.fmt, s.pkt) >= 0) {
    if (s.pkt->stream_index == sidx) {
      ++audio_packets;
      int sret = avcodec_send_packet(s.ctx, s.pkt);
      if (sret == AVERROR(EAGAIN)) {
        // Decoder wants draining first; drain, then retry the packet.
        if (!drain()) {
          av_packet_unref(s.pkt);
          return 11;
        }
        sret = avcodec_send_packet(s.ctx, s.pkt);
      }
      if (sret < 0) {
        ++bad_packets;
      } else if (!drain()) {
        av_packet_unref(s.pkt);
        return 11;
      }
    }
    av_packet_unref(s.pkt);
  }
  if (bad_packets > 2 && bad_packets * 50 > audio_packets) return 14;
  // flush the decoder
  if (avcodec_send_packet(s.ctx, nullptr) == 0) {
    if (!drain()) return 11;
  }

  const int64_t frames = static_cast<int64_t>(samples.size()) / channels;
  if (frames == 0) return 12;
  float* buf = static_cast<float*>(std::malloc(samples.size() * sizeof(float)));
  if (!buf) return 13;
  std::memcpy(buf, samples.data(), samples.size() * sizeof(float));
  *out = buf;
  *out_frames = frames;
  *out_channels = channels;
  *out_sample_rate = sr;
  if (codec_name && codec_name_len > 0) {
    std::strncpy(codec_name, codec->name ? codec->name : "unknown",
                 codec_name_len - 1);
    codec_name[codec_name_len - 1] = '\0';
  }
  return 0;
}

void ta_ffmpeg_free(float* buf) { std::free(buf); }

}  // extern "C"
