// Thin C shim over the system FFmpeg *libraries* (libavformat/libavcodec
// 59, libavutil 57, libswresample 4 — FFmpeg 5.1 line), compiled against the
// system headers so every struct access is ABI-correct by construction
// (ctypes-only bindings would have to hardcode offsets into AVFrame et al.).
//
// The reference shells out to the ffmpeg BINARY for every format its native
// readers miss (pydub in its analyser.py:73-83; the FFmpeg note at
// raytracer_studio.py:1396).  Binding the libraries directly gives AAC/M4A
// both directions without a binary or a subprocess — and a universal decode
// tier for anything libavformat can demux.  The port's copy of the JAX
// package's file, built at first use by utils/kernels.build_host.
//
// API (all return 0 on success, negative on error; err holds a message):
//   lavc_decode_file  — first audio stream -> interleaved float32 (malloc'd)
//   lavc_probe_file   — rate/channels/duration without decoding samples
//   lavc_encode_aac   — interleaved float32 -> native AAC (ADTS .aac or MP4/
//                       M4A by extension), CBR-ish bit_rate target
//   lavc_free_buffer  — free the decode buffer
//
// Build: g++ -O3 -shared -fPIC lavc_shim.cc -o liblavc_shim.so \
//            -lavformat -lavcodec -lavutil -lswresample

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

// Errors surface through the err-buffer return path; keep libav's own
// stderr chatter (encoder Qavg lines, duration estimates) out of CLI output.
struct QuietLog {
    QuietLog() { av_log_set_level(AV_LOG_QUIET); }
} quiet_log;

void set_err(char *err, int errlen, const char *msg, int averr = 0) {
    if (!err || errlen <= 0) return;
    if (averr != 0) {
        char buf[128];
        av_strerror(averr, buf, sizeof(buf));
        snprintf(err, (size_t)errlen, "%s: %s", msg, buf);
    } else {
        snprintf(err, (size_t)errlen, "%s", msg);
    }
}

struct DecodeCtx {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *dec = nullptr;
    SwrContext *swr = nullptr;
    AVPacket *pkt = nullptr;
    AVFrame *frame = nullptr;
    int swr_rate = 0;   // the rate/format the swr was configured for —
    int swr_fmt = -1;   // mid-stream changes must be refused, not garbled
    ~DecodeCtx() {
        if (swr) swr_free(&swr);
        if (dec) avcodec_free_context(&dec);
        if (fmt) avformat_close_input(&fmt);
        if (pkt) av_packet_free(&pkt);
        if (frame) av_frame_free(&frame);
    }
};

int open_audio_stream(const char *path, DecodeCtx &c, int *stream_index,
                      char *err, int errlen) {
    int ret = avformat_open_input(&c.fmt, path, nullptr, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "cannot open input", ret);
        return -1;
    }
    ret = avformat_find_stream_info(c.fmt, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "cannot read stream info", ret);
        return -1;
    }
    const AVCodec *codec = nullptr;
    ret = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (ret < 0 || !codec) {
        set_err(err, errlen, "no decodable audio stream", ret < 0 ? ret : 0);
        return -1;
    }
    *stream_index = ret;
    c.dec = avcodec_alloc_context3(codec);
    if (!c.dec) {
        set_err(err, errlen, "cannot allocate decoder");
        return -1;
    }
    ret = avcodec_parameters_to_context(c.dec, c.fmt->streams[*stream_index]->codecpar);
    if (ret < 0) {
        set_err(err, errlen, "cannot configure decoder", ret);
        return -1;
    }
    ret = avcodec_open2(c.dec, codec, nullptr);
    if (ret < 0) {
        set_err(err, errlen, "cannot open decoder", ret);
        return -1;
    }
    return 0;
}

// Convert one decoded frame to interleaved float32 and append to out.
int append_frame(DecodeCtx &c, AVFrame *f, std::vector<float> &out,
                 int channels, char *err, int errlen) {
    if (!c.swr) {
        // Output layout = the frame's OWN layout: swr then only converts
        // sample format/interleaving and never rematrixes.  Requesting
        // av_channel_layout_default(n) here silently DOWNMIXED layouts
        // whose mask differs from the n-channel default — Vorbis 3.0
        // (SURROUND)→2.1 folded the center into L/R and zeroed a column,
        // QUAD→4.0 merged the backs (caught by the channel-signature
        // cross-check in the lavcio tests).  Column order stays the
        // layout's mask order (FL FR FC LFE …), the product convention.
        int ret = swr_alloc_set_opts2(
            &c.swr, &f->ch_layout, AV_SAMPLE_FMT_FLT, f->sample_rate,
            &f->ch_layout, (AVSampleFormat)f->format, f->sample_rate, 0, nullptr);
        if (ret < 0 || swr_init(c.swr) < 0) {
            // unspec/ambiguous source layouts can refuse identity init —
            // fall back to the historical default-layout conversion
            if (c.swr) swr_free(&c.swr);
            AVChannelLayout out_layout;
            av_channel_layout_default(&out_layout, channels);
            ret = swr_alloc_set_opts2(
                &c.swr, &out_layout, AV_SAMPLE_FMT_FLT, f->sample_rate,
                &f->ch_layout, (AVSampleFormat)f->format, f->sample_rate, 0,
                nullptr);
            av_channel_layout_uninit(&out_layout);
            if (ret < 0 || swr_init(c.swr) < 0) {
                set_err(err, errlen, "cannot initialize resampler", ret);
                return -1;
            }
        }
        c.swr_rate = f->sample_rate;
        c.swr_fmt = f->format;
    } else if (f->sample_rate != c.swr_rate || f->format != c.swr_fmt) {
        // chained streams (e.g. concatenated Ogg) can switch rate/format
        // mid-file; converting with the stale swr config would silently
        // play sections at the wrong pitch or produce garbage samples
        set_err(err, errlen, "sample rate/format changed mid-stream");
        return -1;
    }
    size_t base = out.size();
    out.resize(base + (size_t)f->nb_samples * channels);
    uint8_t *dst = (uint8_t *)(out.data() + base);
    int got = swr_convert(c.swr, &dst, f->nb_samples,
                          (const uint8_t **)f->extended_data, f->nb_samples);
    if (got < 0) {
        set_err(err, errlen, "sample conversion failed", got);
        return -1;
    }
    out.resize(base + (size_t)got * channels);
    return 0;
}

}  // namespace

extern "C" {

int lavc_decode_file(const char *path, float **out_data, long long *out_frames,
                     int *out_channels, int *out_rate, char *err, int errlen) {
    *out_data = nullptr;
    *out_frames = 0;
    DecodeCtx c;
    int stream_index = -1;
    if (open_audio_stream(path, c, &stream_index, err, errlen) < 0) return -1;

    int channels = c.dec->ch_layout.nb_channels;
    int rate = c.dec->sample_rate;
    if (channels <= 0 || rate <= 0) {
        set_err(err, errlen, "stream has no channel/rate information");
        return -1;
    }
    *out_channels = channels;
    *out_rate = rate;

    c.pkt = av_packet_alloc();
    c.frame = av_frame_alloc();
    std::vector<float> samples;
    int ret;
    bool draining = false;
    auto take_frame = [&]() -> int {
        // a mid-stream channel-count change would silently corrupt the
        // interleave; refuse it (none of the target formats do this)
        if (c.frame->ch_layout.nb_channels != channels) {
            set_err(err, errlen, "channel count changed mid-stream");
            return -1;
        }
        if (append_frame(c, c.frame, samples, channels, err, errlen) < 0)
            return -1;
        av_frame_unref(c.frame);
        return 0;
    };
    while (true) {
        if (!draining) {
            ret = av_read_frame(c.fmt, c.pkt);
            if (ret == AVERROR_EOF) {
                draining = true;
                avcodec_send_packet(c.dec, nullptr);  // enter drain mode
            } else if (ret < 0) {
                set_err(err, errlen, "demux error", ret);
                return -1;
            } else if (c.pkt->stream_index != stream_index) {
                av_packet_unref(c.pkt);
                continue;
            } else {
                // EAGAIN from send_packet means the decoder's input queue
                // is full until output is consumed: drain one frame and
                // RE-SEND the same packet (dropping it would silently
                // truncate audio — same contract as the encoder below)
                for (;;) {
                    ret = avcodec_send_packet(c.dec, c.pkt);
                    if (ret != AVERROR(EAGAIN)) break;
                    int r2 = avcodec_receive_frame(c.dec, c.frame);
                    if (r2 < 0) {
                        av_packet_unref(c.pkt);
                        set_err(err, errlen, "decoder stalled (EAGAIN, no output)", r2);
                        return -1;
                    }
                    if (take_frame() < 0) {
                        av_packet_unref(c.pkt);
                        return -1;
                    }
                }
                av_packet_unref(c.pkt);
                if (ret < 0) {
                    set_err(err, errlen, "decode error", ret);
                    return -1;
                }
            }
        }
        while ((ret = avcodec_receive_frame(c.dec, c.frame)) >= 0) {
            if (take_frame() < 0) return -1;
        }
        if (ret == AVERROR_EOF && draining) break;
        if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF) {
            set_err(err, errlen, "decode error", ret);
            return -1;
        }
    }
    if (samples.empty()) {
        set_err(err, errlen, "no audio frames decoded");
        return -1;
    }
    *out_frames = (long long)(samples.size() / channels);
    *out_data = (float *)malloc(samples.size() * sizeof(float));
    if (!*out_data) {
        set_err(err, errlen, "out of memory");
        return -1;
    }
    memcpy(*out_data, samples.data(), samples.size() * sizeof(float));
    return 0;
}

void lavc_free_buffer(float *p) { free(p); }

int lavc_probe_file(const char *path, long long *out_frames, int *out_channels,
                    int *out_rate, char *err, int errlen) {
    DecodeCtx c;
    int stream_index = -1;
    if (open_audio_stream(path, c, &stream_index, err, errlen) < 0) return -1;
    int rate = c.dec->sample_rate;
    *out_channels = c.dec->ch_layout.nb_channels;
    *out_rate = rate;
    AVStream *st = c.fmt->streams[stream_index];
    long long frames = 0;
    if (st->nb_frames > 0 && c.dec->frame_size > 0) {
        frames = st->nb_frames * c.dec->frame_size;
    } else if (st->duration > 0) {
        frames = av_rescale_q(st->duration, st->time_base, AVRational{1, rate});
    } else if (c.fmt->duration > 0) {
        frames = av_rescale(c.fmt->duration, rate, AV_TIME_BASE);
    }
    *out_frames = frames;  // 0 = unknown (e.g. raw ADTS without a tag)
    return 0;
}

int lavc_encode_aac(const char *path, const float *data, long long frames,
                    int channels, int rate, int bitrate_bps, char *err,
                    int errlen) {
    AVFormatContext *oc = nullptr;
    int ret = avformat_alloc_output_context2(&oc, nullptr, nullptr, path);
    if (ret < 0 || !oc) {
        set_err(err, errlen, "cannot guess output container from filename", ret);
        return -1;
    }
    const AVCodec *codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
    AVCodecContext *enc = codec ? avcodec_alloc_context3(codec) : nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    bool io_open = false;
    bool header_written = false;

    // single cleanup path
    auto fail = [&](const char *msg, int averr) -> int {
        set_err(err, errlen, msg, averr);
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        if (enc) avcodec_free_context(&enc);
        if (oc) {
            if (io_open) avio_closep(&oc->pb);
            avformat_free_context(oc);
        }
        return -1;
    };
    if (!codec || !enc) return fail("native AAC encoder unavailable", 0);

    if (codec->supported_samplerates) {
        bool ok = false;
        for (const int *r = codec->supported_samplerates; *r; ++r)
            if (*r == rate) { ok = true; break; }
        if (!ok) return fail("sample rate not supported by the AAC encoder", 0);
    }
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    enc->sample_rate = rate;
    enc->bit_rate = bitrate_bps;
    enc->time_base = AVRational{1, rate};
    av_channel_layout_default(&enc->ch_layout, channels);
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
        enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    ret = avcodec_open2(enc, codec, nullptr);
    if (ret < 0) return fail("cannot open AAC encoder", ret);

    AVStream *st = avformat_new_stream(oc, nullptr);
    if (!st) return fail("cannot create output stream", 0);
    st->time_base = enc->time_base;
    ret = avcodec_parameters_from_context(st->codecpar, enc);
    if (ret < 0) return fail("cannot export encoder parameters", ret);

    if (!(oc->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&oc->pb, path, AVIO_FLAG_WRITE);
        if (ret < 0) return fail("cannot open output file", ret);
        io_open = true;
    }
    ret = avformat_write_header(oc, nullptr);
    if (ret < 0) return fail("cannot write container header", ret);
    header_written = true;

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    const int frame_size = enc->frame_size > 0 ? enc->frame_size : 1024;
    long long pos = 0;
    bool flushed = false;
    auto write_pkt = [&]() -> int {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        return av_interleaved_write_frame(oc, pkt);
    };
    while (!flushed) {
        AVFrame *send = nullptr;
        if (pos < frames) {
            int n = (int)((frames - pos) < frame_size ? (frames - pos) : frame_size);
            frame->nb_samples = n;
            frame->format = AV_SAMPLE_FMT_FLTP;
            ret = av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
            if (ret < 0) return fail("channel layout copy failed", ret);
            ret = av_frame_get_buffer(frame, 0);
            if (ret < 0) return fail("cannot allocate audio frame", ret);
            for (int ch = 0; ch < channels; ++ch) {
                float *dst = (float *)frame->extended_data[ch];
                const float *src = data + pos * channels + ch;
                for (int i = 0; i < n; ++i) dst[i] = src[(long long)i * channels];
            }
            frame->pts = pos;
            pos += n;
            send = frame;
        }
        // send/receive contract: EAGAIN from send_frame means "the input
        // queue is full until output is consumed" — drain a packet and
        // RE-SEND the same frame (dropping it would silently truncate audio;
        // likewise a flush send must not count as flushed until accepted)
        for (;;) {
            ret = avcodec_send_frame(enc, send);  // nullptr = flush
            if (ret != AVERROR(EAGAIN)) break;
            ret = avcodec_receive_packet(enc, pkt);
            if (ret < 0) return fail("AAC encoder stalled (EAGAIN, no output)", ret);
            ret = write_pkt();
            if (ret < 0) return fail("cannot write encoded packet", ret);
        }
        if (ret < 0) return fail("AAC encode failed", ret);
        if (send == nullptr) flushed = true;
        while ((ret = avcodec_receive_packet(enc, pkt)) >= 0) {
            ret = write_pkt();
            if (ret < 0) return fail("cannot write encoded packet", ret);
        }
        if (ret != AVERROR(EAGAIN) && ret != AVERROR_EOF)
            return fail("AAC encode failed", ret);
        if (send == frame) av_frame_unref(frame);
    }
    (void)header_written;
    ret = av_write_trailer(oc);
    if (ret < 0) return fail("cannot finalize container", ret);

    av_frame_free(&frame);
    av_packet_free(&pkt);
    avcodec_free_context(&enc);
    if (io_open) avio_closep(&oc->pb);
    avformat_free_context(oc);
    return 0;
}

}  // extern "C"
