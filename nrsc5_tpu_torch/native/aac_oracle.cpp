// External-oracle AAC decoder: a thin shim over the system libavcodec.
//
// The clean-room HDC codec (nrsc5_tpu/audio/) is otherwise only verified
// against this repo's own encoder (roundtrips) — a shared
// encoder<->decoder misunderstanding would pass every roundtrip test.
// tx/hdc_encoder.HDCEncoder.encode_frame_dual() serializes the SAME
// frame plan as a standard AAC-LC / HE-AAC ADTS stream; this shim
// decodes that stream with ffmpeg's independent, battle-tested decoder
// so tests can pin PCM agreement (reference analog: the patched FAAD2
// decoder behind src/output.c:126-163).
//
// Built lazily by nrsc5_tpu/audio/oracle.py:
//   c++ -O2 -shared -fPIC aac_oracle.cpp -lavcodec -lavutil -o ...

#include <cstring>
#include <cstdint>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>
}

extern "C" {

// Decode an entire ADTS byte stream to interleaved float PCM.
// Returns total samples per channel (>= 0) or a negative error code.
// out receives interleaved float32 (cap in floats); nch/rate report the
// decoded stream layout.
long long aac_oracle_decode(const unsigned char *data, long long len,
                            float *out, long long out_cap,
                            int *nch_out, int *rate_out) {
    const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_AAC);
    if (!codec) return -1;
    AVCodecContext *ctx = avcodec_alloc_context3(codec);
    if (!ctx) return -2;
    AVCodecParserContext *parser = av_parser_init(AV_CODEC_ID_AAC);
    AVPacket *pkt = av_packet_alloc();
    AVFrame *frame = av_frame_alloc();
    long long written = 0;  // floats written
    int nch = 0, rate = 0;
    int rc = 0;

    if (!parser || !pkt || !frame || avcodec_open2(ctx, codec, nullptr) < 0) {
        rc = -3;
        goto done;
    }

    {
        const uint8_t *cur = data;
        long long remaining = len;
        bool flushed = false;
        while (!flushed) {
            if (remaining > 0) {
                uint8_t *obuf = nullptr;
                int osize = 0;
                int used = av_parser_parse2(parser, ctx, &obuf, &osize,
                                            cur, (int)remaining,
                                            AV_NOPTS_VALUE, AV_NOPTS_VALUE, 0);
                if (used < 0) { rc = -4; goto done; }
                cur += used;
                remaining -= used;
                if (osize == 0) continue;
                pkt->data = obuf;
                pkt->size = osize;
                if (avcodec_send_packet(ctx, pkt) < 0) { rc = -5; goto done; }
            } else {
                avcodec_send_packet(ctx, nullptr);  // flush
                flushed = true;
            }
            while (true) {
                int r = avcodec_receive_frame(ctx, frame);
                if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
                if (r < 0) { rc = -6; goto done; }
                int fn = frame->ch_layout.nb_channels;
                if (nch == 0) { nch = fn; rate = frame->sample_rate; }
                // on implicit-SBR reconfiguration keep the LAST layout;
                // callers send SBR from frame 0 so this stays stable
                nch = fn;
                rate = frame->sample_rate;
                long long n = frame->nb_samples;
                if (frame->format != AV_SAMPLE_FMT_FLTP) { rc = -7; goto done; }
                if (written + n * fn > out_cap) { rc = -8; goto done; }
                for (long long i = 0; i < n; i++)
                    for (int c = 0; c < fn; c++)
                        out[written + i * fn + c] =
                            ((const float *)frame->extended_data[c])[i];
                written += n * fn;
                av_frame_unref(frame);
            }
        }
    }

done:
    if (parser) av_parser_close(parser);
    av_packet_free(&pkt);
    av_frame_free(&frame);
    avcodec_free_context(&ctx);
    if (rc < 0) return rc;
    if (nch_out) *nch_out = nch;
    if (rate_out) *rate_out = rate;
    return nch ? written / nch : 0;
}

}  // extern "C"
