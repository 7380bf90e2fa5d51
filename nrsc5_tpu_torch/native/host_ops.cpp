// Native host-side transport kernels (C ABI, bound via ctypes).
//
// The reference implements its whole transport layer in C (src/frame.c,
// src/output.c); in this framework the transport runs on the host next to
// the TPU compute path, and these kernels keep the per-packet byte work
// (CRC scans, HDLC delimiting/unescaping, PDU packet extraction) native so
// multi-station real-time factors aren't bounded by the Python interpreter.
//
// Build: cc -O2 -shared -fPIC host_ops.cpp -o libnrsc5host.so
// (see nrsc5_tpu/native/__init__.py for the lazy build + fallback.)

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-8, poly 0x31 MSB-first, init 0xFF (reference: src/frame.c:60-136)
// ---------------------------------------------------------------------------
static uint8_t crc8_table[256];
static int crc8_init_done = 0;

static void crc8_init() {
    for (int i = 0; i < 256; i++) {
        uint8_t c = (uint8_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x31) : (uint8_t)(c << 1);
        crc8_table[i] = c;
    }
    crc8_init_done = 1;
}

uint8_t nrsc5_crc8(const uint8_t* data, size_t len) {
    if (!crc8_init_done) crc8_init();  // also run at load, see _init_all
    uint8_t c = 0xFF;
    for (size_t i = 0; i < len; i++)
        c = crc8_table[c ^ data[i]];
    return c;
}

// Batched CRC check over packets at given offsets/lengths (+1 CRC byte).
// results[i] = 1 if packet i fails its CRC.
void nrsc5_crc8_packets(const uint8_t* buf, const int32_t* offsets,
                        const int32_t* lengths, int n, uint8_t* bad) {
    for (int i = 0; i < n; i++)
        bad[i] = nrsc5_crc8(buf + offsets[i], (size_t)lengths[i] + 1) != 0;
}

// ---------------------------------------------------------------------------
// HDLC FCS-16 (X.25, reflected 0x8408; reference: src/frame.c:138-144)
// ---------------------------------------------------------------------------
static uint16_t fcs_table[256];
static int fcs_init_done = 0;

static void fcs_init() {
    for (int i = 0; i < 256; i++) {
        uint16_t c = (uint16_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (uint16_t)((c >> 1) ^ 0x8408) : (uint16_t)(c >> 1);
        fcs_table[i] = c;
    }
    fcs_init_done = 1;
}

uint16_t nrsc5_fcs16(const uint8_t* data, size_t len) {
    if (!fcs_init_done) fcs_init();
    uint16_t c = 0xFFFF;
    for (size_t i = 0; i < len; i++)
        c = (uint16_t)((c >> 8) ^ fcs_table[(c ^ data[i]) & 0xFF]);
    return c;
}

// ---------------------------------------------------------------------------
// HDLC unescape (0x7D escape; reference: src/frame.c:328-341)
// out must have room for len bytes.  Returns output length.
// ---------------------------------------------------------------------------
size_t nrsc5_hdlc_unescape(const uint8_t* data, size_t len, uint8_t* out) {
    size_t o = 0;
    for (size_t i = 0; i < len; i++) {
        if (data[i] == 0x7D && i + 1 < len) {
            out[o++] = data[i + 1] | 0x20;
            i++;
        } else {
            out[o++] = data[i];
        }
    }
    return o;
}

// ---------------------------------------------------------------------------
// HDLC frame splitter: scan a byte region for 0x7E-delimited frames.
// Emits (start, length) pairs of the raw (still-escaped) frame bodies that
// are CLOSED within the region; `carry` semantics are handled by the
// caller.  Returns the number of frames found; starts/lengths arrays must
// hold at most len/2+1 entries.
// ---------------------------------------------------------------------------
int nrsc5_hdlc_split(const uint8_t* data, size_t len,
                     int32_t* starts, int32_t* lengths) {
    int n = 0;
    long start = -1;
    for (size_t i = 0; i < len; i++) {
        if (data[i] == 0x7E) {
            if (start >= 0) {
                starts[n] = (int32_t)start;
                lengths[n] = (int32_t)(i - (size_t)start);
                n++;
            }
            start = (long)i + 1;
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Unescape + FCS check + protocol filter in one pass: returns payload
// length (without FCS) if the frame is a valid AAS frame (protocol 0x21),
// else 0.  out must have room for len bytes.
// (reference: src/frame.c:343-367)
// ---------------------------------------------------------------------------
size_t nrsc5_aas_frame(const uint8_t* data, size_t len, uint8_t* out) {
    size_t n = nrsc5_hdlc_unescape(data, len, out);
    if (n < 4) return 0;             // proto + 2 FCS minimum, allow empty
    if (nrsc5_fcs16(out, n) != 0xF0B8) return 0;
    if (out[0] != 0x21) return 0;
    return n - 2;                     // strip FCS
}

// ---------------------------------------------------------------------------
// Gather-and-pack: out[k/8] accumulates bits[idx[k]] MSB-first.  This is
// frame_unpack's bit-order swap + payload packbits fused into one pass
// (reference bit reorder: src/frame.c:645-711).  n need not be a multiple
// of 8; the final partial byte is zero-padded (numpy packbits semantics).
// ---------------------------------------------------------------------------
void nrsc5_gather_pack(const uint8_t* bits, const int32_t* idx, int n,
                       uint8_t* out) {
    int nbytes = (n + 7) / 8;
    memset(out, 0, (size_t)nbytes);
    for (int k = 0; k < n; k++)
        out[k >> 3] |= (uint8_t)((bits[idx[k]] & 1) << (7 - (k & 7)));
}

// ---------------------------------------------------------------------------
// Shortened RS(255,247) PDU-header decoder (8 parity, gfpoly 0x11d, fcr=1).
// Textbook syndrome -> Berlekamp-Massey -> Chien -> Forney, same algorithm
// as the batched numpy implementation in ops/rs.py (which is the tested
// spec); this native path exists because the per-PDU codewords arrive one
// at a time on the host transport thread.  Layout: buf[j] = coefficient of
// x^j for j = 0..95 (parity first), the remaining 159 coefficients zero
// (reference framing: src/frame.c:158-179, src/frame.h:5-8).
// ---------------------------------------------------------------------------
static uint8_t gf_exp[512];
static int16_t gf_log[256];
static int gf_init_done = 0;

static void gf_init() {
    int x = 1;
    for (int i = 0; i < 255; i++) {
        gf_exp[i] = (uint8_t)x;
        gf_log[x] = (int16_t)i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11d;
    }
    for (int i = 255; i < 510; i++) gf_exp[i] = gf_exp[i - 255];
    gf_log[0] = -1;
    gf_init_done = 1;
}

static inline uint8_t gf_mul(uint8_t a, uint8_t b) {
    if (a == 0 || b == 0) return 0;
    return gf_exp[gf_log[a] + gf_log[b]];
}

static inline uint8_t gf_div(uint8_t a, uint8_t b) {
    if (a == 0) return 0;
    return gf_exp[gf_log[a] + 255 - gf_log[b]];
}

#define RS_NROOTS 8
#define RS_DATA 96

// Decode one codeword in place.  Returns -1 on failure (buf unchanged),
// else the number of corrected bytes.
static int rs_decode_one(uint8_t* buf) {
    if (!gf_init_done) gf_init();

    uint8_t syn[RS_NROOTS];
    int any = 0;
    for (int i = 0; i < RS_NROOTS; i++) {
        uint8_t s = 0;
        for (int j = 0; j < RS_DATA; j++) {
            if (buf[j])
                s ^= gf_exp[(gf_log[buf[j]] + (i + 1) * j) % 255];
        }
        syn[i] = s;
        any |= s;
    }
    if (!any) return 0;

    // Berlekamp-Massey (classic form with inversion).
    uint8_t C[RS_NROOTS + 1] = {1}, B[RS_NROOTS + 1] = {1}, T[RS_NROOTS + 1];
    int L = 0, m = 1;
    uint8_t b = 1;
    for (int n = 0; n < RS_NROOTS; n++) {
        uint8_t d = syn[n];
        for (int i = 1; i <= L && i <= RS_NROOTS; i++)
            d ^= gf_mul(C[i], syn[n - i]);
        if (d == 0) {
            m++;
        } else if (2 * L <= n) {
            memcpy(T, C, sizeof(C));
            uint8_t coef = gf_div(d, b);
            for (int i = 0; i + m <= RS_NROOTS; i++)
                C[i + m] ^= gf_mul(coef, B[i]);
            L = n + 1 - L;
            memcpy(B, T, sizeof(B));
            b = d;
            m = 1;
        } else {
            uint8_t coef = gf_div(d, b);
            for (int i = 0; i + m <= RS_NROOTS; i++)
                C[i + m] ^= gf_mul(coef, B[i]);
            m++;
        }
    }
    if (L > RS_NROOTS / 2) return -1;

    // Chien search over the full field; errors must land in 0..95.
    int pos[RS_NROOTS / 2];
    int nroots = 0;
    for (int p = 0; p < 255; p++) {
        uint8_t v = 0;
        for (int i = 0; i <= L; i++) {
            if (C[i])
                v ^= gf_exp[(gf_log[C[i]] + ((255 - p) % 255) * i) % 255];
        }
        if (v == 0) {
            if (p >= RS_DATA || nroots >= RS_NROOTS / 2) return -1;
            pos[nroots++] = p;
        }
    }
    if (nroots != L) return -1;

    // Forney (fcr = 1): omega(x) = S(x) C(x) mod x^8;
    // err[p] = omega(X^-1) / C'(X^-1), X = alpha^p.
    uint8_t omega[RS_NROOTS];
    for (int i = 0; i < RS_NROOTS; i++) {
        uint8_t acc = 0;
        for (int j = 0; j <= i && j <= RS_NROOTS; j++)
            acc ^= gf_mul(C[j], syn[i - j]);
        omega[i] = acc;
    }
    for (int k = 0; k < nroots; k++) {
        int p = pos[k];
        int ip = (255 - p) % 255; // log of X^-1
        uint8_t num = 0, den = 0;
        for (int i = 0; i < RS_NROOTS; i++)
            if (omega[i])
                num ^= gf_exp[(gf_log[omega[i]] + ip * i) % 255];
        for (int i = 1; i <= RS_NROOTS; i += 2)
            if (C[i])
                den ^= gf_exp[(gf_log[C[i]] + ip * (i - 1)) % 255];
        if (den == 0) return -1;
        buf[p] ^= gf_div(num, den);
    }
    return nroots;
}

// Batched in-place decode: bufs = n x 96 bytes.  ok[i] in {0,1};
// ncorr[i] = corrected byte count (0 when ok[i] == 0; data restored).
void nrsc5_rs_decode_pdu(uint8_t* bufs, int n, uint8_t* ok, int32_t* ncorr) {
    for (int i = 0; i < n; i++) {
        uint8_t* cw = bufs + (size_t)i * RS_DATA;
        uint8_t save[RS_DATA];
        memcpy(save, cw, RS_DATA);
        int r = rs_decode_one(cw);
        if (r < 0) {
            memcpy(cw, save, RS_DATA);
            ok[i] = 0;
            ncorr[i] = 0;
        } else {
            ok[i] = 1;
            ncorr[i] = r;
        }
    }
}

// ---------------------------------------------------------------------------
// HDC spectral huffman section decode (hot path of the audio decoder;
// mirrors nrsc5_tpu/audio/hdc_decoder._parse_spectral's inner loop —
// bitstream layout per tuple: codeword, then sign bits for the nonzero
// magnitudes, then escapes for |v|==16 in the escape book).
// ---------------------------------------------------------------------------

// Zero-padded MSB-first peek of up to 32 bits at arbitrary bit position
// (matches audio/bitio.py's read-past-end-returns-zero semantics).
static inline uint32_t hdc_peek(const uint8_t* d, long nbytes, long pos,
                                int k) {
    if (k <= 0) return 0;
    uint64_t v = 0;
    long byte = pos >> 3;
    for (int i = 0; i < 8; i++) {
        uint64_t b = (byte + i >= 0 && byte + i < nbytes)
                         ? d[byte + i] : 0;
        v = (v << 8) | b;
    }
    int shift = 64 - (int)(pos & 7) - k;
    return (uint32_t)((v >> shift) & ((k == 32) ? 0xFFFFFFFFu
                                                : ((1u << k) - 1u)));
}

// Decode n spectral values of one codebook section starting at bit `pos`.
// lut_sym/lut_len: flat LUT of width lut_bits (sym < 0 = invalid);
// tuples: int16[nsym * dim] pre-unpacked codeword values (signed books:
// signed; unsigned books: magnitudes).  Returns the new bit position, or
// -1 on an invalid codeword / bad escape.
long nrsc5_hdc_spectral(const uint8_t* data, long nbytes, long pos,
                        const int16_t* lut_sym, const uint8_t* lut_len,
                        int lut_bits, const int16_t* tuples, int dim,
                        int is_signed, int is_esc, long n, int32_t* out) {
    long nbits = 8 * nbytes;
    long i = 0;
    long vals[4];
    while (i < n) {
        uint32_t probe = hdc_peek(data, nbytes, pos, lut_bits);
        int sym = lut_sym[probe];
        if (sym < 0) return -1;
        pos += lut_len[probe];
        const int16_t* tp = tuples + (long)sym * dim;
        for (int j = 0; j < dim; j++) {
            long v = tp[j];
            if (!is_signed && v) {
                if (hdc_peek(data, nbytes, pos, 1)) v = -v;
                pos += 1;
            }
            vals[j] = v;
        }
        if (is_esc) {
            for (int j = 0; j < dim; j++) {
                long v = vals[j];
                if (v != 16 && v != -16) continue;
                int cnt = 0;
                while (hdc_peek(data, nbytes, pos, 1)) {
                    pos += 1;
                    if (++cnt > 16 || pos > nbits) return -1;
                }
                pos += 1;  // the terminating 0
                int nb = cnt + 4;
                long mag = ((long)1 << nb)
                           | hdc_peek(data, nbytes, pos, nb);
                pos += nb;
                vals[j] = (v < 0) ? -mag : mag;
            }
        }
        for (int j = 0; j < dim && i + j < n; j++)
            out[i + j] = (int32_t)vals[j];
        i += dim;
        if (pos > nbits + 64) return -1;  // runaway on a truncated packet
    }
    return pos;
}

// ---------------------------------------------------------------------------
// Whole-ICS parse: section data + scale factors + spectral huffman in ONE
// call per channel (mirrors hdc_decoder._parse_section_data /
// _parse_scale_factors / _parse_spectral bit-exactly; pinned by
// tests/test_audio.py::test_native_ics_matches_python).  The per-section
// ctypes dispatch of nrsc5_hdc_spectral (~79 calls/packet) was ~25% of the
// host parse wall; this is 1 call per channel.
// ---------------------------------------------------------------------------

#define HDC_NBOOKS 16
#define HDC_SF_BOOK 12  // reserved spectral codebook id reused for SF book
struct HdcBook {
    const int16_t* sym;
    const uint8_t* len;
    int bits;
    const int16_t* tuples;
    int dim;
    int is_signed;
    int is_esc;
    int set;
};
static HdcBook hdc_books[HDC_NBOOKS];

void nrsc5_hdc_register_book(int cb, const int16_t* sym, const uint8_t* len,
                             int bits, const int16_t* tuples, int dim,
                             int is_signed, int is_esc) {
    if (cb < 0 || cb >= HDC_NBOOKS) return;
    hdc_books[cb].sym = sym;
    hdc_books[cb].len = len;
    hdc_books[cb].bits = bits;
    hdc_books[cb].tuples = tuples;
    hdc_books[cb].dim = dim;
    hdc_books[cb].is_signed = is_signed;
    hdc_books[cb].is_esc = is_esc;
    hdc_books[cb].set = 1;
}

static inline int hdc_decode_sym(const uint8_t* d, long nbytes, long* pos,
                                 const HdcBook* bk) {
    uint32_t probe = hdc_peek(d, nbytes, *pos, bk->bits);
    int sym = bk->sym[probe];
    if (sym < 0) return -1;
    *pos += bk->len[probe];
    return sym;
}

// Parse one channel's individual stream: global_gain (8 bits) + section
// data + scale factors + spectral data, starting at bit `pos`.
// group_len: int32[num_groups]; swb_offset: int16[max_sfb + 1];
// sfb_cb/sf_out: int32[num_groups * max_sfb]; quant: int32[1024],
// caller-zeroed.  Returns the new bit position, or -1 on any condition
// where the Python parser raises (reserved codebook, section overrun,
// scalefactor out of range, invalid codeword, bad escape, spectral
// overrun), or -2 if codebooks were not registered.
long nrsc5_hdc_ics(const uint8_t* data, long nbytes, long pos,
                   int short_flag, int max_sfb, int num_groups,
                   const int32_t* group_len, const int16_t* swb_offset,
                   int32_t* sfb_cb, int32_t* sf_out, int32_t* quant) {
    long nbits = 8 * nbytes;
    if (!hdc_books[HDC_SF_BOOK].set) return -2;

    int global_gain = (int)hdc_peek(data, nbytes, pos, 8);
    pos += 8;

    // --- section data (hdc_decoder._parse_section_data) ---
    int sect_bits = short_flag ? 3 : 5;
    int esc = (1 << sect_bits) - 1;
    for (int g = 0; g < num_groups; g++) {
        int k = 0;
        while (k < max_sfb) {
            int cb = (int)hdc_peek(data, nbytes, pos, 4);
            pos += 4;
            if (cb == 12) return -1;  // reserved codebook id
            long run = 0;
            for (;;) {
                int incr = (int)hdc_peek(data, nbytes, pos, sect_bits);
                pos += sect_bits;
                run += incr;
                if (incr != esc) break;
            }
            if (k + run > max_sfb || pos > nbits) return -1;
            for (long j = 0; j < run; j++) sfb_cb[g * max_sfb + k + j] = cb;
            k += (int)run;
        }
    }

    // --- scale factors (hdc_decoder._parse_scale_factors; NO overrun
    // check here — the Python parser reads zero bits past the end) ---
    const HdcBook* sfbk = &hdc_books[HDC_SF_BOOK];
    int scale_factor = global_gain;
    int is_position = 0;
    int noise_energy = global_gain - 90;
    int noise_pcm = 1;
    for (int g = 0; g < num_groups; g++) {
        for (int b = 0; b < max_sfb; b++) {
            int cb = sfb_cb[g * max_sfb + b];
            int32_t* dst = &sf_out[g * max_sfb + b];
            if (cb == 0) {  // ZERO_HCB
                *dst = 0;
            } else if (cb == 14 || cb == 15) {  // INTENSITY_HCB2 / _HCB
                int s = hdc_decode_sym(data, nbytes, &pos, sfbk);
                if (s < 0) return -1;
                is_position += s - 60;  // SF_CENTER
                *dst = is_position;
            } else if (cb == 13) {  // NOISE_HCB
                if (noise_pcm) {
                    noise_pcm = 0;
                    noise_energy += (int)hdc_peek(data, nbytes, pos, 9) - 256;
                    pos += 9;
                } else {
                    int s = hdc_decode_sym(data, nbytes, &pos, sfbk);
                    if (s < 0) return -1;
                    noise_energy += s - 60;
                }
                *dst = noise_energy;
            } else {
                int s = hdc_decode_sym(data, nbytes, &pos, sfbk);
                if (s < 0) return -1;
                scale_factor += s - 60;
                if (scale_factor < 0 || scale_factor >= 256) return -1;
                *dst = scale_factor;
            }
        }
    }

    // --- spectral data (hdc_decoder._parse_spectral) ---
    int win_base = 0;
    for (int g = 0; g < num_groups; g++) {
        int glen = group_len[g];
        for (int b = 0; b < max_sfb; b++) {
            int cb = sfb_cb[g * max_sfb + b];
            if (cb == 0 || cb >= 13) continue;  // ZERO / NOISE / INTENSITY
            const HdcBook* bk = &hdc_books[cb];
            if (!bk->set) return -2;
            int width = (int)(swb_offset[b + 1] - swb_offset[b]);
            long n = (long)width * glen;
            long i = 0;
            long vals[4];
            int dim = bk->dim;
            // temporary bitstream-order buffer (sfb-major: window, bin)
            int32_t tmp[8 * 128];
            while (i < n) {
                int sym = hdc_decode_sym(data, nbytes, &pos, bk);
                if (sym < 0) return -1;
                const int16_t* tp = bk->tuples + (long)sym * dim;
                for (int j = 0; j < dim; j++) {
                    long v = tp[j];
                    if (!bk->is_signed && v) {
                        if (hdc_peek(data, nbytes, pos, 1)) v = -v;
                        pos += 1;
                    }
                    vals[j] = v;
                }
                if (bk->is_esc) {
                    for (int j = 0; j < dim; j++) {
                        long v = vals[j];
                        if (v != 16 && v != -16) continue;
                        int cnt = 0;
                        while (hdc_peek(data, nbytes, pos, 1)) {
                            pos += 1;
                            if (++cnt > 16 || pos > nbits) return -1;
                        }
                        pos += 1;  // terminating 0
                        int nb = cnt + 4;
                        long mag = ((long)1 << nb)
                                   | hdc_peek(data, nbytes, pos, nb);
                        pos += nb;
                        vals[j] = (v < 0) ? -mag : mag;
                    }
                }
                for (int j = 0; j < dim && i + j < n; j++)
                    tmp[i + j] = (int32_t)vals[j];
                i += dim;
                if (pos > nbits + 64) return -1;  // truncated-packet runaway
            }
            if (pos > nbits) return -1;  // br.overrun() after each section
            // scatter to per-window order (quant[1024])
            for (int wi = 0; wi < glen; wi++) {
                long lo = short_flag
                              ? (long)(win_base + wi) * 128 + swb_offset[b]
                              : (long)swb_offset[b];
                for (int j = 0; j < width; j++)
                    quant[lo + j] = tmp[(long)wi * width + j];
            }
        }
        win_base += glen;
    }
    return pos;
}

}  // extern "C"

// Initialize every lookup table at library load: the transport runs these
// kernels from multiple Python threads with the GIL released, so lazy
// first-call init would be a data race on the *_init_done flags.
namespace {
struct _InitAll {
    _InitAll() {
        crc8_init();
        fcs_init();
        gf_init();
    }
};
static _InitAll _init_all;
}  // namespace
