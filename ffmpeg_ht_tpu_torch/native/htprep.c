/* Host-side HT stream preparation — native runtime component.
 *
 * Flattens each codeblock's Dcup segments (MagSgn / MEL / VLC) into dense
 * little-endian bit streams packed as uint32 words, applying the three
 * T.814 bit-unstuffing rules and the modDcup trailer handling. This is
 * the C replacement for the vectorized-numpy path in
 * ffmpeg_ht_tpu/ops/ht_batch.py (prepare_streams_batch) — semantics are
 * identical and cross-checked by tests/test_ht_codec.py.
 *
 * Reference behavior being mirrored (not copied): the bit readers of
 * /root/reference/libavcodec/jpeg2000htdec.c:145-221 and the modDcup
 * handling at :1266-1293.
 *
 * Exposed via ctypes (see ffmpeg_ht_tpu/utils/native.py); build with
 * native/build.sh.
 */

#include <stdint.h>
#include <string.h>

typedef struct {
    uint32_t *words;
    int64_t bitpos;
} bitsink;

static inline void put_bits(bitsink *s, uint32_t val, int n)
{
    int64_t w = s->bitpos >> 5;
    int off = (int)(s->bitpos & 31);
    s->words[w] |= val << off;
    if (off + n > 32)
        s->words[w + 1] |= val >> (32 - off);
    s->bitpos += n;
}

static inline void put_ones(bitsink *s, int n)
{
    for (int i = 0; i < n; i++)
        put_bits(s, 1, 1);
}

/* MagSgn: forward bytes, LSB-first payload; a byte following 0xFF carries
 * 7 bits (MSB is stuffing). */
static int64_t pack_forward(const uint8_t *seg, int64_t len, uint32_t *out)
{
    bitsink s = { out, 0 };
    uint8_t prev = 0;
    for (int64_t i = 0; i < len; i++) {
        int nbits = (prev == 0xFF) ? 7 : 8;
        put_bits(&s, seg[i] & ((1u << nbits) - 1), nbits);
        prev = seg[i];
    }
    put_ones(&s, 64); /* 0xFF synthesis past the segment end */
    return s.bitpos;
}

/* MEL: forward bytes, MSB-first within the 7/8-bit payload. */
static int64_t pack_mel(const uint8_t *seg, int64_t len, uint32_t *out)
{
    bitsink s = { out, 0 };
    uint8_t prev = 0;
    for (int64_t i = 0; i < len; i++) {
        int nbits = (prev == 0xFF) ? 7 : 8;
        for (int j = nbits - 1; j >= 0; j--)
            put_bits(&s, (seg[i] >> j) & 1, 1);
        prev = seg[i];
    }
    put_ones(&s, 64);
    return s.bitpos;
}

/* VLC: bytes from lcup-2 down to pcup in reading order, LSB-first; the
 * MSB of a byte is dropped when the previously-read byte (higher address,
 * post-modDcup) exceeds 0x8F and the low 7 bits are all ones. The first
 * byte's low nibble (Scup) is skipped. */
static int64_t pack_vlc(const uint8_t *dcup, int64_t lcup, int64_t pcup,
                        uint32_t *out)
{
    bitsink s = { out, 0 };
    if (lcup - pcup < 2)
        return 0;
    uint8_t prev = 0xFF; /* modDcup trailer byte at lcup-1 */
    for (int64_t a = lcup - 2; a >= pcup; a--) {
        uint8_t cur = dcup[a];
        if (a == lcup - 2)
            cur |= 0x0F; /* modDcup Scup nibble */
        int nbits = (prev > 0x8F && (cur & 0x7F) == 0x7F) ? 7 : 8;
        if (a == lcup - 2)
            put_bits(&s, (cur & ((1u << nbits) - 1)) >> 4, nbits - 4);
        else
            put_bits(&s, cur & ((1u << nbits) - 1), nbits);
        prev = cur;
    }
    return s.bitpos;
}

/* Batch entry point: data (n, l) row-major; outputs (n, w_words) each,
 * caller-zeroed. Returns 0, or -1 if any row overflows w_words. */
int ht_prepare_streams(const uint8_t *data, int64_t n, int64_t l,
                       const int64_t *lcup, const int64_t *pcup,
                       uint32_t *msw, uint32_t *melw, uint32_t *vlcw,
                       int64_t w_words, int64_t *max_words_out,
                       int32_t *ms_lim, int32_t *mel_lim)
{
    int64_t maxw = 0;
    int64_t cap_bits = (w_words - 2) * 32;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *row = data + i * l;
        int64_t lc = lcup[i], pc = pcup[i];
        if (pc < 0 || lc > l || pc > lc)
            return -1;
        if (8 * lc + 64 > cap_bits)
            return -1;
        int64_t b1 = pack_forward(row, pc, msw + i * w_words);
        int64_t b2 = pack_mel(row + pc, lc - pc, melw + i * w_words);
        int64_t b3 = pack_vlc(row, lc, pc, vlcw + i * w_words);
        int64_t w1 = (b1 + 31) >> 5, w2 = (b2 + 31) >> 5, w3 = (b3 + 31) >> 5;
        /* first all-synthesized word index: payload + the 64-ones tail,
         * floor-divided (ht_batch.stream_limits parity) */
        if (ms_lim)
            ms_lim[i] = (int32_t)(b1 >> 5);
        if (mel_lim)
            mel_lim[i] = (int32_t)(b2 >> 5);
        if (w1 > maxw) maxw = w1;
        if (w2 > maxw) maxw = w2;
        if (w3 > maxw) maxw = w3;
    }
    *max_words_out = maxw;
    return 0;
}
