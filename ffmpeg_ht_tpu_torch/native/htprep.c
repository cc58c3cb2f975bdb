/* Host-side HT stream preparation — native runtime component.
 *
 * Flattens each codeblock's Dcup segments (MagSgn / MEL / VLC) into dense
 * little-endian bit streams packed as uint32 words, applying the three
 * T.814 bit-unstuffing rules and the modDcup trailer handling. This is
 * the C replacement for the vectorized-numpy path in
 * ffmpeg_ht_tpu_torch/ops/ht_batch.py (prepare_streams_batch) — semantics
 * are identical and cross-checked by tests/test_torch_host.py.
 *
 * Two entries: ht_prepare_streams packs the rows of a caller-built byte
 * matrix (the v2 and object paths); ht_v3_extents + ht_v3_pack read each
 * lane straight from its frame's codestream body and write the v3
 * program's word streams at their final width.
 *
 * Reference behavior being mirrored (not copied): the bit readers of
 * the reference decoder's libavcodec/jpeg2000htdec.c:145-221 and its
 * modDcup handling at :1266-1293.
 *
 * Exposed via ctypes (see ffmpeg_ht_tpu_torch/utils/native.py).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the word packers assume a little-endian host"
#endif

/* Bits gather LSB-first in a 64-bit register and leave as little-endian
 * uint32 words; a row holds `cap` words, and words at or past it are
 * dropped (the caller sizes `cap` so that only zero words fall there). */
typedef struct {
    uint32_t *out;
    int64_t cap, nw;
    uint64_t acc;
    int n;
} wsink;

static inline void put_bits(wsink *s, uint32_t val, int nbits)
{
    s->acc |= (uint64_t)val << s->n;
    s->n += nbits;
    if (s->n >= 32) {
        if (s->nw < s->cap)
            s->out[s->nw] = (uint32_t)s->acc;
        s->nw++;
        s->acc >>= 32;
        s->n -= 32;
    }
}

/* 0xFF synthesis past the segment end */
static inline void put_ones64(wsink *s)
{
    put_bits(s, 0xFFFFFFFFu, 32);
    put_bits(s, 0xFFFFFFFFu, 32);
}

/* Flushes the partial word, zeroes the rest of the row; returns the bits
 * written. */
static int64_t sink_close(wsink *s)
{
    int64_t bits = s->nw * 32 + s->n;
    if (s->n) {
        if (s->nw < s->cap)
            s->out[s->nw] = (uint32_t)s->acc;
        s->nw++;
    }
    if (s->nw < s->cap)
        memset(s->out + s->nw, 0, (size_t)(s->cap - s->nw) * 4);
    return bits;
}

static inline uint32_t load_le32(const uint8_t *p)
{
    uint32_t x;
    memcpy(&x, p, 4);
    return x;
}

static inline int has_zero_byte(uint32_t v)
{
    return ((v - 0x01010101u) & ~v & 0x80808080u) != 0;
}

/* x with the bits of each byte in reverse order */
static inline uint32_t rev_in_bytes(uint32_t x)
{
    x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
    x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
    return ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
}

/* MagSgn (rev = 0): forward bytes, LSB-first payload; a byte following
 * 0xFF carries 7 bits (MSB is stuffing). MEL (rev = 1): the same bytes
 * MSB-first within the 7/8-bit payload, so each payload goes out with its
 * bits reversed. Four bytes at a time where none of them follows 0xFF. */
static int64_t pack_forward(const uint8_t *seg, int64_t len, uint32_t *out,
                            int64_t cap, int rev)
{
    wsink s = { out, cap, 0, 0, 0 };
    uint8_t prev = 0;
    int64_t i = 0;
    while (i < len) {
        if (prev != 0xFF && i + 4 <= len) {
            uint32_t x = load_le32(seg + i);
            if (!has_zero_byte(~x | 0xFF000000u)) {  /* no 0xFF in 0..2 */
                put_bits(&s, rev ? rev_in_bytes(x) : x, 32);
                prev = (uint8_t)(x >> 24);
                i += 4;
                continue;
            }
        }
        uint8_t b = seg[i++];
        int nbits = (prev == 0xFF) ? 7 : 8;
        if (rev)
            put_bits(&s, rev_in_bytes(b) >> (8 - nbits), nbits);
        else
            put_bits(&s, b & ((1u << nbits) - 1), nbits);
        prev = b;
    }
    put_ones64(&s);
    return sink_close(&s);
}

/* VLC: bytes from lcup-2 down to pcup in reading order, LSB-first; the
 * MSB of a byte is dropped when the previously-read byte (higher address,
 * post-modDcup) exceeds 0x8F and the low 7 bits are all ones. The first
 * byte's low nibble (Scup) is skipped. Four bytes at a time where none
 * has its low 7 bits all ones. */
static int64_t pack_vlc(const uint8_t *dcup, int64_t lcup, int64_t pcup,
                        uint32_t *out, int64_t cap)
{
    wsink s = { out, cap, 0, 0, 0 };
    if (lcup - pcup >= 2) {
        int64_t a = lcup - 2;
        /* modDcup: the trailer byte 0xFF before it, the Scup nibble set */
        uint8_t prev = dcup[a] | 0x0F;
        int nbits = ((prev & 0x7F) == 0x7F) ? 7 : 8;
        put_bits(&s, (prev & ((1u << nbits) - 1)) >> 4, nbits - 4);
        for (a--; a >= pcup;) {
            if (a - 3 >= pcup) {
                uint32_t x = load_le32(dcup + a - 3);
                if (!has_zero_byte((x & 0x7F7F7F7Fu) ^ 0x7F7F7F7Fu)) {
                    put_bits(&s, __builtin_bswap32(x), 32);
                    prev = (uint8_t)x;
                    a -= 4;
                    continue;
                }
            }
            uint8_t cur = dcup[a--];
            nbits = (prev > 0x8F && (cur & 0x7F) == 0x7F) ? 7 : 8;
            put_bits(&s, cur & ((1u << nbits) - 1), nbits);
            prev = cur;
        }
    }
    return sink_close(&s);
}

/* Batch entry point: data (n, l) row-major; outputs (n, w_words) each,
 * every word written. Returns 0, or -1 if any row overflows w_words. */
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
        int64_t b1 = pack_forward(row, pc, msw + i * w_words, w_words, 0);
        int64_t b2 = pack_forward(row + pc, lc - pc, melw + i * w_words,
                                  w_words, 1);
        int64_t b3 = pack_vlc(row, lc, pc, vlcw + i * w_words, w_words);
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

/* ------------------------------------------------------------------------
 * The v3 lane build: rows r = f * n + i of `nframes` frames of n lanes.
 * Row r holds the bytes bodies[f][off[r] + j], j < lcup[r], reading 0
 * outside [0, blen[f]); where moddcup[r], its last byte reads 0xFF and
 * the one before it has 0x0F OR-ed in (the v3 device lanes).
 * --------------------------------------------------------------------- */

/* Copies row r into `row` (lcup[r] bytes) with modDcup applied. */
static void load_row(uint8_t *row, const uint8_t *body, int64_t blen,
                     int64_t off, int64_t lc, int mod)
{
    int64_t lo = off < 0 ? -off : 0;
    int64_t hi = blen - off < lc ? blen - off : lc;
    if (hi < lo)
        hi = lo;
    if (lo > lc)
        lo = hi = lc;
    memset(row, 0, (size_t)lo);
    if (hi > lo)
        memcpy(row + lo, body + off + lo, (size_t)(hi - lo));
    memset(row + hi, 0, (size_t)(lc - hi));
    if (mod && lc >= 2) {
        row[lc - 1] = 0xFF;
        row[lc - 2] |= 0x0F;
    }
}

static int64_t count_ff(const uint8_t *p, int64_t len)
{
    int64_t c = 0;
    for (int64_t i = 0; i < len; i++)
        c += p[i] == 0xFF;
    return c;
}

static inline int highbit(uint32_t v)
{
    return 31 - __builtin_clz(v);
}

/* The VLC stream's index of its last set bit, -1 if none, without
 * packing it: a byte that reads as zero payload is a 0x00 byte (a
 * stuffed byte keeps its seven ones), so the last set bit lies in the
 * lowest-addressed nonzero byte above pcup. */
static int64_t vlc_last_bit(const uint8_t *r, int64_t lc, int64_t pc)
{
    if (lc - pc < 2)
        return -1;
    int64_t top = lc - 2;
    uint8_t c0 = r[top] | 0x0F;
    int n0 = ((c0 & 0x7F) == 0x7F) ? 7 : 8;  /* after the 0xFF trailer */
    int64_t stuffed = 0;
    for (int64_t a = pc; a < top - 1; a++)
        stuffed += (r[a + 1] > 0x8F) & ((r[a] & 0x7F) == 0x7F);
    if (top - 1 >= pc)
        stuffed += (c0 > 0x8F) & ((r[top - 1] & 0x7F) == 0x7F);
    int64_t total = (n0 - 4) + 8 * (top - pc) - stuffed;
    int64_t a = pc;
    while (a < top && r[a] == 0)
        a++;
    if (a == top) {
        uint32_t v0 = (c0 & ((1u << n0) - 1)) >> 4;
        return v0 ? highbit(v0) : -1;
    }
    uint8_t prev = (a + 1 == top) ? c0 : r[a + 1];
    int nb = (prev > 0x8F && (r[a] & 0x7F) == 0x7F) ? 7 : 8;
    /* bytes [pc, a) are zero bytes of 8 bits each, written after byte a */
    int64_t start = total - 8 * (a - pc) - nb;
    return start + highbit(r[a] & ((1u << nb) - 1));
}

static int check_rows(int64_t rows, const int64_t *lcup, const int64_t *pcup,
                      int64_t *lmax)
{
    *lmax = 0;
    for (int64_t r = 0; r < rows; r++) {
        if (pcup[r] < 0 || pcup[r] > lcup[r])
            return -1;
        if (lcup[r] > *lmax)
            *lmax = lcup[r];
    }
    return 0;
}

/* First pass: each row's MagSgn and MEL limits (the first word index past
 * the payload and its 64-ones tail, as ht_prepare_streams gives them),
 * and in last_words[0..2] the highest word index holding a set bit over
 * all rows of each stream (-1 if none). Returns 0, or -1 on a row with
 * pcup outside [0, lcup], or -2 when out of memory. */
int ht_v3_extents(const uint8_t *const *bodies, const int64_t *blen,
                  int64_t nframes, int64_t n, const int64_t *off,
                  const int64_t *lcup, const int64_t *pcup,
                  const uint8_t *moddcup, int32_t *ms_lim, int32_t *mel_lim,
                  int64_t *last_words)
{
    int64_t lmax;
    if (check_rows(nframes * n, lcup, pcup, &lmax))
        return -1;
    uint8_t *row = malloc((size_t)lmax + 1);
    if (!row)
        return -2;
    int64_t lw[3] = { -1, -1, -1 };
    for (int64_t f = 0; f < nframes; f++) {
        for (int64_t i = 0; i < n; i++) {
            int64_t r = f * n + i, lc = lcup[r], pc = pcup[r];
            load_row(row, bodies[f], blen[f], off[r], lc, moddcup[r]);
            /* a byte after 0xFF carries 7 bits: count the 0xFF bytes that
             * have a successor in their segment */
            int64_t b1 = 64 + 8 * pc - (pc ? count_ff(row, pc - 1) : 0);
            int64_t b2 = 64 + 8 * (lc - pc)
                - (lc > pc ? count_ff(row + pc, lc - pc - 1) : 0);
            int64_t v = vlc_last_bit(row, lc, pc);
            ms_lim[r] = (int32_t)(b1 >> 5);
            mel_lim[r] = (int32_t)(b2 >> 5);
            if ((b1 - 1) >> 5 > lw[0]) lw[0] = (b1 - 1) >> 5;
            if ((b2 - 1) >> 5 > lw[1]) lw[1] = (b2 - 1) >> 5;
            if (v >= 0 && v >> 5 > lw[2]) lw[2] = v >> 5;
        }
    }
    free(row);
    memcpy(last_words, lw, sizeof lw);
    return 0;
}

/* Second pass: the three streams of every row into (rows, w_ms),
 * (rows, w_mel) and (rows, w_vlc) word arrays, every word written; the
 * widths come from ht_v3_extents, so no set bit falls past them. Returns
 * as ht_v3_extents. */
int ht_v3_pack(const uint8_t *const *bodies, const int64_t *blen,
               int64_t nframes, int64_t n, const int64_t *off,
               const int64_t *lcup, const int64_t *pcup,
               const uint8_t *moddcup, uint32_t *msw, int64_t w_ms,
               uint32_t *melw, int64_t w_mel, uint32_t *vlcw, int64_t w_vlc)
{
    int64_t lmax;
    if (check_rows(nframes * n, lcup, pcup, &lmax))
        return -1;
    uint8_t *row = malloc((size_t)lmax + 1);
    if (!row)
        return -2;
    for (int64_t f = 0; f < nframes; f++) {
        for (int64_t i = 0; i < n; i++) {
            int64_t r = f * n + i, lc = lcup[r], pc = pcup[r];
            load_row(row, bodies[f], blen[f], off[r], lc, moddcup[r]);
            pack_forward(row, pc, msw + r * w_ms, w_ms, 0);
            pack_forward(row + pc, lc - pc, melw + r * w_mel, w_mel, 1);
            pack_vlc(row, lc, pc, vlcw + r * w_vlc, w_vlc);
        }
    }
    free(row);
    return 0;
}
