/* Native HT (Rec. ITU-T T.814) block decoder — C port of the repo's own
 * scalar oracle (ffmpeg_ht_tpu/ops/ht_dec.py), which is the behavioral
 * spec here; reference parity anchors are the same ones the oracle
 * cites (jpeg2000htdec.c:107-1336).
 *
 * Role: the host-fallback lanes (edge slivers, extreme bitplanes,
 * outlier-length streams) used to run the Python oracle at ~20 ms per
 * 64x64 codeblock on the 1-core host; this runs the identical
 * algorithm at C speed. The Python oracle stays as the provenance
 * model and the cross-check in tests (test_native_htdec parity).
 *
 * Entry: ht_decode_block() below — the caller (ht_dec.decode_htj2k)
 * still does pass accounting, Scup validation, modDcup and the buffer
 * extension, so the byte layout this sees is exactly the oracle's.
 *
 * Exposed via ctypes (ffmpeg_ht_tpu/utils/native.py); built by
 * native/build.sh. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* block_states bit positions (jpeg2000htdec.c:62-65) */
#define HT_SIGMA 0
#define HT_REF_IND 2
#define HT_REF 3
#define HT_SCAN 4

/* ---- backward VLC reader with unstuffing (ht_dec._RevBits) ---- */

typedef struct {
    const uint8_t *arr;
    int64_t len;
    int64_t pos;
    uint32_t last;
    uint64_t bit_buf;
    int bits_left;
} RevBits;

static void rev_init(RevBits *r, const uint8_t *arr, int64_t len,
                     int64_t pos, uint32_t last)
{
    r->arr = arr;
    r->len = len;
    r->pos = pos;
    r->last = last;
    r->bit_buf = 0;
    r->bits_left = 0;
}

static void rev_refill(RevBits *r)
{
    const uint8_t *a = r->arr;
    uint64_t tmp;
    int new_bits = 32;
    r->last = (r->pos + 1 < r->len) ? a[r->pos + 1] : 0;
    if (r->bits_left >= 32)
        return;
    if (r->pos >= 3) {
        tmp = ((uint64_t)a[r->pos - 3] << 32)
            | ((uint64_t)a[r->pos - 2] << 24)
            | ((uint64_t)a[r->pos - 1] << 16)
            | ((uint64_t)a[r->pos] << 8) | r->last;
        r->pos -= 4;
    } else {
        tmp = 0;
        if (r->pos >= 2)
            tmp = a[r->pos - 2];
        if (r->pos >= 1)
            tmp = (tmp << 8) | a[r->pos - 1];
        if (r->pos >= 0)
            tmp = (tmp << 8) | a[r->pos];
        r->pos = 0;
        tmp = (tmp << 8) | r->last;
    }
    /* unstuff: drop the MSB of any byte preceded (stream order) by >0x8F
     * (jpeg2000htdec.c:145-201; same window arithmetic as the oracle) */
    if ((tmp & 0x7FFF000000ULL) > 0x7F8F000000ULL) {
        tmp &= 0x7FFFFFFFFFULL;
        new_bits--;
    }
    if ((tmp & 0x007FFF0000ULL) > 0x007F8F0000ULL) {
        tmp = (tmp & 0x007FFFFFFFULL) + ((tmp & 0xFF00000000ULL) >> 1);
        new_bits--;
    }
    if ((tmp & 0x00007FFF00ULL) > 0x00007F8F00ULL) {
        tmp = (tmp & 0x00007FFFFFULL) + ((tmp & 0xFFFF000000ULL) >> 1);
        new_bits--;
    }
    if ((tmp & 0x0000007FFFULL) > 0x0000007F8FULL) {
        tmp = (tmp & 0x0000007FFFULL) + ((tmp & 0xFFFFFF0000ULL) >> 1);
        new_bits--;
    }
    tmp >>= 8;
    r->bit_buf |= tmp << r->bits_left;
    r->bits_left += new_bits;
}

static inline uint32_t rev_peek(RevBits *r, int n)
{
    return (uint32_t)(r->bit_buf & ((1u << n) - 1));
}

static inline void rev_drop(RevBits *r, int n)
{
    r->bit_buf >>= n;
    r->bits_left -= n;
}

static inline uint32_t rev_get(RevBits *r, int n)
{
    uint32_t v;
    if (r->bits_left < n)
        rev_refill(r);
    v = (uint32_t)(r->bit_buf & ((1u << n) - 1));
    rev_drop(r, n);
    return v;
}

/* ---- forward MagSgn reader (ht_dec._FwdBits) ---- */

typedef struct {
    const uint8_t *arr;
    int64_t length;
    int64_t pos;
    uint32_t last;
    uint64_t bit_buf;
    int bits_left;
} FwdBits;

static void fwd_init(FwdBits *f, const uint8_t *arr, int64_t length)
{
    f->arr = arr;
    f->length = length;
    f->pos = 0;
    f->last = 0;
    f->bit_buf = 0;
    f->bits_left = 0;
}

static void fwd_refill(FwdBits *f)
{
    while (f->bits_left < 32) {
        uint32_t tmp = 0xFF;
        int nbits = (f->last == 0xFF) ? 7 : 8;
        if (f->pos < f->length) {
            tmp = f->arr[f->pos++];
            f->last = tmp;
        }
        f->bit_buf |= (uint64_t)tmp << f->bits_left;
        f->bits_left += nbits;
    }
}

static uint32_t fwd_get(FwdBits *f, int n)
{
    uint32_t v;
    if (f->bits_left <= n)
        fwd_refill(f);
    v = (uint32_t)(f->bit_buf & (((uint64_t)1 << n) - 1));
    f->bit_buf >>= n;
    f->bits_left -= n;
    return v;
}

/* ---- MEL decoder (ht_dec._MelState; jpeg2000htdec.c:462-495) ---- */

typedef struct {
    int k, run, one;
    int64_t pos, length;
    uint32_t tmp;
    int bits;
    const uint8_t *arr;
} MelState;

static void mel_init(MelState *m, const uint8_t *arr, int64_t pcup,
                     int64_t lcup)
{
    m->k = 0;
    m->run = 0;
    m->one = 0;
    m->arr = arr;
    m->length = lcup;
    m->pos = pcup;
    m->tmp = 0;
    m->bits = 0;
}

static int mel_import_bit(MelState *m)
{
    int cond = m->pos < m->length;
    int64_t pos = cond ? m->pos : m->length - 1;
    if (m->bits == 0) {
        m->bits = (m->tmp == 0xFF) ? 7 : 8;
        if (cond)
            m->pos++;
        m->tmp = cond ? m->arr[pos] : 0xFF;
    }
    m->bits--;
    return (m->tmp >> m->bits) & 1;
}

static int mel_sym(MelState *m)
{
    if (m->run == 0 && m->one == 0) {
        /* MEL_E[k] = min(k/3, 3) + max(k-10, 0) */
        int ev = (m->k / 3 < 3 ? m->k / 3 : 3)
               + (m->k > 10 ? m->k - 10 : 0);
        if (mel_import_bit(m) == 1) {
            m->run = 1 << ev;
            m->k = m->k + 1 < 12 ? m->k + 1 : 12;
        } else {
            m->run = 0;
            while (ev > 0) {
                m->run = 2 * m->run + mel_import_bit(m);
                ev--;
            }
            m->k = m->k - 1 > 0 ? m->k - 1 : 0;
            m->one = 1;
        }
    }
    if (m->run > 0) {
        m->run--;
        return 0;
    }
    m->one = 0;
    return 1;
}

/* ---- SigProp bit reader (ht_dec._SPBits) ---- */

typedef struct {
    const uint8_t *arr;
    int64_t length, pos;
    uint32_t tmp, last;
    int bits;
} SPBits;

static void sp_init(SPBits *s, const uint8_t *arr, int64_t length)
{
    s->arr = arr;
    s->length = length;
    s->pos = 0;
    s->tmp = 0;
    s->last = 0;
    s->bits = 0;
}

static int sp_bit(SPBits *s)
{
    int b;
    if (s->bits == 0) {
        s->bits = (s->last == 0xFF) ? 7 : 8;
        s->tmp = (s->pos < s->length) ? s->arr[s->pos++] : 0;
        s->last = s->tmp;
    }
    b = s->tmp & 1;
    s->tmp >>= 1;
    s->bits--;
    return b;
}

/* ---- CxtVLC / U-VLC (ht_dec._decode_ctx_vlc/_u_*) ---- */

static void ctx_vlc(RevBits *vlc, const uint16_t *tbl, int context,
                    int *res_off, int *sig_pat, int *emb_k, int *emb_1)
{
    uint32_t code, packed;
    rev_refill(vlc);
    code = rev_peek(vlc, 7);
    packed = tbl[code + (context << 7)];
    rev_drop(vlc, (packed & 0xF) >> 1);
    *res_off = packed & 1;
    *sig_pat = (packed >> 4) & 0xF;
    *emb_k = (packed >> 8) & 0xF;
    *emb_1 = (packed >> 12) & 0xF;
}

static int u_prefix(RevBits *vlc)
{
    uint32_t bits;
    if (vlc->bits_left < 3)
        rev_refill(vlc);
    bits = rev_peek(vlc, 3);
    if (bits & 1) {
        rev_drop(vlc, 1);
        return 1;
    }
    if (bits & 2) {
        rev_drop(vlc, 2);
        return 2;
    }
    rev_drop(vlc, 3);
    return bits == 4 ? 3 : 5;
}

static int u_suffix(RevBits *vlc, int prefix)
{
    uint32_t bits;
    if (prefix < 3)
        return 0;
    if (vlc->bits_left < 5)
        rev_refill(vlc);
    bits = rev_peek(vlc, 5);
    if (prefix == 3) {
        rev_drop(vlc, 1);
        return bits & 1;
    }
    rev_drop(vlc, 5);
    return bits & 31;
}

static int u_extension(RevBits *vlc, int suffix)
{
    return suffix >= 28 ? (int)rev_get(vlc, 4) : 0;
}

static void sig_emb(MelState *mel, RevBits *vlc, const uint16_t *tbl,
                    int context, int *res_off, int *sig_pat, int *emb_k,
                    int *emb_1)
{
    if (context == 0 && mel_sym(mel) == 0) {
        *res_off = 0;
        *sig_pat = 0;
        *emb_k = 0;
        *emb_1 = 0;
        return;
    }
    ctx_vlc(vlc, tbl, context, res_off, sig_pat, emb_k, emb_1);
}

static void recover_mag_sgn(FwdBits *magsgn, int q, const int m4[4],
                            int emb_1, uint8_t *E, uint32_t *mu, int pLSB)
{
    int i;
    for (i = 0; i < 4; i++) {
        int n = 4 * q + i;
        int m_n = m4[i];
        uint32_t known_1 = (emb_1 >> i) & 1;
        uint32_t v = 0;
        if (m_n > 0)
            v = fwd_get(magsgn, m_n) + (known_1 << m_n);
        if (m_n != 0) {
            uint32_t w = v | 1, val;
            int bl = 0;
            while (w) {
                bl++;
                w >>= 1;
            }
            E[n] = (uint8_t)bl;
            val = (((v >> 1) + 1) << pLSB) | (1u << (pLSB - 1))
                | ((v & 1) << 31);
            mu[n] = val;
        }
    }
}

/* U-VLC for a quad pair (ht_dec.quad_u_pair_exact;
 * jpeg2000htdec.c:666-712, 828-854) */
static void u_pair(RevBits *vlc, MelState *mel, int r0, int r1,
                   int initial_row, int u[2])
{
    u[0] = 0;
    u[1] = 0;
    rev_refill(vlc);
    if (r0 == 1 && r1 == 1) {
        if (initial_row) {
            if (mel_sym(mel) == 1) {
                int p0 = u_prefix(vlc), p1 = u_prefix(vlc);
                int s0 = u_suffix(vlc, p0), s1 = u_suffix(vlc, p1);
                u[0] = 2 + p0 + s0 + 4 * u_extension(vlc, s0);
                u[1] = 2 + p1 + s1 + 4 * u_extension(vlc, s1);
            } else {
                int p0 = u_prefix(vlc);
                if (p0 > 2) {
                    int s0;
                    u[1] = (int)rev_get(vlc, 1) + 1;
                    s0 = u_suffix(vlc, p0);
                    u[0] = p0 + s0 + 4 * u_extension(vlc, s0);
                } else {
                    int p1 = u_prefix(vlc);
                    int s0 = u_suffix(vlc, p0), s1 = u_suffix(vlc, p1);
                    u[1] = p1 + s1 + 4 * u_extension(vlc, s1);
                    u[0] = p0 + s0 + 4 * u_extension(vlc, s0);
                }
            }
        } else {
            int p0 = u_prefix(vlc), p1 = u_prefix(vlc);
            int s0 = u_suffix(vlc, p0), s1 = u_suffix(vlc, p1);
            u[0] = p0 + s0 + (u_extension(vlc, s0) << 2);
            u[1] = p1 + s1 + (u_extension(vlc, s1) << 2);
        }
    } else if (r0 == 1 || r1 == 1) {
        int pos = r0 == 1 ? 0 : 1;
        int p = u_prefix(vlc);
        int s = u_suffix(vlc, p);
        u[pos] = p + s + (u_extension(vlc, s) << 2);
    }
}

/* ---- cleanup segment (ht_dec.decode_cleanup) ----
 * Fills sample_buf ((h+4)*stride u32, samples at +0,+0) and block_states
 * ((h+4)*stride u8, ring offset +1,+1). Returns 0 or -1 (bad U). */
static int decode_cleanup(const uint8_t *data, int64_t datalen,
                          int64_t lcup, int64_t pcup, int pLSB,
                          int width, int height, int maxbp,
                          const uint16_t *cxtvlc,
                          uint32_t *sample_buf, uint8_t *block_states,
                          int stride, uint8_t *sigma, uint8_t *E,
                          uint32_t *mu)
{
    int qw = (width + 1) / 2, qh = (height + 1) / 2;
    int n_quads = qw * qh;
    MelState mel;
    RevBits vlc;
    FwdBits magsgn;
    const uint16_t *tbl0 = cxtvlc, *tbl1 = cxtvlc + 1024;
    int context = 0, q = 0, row, y, x, i, idx;
    int is_bx = width & 1, is_by = height & 1;

    if (maxbp >= 32)
        return -1;
    memset(sigma, 0, 4 * n_quads + 8);
    memset(E, 0, 4 * n_quads + 8);
    memset(mu, 0, (4 * n_quads + 8) * sizeof(uint32_t));

    mel_init(&mel, data, pcup, lcup);
    rev_init(&vlc, data + pcup, datalen - pcup, lcup - 2 - pcup,
             data[lcup - 2]);
    rev_refill(&vlc);
    rev_drop(&vlc, 4);
    fwd_init(&magsgn, data, pcup);
    fwd_refill(&magsgn);

#define QUAD_SIG(qq, sp) do { for (i = 0; i < 4; i++) \
        sigma[4 * (qq) + i] = ((sp) >> i) & 1; } while (0)
#define CTX_FIRST(qq) ((sigma[4 * (qq)] | sigma[4 * (qq) + 1]) \
        + (sigma[4 * (qq) + 2] << 1) + (sigma[4 * (qq) + 3] << 2))

    /* initial quad row */
    while (q < qw - 1) {
        int r1, sp1, ek1, e11, r2, sp2, ek2, e12, u[2], U1, U2;
        int m1[4], m2[4];
        sig_emb(&mel, &vlc, tbl0, context, &r1, &sp1, &ek1, &e11);
        QUAD_SIG(q, sp1);
        context = CTX_FIRST(q);
        sig_emb(&mel, &vlc, tbl0, context, &r2, &sp2, &ek2, &e12);
        QUAD_SIG(q + 1, sp2);
        context = CTX_FIRST(q + 1);
        u_pair(&vlc, &mel, r1, r2, 1, u);
        U1 = 1 + u[0];
        U2 = 1 + u[1];
        if (U1 > maxbp || U2 > maxbp)
            return -1;
        for (i = 0; i < 4; i++) {
            m1[i] = sigma[4 * q + i] * U1 - ((ek1 >> i) & 1);
            m2[i] = sigma[4 * (q + 1) + i] * U2 - ((ek2 >> i) & 1);
        }
        recover_mag_sgn(&magsgn, q, m1, e11, E, mu, pLSB);
        recover_mag_sgn(&magsgn, q + 1, m2, e12, E, mu, pLSB);
        q += 2;
    }
    if (qw & 1) {
        int r1, sp1, ek1, e11, u1 = 0, U1, m1[4];
        sig_emb(&mel, &vlc, tbl0, context, &r1, &sp1, &ek1, &e11);
        QUAD_SIG(q, sp1);
        if (r1 == 1) {
            int p, s;
            rev_refill(&vlc);
            p = u_prefix(&vlc);
            s = u_suffix(&vlc, p);
            u1 = p + s + 4 * u_extension(&vlc, s);
        }
        U1 = 1 + u1;
        if (U1 > maxbp)
            return -1;
        for (i = 0; i < 4; i++)
            m1[i] = sigma[4 * q + i] * U1 - ((ek1 >> i) & 1);
        recover_mag_sgn(&magsgn, q, m1, e11, E, mu, pLSB);
        q += 1;
    }

    /* non-initial rows */
#define CTX_ABOVE(qq) ({ \
        int c = sigma[4 * ((qq) - qw) + 1]; \
        c += sigma[4 * ((qq) - qw) + 3] << 2; \
        if ((qq) % qw != 0) { \
            c |= sigma[4 * ((qq) - qw) - 1]; \
            c += (sigma[4 * (qq) - 1] | sigma[4 * (qq) - 2]) << 1; \
        } \
        if (((qq) + 1) % qw != 0) \
            c |= sigma[4 * ((qq) - qw) + 5] << 2; \
        c; })
#define KAPPA(qq, sp) ({ \
        int gamma = ((sp) == 0 || (sp) == 1 || (sp) == 2 || (sp) == 4 \
                     || (sp) == 8) ? 0 : 1; \
        int e_n = E[4 * ((qq) - qw) + 1]; \
        int e_ne = E[4 * ((qq) - qw) + 3]; \
        int64_t nwij = 4 * ((qq) - qw) - 1; \
        int e_nw = ((qq) % qw != 0) * E[nwij > 0 ? nwij : 0]; \
        int e_nf = (((qq) + 1) % qw != 0) * E[4 * ((qq) - qw) + 5]; \
        int max_e = e_nw > e_n ? e_nw : e_n; \
        if (e_ne > max_e) max_e = e_ne; \
        if (e_nf > max_e) max_e = e_nf; \
        gamma * (max_e - 1) > 1 ? gamma * (max_e - 1) : 1; })

    for (row = 1; row < qh; row++) {
        while ((q - row * qw) < qw - 1 && q < qh * qw) {
            int c1, c2, r1, sp1, ek1, e11, r2, sp2, ek2, e12;
            int u[2], U1, U2, m1[4], m2[4];
            c1 = CTX_ABOVE(q);
            sig_emb(&mel, &vlc, tbl1, c1, &r1, &sp1, &ek1, &e11);
            QUAD_SIG(q, sp1);
            c2 = CTX_ABOVE(q + 1);
            sig_emb(&mel, &vlc, tbl1, c2, &r2, &sp2, &ek2, &e12);
            QUAD_SIG(q + 1, sp2);
            u_pair(&vlc, &mel, r1, r2, 0, u);
            U1 = KAPPA(q, sp1) + u[0];
            U2 = KAPPA(q + 1, sp2) + u[1];
            if (U1 > maxbp || U2 > maxbp)
                return -1;
            for (i = 0; i < 4; i++) {
                m1[i] = sigma[4 * q + i] * U1 - ((ek1 >> i) & 1);
                m2[i] = sigma[4 * (q + 1) + i] * U2 - ((ek2 >> i) & 1);
            }
            recover_mag_sgn(&magsgn, q, m1, e11, E, mu, pLSB);
            recover_mag_sgn(&magsgn, q + 1, m2, e12, E, mu, pLSB);
            q += 2;
        }
        if (qw & 1) {
            int c1, r1, sp1, ek1, e11, u1 = 0, U1, m1[4];
            c1 = CTX_ABOVE(q);
            sig_emb(&mel, &vlc, tbl1, c1, &r1, &sp1, &ek1, &e11);
            QUAD_SIG(q, sp1);
            if (r1 == 1) {
                int p, s;
                rev_refill(&vlc);
                p = u_prefix(&vlc);
                s = u_suffix(&vlc, p);
                u1 = p + s + (u_extension(&vlc, s) << 2);
            }
            U1 = KAPPA(q, sp1) + u1;
            if (U1 > maxbp)
                return -1;
            for (i = 0; i < 4; i++)
                m1[i] = sigma[4 * q + i] * U1 - ((ek1 >> i) & 1);
            recover_mag_sgn(&magsgn, q, m1, e11, E, mu, pLSB);
            q += 1;
        }
    }

    /* quad grid -> raster (jpeg2000htdec.c:976-1007) */
    idx = 0;
    for (y = 0; y < qh; y++) {
        for (x = 0; x < qw; x++) {
            int j1 = 2 * y, j2 = 2 * x;
            int x1 = (y != qh - 1 || is_by == 0) ? 1 : 0;
            int x2 = (x != qw - 1 || is_bx == 0) ? 1 : 0;
            int x3 = x1 | x2;
            sample_buf[j2 + j1 * stride] = mu[idx];
            block_states[(j1 + 1) * stride + (j2 + 1)] |= sigma[idx];
            sample_buf[j2 + (j1 + 1) * stride] = mu[idx + 1] * x1;
            block_states[(j1 + 2) * stride + (j2 + 1)] |=
                sigma[idx + 1] * x1;
            sample_buf[(j2 + 1) + j1 * stride] = mu[idx + 2] * x2;
            block_states[(j1 + 1) * stride + (j2 + 2)] |=
                sigma[idx + 2] * x2;
            sample_buf[(j2 + 1) + (j1 + 1) * stride] = mu[idx + 3] * x3;
            block_states[(j1 + 2) * stride + (j2 + 2)] |=
                sigma[idx + 3] * x3;
            idx += 4;
        }
    }
    return 0;
}

/* ---- SigProp (ht_dec.decode_sigprop; jpeg2000htdec.c:1016-1131) ---- */

static int calc_mbr(int i, int j, int causal_cond, const uint8_t *bs,
                    int stride)
{
    int p0 = i * stride + j;
    int p1 = (i + 1) * stride + j;
    int p2 = (i + 2) * stride + j;
    int mbr0 = bs[p0] | bs[p0 + 1] | bs[p0 + 2];
    int mbr1 = bs[p1] | bs[p1 + 2];
    int mbr2 = bs[p2] | bs[p2 + 1] | bs[p2 + 2];
    int mbr = mbr0 | mbr1 | (mbr2 & causal_cond);
    mbr |= (mbr0 >> HT_REF) & (mbr0 >> HT_SCAN);
    mbr |= (mbr1 >> HT_REF) & (mbr1 >> HT_SCAN);
    mbr |= (mbr2 >> HT_REF) & (mbr2 >> HT_SCAN) & causal_cond;
    return mbr & 1;
}

static void stripes_block(SPBits *spd, int i_s, int j_s, int width,
                          int height, int stride, int pLSB,
                          uint32_t *sample_buf, uint8_t *bs, int is_causal)
{
    int i, j;
    for (j = j_s; j < j_s + width; j++) {
        for (i = i_s; i < i_s + height; i++) {
            int causal_cond =
                (is_causal == 0 || i != i_s + height - 1) ? 1 : 0;
            int mbr = 0, modify;
            if (((bs[(i + 1) * stride + (j + 1)] >> HT_SIGMA) & 1) == 0)
                mbr = calc_mbr(i, j, causal_cond, bs, stride);
            modify = bs[(i + 1) * stride + (j + 1)] | (1 << HT_SCAN);
            if (mbr != 0) {
                int bit = sp_bit(spd);
                modify |= 1 << HT_REF_IND;
                modify |= bit << HT_REF;
                sample_buf[j + i * stride] |=
                    ((uint32_t)bit << pLSB) | ((uint32_t)bit << (pLSB - 1));
            }
            bs[(i + 1) * stride + (j + 1)] |= (uint8_t)modify;
        }
    }
    for (j = j_s; j < j_s + width; j++)
        for (i = i_s; i < i_s + height; i++)
            if ((bs[(i + 1) * stride + (j + 1)] >> HT_REF) & 1)
                sample_buf[j + i * stride] |= (uint32_t)sp_bit(spd) << 31;
}

static void decode_sigprop(const uint8_t *dref, int64_t lref, int width,
                           int height, int stride, int pLSB,
                           uint32_t *sample_buf, uint8_t *bs, int is_causal)
{
    SPBits spd;
    int num_v = height / 4, num_h = width / 4;
    int i = 0, j, v, h, bh = height % 4;
    sp_init(&spd, dref, lref);
    for (v = 0; v < num_v; v++) {
        j = 0;
        for (h = 0; h < num_h; h++) {
            stripes_block(&spd, i, j, 4, 4, stride, pLSB, sample_buf, bs,
                          is_causal);
            j += 4;
        }
        if (width % 4)
            stripes_block(&spd, i, j, width % 4, 4, stride, pLSB,
                          sample_buf, bs, is_causal);
        i += 4;
    }
    j = 0;
    for (h = 0; h < num_h; h++) {
        stripes_block(&spd, i, j, 4, bh, stride, pLSB, sample_buf, bs,
                      is_causal);
        j += 4;
    }
    if (width % 4)
        stripes_block(&spd, i, j, width % 4, bh, stride, pLSB, sample_buf,
                      bs, is_causal);
}

/* ---- MagRef (ht_dec.decode_magref; jpeg2000htdec.c:1137-1185) ---- */

static void decode_magref(const uint8_t *dref, int64_t dref_len,
                          int64_t lref, int width, int height, int stride,
                          int pLSB, uint32_t *sample_buf, uint8_t *bs)
{
    RevBits mr;
    int num_v = height / 4, i_start = 0, v, i, j;
    /* dref_len covers the caller's trailing 0xFF byte past lref — the
     * oracle's reader sees it as `last` during the first refill */
    rev_init(&mr, dref, dref_len, lref - 1, 0xFF);

#define REFINE(ii, jj) do { \
        if ((bs[((ii) + 1) * stride + ((jj) + 1)] >> HT_SIGMA) & 1) { \
            uint32_t bit, t, val; \
            bs[((ii) + 1) * stride + ((jj) + 1)] |= 1 << HT_REF_IND; \
            bit = rev_get(&mr, 1); \
            t = (0xFFFFFFFEu | bit) << pLSB; \
            val = sample_buf[(ii) * stride + (jj)] & t; \
            val |= 1u << (pLSB - 1); \
            sample_buf[(ii) * stride + (jj)] = val; \
        } } while (0)

    for (v = 0; v < num_v; v++) {
        for (j = 0; j < width; j++)
            for (i = i_start; i < i_start + 4; i++)
                REFINE(i, j);
        i_start += 4;
    }
    for (j = 0; j < width; j++)
        for (i = i_start; i < i_start + height % 4; i++)
            REFINE(i, j);
}

/* ---- entry point ----
 * buf: the oracle's prepared buffer (extended, trailing 0xFF, modDcup
 * applied, Scup validated by the caller). z_blk in 1..3. pLSB = 30 -
 * S_blk; maxbp = S_blk + 1. out: height*width int32 sign-magnitude.
 * Returns 0, or -1 on invalid stream (caller raises InvalidData). */
int ht_decode_block(const uint8_t *buf, int64_t buflen, int64_t lcup,
                    int64_t pcup, int64_t lref, int pLSB, int width,
                    int height, int maxbp, int magb, int roi_shift,
                    int z_blk, int is_causal, const uint16_t *cxtvlc,
                    int32_t *out)
{
    int stride = width + 4;
    int qw = (width + 1) / 2, qh = (height + 1) / 2;
    int nq = qw * qh;
    uint32_t *sample_buf;
    uint8_t *block_states, *sigma, *E;
    uint32_t *mu;
    uint32_t mask;
    int rc, i, j;

    sample_buf = calloc((size_t)(height + 4) * stride, sizeof(uint32_t));
    block_states = calloc((size_t)(height + 4) * stride, 1);
    sigma = malloc(4 * nq + 8);
    E = malloc(4 * nq + 8);
    mu = malloc((4 * nq + 8) * sizeof(uint32_t));
    if (!sample_buf || !block_states || !sigma || !E || !mu) {
        rc = -2;
        goto done;
    }

    rc = decode_cleanup(buf, buflen, lcup, pcup, pLSB, width, height,
                        maxbp, cxtvlc, sample_buf, block_states, stride,
                        sigma, E, mu);
    if (rc)
        goto done;

    if (z_blk > 1)
        decode_sigprop(buf + lcup, lref, width, height, stride, pLSB - 1,
                       sample_buf, block_states, is_causal);
    if (z_blk > 2)
        decode_magref(buf + lcup, buflen - lcup, lref, width, height,
                      stride, pLSB - 1, sample_buf, block_states);

    /* final writeback with ROI upshift (jpeg2000htdec.c:1317-1331) */
    mask = 0xFFFFFFFFu >> (magb + 1);
    for (i = 0; i < height; i++) {
        for (j = 0; j < width; j++) {
            uint32_t v = sample_buf[i * stride + j];
            uint32_t sign = v & 0x80000000u;
            uint32_t mag = v & 0x7FFFFFFFu;
            if (roi_shift && (mag & ~mask & 0x7FFFFFFFu) == 0)
                mag = (mag << roi_shift) & 0x7FFFFFFFu;
            out[i * width + j] = (int32_t)(mag | sign);
        }
    }
    rc = 0;
done:
    free(sample_buf);
    free(block_states);
    free(sigma);
    free(E);
    free(mu);
    return rc;
}
