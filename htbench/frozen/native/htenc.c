/* HT cleanup-pass encoder — native runtime component.
 *
 * Serial C mirror of ffmpeg_ht_tpu/ops/ht_enc.py (encode_cleanup and its
 * packers): MEL run-length coding, CxtVLC significance/EMB selection via
 * host-precomputed inverse tables, U-VLC pair interleaving and the MagSgn
 * magnitude/sign stream, assembled per T.814 7.2/7.3. Output is
 * byte-identical to the Python encoder (cross-checked in
 * tests/test_ht_codec.py); the per-quad scan is inherently sequential,
 * which is exactly what the scalar unit is for.
 *
 * Inverse-table layout (built by ht_enc._inverse_cxtvlc, flattened by
 * utils/native.py): for tbl in {0,1}, ctx in 0..7, rho in 0..15,
 * u_off in 0..1 there are up to 8 candidate entries of
 *   {cwd, len, emb_k, emb_1} packed as uint32:
 *   cwd | len<<8 | emb_k<<16 | emb_1<<20 | valid<<24
 * indexed [tbl][ctx][rho][u_off][cand].
 */

#include <stdint.h>
#include <string.h>

#define CAND 16

/* ---- bit sinks ---- */

typedef struct { /* forward LSB-first, 0xFF -> 7-bit follower */
    uint8_t *buf;
    int64_t len;
    int cur, nbits, cap;
} fwd_sink;

static void fwd_put(fwd_sink *s, uint32_t val, int n)
{
    for (int i = 0; i < n; i++) {
        s->cur |= ((val >> i) & 1) << s->nbits;
        if (++s->nbits == s->cap) {
            s->buf[s->len++] = (uint8_t)s->cur;
            s->cap = (s->cur == 0xFF) ? 7 : 8;
            s->cur = 0;
            s->nbits = 0;
        }
    }
}

static void fwd_finish(fwd_sink *s)
{
    if (s->nbits) {
        s->buf[s->len++] = (uint8_t)s->cur;
        s->cur = 0;
        s->nbits = 0;
    }
}

typedef struct { /* MEL state + MSB-first sink */
    uint8_t *buf;
    int64_t len;
    int cur, nbits, cap;
    int k, run;
} mel_sink;

static const int MEL_E[13] = {0,0,0,1,1,1,2,2,2,3,3,4,5};

static void mel_bit(mel_sink *s, int b)
{
    s->cur |= b << (s->cap - 1 - s->nbits);
    if (++s->nbits == s->cap) {
        s->buf[s->len++] = (uint8_t)s->cur;
        s->cap = (s->cur == 0xFF) ? 7 : 8;
        s->cur = 0;
        s->nbits = 0;
    }
}

static void mel_sym(mel_sink *s, int sym)
{
    int e = MEL_E[s->k];
    if (sym == 0) {
        if (++s->run == (1 << e)) {
            mel_bit(s, 1);
            s->run = 0;
            if (s->k < 12) s->k++;
        }
    } else {
        mel_bit(s, 0);
        for (int i = e - 1; i >= 0; i--)
            mel_bit(s, (s->run >> i) & 1);
        s->run = 0;
        if (s->k > 0) s->k--;
    }
}

static void mel_finish(mel_sink *s)
{
    if (s->run > 0)
        mel_bit(s, 1);
    if (s->nbits) {
        s->buf[s->len++] = (uint8_t)s->cur;
        s->cur = 0;
        s->nbits = 0;
    }
}

typedef struct { /* backward VLC sink, reading-order bytes */
    uint8_t *buf;      /* reading order; reversed at assembly */
    int64_t len;
    int cur, nbits, prev;
} vlc_sink;

static void vlc_bit(vlc_sink *s, int b)
{
    s->cur |= b << s->nbits;
    s->nbits++;
    int full = (s->nbits == 8)
        || (s->nbits == 7 && s->prev > 0x8F && (s->cur & 0x7F) == 0x7F);
    if (full) {
        s->buf[s->len++] = (uint8_t)s->cur;
        s->prev = s->cur;
        s->cur = 0;
        s->nbits = 0;
    }
}

static void vlc_put(vlc_sink *s, uint32_t val, int n)
{
    for (int i = 0; i < n; i++)
        vlc_bit(s, (val >> i) & 1);
}

static void vlc_finish(vlc_sink *s)
{
    if (s->nbits > 0 || s->len == 0) {
        s->buf[s->len++] = (uint8_t)s->cur;
        s->cur = 0;
        s->nbits = 0;
    }
    s->buf[0] &= 0xF0; /* clear the Scup placeholder nibble */
}

/* ---- U-VLC (inverse of ht_dec._u_prefix/_u_suffix/_u_extension) ---- */

/* prefix codes: value -> (bits, nbits); from ht_enc._uvlc_prefix_codes */
typedef struct { int bits[6], nb[6]; } upfx;

typedef struct { int v[3], n[3]; } uparts; /* prefix, suffix, ext fields */

static int uvlc_parts(const upfx *p, int u, uparts *out)
{
    out->v[1] = out->v[2] = 0;
    out->n[1] = out->n[2] = 0;
    if (u <= 2) {
        out->v[0] = p->bits[u]; out->n[0] = p->nb[u];
        return 0;
    }
    if (u <= 4) {
        out->v[0] = p->bits[3]; out->n[0] = p->nb[3];
        out->v[1] = u - 3; out->n[1] = 1;
        return 0;
    }
    out->v[0] = p->bits[5]; out->n[0] = p->nb[5];
    {
        int s = u - 5;
        if (s < 28) {
            out->v[1] = s; out->n[1] = 5;
        } else {
            int sf = 28 + (s % 4);
            int ext = (s - sf) >> 2;
            if (ext < 0 || ext > 15)
                return -1;
            out->v[1] = sf; out->n[1] = 5;
            out->v[2] = ext; out->n[2] = 4;
        }
    }
    return 0;
}

static void put_parts(vlc_sink *v, const uparts *a)
{
    for (int i = 0; i < 3; i++)
        vlc_put(v, a->v[i], a->n[i]);
}

static void put_pair(vlc_sink *v, const uparts *a, const uparts *b)
{
    for (int i = 0; i < 3; i++) {
        vlc_put(v, a->v[i], a->n[i]);
        vlc_put(v, b->v[i], b->n[i]);
    }
}

/* ---- per-block encode ---- */

typedef struct {
    const uint32_t *inv;     /* [2][8][16][2][CAND] packed entries */
    const upfx *pfx;
    int maxbp;
    /* per-block scratch (max 33x33 quads) */
    uint8_t sigma[4 * 1156 + 8];
    int32_t v[4 * 1156 + 8];
    uint8_t E[4 * 1156 + 8];
} henc;

static int bitlen(uint32_t x) { return 32 - __builtin_clz(x | 1); }

static const uint32_t *inv_at(const henc *H, int tbl, int ctx, int rho,
                              int uoff)
{
    return H->inv + (((tbl * 8 + ctx) * 16 + rho) * 2 + uoff) * CAND;
}

/* pick the CxtVLC entry (ht_enc._pick_entry): maximize popcount(emb_k),
 * tie-break shortest codeword; feasibility mirrors the Python rules. */
static int pick_entry(const henc *H, int tbl, int ctx, int rho, int uoff,
                      int U, int64_t base, int *cwd, int *len, int *ek)
{
    const uint32_t *cands = inv_at(H, tbl, ctx, rho, uoff);
    int best = -1, bcost = -1, blen = 99, bcwd = 0, bek = 0;
    for (int c = 0; c < CAND; c++) {
        uint32_t e = cands[c];
        if (!(e >> 24))
            break;
        int k = (e >> 16) & 0xF, e1 = (e >> 20) & 0xF;
        int ok = 1;
        for (int i = 0; i < 4 && ok; i++) {
            if (!((rho >> i) & 1)) {
                if ((k >> i) & 1) ok = 0;
                continue;
            }
            if ((k >> i) & 1) {
                if (U < 2 || (H->v[base + i] >> (U - 1)) != ((e1 >> i) & 1))
                    ok = 0;
            } else if (H->E[base + i] > U) {
                ok = 0;
            }
        }
        if (!ok)
            continue;
        int cost = __builtin_popcount(k & rho);
        int l = (e >> 8) & 0xFF;
        if (cost > bcost || (cost == bcost && l < blen)) {
            best = c; bcost = cost; blen = l;
            bcwd = e & 0xFF; bek = k;
        }
    }
    if (best < 0)
        return -1;
    *cwd = bcwd; *len = blen; *ek = bek;
    return 0;
}

static void emit_magsgn(henc *H, fwd_sink *ms, int64_t q, int U, int ek)
{
    for (int i = 0; i < 4; i++) {
        int64_t idx = 4 * q + i;
        if (!H->sigma[idx])
            continue;
        fwd_put(ms, (uint32_t)H->v[idx], U - ((ek >> i) & 1));
    }
}

static int quad_U(const henc *H, int64_t q)
{
    int m = 0;
    for (int i = 0; i < 4; i++)
        if (H->sigma[4 * q + i] && H->E[4 * q + i] > m)
            m = H->E[4 * q + i];
    return m;
}

static int rho_of(const henc *H, int64_t q)
{
    return H->sigma[4 * q] | (H->sigma[4 * q + 1] << 1)
        | (H->sigma[4 * q + 2] << 2) | (H->sigma[4 * q + 3] << 3);
}

/* returns u (>=0) or -1 on failure; emits MEL sig bit + VLC codeword */
static int encode_quad(henc *H, mel_sink *mel, vlc_sink *vlc, int64_t q,
                       int tbl, int ctx, int kappa, int *U_out, int *ek_out)
{
    int rho = rho_of(H, q);
    *U_out = 0;
    *ek_out = 0;
    if (ctx == 0) {
        mel_sym(mel, rho ? 1 : 0);
        if (rho == 0)
            return 0;
    }
    if (rho == 0) {
        int cwd, len, ek;
        if (pick_entry(H, tbl, ctx, 0, 0, 0, 4 * q, &cwd, &len, &ek))
            return -1;
        vlc_put(vlc, cwd, len);
        return 0;
    }
    int U = quad_U(H, q);
    if (U < kappa) U = kappa;
    int u = U - kappa;
    int uoff = u > 0;
    int cwd, len, ek;
    if (pick_entry(H, tbl, ctx, rho, uoff, U, 4 * q, &cwd, &len, &ek)) {
        U += 1;
        u = U - kappa;
        uoff = 1;
        if (pick_entry(H, tbl, ctx, rho, uoff, U, 4 * q, &cwd, &len, &ek))
            return -1;
    }
    if (U > H->maxbp)
        return -1;
    vlc_put(vlc, cwd, len);
    *U_out = U;
    *ek_out = ek;
    return u;
}

/* Encode one block's cleanup segment into out (caller provides >= 8*w*h+64
 * bytes); returns Lcup, or -1 on failure (caller falls back to Python). */
int64_t ht_encode_cleanup(const int64_t *mag, const int64_t *sign,
                          int64_t width, int64_t height, int64_t zbp,
                          const uint32_t *inv_tables, const int *pfx_bits,
                          const int *pfx_nb, uint8_t *out, uint8_t *scratch)
{
    henc H;
    upfx pfx;
    H.inv = inv_tables;
    H.pfx = &pfx;
    H.maxbp = (int)zbp + 1;
    for (int i = 0; i < 6; i++) {
        pfx.bits[i] = pfx_bits[i];
        pfx.nb[i] = pfx_nb[i];
    }

    int64_t qw = (width + 1) / 2, qh = (height + 1) / 2;
    if (4 * qw * qh + 8 > (int64_t)sizeof(H.sigma))
        return -1;
    memset(H.sigma, 0, 4 * qw * qh + 8);
    memset(H.E, 0, 4 * qw * qh + 8);

    for (int64_t qy = 0; qy < qh; qy++)
        for (int64_t qx = 0; qx < qw; qx++) {
            int64_t q = qy * qw + qx;
            for (int i = 0; i < 4; i++) {
                int64_t x = 2 * qx + (i >> 1), y = 2 * qy + (i & 1);
                if (x >= width || y >= height)
                    continue;
                int64_t m = mag[y * width + x];
                if (!m)
                    continue;
                int64_t idx = 4 * q + i;
                H.sigma[idx] = 1;
                H.v[idx] = (int32_t)(2 * (m - 1) + sign[y * width + x]);
                H.E[idx] = (uint8_t)bitlen((uint32_t)H.v[idx]);
            }
        }

    /* sinks use scratch: [ms | mel | vlc], each sized 8*w*h + 80 */
    int64_t cap = 8 * width * height + 80;
    fwd_sink ms = { scratch, 0, 0, 0, 8 };
    mel_sink mel = { scratch + cap, 0, 0, 0, 8, 0, 0 };
    vlc_sink vlc = { scratch + 2 * cap, 0, 0x0F, 4, 0xFF };

    int U1, U2, ek1, ek2, u1, u2;
    uparts a, b;

    /* initial row */
    int ctx = 0;
    int64_t q = 0;
    while (q < qw - 1) {
        u1 = encode_quad(&H, &mel, &vlc, q, 0, ctx, 1, &U1, &ek1);
        if (u1 < 0) return -1;
        ctx = (H.sigma[4 * q] | H.sigma[4 * q + 1])
            + (H.sigma[4 * q + 2] << 1) + (H.sigma[4 * q + 3] << 2);
        u2 = encode_quad(&H, &mel, &vlc, q + 1, 0, ctx, 1, &U2, &ek2);
        if (u2 < 0) return -1;
        ctx = (H.sigma[4 * q + 4] | H.sigma[4 * q + 5])
            + (H.sigma[4 * q + 6] << 1) + (H.sigma[4 * q + 7] << 2);
        if (u1 > 0 && u2 > 0) {
            if (u1 >= 3 && u2 >= 3) {
                mel_sym(&mel, 1);
                if (uvlc_parts(&pfx, u1 - 2, &a)
                    || uvlc_parts(&pfx, u2 - 2, &b))
                    return -1;
                put_pair(&vlc, &a, &b);
            } else if (u1 >= 3) {
                mel_sym(&mel, 0);
                if (uvlc_parts(&pfx, u1, &a))
                    return -1;
                vlc_put(&vlc, a.v[0], a.n[0]);
                vlc_put(&vlc, u2 - 1, 1);
                vlc_put(&vlc, a.v[1], a.n[1]);
                vlc_put(&vlc, a.v[2], a.n[2]);
            } else {
                mel_sym(&mel, 0);
                if (uvlc_parts(&pfx, u1, &a) || uvlc_parts(&pfx, u2, &b))
                    return -1;
                put_pair(&vlc, &a, &b);
            }
        } else if (u1 > 0) {
            if (uvlc_parts(&pfx, u1, &a)) return -1;
            put_parts(&vlc, &a);
        } else if (u2 > 0) {
            if (uvlc_parts(&pfx, u2, &b)) return -1;
            put_parts(&vlc, &b);
        }
        emit_magsgn(&H, &ms, q, U1, ek1);
        emit_magsgn(&H, &ms, q + 1, U2, ek2);
        q += 2;
    }
    if (qw & 1) {
        u1 = encode_quad(&H, &mel, &vlc, q, 0, ctx, 1, &U1, &ek1);
        if (u1 < 0) return -1;
        if (u1 > 0) {
            if (uvlc_parts(&pfx, u1, &a)) return -1;
            put_parts(&vlc, &a);
        }
        emit_magsgn(&H, &ms, q, U1, ek1);
        q += 1;
    }

    /* non-initial rows */
    for (int64_t row = 1; row < qh; row++) {
        while (q - row * qw < qw - 1 && q < qh * qw) {
            int64_t q1 = q, q2 = q + 1;
            /* ctx_above / kappa_of (mirrors ht_enc.encode_cleanup) */
            int c1 = H.sigma[4 * (q1 - qw) + 1]
                | (H.sigma[4 * (q1 - qw) + 3] << 2);
            if (q1 % qw != 0) {
                c1 |= H.sigma[4 * (q1 - qw) - 1];
                c1 += (H.sigma[4 * q1 - 1] | H.sigma[4 * q1 - 2]) << 1;
            }
            if ((q1 + 1) % qw != 0)
                c1 |= H.sigma[4 * (q1 - qw) + 5] << 2;
            {
                int rho1 = rho_of(&H, q1);
                int pc = __builtin_popcount(rho1);
                int gamma = pc > 1;
                int e_n = H.E[4 * (q1 - qw) + 1];
                int e_ne = H.E[4 * (q1 - qw) + 3];
                int e_nw = (q1 % qw != 0)
                    ? H.E[(4 * (q1 - qw) - 1 > 0) ? 4 * (q1 - qw) - 1 : 0]
                    : 0;
                int e_nf = ((q1 + 1) % qw != 0)
                    ? H.E[4 * (q1 - qw) + 5] : 0;
                int mx = e_n;
                if (e_ne > mx) mx = e_ne;
                if (e_nw > mx) mx = e_nw;
                if (e_nf > mx) mx = e_nf;
                int kap1 = gamma * (mx - 1);
                if (kap1 < 1) kap1 = 1;
                u1 = encode_quad(&H, &mel, &vlc, q1, 1, c1, kap1, &U1,
                                 &ek1);
                if (u1 < 0) return -1;
            }
            int c2 = H.sigma[4 * (q2 - qw) + 1]
                | (H.sigma[4 * (q2 - qw) + 3] << 2);
            if (q2 % qw != 0) {
                c2 |= H.sigma[4 * (q2 - qw) - 1];
                c2 += (H.sigma[4 * q2 - 1] | H.sigma[4 * q2 - 2]) << 1;
            }
            if ((q2 + 1) % qw != 0)
                c2 |= H.sigma[4 * (q2 - qw) + 5] << 2;
            {
                int rho2 = rho_of(&H, q2);
                int pc = __builtin_popcount(rho2);
                int gamma = pc > 1;
                int e_n = H.E[4 * (q2 - qw) + 1];
                int e_ne = H.E[4 * (q2 - qw) + 3];
                int e_nw = (q2 % qw != 0) ? H.E[4 * (q2 - qw) - 1] : 0;
                int e_nf = ((q2 + 1) % qw != 0)
                    ? H.E[4 * (q2 - qw) + 5] : 0;
                int mx = e_n;
                if (e_ne > mx) mx = e_ne;
                if (e_nw > mx) mx = e_nw;
                if (e_nf > mx) mx = e_nf;
                int kap2 = gamma * (mx - 1);
                if (kap2 < 1) kap2 = 1;
                u2 = encode_quad(&H, &mel, &vlc, q2, 1, c2, kap2, &U2,
                                 &ek2);
                if (u2 < 0) return -1;
            }
            if (u1 > 0 && u2 > 0) {
                if (uvlc_parts(&pfx, u1, &a) || uvlc_parts(&pfx, u2, &b))
                    return -1;
                put_pair(&vlc, &a, &b);
            } else if (u1 > 0) {
                if (uvlc_parts(&pfx, u1, &a)) return -1;
                put_parts(&vlc, &a);
            } else if (u2 > 0) {
                if (uvlc_parts(&pfx, u2, &b)) return -1;
                put_parts(&vlc, &b);
            }
            emit_magsgn(&H, &ms, q1, U1, ek1);
            emit_magsgn(&H, &ms, q2, U2, ek2);
            q += 2;
        }
        if (qw & 1) {
            int64_t q1 = q;
            int c1 = H.sigma[4 * (q1 - qw) + 1]
                | (H.sigma[4 * (q1 - qw) + 3] << 2);
            if (q1 % qw != 0) {
                c1 |= H.sigma[4 * (q1 - qw) - 1];
                c1 += (H.sigma[4 * q1 - 1] | H.sigma[4 * q1 - 2]) << 1;
            }
            if ((q1 + 1) % qw != 0)
                c1 |= H.sigma[4 * (q1 - qw) + 5] << 2;
            int rho1 = rho_of(&H, q1);
            int pc = __builtin_popcount(rho1);
            int gamma = pc > 1;
            int e_n = H.E[4 * (q1 - qw) + 1];
            int e_ne = H.E[4 * (q1 - qw) + 3];
            int e_nw = (q1 % qw != 0) ? H.E[4 * (q1 - qw) - 1] : 0;
            int e_nf = ((q1 + 1) % qw != 0) ? H.E[4 * (q1 - qw) + 5] : 0;
            int mx = e_n;
            if (e_ne > mx) mx = e_ne;
            if (e_nw > mx) mx = e_nw;
            if (e_nf > mx) mx = e_nf;
            int kap1 = gamma * (mx - 1);
            if (kap1 < 1) kap1 = 1;
            u1 = encode_quad(&H, &mel, &vlc, q1, 1, c1, kap1, &U1, &ek1);
            if (u1 < 0) return -1;
            if (u1 > 0) {
                if (uvlc_parts(&pfx, u1, &a)) return -1;
                put_parts(&vlc, &a);
            }
            emit_magsgn(&H, &ms, q1, U1, ek1);
            q += 1;
        }
    }

    fwd_finish(&ms);
    mel_finish(&mel);
    vlc_finish(&vlc);

    /* assemble Dcup = ms || mel || reversed(vlc) || Scup trailer */
    int64_t scup = mel.len + vlc.len + 1;
    if (scup < 2 || scup > 4079)
        return -1;
    int64_t pos = 0;
    memcpy(out + pos, ms.buf, ms.len);
    pos += ms.len;
    memcpy(out + pos, mel.buf, mel.len);
    pos += mel.len;
    for (int64_t i = 0; i < vlc.len; i++)
        out[pos + i] = vlc.buf[vlc.len - 1 - i];
    pos += vlc.len;
    out[pos - 1] |= (uint8_t)(scup & 0xF);
    out[pos] = (uint8_t)(scup >> 4);
    return pos + 1;
}
