/* Legacy EBCOT Tier-1 decoder (MQ arithmetic coder), native tier.
 *
 * C port of ffmpeg_ht_tpu/ops/ebcot.py (which carries behavior parity
 * with the reference's mqcdec.c + jpeg2000dec.c:1872-2089). Plain J2K
 * and HT-MIXED codeblocks are inherently bit-serial per sample, so they
 * run on the host; this closes the 1-core-Python cliff for that tier
 * (VERDICT round-2 item 3).
 *
 * Exported: ebcot_decode_cblk() — one codeblock to sign-magnitude int32
 * with the binary point at 31 - magb (the HT path's convention).
 */

#include <stdint.h>
#include <string.h>

/* ---- T1 flag bits (jpeg2000.h:84-108 semantics) ---- */
#define SIG_N  0x0001
#define SIG_E  0x0002
#define SIG_W  0x0004
#define SIG_S  0x0008
#define SIG_NE 0x0010
#define SIG_NW 0x0020
#define SIG_SE 0x0040
#define SIG_SW 0x0080
#define SIG_NB 0x00FF
#define SGN_N  0x0100
#define SGN_S  0x0200
#define SGN_W  0x0400
#define SGN_E  0x0800
#define T1_VIS 0x1000
#define T1_SIG 0x2000
#define T1_REF 0x4000

#define CX_UNI 17
#define CX_RL  18

/* ---- MQ coder state machine (ISO 15444-1 Table C.2, doubled states
 * carrying the MPS bit in bit 0 — same layout as ops/tables.py) ---- */
static const uint16_t MQ_QE[94] = {
    0x5601,0x5601,0x3401,0x3401,0x1801,0x1801,0x0AC1,0x0AC1,
    0x0521,0x0521,0x0221,0x0221,0x5601,0x5601,0x5401,0x5401,
    0x4801,0x4801,0x3801,0x3801,0x3001,0x3001,0x2401,0x2401,
    0x1C01,0x1C01,0x1601,0x1601,0x5601,0x5601,0x5401,0x5401,
    0x5101,0x5101,0x4801,0x4801,0x3801,0x3801,0x3401,0x3401,
    0x3001,0x3001,0x2801,0x2801,0x2401,0x2401,0x2201,0x2201,
    0x1C01,0x1C01,0x1801,0x1801,0x1601,0x1601,0x1401,0x1401,
    0x1201,0x1201,0x1101,0x1101,0x0AC1,0x0AC1,0x09C1,0x09C1,
    0x08A1,0x08A1,0x0521,0x0521,0x0441,0x0441,0x02A1,0x02A1,
    0x0221,0x0221,0x0141,0x0141,0x0111,0x0111,0x0085,0x0085,
    0x0049,0x0049,0x0025,0x0025,0x0015,0x0015,0x0009,0x0009,
    0x0005,0x0005,0x0001,0x0001,0x5601,0x5601,
};
static const uint8_t MQ_NLPS[94] = {
    3,2,12,13,18,19,24,25,58,59,66,67,13,12,28,29,
    28,29,28,29,34,35,36,37,40,41,42,43,29,28,28,29,
    30,31,32,33,34,35,36,37,38,39,38,39,40,41,42,43,
    44,45,46,47,48,49,50,51,52,53,54,55,56,57,58,59,
    60,61,62,63,64,65,66,67,68,69,70,71,72,73,74,75,
    76,77,78,79,80,81,82,83,84,85,86,87,92,93,
};
static const uint8_t MQ_NMPS[94] = {
    2,3,4,5,6,7,8,9,10,11,76,77,14,15,16,17,
    18,19,20,21,22,23,24,25,26,27,58,59,30,31,32,33,
    34,35,36,37,38,39,40,41,42,43,44,45,46,47,48,49,
    50,51,52,53,54,55,56,57,58,59,60,61,62,63,64,65,
    66,67,68,69,70,71,72,73,74,75,76,77,78,79,80,81,
    82,83,84,85,86,87,88,89,90,91,90,91,92,93,
};

/* ---- context LUTs built once (jpeg2000.c:96-176 semantics) ---- */
static uint8_t SIGCTX[256][4];
static uint8_t SGNCTX[16][16];
static uint8_t XORBIT[16][16];
static int luts_ready = 0;

static void build_luts(void)
{
    if (luts_ready) return;
    for (int flag = 0; flag < 256; flag++) {
        int h = !!(flag & SIG_E) + !!(flag & SIG_W);
        int v = !!(flag & SIG_N) + !!(flag & SIG_S);
        int d = !!(flag & SIG_NE) + !!(flag & SIG_NW)
              + !!(flag & SIG_SE) + !!(flag & SIG_SW);
        for (int bandno = 0; bandno < 4; bandno++) {
            int hh = (bandno == 1) ? v : h;
            int vv = (bandno == 1) ? h : v;
            int c;
            if (bandno < 3) {
                if (hh == 2) c = 8;
                else if (hh == 1) c = (vv >= 1) ? 7 : (d >= 1 ? 6 : 5);
                else if (vv == 2) c = 4;
                else if (vv == 1) c = 3;
                else if (d >= 2) c = 2;
                else if (d == 1) c = 1;
                else c = 0;
            } else {
                if (d >= 3) c = 8;
                else if (d == 2) c = (hh + vv >= 1) ? 7 : 6;
                else if (d == 1)
                    c = (hh + vv >= 2) ? 5 : (hh + vv == 1 ? 4 : 3);
                else if (hh + vv >= 2) c = 2;
                else if (hh + vv == 1) c = 1;
                else c = 0;
            }
            SIGCTX[flag][bandno] = (uint8_t)c;
        }
    }
    static const int contrib[3][3] = {{0,-1,1},{-1,-1,0},{1,0,1}};
    static const int ctxlbl[3][3] = {{13,12,11},{10,9,10},{11,12,13}};
    static const int xorb[3][3] = {{1,1,1},{1,0,0},{0,0,0}};
    for (int i = 0; i < 16; i++) {
        for (int j = 0; j < 16; j++) {
            int flag = i + (j << 8);
            int se = (flag & SIG_E) ? ((flag & SGN_E) ? 1 : 2) : 0;
            int sw = (flag & SIG_W) ? ((flag & SGN_W) ? 1 : 2) : 0;
            int ss = (flag & SIG_S) ? ((flag & SGN_S) ? 1 : 2) : 0;
            int sn = (flag & SIG_N) ? ((flag & SGN_N) ? 1 : 2) : 0;
            int h = contrib[se][sw] + 1;
            int v = contrib[ss][sn] + 1;
            SGNCTX[i][j] = (uint8_t)ctxlbl[h][v];
            XORBIT[i][j] = (uint8_t)xorb[h][v];
        }
    }
    luts_ready = 1;
}

static const uint8_t REFCTX[2][2] = {{14, 15}, {16, 16}};

/* ---- MQ decoder (mqcdec.c parity via ops/ebcot.MQDecoder) ---- */
typedef struct {
    const uint8_t *data;
    int64_t len;
    int64_t bp;
    uint32_t a, c;
    int raw;
    uint8_t cx[19];
} MQDec;

static uint8_t byte_at(const MQDec *m, int64_t i)
{
    return i < m->len ? m->data[i] : 0xFF;
}

static void mq_init_states(MQDec *m)
{
    memset(m->cx, 0, sizeof(m->cx));
    m->cx[CX_UNI] = 2 * 46;
    m->cx[CX_RL] = 2 * 3;
    m->cx[0] = 2 * 4;
}

static void mq_bytein(MQDec *m)
{
    if (byte_at(m, m->bp) == 0xFF) {
        if (byte_at(m, m->bp + 1) > 0x8F) {
            m->c += 1;
        } else {
            m->bp += 1;
            m->c += 2 + 0xFE00 - ((uint32_t)byte_at(m, m->bp) << 9);
        }
    } else {
        m->bp += 1;
        m->c += 1 + 0xFF00 - ((uint32_t)byte_at(m, m->bp) << 8);
    }
}

static void mq_reinit(MQDec *m, int64_t bp, int raw, int reset)
{
    m->raw = raw;
    if (reset) mq_init_states(m);
    m->bp = bp;
    m->c = (uint32_t)(byte_at(m, bp) ^ 0xFF) << 16;
    mq_bytein(m);
    m->c <<= 7;
    m->a = 0x8000;
}

static int mq_exchange(MQDec *m, int cx, int lps)
{
    int state = m->cx[cx];
    uint32_t qe = MQ_QE[state];
    int d;
    if ((m->a < qe) ^ (!lps)) {
        if (lps) m->a = qe;
        d = state & 1;
        m->cx[cx] = MQ_NMPS[state];
    } else {
        if (lps) m->a = qe;
        d = 1 - (state & 1);
        m->cx[cx] = MQ_NLPS[state];
    }
    for (;;) {
        if (!(m->c & 0xFF)) {
            m->c -= 0x100;
            mq_bytein(m);
        }
        m->a += m->a;
        m->c += m->c;
        if (m->a & 0x8000) break;
    }
    return d;
}

static int mq_decode(MQDec *m, int cx)
{
    if (m->raw) {
        int bit = (m->c & 0x40000000) ? 0 : 1;
        if (!(m->c & 0xFF)) {
            m->c -= 0x100;
            mq_bytein(m);
        }
        m->c += m->c;
        return bit;
    }
    int state = m->cx[cx];
    m->a -= MQ_QE[state];
    if ((m->c >> 16) < m->a) {
        if (m->a & 0x8000) return state & 1;
        return mq_exchange(m, cx, 0);
    }
    m->c -= (uint32_t)m->a << 16;
    return mq_exchange(m, cx, 1);
}

/* ---- passes ---- */
static void set_significance(uint32_t *flags, int stride, int x, int y,
                             int negative)
{
    x += 1; y += 1;
    flags[y * stride + x] |= T1_SIG;
    if (negative) {
        flags[y * stride + x + 1] |= SIG_W | SGN_W;
        flags[y * stride + x - 1] |= SIG_E | SGN_E;
        flags[(y + 1) * stride + x] |= SIG_N | SGN_N;
        flags[(y - 1) * stride + x] |= SIG_S | SGN_S;
    } else {
        flags[y * stride + x + 1] |= SIG_W;
        flags[y * stride + x - 1] |= SIG_E;
        flags[(y + 1) * stride + x] |= SIG_N;
        flags[(y - 1) * stride + x] |= SIG_S;
    }
    flags[(y + 1) * stride + x + 1] |= SIG_NW;
    flags[(y + 1) * stride + x - 1] |= SIG_NE;
    flags[(y - 1) * stride + x + 1] |= SIG_SW;
    flags[(y - 1) * stride + x - 1] |= SIG_SE;
}

#define VSC_MASK (~(uint32_t)(SIG_S | SIG_SW | SIG_SE | SGN_S))

static void sigpass(MQDec *mqc, uint32_t *data, uint32_t *flags, int stride,
                    int width, int height, int bpno, int bandpos, int vsc)
{
    uint32_t mask = 3u << (bpno - 1);
    for (int y0 = 0; y0 < height; y0 += 4)
        for (int x = 0; x < width; x++)
            for (int y = y0; y < height && y < y0 + 4; y++) {
                uint32_t fmask = (vsc && y == y0 + 3) ? VSC_MASK
                                                      : 0xFFFFFFFFu;
                uint32_t f = flags[(y + 1) * stride + x + 1];
                if ((f & SIG_NB & fmask) && !(f & (T1_SIG | T1_VIS))) {
                    if (mq_decode(mqc,
                                  SIGCTX[f & fmask & 255][bandpos])) {
                        uint32_t fm = f & fmask;
                        int xb = XORBIT[fm & 15][(fm >> 8) & 15];
                        int cn = SGNCTX[fm & 15][(fm >> 8) & 15];
                        if (mqc->raw)
                            data[y * stride + x] |=
                                (uint32_t)mq_decode(mqc, cn) << 31;
                        else
                            data[y * stride + x] |=
                                (uint32_t)(mq_decode(mqc, cn) ^ xb) << 31;
                        data[y * stride + x] |= mask;
                        set_significance(flags, stride, x, y,
                                         !!(data[y * stride + x]
                                            & 0x80000000u));
                    }
                    flags[(y + 1) * stride + x + 1] |= T1_VIS;
                }
            }
}

static void refpass(MQDec *mqc, uint32_t *data, uint32_t *flags, int stride,
                    int width, int height, int bpno, int vsc)
{
    uint32_t phalf = 1u << (bpno - 1);
    for (int y0 = 0; y0 < height; y0 += 4)
        for (int x = 0; x < width; x++)
            for (int y = y0; y < height && y < y0 + 4; y++) {
                uint32_t f = flags[(y + 1) * stride + x + 1];
                if ((f & (T1_SIG | T1_VIS)) == T1_SIG) {
                    uint32_t fmask = (vsc && y == y0 + 3) ? VSC_MASK
                                                          : 0xFFFFFFFFu;
                    uint32_t fm = f & fmask;
                    int cn = REFCTX[(fm >> 14) & 1][(fm & 255) != 0];
                    data[y * stride + x] |= phalf;
                    if (mq_decode(mqc, cn))
                        data[y * stride + x] |= phalf << 1;
                    else
                        data[y * stride + x] &= ~(phalf << 1);
                    flags[(y + 1) * stride + x + 1] |= T1_REF;
                }
            }
}

static int clnpass(MQDec *mqc, uint32_t *data, uint32_t *flags, int stride,
                   int width, int height, int bpno, int bandpos,
                   int seg_symbols, int vsc)
{
    uint32_t mask = 3u << (bpno - 1);
    for (int y0 = 0; y0 < height; y0 += 4)
        for (int x = 0; x < width; x++) {
            uint32_t fmask = vsc ? VSC_MASK : 0xFFFFFFFFu;
            int runlen = 0, dec = 0;
            if (y0 + 3 < height
                && !((flags[(y0 + 1) * stride + x + 1]
                      & (SIG_NB | T1_VIS | T1_SIG))
                     || (flags[(y0 + 2) * stride + x + 1]
                         & (SIG_NB | T1_VIS | T1_SIG))
                     || (flags[(y0 + 3) * stride + x + 1]
                         & (SIG_NB | T1_VIS | T1_SIG))
                     || (flags[(y0 + 4) * stride + x + 1]
                         & (SIG_NB | T1_VIS | T1_SIG) & fmask))) {
                if (!mq_decode(mqc, CX_RL))
                    continue;
                runlen = mq_decode(mqc, CX_UNI);
                runlen = (runlen << 1) | mq_decode(mqc, CX_UNI);
                dec = 1;
            }
            for (int y = y0 + runlen; y < height && y < y0 + 4; y++) {
                uint32_t fm2 = (vsc && y == y0 + 3) ? VSC_MASK
                                                    : 0xFFFFFFFFu;
                uint32_t f = flags[(y + 1) * stride + x + 1];
                if (!dec) {
                    if (!(f & (T1_SIG | T1_VIS)))
                        dec = mq_decode(mqc,
                                        SIGCTX[f & fm2 & 255][bandpos]);
                }
                if (dec) {
                    uint32_t fm = f & fm2;
                    int xb = XORBIT[fm & 15][(fm >> 8) & 15];
                    int cn = SGNCTX[fm & 15][(fm >> 8) & 15];
                    data[y * stride + x] |=
                        (uint32_t)(mq_decode(mqc, cn) ^ xb) << 31;
                    data[y * stride + x] |= mask;
                    set_significance(flags, stride, x, y,
                                     !!(data[y * stride + x]
                                        & 0x80000000u));
                }
                dec = 0;
                flags[(y + 1) * stride + x + 1] &= ~(uint32_t)T1_VIS;
            }
        }
    if (seg_symbols) {
        int val = mq_decode(mqc, CX_UNI);
        val = (val << 1) + mq_decode(mqc, CX_UNI);
        val = (val << 1) + mq_decode(mqc, CX_UNI);
        val = (val << 1) + mq_decode(mqc, CX_UNI);
        if (val != 0xA)
            return 1;   /* segmentation symbol mismatch (warn upstream) */
    }
    return 0;
}

/* needs_termination (t2.py:27-40 / jpeg2000.h:302-317 parity) */
static int needs_term(int style, int passno)
{
    if (style & 0x01) {             /* CBLK_BYPASS */
        int ptype = passno % 3;
        passno /= 3;
        if (ptype == 0 && passno > 2) return 2;
        if (ptype == 2 && passno > 2) return 1;
        if (style & 0x04)           /* CBLK_TERMALL */
            return passno > 2 ? 2 : 1;
    }
    if (style & 0x04)
        return 1;
    return 0;
}

/* returns 0 ok, <0 invalid, 1 ok-with-segsym-warning */
int ebcot_decode_cblk(
    const uint8_t *data, int64_t data_len,
    int32_t npasses, int32_t nonzerobits, int32_t cblk_style,
    int32_t width, int32_t height, int32_t bandpos, int32_t magb,
    int32_t roi_shift, int32_t nb_terminations,
    const int64_t *data_start, int32_t n_data_start,
    int32_t log2_cblk_width, int32_t stride_unused,
    uint32_t *work /* stride*(height+3) + stride*height scratch */,
    int32_t *out /* height*width */)
{
    (void)stride_unused;
    build_luts();
    int stride = (1 << log2_cblk_width) + 2;
    uint32_t *d = work;
    uint32_t *flags = work + (size_t)stride * height;
    memset(d, 0, sizeof(uint32_t) * (size_t)stride * height);
    memset(flags, 0, sizeof(uint32_t) * (size_t)stride * (height + 2));
    memset(out, 0, sizeof(int32_t) * (size_t)width * height);
    if (data_len == 0 || npasses == 0)
        return 0;

    MQDec mqc;
    mqc.data = data;
    mqc.len = data_len;    /* reads past end synthesize 0xFF */
    mq_init_states(&mqc);
    mq_reinit(&mqc, 0, 0, 0);

    int vsc = cblk_style & 0x08;
    int warn = 0;
    int bpno = nonzerobits - 1 + 31 - magb - 1 - roi_shift;
    int pass_t = 2, pass_cnt = 0, term_cnt = 0;

    for (int passno = npasses; passno > 0;) {
        passno--;
        if (bpno < 0 || bpno > 29)
            return -1;
        if (pass_t == 0)
            sigpass(&mqc, d, flags, stride, width, height, bpno + 1,
                    bandpos, vsc);
        else if (pass_t == 1)
            refpass(&mqc, d, flags, stride, width, height, bpno + 1, vsc);
        else
            warn |= clnpass(&mqc, d, flags, stride, width, height,
                            bpno + 1, bandpos, cblk_style & 0x20, vsc);
        if (cblk_style & 0x02)      /* RESET */
            mq_init_states(&mqc);

        if (passno) {
            int coder_type = needs_term(cblk_style, pass_cnt);
            if (coder_type) {
                if (term_cnt >= nb_terminations)
                    return -2;      /* missing needed termination */
                term_cnt++;
                if (term_cnt >= n_data_start)
                    return -3;
                mq_reinit(&mqc, data_start[term_cnt],
                          coder_type == 2, 0);
            }
        }
        pass_t++;
        if (pass_t == 3) { bpno--; pass_t = 0; }
        pass_cnt++;
    }

    uint32_t mask = 0xFFFFFFFFu >> (magb + 1);
    for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++) {
            uint32_t v = d[y * stride + x];
            uint32_t sign = v & 0x80000000u;
            uint32_t mag = v & 0x7FFFFFFFu;
            if (roi_shift && !(mag & ~mask & 0x7FFFFFFFu))
                mag = (mag << roi_shift) & 0x7FFFFFFFu;
            out[y * width + x] = (int32_t)(mag | sign);
        }
    return warn;
}
