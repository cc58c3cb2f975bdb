/* Native tier-2 packet-header parser (single-layer fast path).
 *
 * The measured host bottleneck of the device pipeline is the per-codeblock
 * Python work in codestream/t2.py: packet-header bit reads, tag-tree
 * decodes, and the HT segment-length machine. This C parser handles the
 * profile the flagship decode path uses -- single quality layer, no
 * PPM/PPT/POC, any progression order (the *order* is computed by Python,
 * which passes band-instances in stream order) -- and emits flat per-
 * codeblock arrays the batcher consumes without building Python objects.
 *
 * Behavior parity, branch for branch, with the Python implementation
 * (itself paritied against jpeg2000dec.c):
 *   bit reader        bitio.PacketBitReader   (jpeg2000dec.c:70-90)
 *   tag tree          tagtree.TagTree.decode  (jpeg2000dec.c:93-131)
 *   packet decode     t2.decode_packet        (jpeg2000dec.c:1136-1541)
 *   length machine    t2._decode_lengths      (jpeg2000dec.c:1256-1439)
 *
 * Anything outside the profile (HT-MIXED transitions, TERMALL/BYPASS
 * legacy segmentation, >16-bit lengths) returns T2_UNSUPPORTED and the
 * caller falls back to the Python path.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define T2_OK 0
#define T2_INVALID (-1)
#define T2_UNSUPPORTED (-100)

/* ---- bit reader (PacketBitReader parity) ---- */

typedef struct {
    const uint8_t *buf;
    int64_t pos, end;
    int bit_index;
} BitReader;

static inline int br_u8(BitReader *b)
{
    if (b->pos >= b->end)
        return 0;
    return b->buf[b->pos++];
}

static inline int br_peek(const BitReader *b)
{
    return b->pos < b->end ? b->buf[b->pos] : 0;
}

static inline int br_bit(BitReader *b)
{
    if (b->bit_index == 0)
        b->bit_index = 7 + (br_u8(b) != 0xFF);
    b->bit_index--;
    return (br_peek(b) >> b->bit_index) & 1;
}

static inline uint32_t br_bits(BitReader *b, int n)
{
    uint32_t v = 0;
    for (int i = 0; i < n; i++)
        v = (v << 1) | br_bit(b);
    return v;
}

static inline void br_flush(BitReader *b)
{
    if (br_u8(b) == 0xFF)
        b->pos = b->pos < b->end ? b->pos + 1 : b->pos;
    b->bit_index = 8;
}

/* ---- tag tree (TagTree parity; levels from leaves to 1x1 root) ---- */

typedef struct {
    int n;
    int *val, *vis, *parent;
    int leaf_off;   /* leaves are nodes [0, w*h) */
} TagTree;

static int tt_init(TagTree *t, int w, int h)
{
    int sizes[64][2], nlev = 0, off = 0, offs[64];
    int ww = w, hh = h;
    while (ww > 1 || hh > 1) {
        sizes[nlev][0] = ww; sizes[nlev][1] = hh; nlev++;
        ww = (ww + 1) >> 1; hh = (hh + 1) >> 1;
    }
    sizes[nlev][0] = ww; sizes[nlev][1] = hh; nlev++;
    for (int k = 0; k < nlev; k++) {
        offs[k] = off;
        off += sizes[k][0] * sizes[k][1];
    }
    t->n = off;
    t->val = calloc((size_t)off, sizeof(int));
    t->vis = calloc((size_t)off, sizeof(int));
    t->parent = malloc((size_t)off * sizeof(int));
    if (!t->val || !t->vis || !t->parent)
        return -1;
    for (int i = 0; i < off; i++)
        t->parent[i] = -1;
    for (int k = 0; k + 1 < nlev; k++) {
        int lw = sizes[k][0], lh = sizes[k][1], o = offs[k];
        int pw = sizes[k + 1][0], po = offs[k + 1];
        for (int i = 0; i < lh; i++)
            for (int j = 0; j < lw; j++)
                t->parent[o + i * lw + j] = po + (i >> 1) * pw + (j >> 1);
    }
    t->leaf_off = 0;
    return 0;
}

static void tt_free(TagTree *t)
{
    free(t->val); free(t->vis); free(t->parent);
}

static int tt_decode(TagTree *t, BitReader *br, int leaf, int threshold)
{
    int stack[64], sp = 0;
    int node = leaf;
    while (node >= 0 && !t->vis[node]) {
        stack[sp++] = node;
        node = t->parent[node];
    }
    int curval = node >= 0 ? t->val[node] : t->val[stack[sp - 1]];
    while (curval < threshold && sp > 0) {
        node = stack[--sp];
        if (curval < t->val[node])
            curval = t->val[node];
        while (curval < threshold) {
            if (br_bit(br)) {
                t->vis[node]++;
                break;
            }
            curval++;
        }
        t->val[node] = curval;
    }
    return curval;
}

/* ---- helpers ---- */

static inline int av_log2i(uint32_t x)
{
    int n = -1;
    while (x) { n++; x >>= 1; }
    return n < 0 ? 0 : n;
}

static int getnpasses(BitReader *br)
{
    if (!br_bit(br)) return 1;
    if (!br_bit(br)) return 2;
    uint32_t num = br_bits(br, 2);
    if (num != 3) return 3 + (int)num;
    num = br_bits(br, 5);
    if (num != 31) return 6 + (int)num;
    return 37 + (int)br_bits(br, 7);
}

static int getlblockinc(BitReader *br)
{
    int res = 0;
    while (br_bit(br))
        res++;
    return res;
}

/* style bits (markers.py) */
#define CBLK_TERMALL 0x04
#define CBLK_BYPASS  0x01
#define CTSY_HTJ2K_F 0x40
#define HT_PLHD_ON   1

/* per-cblk parse state (persists across quality layers) */
typedef struct {
    int incl, npasses, lblock, ht_plhd, modes;
    int64_t lcup, lref, total;
} CState;

/* _decode_lengths parity (t2.py:281-431 / jpeg2000dec.c:1256-1439) for
 * the HTONLY profile, including placeholder-pass layers and non-initial
 * quality-layer segments; HT-MIXED transitions and TERMALL/BYPASS
 * legacy segmentation fall back (T2_UNSUPPORTED).
 * Appends this packet's segment byte-count to *seg_bytes. */
static int decode_lengths(BitReader *br, CState *cs, int newpasses,
                          int64_t *seg_bytes)
{
    int bits_to_read = 0;
    int64_t segment_bytes = 0;
    int segment_passes = 0, next_segment_passes = 0;
    int64_t pkt_bytes = 0;

    if (cs->ht_plhd) {
        int href_passes = (cs->npasses + newpasses - 1) % 3;
        segment_passes = newpasses - href_passes;
        int pass_bound = 2;
        bits_to_read = cs->lblock;
        if (segment_passes < 1) {
            /* placeholder passes or MIXED start (t2.py:294-307) */
            segment_passes = newpasses;
            while (pass_bound <= segment_passes) {
                bits_to_read++;
                pass_bound += pass_bound;
            }
            segment_bytes = br_bits(br, bits_to_read);
            if (segment_bytes)
                return T2_UNSUPPORTED;      /* MIXED or invalid */
        } else {
            while (pass_bound <= segment_passes) {
                bits_to_read++;
                pass_bound += pass_bound;
            }
            segment_bytes = br_bits(br, bits_to_read);
            if (segment_bytes) {
                if (cs->modes & CTSY_HTJ2K_F) {
                    /* first HT Cleanup pass (HTONLY arm) */
                    if (segment_bytes < 2)
                        return T2_INVALID;
                    next_segment_passes = 2;
                    cs->ht_plhd = 0;
                    cs->lcup = segment_bytes;
                } else {
                    return T2_UNSUPPORTED;
                }
            } else {
                /* probably placeholder passes; read extra length bits
                 * (t2.py:337-352) */
                segment_passes = newpasses;
                if (pass_bound <= segment_passes) {
                    for (;;) {
                        bits_to_read++;
                        pass_bound += pass_bound;
                        segment_bytes =
                            (segment_bytes << 1) | br_bit(br);
                        if (pass_bound > segment_passes)
                            break;
                    }
                    if (segment_bytes)
                        return T2_UNSUPPORTED;  /* MIXED or invalid */
                }
            }
        }
    } else if (cs->modes & CTSY_HTJ2K_F) {
        /* quality layer commences with a non-initial HT coding pass
         * (t2.py:353-368) */
        segment_passes = cs->npasses % 3;
        if (segment_passes == 0) {
            segment_passes = 1;
            next_segment_passes = 2;
        } else {
            segment_passes = newpasses > 1 ? 3 - segment_passes : 1;
            next_segment_passes = 1;
            bits_to_read = av_log2i((uint32_t)segment_passes);
        }
        bits_to_read += cs->lblock;
        segment_bytes = br_bits(br, bits_to_read);
        cs->lref += segment_bytes;
    } else if (!(cs->modes & (CBLK_TERMALL | CBLK_BYPASS))) {
        bits_to_read = cs->lblock + av_log2i((uint32_t)newpasses);
        segment_bytes = br_bits(br, bits_to_read);
        segment_passes = newpasses;
    } else {
        return T2_UNSUPPORTED;      /* RESTART/BYPASS segmentation */
    }

    cs->npasses += segment_passes;
    cs->total += segment_bytes;
    pkt_bytes += segment_bytes;

    if ((cs->modes & CTSY_HTJ2K_F) && !cs->ht_plhd) {
        newpasses -= segment_passes;
        while (newpasses > 0) {
            segment_passes = newpasses > 1 ? next_segment_passes : 1;
            next_segment_passes = 3 - next_segment_passes;
            bits_to_read = cs->lblock + av_log2i((uint32_t)segment_passes);
            segment_bytes = br_bits(br, bits_to_read);
            newpasses -= segment_passes;
            cs->lref += segment_bytes;
            cs->npasses += segment_passes;
            cs->total += segment_bytes;
            pkt_bytes += segment_bytes;
        }
    } else {
        newpasses -= segment_passes;
        if (newpasses > 0)
            return T2_UNSUPPORTED;
    }
    *seg_bytes = pkt_bytes;
    return T2_OK;
}

/* ---- the parser ---- */

int t2_parse_packets(
    const uint8_t *body, int64_t body_len,
    const uint8_t *pph, int64_t pph_len,   /* packed packet headers
                                              (PPM/PPT); NULL = inline */
    int32_t npackets,
    const int32_t *pkt_nband,
    const int32_t *pkt_csty,
    const int32_t *pkt_cblk_style,
    const int32_t *pkt_layno,
    const int32_t *bi_cblk_base,
    const int32_t *bi_cw,
    const int32_t *bi_ch,
    const int32_t *bi_magb,
    const int32_t *bi_tree,     /* band-instance ordinal (tag-tree id) */
    int32_t n_trees,
    int32_t roi_shift,
    int32_t ncblks,
    int32_t max_segs,
    int32_t *o_incl, int32_t *o_zbp, int32_t *o_nzb,
    int32_t *o_npasses, int64_t *o_lcup, int64_t *o_lref,
    int64_t *o_seg_off, int64_t *o_seg_len, int32_t *o_nseg,
    int64_t *o_len)
{
    BitReader br = { body, 0, body_len, 8 };
    /* PPM/PPT form (T.800 A.7.4/A.7.5): packet headers read from the
     * packed-headers stream, payloads from the body stream (the
     * select_header / _post_header split, t2.py:124-130,251-255).
     * Without packed headers, h aliases the body reader. */
    BitReader hbr = { pph, 0, pph_len, 8 };
    const int use_pph = pph != NULL;
    BitReader *h = use_pph ? &hbr : &br;
    int bi = 0;
    int ret = T2_OK;

    memset(o_incl, 0, (size_t)ncblks * sizeof(int32_t));
    memset(o_nseg, 0, (size_t)ncblks * sizeof(int32_t));
    memset(o_len, 0, (size_t)ncblks * sizeof(int64_t));

    CState *states = calloc((size_t)ncblks, sizeof(CState));
    TagTree *incl_t = calloc((size_t)n_trees, sizeof(TagTree));
    TagTree *zero_t = calloc((size_t)n_trees, sizeof(TagTree));
    uint8_t *tree_ready = calloc((size_t)n_trees, 1);
    /* this packet's per-cblk byte counts, for the payload pass */
    int64_t *pkt_bytes = calloc((size_t)ncblks, sizeof(int64_t));
    if (!states || !incl_t || !zero_t || !tree_ready || !pkt_bytes)
        ret = T2_INVALID;

    for (int p = 0; p < npackets && ret == T2_OK; p++) {
        int nband = pkt_nband[p];
        int csty = pkt_csty[p];
        int style = pkt_cblk_style[p];
        int layno = pkt_layno[p];

        if (style & ~CTSY_HTJ2K_F) {    /* VSC/TERMALL/BYPASS/... */
            ret = T2_UNSUPPORTED;
            break;
        }

        /* SOP before the packet (select_stream, jpeg2000dec.c:1125-1132);
         * the full 6-byte segment must fit. With packed headers the
         * body-stream SOP is skipped after the header instead
         * (_post_header -> select_stream, t2.py:251-255). */
        if ((csty & 0x02) && !use_pph) {
            if (br.pos + 2 <= br.end
                && br.buf[br.pos] == 0xFF && br.buf[br.pos + 1] == 0x91) {
                if (br.pos + 6 > br.end) {
                    ret = T2_INVALID;
                    break;
                }
                br.pos += 6;
            }
        }

        if (!br_bit(h)) {               /* empty packet */
            br_flush(h);
            if (csty & 0x04) {          /* EPH (header stream) */
                if (h->pos + 2 <= h->end
                    && h->buf[h->pos] == 0xFF && h->buf[h->pos + 1] == 0x92)
                    h->pos += 2;
            }
            if (use_pph && (csty & 0x02)) {
                if (br.pos + 6 <= br.end
                    && br.buf[br.pos] == 0xFF && br.buf[br.pos + 1] == 0x91)
                    br.pos += 6;
            }
            bi += nband;
            continue;
        }

        /* pass 1: headers */
        int first_bi = bi;
        for (int b = 0; b < nband && ret == T2_OK; b++, bi++) {
            int cw = bi_cw[bi], ch = bi_ch[bi];
            int base = bi_cblk_base[bi];
            int magb = bi_magb[bi];
            int tid = bi_tree[bi];
            int ncb = cw * ch;
            if (!ncb)
                continue;
            if (tid < 0 || tid >= n_trees) {
                ret = T2_INVALID;
                break;
            }
            if (!tree_ready[tid]) {
                if (tt_init(&incl_t[tid], cw, ch)
                    || tt_init(&zero_t[tid], cw, ch)) {
                    ret = T2_INVALID;
                    break;
                }
                tree_ready[tid] = 1;
            }
            for (int c = 0; c < ncb && ret == T2_OK; c++) {
                int idx = base + c;
                CState *cs = &states[idx];
                pkt_bytes[idx] = 0;
                int included;
                if (!cs->incl) {
                    included =
                        tt_decode(&incl_t[tid], h, c, layno + 1)
                        <= layno;
                } else {
                    included = br_bit(h);
                }
                if (!included)
                    continue;
                if (!cs->incl) {
                    int zbp = tt_decode(&zero_t[tid], h, c, 100);
                    int v = magb - (zbp - roi_shift);
                    if (v < 0 || v > 30) {
                        ret = T2_INVALID;
                        break;
                    }
                    cs->incl = 1;
                    cs->lblock = 3;
                    cs->ht_plhd = (style & CTSY_HTJ2K_F) ? HT_PLHD_ON : 0;
                    cs->modes = style;
                    o_incl[idx] = 1;
                    o_zbp[idx] = zbp;
                    o_nzb[idx] = v;
                }
                int newpasses = getnpasses(h);
                if (newpasses >= 100) {     /* MAX_PASSES guard */
                    ret = T2_UNSUPPORTED;
                    break;
                }
                int llen = getlblockinc(h);
                if (cs->lblock + llen + av_log2i((uint32_t)newpasses)
                    > 16) {
                    ret = T2_UNSUPPORTED;
                    break;
                }
                cs->lblock += llen;
                int64_t seg = 0;
                int r = decode_lengths(h, cs, newpasses, &seg);
                if (r != T2_OK) {
                    ret = r;
                    break;
                }
                pkt_bytes[idx] = seg;
                o_npasses[idx] = cs->npasses;
                o_lcup[idx] = cs->lcup ? cs->lcup : cs->total;
                o_lref[idx] = cs->lref;
                o_len[idx] = cs->total;
            }
        }
        if (ret != T2_OK)
            break;

        br_flush(h);
        if (csty & 0x04) {              /* EPH (header stream) */
            if (h->pos + 2 <= h->end
                && h->buf[h->pos] == 0xFF && h->buf[h->pos + 1] == 0x92)
                h->pos += 2;
        }
        if (use_pph && (csty & 0x02)) { /* body-stream SOP */
            if (br.pos + 6 <= br.end
                && br.buf[br.pos] == 0xFF && br.buf[br.pos + 1] == 0x91)
                br.pos += 6;
        }

        /* pass 2: payload offsets (stream order = cblk order) */
        for (int b2 = first_bi; b2 < first_bi + nband && ret == T2_OK;
             b2++) {
            int ncb = bi_cw[b2] * bi_ch[b2];
            int base = bi_cblk_base[b2];
            for (int c = 0; c < ncb; c++) {
                int idx = base + c;
                int64_t nb = pkt_bytes[idx];
                if (!nb)
                    continue;
                if (br.pos + nb > br.end) {
                    ret = T2_INVALID;
                    break;
                }
                int ns = o_nseg[idx];
                if (ns >= max_segs) {
                    ret = T2_UNSUPPORTED;
                    break;
                }
                o_seg_off[(int64_t)idx * max_segs + ns] = br.pos;
                o_seg_len[(int64_t)idx * max_segs + ns] = nb;
                o_nseg[idx] = ns + 1;
                br.pos += nb;
            }
        }
    }

    if (states) free(states);
    if (pkt_bytes) free(pkt_bytes);
    for (int t = 0; t < n_trees; t++)
        if (tree_ready && tree_ready[t]) {
            tt_free(&incl_t[t]);
            tt_free(&zero_t[t]);
        }
    if (incl_t) free(incl_t);
    if (zero_t) free(zero_t);
    if (tree_ready) free(tree_ready);
    return ret;
}
