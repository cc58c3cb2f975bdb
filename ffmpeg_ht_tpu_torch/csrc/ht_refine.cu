// HT refinement passes over the cleanup output, as two launches per refined
// bucket: ht_sigprop_pass (a thread per codeblock, 32 codeblocks a warp),
// then ht_magref_pass (a warp per codeblock).
//
// Replaces ffmpeg_ht_tpu/ops/ht_refine.py:58 decode_refinement_scan (XLA
// ops, not Pallas, in the JAX package). The plain PyTorch versions are
// ffmpeg_ht_tpu_torch/ops/ht_refine.py: sigprop_pass_ref and
// magref_pass_ref, whose composition is refine_ref; the contract (inputs,
// layouts, the word format, the one deliberate difference from the JAX
// function) is in that module's docstring.
//
// What bounds it on the H100. By bytes: the mu raster read and written (4
// bytes a sample each way) beside the quad patterns and the refinement
// words. But SigProp is serial within a codeblock (whether a sample reads a
// bit depends on the bits read before it), so the latency of one
// codeblock's walk sets a floor: a thread per codeblock, with fewer warps
// than the card has schedulers, runs at the speed of its dependent chain.
// The earlier one-warp-per-codeblock kernel walked on lane 0 alone and was
// bound by issue slots (every SigProp instruction did one lane's work).
//
// What the design does about it. SigProp touches only the samples that the
// cleanup left insignificant, MagRef only the others, and SigProp reads
// only the cleanup's sigma and its own REF bits, so the passes split:
//  * ht_sigprop_pass, a thread per codeblock: walks the stripes and 4x4
//    blocks with its state in registers: the sigma rows around the stripe
//    as 64-bit masks (two new quad rows a stripe), the stripe's candidate
//    and seed rows (the candidates are the insignificant samples inside the
//    codeblock, the seeds those with a significant neighbour, causal
//    codeblocks dropping the row below on a stripe's last row), turned
//    into scan order (bit 4 * (x % 8) + y % 4 of a word a group of 8
//    columns) off the dependent chain; the REF of the row above and of the
//    previous block; the bit position and a two-word window of the SigProp
//    words plus one fetched ahead. The sigma rows come 8 quads a word
//    (their row-0 corners are the word's even bits). In scan order a REF
//    bit can only make later samples members (the one below, and the next
//    column's up-right, right and down-right), so a branch-free 16-step
//    loop finds the members with a short chain per sample and every lane
//    of the warp runs the same steps (a loop over pending members by __ffs
//    ran dense 32x32 buckets 2x slower on an H100: a warp waits for its
//    longest codeblock's loop). The block's signs are the next bits of the
//    window, one a REF bit: they are kept in that order. It writes its
//    REF bits and signs as two words a group (N x S x G x 2),
//    not into the raster: 32 threads ORing single samples of 32
//    codeblocks would cost a memory transaction a sample;
//  * ht_magref_pass, a warp per codeblock, every lane busy (one raster
//    column a lane up to 32 wide, two up to 64): sigma as column masks
//    from the lane's quad column; the raster in chunks of 8 rows whose
//    loads are issued before any is used; MagRef ranks from a warp scan of
//    the columns' counts, two stripes a scan; SigProp's bits merged from
//    its words; every row stored once, coalesced.
// Two launches rather than one kernel with a shared-memory hand-off: a
// block of 32 warps whose warp 0 walks SigProp for the block's codeblocks
// holds all 32 warps while one walks, and ran 1.5x slower on an H100.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // codeblocks per ht_magref block
constexpr unsigned kFull = 0xFFFFFFFFu;

// bit i of a byte -> bit 4i
__device__ __forceinline__ uint32_t spread8(uint32_t b) {
  b = (b | (b << 12)) & 0x000F000Fu;
  b = (b | (b << 6)) & 0x03030303u;
  return (b | (b << 3)) & 0x11111111u;
}

// row r of a block's 16 scan-order bits (bits r, r + 4, r + 8, r + 12) as a
// nibble: the product places them at bits 9..12 without carries
__device__ __forceinline__ uint32_t block_row(uint32_t b, int r) {
  return ((((b >> r) & 0x1111u) * 0x249u) >> 9) & 0xFu;
}

// the samples a member at scan-order bit b makes members when its bit is 1:
// the one below (b + 1) and the next column's rows r - 1 .. r + 1
// (b + 3 .. b + 5), as far as they lie in the block's rows
__device__ __forceinline__ uint32_t after(int b) {
  return ((0x183A3A32u >> (8 * (b & 3))) & 0xFFu) << b;
}

__device__ __forceinline__ uint32_t sp_word(const uint32_t* w, int W,
                                            int idx) {
  return idx < W ? __ldg(w + idx) : 0u;
}

__device__ __forceinline__ uint32_t nibble(uint64_t col, int s) {
  return (uint32_t)(col >> (4 * s)) & 0xFu;
}

__device__ __forceinline__ uint64_t dilate(uint64_t m) {
  return m | (m << 1) | (m >> 1);
}

// the even bits of x (0, 2, .., 30) -> bits 0..15
__device__ __forceinline__ uint32_t compress2(uint32_t x) {
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// rows 2q and 2q + 1 of the codeblock's sigma as 64-bit masks (zero outside
// the codeblock): corner i of a quad sits at (dy, dx) = (i & 1, i >> 1), so
// with 8 quads' patterns side by side in a word, the row-0 corners are its
// even bits and the row-1 corners its odd bits
__device__ __forceinline__ void quad_row(const int32_t* __restrict__ sig,
                                         int qw, int qh, int q, int h,
                                         uint64_t wmask, uint64_t& even,
                                         uint64_t& odd) {
  even = odd = 0ull;
  if (q >= qh) return;
  const int32_t* p = sig + q * qw;
  for (int qx0 = 0; qx0 < qw; qx0 += 8) {
    uint32_t v = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (qx0 + j < qw) v |= (uint32_t)__ldg(p + qx0 + j) << (4 * j);
    even |= (uint64_t)compress2(v & 0x55555555u) << (2 * qx0);
    odd |= (uint64_t)compress2((v >> 1) & 0x55555555u) << (2 * qx0);
  }
  even = 2 * q < h ? even & wmask : 0ull;
  odd = 2 * q + 1 < h ? odd & wmask : 0ull;
}

// SigProp over one codeblock, run by one thread: its REF and sign bits into
// `words` (S x G (REF, signs) pairs, zero where it sets nothing; the signs
// of a group's REF samples in scan order, bit k for the k-th).
__device__ void sigprop_codeblock(const int32_t* __restrict__ sig,
                                  const uint32_t* __restrict__ spw, int sp_W,
                                  bool has_sp, bool causal, int qw, int qh,
                                  int w, int h, uint2* words) {
  const int S = (qh + 1) >> 1, G = (qw + 3) >> 2;
  const uint64_t wmask = w >= 64 ? ~0ull : (1ull << w) - 1ull;
  int pos = 0;                             // SigProp bit position
  int wi = 0;                              // w0, w1: words wi, wi + 1;
  uint32_t w0 = sp_word(spw, sp_W, 0);     // ahead: word wi + 2
  uint32_t w1 = sp_word(spw, sp_W, 1);
  uint32_t ahead = sp_word(spw, sp_W, 2);
  uint64_t rm[8];                          // sigma rows r0 - 2 .. r0 + 5
#pragma unroll
  for (int k = 0; k < 6; ++k) rm[k] = 0ull;
  quad_row(sig, qw, qh, 0, h, wmask, rm[6], rm[7]);
  uint64_t above = 0ull;                   // REF of the row above the stripe
  int s = 0;
  for (int r0 = 0; r0 < h; r0 += 4, ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rm[k] = rm[k + 4];
    quad_row(sig, qw, qh, (r0 >> 1) + 1, h, wmask, rm[4], rm[5]);
    quad_row(sig, qw, qh, (r0 >> 1) + 2, h, wmask, rm[6], rm[7]);
    // the stripe's candidate and seed rows
    uint64_t crow[4], srow[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool below = !(causal && (r == 3 || r0 + r == h - 1));
      const uint64_t mid = rm[r + 2];
      const uint64_t nb = dilate(rm[r + 1]) | (mid << 1) | (mid >> 1) |
                          (below ? dilate(rm[r + 3]) : 0ull);
      crow[r] = has_sp && r0 + r < h ? ~mid & wmask : 0ull;
      srow[r] = crow[r] & nb;
    }
    const int last = min(4, h - r0) - 1;   // the stripe's last row
    uint64_t row_last = 0ull;
    uint32_t prev = 0u;                    // REF of the previous block
    uint32_t cw = 0u, sw = 0u;             // the group's candidates, seeds
    uint32_t gref = 0u, gsgn = 0u;         // the group's REF and signs
    int gn = 0;                            // the group's REF count
    for (int x0 = 0; x0 < w; x0 += 4) {
      if ((x0 & 7) == 0) {
        cw = sw = 0u;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cw |= spread8((uint32_t)(crow[r] >> x0) & 0xFFu) << r;
          sw |= spread8((uint32_t)(srow[r] >> x0) & 0xFFu) << r;
        }
      }
      const int s4 = 4 * (x0 & 7);
      const uint32_t cand = (cw >> s4) & 0xFFFFu;
      // REF outside the block: the row above (columns x0 - 1 .. x0 + 4) for
      // row 0; the previous block's last column (left, up-left, down-left)
      // for column 0
      const uint32_t a =
          (uint32_t)(x0 ? above >> (x0 - 1) : above << 1) & 0x3Fu;
      const uint32_t ad = (a | (a >> 1) | (a >> 2)) & 0xFu;
      const uint32_t p = prev >> 12;
      uint32_t pend = ((sw >> s4) & 0xFFFFu) |
                      (cand & (spread8(ad) | ((p | (p << 1) | (p >> 1)) &
                                             0xFu)));
      // the window: magnitude bits of the members in scan order, then the
      // signs of those whose bit is 1; wv drops a bit per member
      uint32_t wv = (uint32_t)((((uint64_t)w1 << 32) | w0) >> (pos & 31));
      uint32_t ref = 0u;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const uint32_t m = (pend >> b) & 1u;
        const uint32_t bit = wv & m;
        wv >>= m;
        ref |= bit << b;
        pend |= (cand & after(b)) & (0u - bit);
      }
      const int nref = __popc(ref);        // wv: its signs, in order
      pos += __popc(pend) + nref;          // pend: the block's members
      gref |= ref << s4;
      gsgn |= (wv & ((1u << nref) - 1u)) << gn;
      gn += nref;
      if ((x0 & 7) == 4 || x0 + 4 >= w) {
        words[s * G + (x0 >> 3)] = make_uint2(gref, gsgn);
        gref = gsgn = 0u;
        gn = 0;
      }
      if ((pos >> 5) != wi) {              // <= 32 bits a block: one word
        ++wi;
        w0 = w1;
        w1 = ahead;
        ahead = sp_word(spw, sp_W, wi + 2);
      }
      prev = ref;
      row_last |= (uint64_t)block_row(ref, last) << x0;
    }
    for (int g = (w + 7) >> 3; g < G; ++g)
      words[s * G + g] = make_uint2(0u, 0u);
    above = row_last;
  }
  for (int i = s * G; i < S * G; ++i) words[i] = make_uint2(0u, 0u);
}

// MagRef over one codeblock, with SigProp's bits merged in, run by the whole
// warp. CPL: raster columns per lane (1 up to 32 wide, 2 up to 64).
template <int CPL>
__device__ void magref_codeblock(
    int lane, const uint32_t* __restrict__ mu,
    const int32_t* __restrict__ sig, const uint32_t* __restrict__ mrw,
    int mr_W, int pLSB, bool has_mr, int qw, int qh, int w, int h,
    const uint2* words, uint32_t* __restrict__ out) {
  const int H = 2 * qh, W = 2 * qw, S = (H + 3) >> 2, G = (W + 7) >> 3;
  const int x = CPL * lane;                // this lane's first column
  const uint64_t rows = h >= 64 ? ~0ull : (1ull << h) - 1ull;

  // sigma of the lane's columns as column masks (bit y): corner i of a
  // quad sits at (dy, dx) = (i & 1, i >> 1)
  uint64_t c[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) c[k] = 0ull;
  if ((x >> 1) < qw) {
    const int32_t* q = sig + (x >> 1);
#pragma unroll 8
    for (int qr = 0; qr < qh; ++qr) {
      const uint32_t p = (uint32_t)__ldg(q + qr * qw);
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        c[k] |= (uint64_t)((p >> (2 * ((x + k) & 1))) & 3u) << (2 * qr);
    }
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) c[k] = x + k < w ? c[k] & rows : 0ull;

  const uint32_t pL = (uint32_t)(pLSB - 1);
  const uint32_t half = 1u << (pL - 1);
  const uint32_t sp_val = (1u << pL) | half;
  int base = 0;                            // MagRef rank of the chunk
  for (int s0 = 0; s0 < S; s0 += 2) {      // chunks of two stripes
    const int y0 = 4 * s0;
    uint32_t v[8][CPL];                    // the chunk's samples
    uint2 sp[2];                           // SigProp's words, this group
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (y0 + i < H && x < W) {
        if constexpr (CPL == 2) {
          const uint2 in =
              *reinterpret_cast<const uint2*>(mu + (y0 + i) * W + x);
          v[i][0] = in.x;
          v[i][CPL - 1] = in.y;
        } else {
          v[i][0] = mu[(y0 + i) * W + x];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sp[j] = s0 + j < S && x < W ? words[(s0 + j) * G + (x >> 3)]
                                  : make_uint2(0u, 0u);
    // a warp scan of the columns' significant counts, both stripes at once
    // (16-bit fields), gives every sample its rank in scan order, hence its
    // bit in the MagRef words
    uint32_t cnt = 0u;
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      cnt += __popc(nibble(c[k], s0)) +
             (s0 + 1 < S ? __popc(nibble(c[k], s0 + 1)) << 16 : 0u);
    uint32_t incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    const uint32_t tot = __shfl_sync(kFull, incl, 31);
    const int excl = (int)(incl - cnt);
    const int rank0[2] = {base + (excl & 0xFFFF),
                          base + (int)(tot & 0xFFFF) + (excl >> 16)};
    base += (int)(tot & 0xFFFF) + (int)(tot >> 16);
    if (x >= W) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int y = y0 + i, r = i & 3;
      if (y >= H) break;
      int rk = rank0[i >> 2];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const uint32_t col = nibble(c[k], y >> 2);
        const int bit4 = 4 * ((x + k) & 7) + r;
        if (y >= h || x + k >= w) {
          v[i][k] = 0u;
        } else if (has_mr && ((col >> r) & 1u)) {
          const int rr = rk + __popc(col & ((1u << r) - 1u));
          const int wi = min(rr >> 5, mr_W - 1);
          const uint32_t bit = (__ldg(mrw + wi) >> (rr & 31)) & 1u;
          v[i][k] = (v[i][k] & ((0xFFFFFFFEu | bit) << pL)) | half;
        } else if ((sp[i >> 2].x >> bit4) & 1u) {
          const int nth = __popc(sp[i >> 2].x & ((1u << bit4) - 1u));
          v[i][k] |= sp_val | (((sp[i >> 2].y >> nth) & 1u) << 31);
        }
        rk += __popc(col);
      }
      if constexpr (CPL == 2)
        *reinterpret_cast<uint2*>(out + y * W + x) =
            make_uint2(v[i][0], v[i][CPL - 1]);
      else
        out[y * W + x] = v[i][0];
    }
  }
}

__global__ void __launch_bounds__(32)
ht_sigprop_kernel(const int32_t* __restrict__ sig_in,
                  const uint32_t* __restrict__ spw_all, int sp_W,
                  const uint8_t* __restrict__ has_sp_v,
                  const uint8_t* __restrict__ causal_v, int N, int qw, int qh,
                  int w, int h, uint2* __restrict__ words_all) {
  const int n = blockIdx.x * 32 + threadIdx.x;
  if (n >= N) return;
  const int nw = ((qh + 1) >> 1) * ((qw + 3) >> 2);
  sigprop_codeblock(sig_in + (size_t)n * qh * qw, spw_all + (size_t)n * sp_W,
                    sp_W, has_sp_v[n] != 0, causal_v[n] != 0, qw, qh, w, h,
                    words_all + (size_t)n * nw);
}

template <int CPL>
__global__ void __launch_bounds__(32 * kWarps)
ht_magref_kernel(const uint32_t* __restrict__ mu_in,
                 const int32_t* __restrict__ sig_in,
                 const uint32_t* __restrict__ mrw_all, int mr_W,
                 const int32_t* __restrict__ pLSB_v,
                 const uint8_t* __restrict__ has_mr_v,
                 const uint2* __restrict__ words_all, int N, int qw, int qh,
                 int w, int h, uint32_t* __restrict__ mu_out) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;                      // whole warps leave together
  const size_t hw = (size_t)4 * qh * qw;
  const int nw = ((qh + 1) >> 1) * ((qw + 3) >> 2);
  magref_codeblock<CPL>(threadIdx.x & 31, mu_in + n * hw,
                        sig_in + (size_t)n * qh * qw,
                        mrw_all + (size_t)n * mr_W, mr_W, pLSB_v[n],
                        has_mr_v[n] != 0, qw, qh, w, h,
                        words_all + (size_t)n * nw, mu_out + n * hw);
}

}  // namespace

// Plain C entry points (ctypes): device pointers from torch tensors (bool
// tensors are one byte per element), the CUDA stream from
// torch.cuda.current_stream().cuda_stream. Each launches on that stream
// without synchronising and returns cudaGetLastError().

// SigProp's REF and sign words into `words` (N x S x G x 2 int32,
// S = (qh + 1) / 2 stripes, G = (qw + 3) / 4 groups of 8 columns).
extern "C" int ht_sigprop_pass_launch(const void* sig, const void* spw,
                                      int sp_W, const void* has_sp,
                                      const void* causal, int N, int qw,
                                      int qh, int w, int h, void* words,
                                      void* stream) {
  ht_sigprop_kernel<<<(N + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sig, (const uint32_t*)spw, sp_W,
      (const uint8_t*)has_sp, (const uint8_t*)causal, N, qw, qh, w, h,
      (uint2*)words);
  return (int)cudaGetLastError();
}

// The refined raster into `out`: MagRef, and SigProp's words merged in.
extern "C" int ht_magref_pass_launch(const void* mu, const void* sig,
                                     const void* mrw, int mr_W,
                                     const void* pLSB, const void* has_mr,
                                     const void* words, int N, int qw,
                                     int qh, int w, int h, void* out,
                                     void* stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  auto* kernel = qw > 16 ? ht_magref_kernel<2> : ht_magref_kernel<1>;
  kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mu, (const int32_t*)sig, (const uint32_t*)mrw, mr_W,
      (const int32_t*)pLSB, (const uint8_t*)has_mr, (const uint2*)words, N,
      qw, qh, w, h, (uint32_t*)out);
  return (int)cudaGetLastError();
}
