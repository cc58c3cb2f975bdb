// HT cleanup decode, launch 1 of 2: the VLC pass (MEL + CxtVLC + U-VLC).
//
// Replaces, with ht_magsgn_pass.cu, the TPU kernel
// ffmpeg_ht_tpu/ops/ht_scan_pallas.py:192 decode_cleanup_pallas and its XLA
// twins ht_scan._cleanup_impl / decode_cleanup_scan_dims(_2d). The plain
// PyTorch version is ffmpeg_ht_tpu_torch/ops/ht_scan.py:vlc_pass_ref; the
// record layout is documented there.
//
// What bounds it on the H100: serial, latency-limited integer work. A
// codeblock's MEL run, CxtVLC codewords and U-VLC pairs form one chain of
// variable-length reads with a data-dependent position, so one thread per
// codeblock is the only parallelism there is; branches diverge across a
// warp. Its bytes are small: the MEL/VLC words it uses and one 4-byte
// record per quad.
//
// What the split does about it: MEL/VLC decoding of quad row r needs only
// the significance of row r - 1, not the exponents, so this pass runs the
// whole codeblock without MagSgn and leaves a compact record per quad for
// the warp-wide ht_magsgn_pass. What is left of the chain is kept short:
//  * MEL and VLC each read through a 64-bit register bit buffer, refilled
//    by one __ldg of a word when fewer than 32 bits remain (peeks never
//    touch memory);
//  * the row-above significance is two 32-bit masks in registers (sN and
//    sNE per quad column), no local arrays;
//  * the two 1024-entry CxtVLC tables sit in shared memory (lookups
//    diverge across a warp, which constant memory would serialise);
//  * 4 codeblocks per warp (lanes 0-3; KPW below), 4 warps per block: a
//    4K frame's ~6.7k codeblocks make ~1.7k warps, 3 or 4 per scheduler
//    of each SM, so one warp's latency hides behind the others', and a
//    warp's threads diverge among 4 codeblocks, not 32.
//    tools/sweep_vlc_pass.py times 1..32 codeblocks per warp on the card;
//    32 per warp (one thread per lane) leaves ~1.6 warps per SM.
// Reads follow the reference's end-of-segment rule: a word index >= lim
// reads all ones, any other index >= W reads zero; VLC has no limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef KPW
#define KPW 4                // codeblocks per warp (lanes 0..KPW-1)
#endif
constexpr int kWarps = 4;    // warps per block

// forward LSB-first reader: `buf` holds `nbits` (>= 32) unread bits
struct BitBuf {
  const uint32_t* w;
  int W, lim, next, nbits;
  uint64_t buf;
};

__device__ __forceinline__ uint32_t fetch(const BitBuf& s, int idx) {
  if (idx >= s.lim) return 0xFFFFFFFFu;
  if (idx >= s.W) return 0u;
  return __ldg(s.w + idx);
}

__device__ __forceinline__ void bb_init(BitBuf& s, const uint32_t* w, int W,
                                        int lim) {
  s.w = w;
  s.W = W;
  s.lim = lim;
  s.buf = (uint64_t)fetch(s, 0) | ((uint64_t)fetch(s, 1) << 32);
  s.next = 2;
  s.nbits = 64;
}

__device__ __forceinline__ uint32_t bb_peek(const BitBuf& s) {
  return (uint32_t)s.buf;
}

// drop n <= 32 bits; one word refill keeps >= 32 bits buffered
__device__ __forceinline__ void bb_skip(BitBuf& s, int n) {
  s.buf >>= n;
  s.nbits -= n;
  if (s.nbits < 32) {
    s.buf |= (uint64_t)fetch(s, s.next++) << s.nbits;
    s.nbits += 32;
  }
}

struct Mel {
  BitBuf b;
  int k, run, one;
};

// one MEL symbol (jpeg2000htdec.c:462-495)
__device__ int mel_sym(Mel& m) {
  if (m.run == 0 && m.one == 0) {
    const int ev = min(m.k / 3, 3) + max(m.k - 10, 0);   // MEL_E[k]
    const uint32_t pk = bb_peek(m.b);
    if (pk & 1u) {
      bb_skip(m.b, 1);
      m.run = 1 << ev;
      m.k = min(12, m.k + 1);
    } else {
      const uint32_t mv = (pk >> 1) & ((1u << ev) - 1u);
      bb_skip(m.b, 1 + ev);
      m.run = ev ? (int)(__brev(mv) >> (32 - ev)) : 0;   // MSB-first
      m.k = max(0, m.k - 1);
      m.one = 1;
    }
  }
  if (m.run > 0) {
    --m.run;
    return 0;
  }
  m.one = 0;
  return 1;
}

struct Quad {
  int res, sp, ek, e1;
};

// MEL-gated CxtVLC decode of one quad (jpeg2000htdec.c:510-531);
// returns the codeword length
__device__ __forceinline__ int cxt_quad(uint32_t code, int ctx, bool active,
                                        Mel& mel, const uint16_t* tbl,
                                        Quad& q) {
  q = Quad{0, 0, 0, 0};
  if (!active) return 0;
  if (ctx == 0 && mel_sym(mel) == 0) return 0;
  const uint32_t e = tbl[(ctx << 7) | code];
  q.res = e & 1;
  q.sp = (e >> 4) & 0xF;
  q.ek = (e >> 8) & 0xF;
  q.e1 = (e >> 12) & 0xF;
  return (e & 0xF) >> 1;
}

// U-VLC fields read from one 32-bit peek (jpeg2000htdec.c:338-388)
__device__ __forceinline__ int u_prefix(uint32_t pk, int& off) {
  const uint32_t b = (pk >> off) & 7u;
  if (b & 1u) { off += 1; return 1; }
  if (b & 2u) { off += 2; return 2; }
  off += 3;
  return b == 4u ? 3 : 5;
}

__device__ __forceinline__ int u_suffix(uint32_t pk, int& off, int p) {
  if (p == 3) { const int v = (pk >> off) & 1u; off += 1; return v; }
  if (p > 3) { const int v = (pk >> off) & 31u; off += 5; return v; }
  return 0;
}

__device__ __forceinline__ int u_ext(uint32_t pk, int& off, int s) {
  if (s < 28) return 0;
  const int v = (pk >> off) & 15u;
  off += 4;
  return v;
}

__device__ __forceinline__ int u_single(BitBuf& vlc) {
  const uint32_t pk = bb_peek(vlc);
  int off = 0;
  const int p = u_prefix(pk, off);
  const int s = u_suffix(pk, off, p);
  const int x = u_ext(pk, off, s);
  bb_skip(vlc, off);
  return p + s + 4 * x;
}

// U pair of the initial quad row (jpeg2000htdec.c:666-712), with the MEL
// bonus and the p0 > 2 case folded into u1 / u2
__device__ void u_pair_initial(BitBuf& vlc, Mel& mel, bool a1, bool a2,
                               int r1, int r2, int& u1, int& u2) {
  u1 = u2 = 0;
  const bool both = a1 && a2 && r1 && r2;
  if (both) {
    const int mel1 = mel_sym(mel);
    const uint32_t pk = bb_peek(vlc);
    int off = 0;
    const int p0 = u_prefix(pk, off);
    if (!mel1 && p0 > 2) {
      const int bit = (pk >> off) & 1u;
      off += 1;
      const int s0 = u_suffix(pk, off, p0);
      const int x0 = u_ext(pk, off, s0);
      u1 = p0 + s0 + 4 * x0;
      u2 = bit + 1;
    } else {
      const int p1 = u_prefix(pk, off);
      const int s0 = u_suffix(pk, off, p0);
      const int s1 = u_suffix(pk, off, p1);
      const int x0 = u_ext(pk, off, s0);
      const int x1 = u_ext(pk, off, s1);
      u1 = p0 + s0 + 4 * x0 + 2 * mel1;
      u2 = p1 + s1 + 4 * x1 + 2 * mel1;
    }
    bb_skip(vlc, off);
  } else if (a1 && r1) {
    u1 = u_single(vlc);
  } else if (a2 && r2) {
    u2 = u_single(vlc);
  }
}

// U pair of a non-initial quad row (jpeg2000htdec.c:828-854)
__device__ void u_pair_noninit(BitBuf& vlc, bool a1, bool a2, int r1, int r2,
                               int& u1, int& u2) {
  u1 = u2 = 0;
  if (a1 && a2 && r1 && r2) {
    const uint32_t pk = bb_peek(vlc);
    int off = 0;
    const int p0 = u_prefix(pk, off);
    const int p1 = u_prefix(pk, off);
    const int s0 = u_suffix(pk, off, p0);
    const int s1 = u_suffix(pk, off, p1);
    const int x0 = u_ext(pk, off, s0);
    const int x1 = u_ext(pk, off, s1);
    bb_skip(vlc, off);
    u1 = p0 + s0 + 4 * x0;
    u2 = p1 + s1 + 4 * x1;
  } else if (a1 && r1) {
    u1 = u_single(vlc);
  } else if (a2 && r2) {
    u2 = u_single(vlc);
  }
}

__device__ __forceinline__ int ctx_first(int sp) {
  return ((sp | (sp >> 1)) & 1) + (((sp >> 2) & 1) << 1) +
         (((sp >> 3) & 1) << 2);
}

__device__ __forceinline__ int west(int sp) { return ((sp >> 2) | (sp >> 3)) & 1; }

// non-initial context from the row above (jpeg2000htdec.c:784-919):
// bit q of aN / aNE is corner 1 / corner 3 significance of quad q above
__device__ __forceinline__ int ctx_above(uint32_t aN, uint32_t aNE, int q) {
  const int sN = (aN >> q) & 1, sNE = (aNE >> q) & 1;
  const int sNW = q ? (aNE >> (q - 1)) & 1 : 0;
  const int sNF = (int)(((uint64_t)aN >> (q + 1)) & 1);
  return (sN | sNW) | ((sNE | sNF) << 2);
}

__device__ __forceinline__ int32_t record(const Quad& q, int u) {
  return q.sp | (q.ek << 4) | (q.e1 << 8) | (u << 12);
}

__global__ void __launch_bounds__(32 * kWarps)
ht_vlc_pass_kernel(const uint32_t* __restrict__ melw, int mel_W,
                   const uint32_t* __restrict__ vlcw, int vlc_W,
                   const int32_t* __restrict__ mel_lim,
                   const int32_t* __restrict__ qws,
                   const int32_t* __restrict__ qhs,
                   const int32_t* __restrict__ tables, int N, int qw, int qh,
                   int32_t* __restrict__ rec_out) {
  __shared__ uint16_t tbl[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    tbl[i] = (uint16_t)tables[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * KPW + lane;
  if (lane >= KPW || n >= N) return;

  const int QW = qws[n], QH = qhs[n];
  int32_t* rec = rec_out + (size_t)n * (qh * qw);
  BitBuf vlc;
  Mel mel;
  bb_init(vlc, vlcw + (size_t)n * vlc_W, vlc_W, 1 << 29);
  bb_init(mel.b, melw + (size_t)n * mel_W, mel_W, mel_lim[n]);
  mel.k = mel.run = mel.one = 0;

  uint32_t aN = 0, aNE = 0;      // row-above significance masks
  for (int r = 0; r < qh; ++r) {
    int32_t* row = rec + r * qw;
    if (r >= QH) {
      for (int j = 0; j < qw; ++j) row[j] = 0;
      continue;
    }
    const uint16_t* t = tbl + (r ? 1024 : 0);
    uint32_t cN = 0, cNE = 0;
    int context = 0, wprev = 0;
    for (int j1 = 0; j1 < qw; j1 += 2) {
      const int j2 = j1 + 1;
      const bool a1 = j1 < QW, a2 = j2 < QW;
      Quad q1, q2;
      int u1 = 0, u2 = 0;
      if (a1) {
        const uint32_t pk = bb_peek(vlc);
        if (r == 0) {
          const int ln1 = cxt_quad(pk & 0x7Fu, context, true, mel, t, q1);
          const int c2 = ctx_first(q1.sp);
          const int ln2 = cxt_quad((pk >> ln1) & 0x7Fu, c2, a2, mel, t, q2);
          bb_skip(vlc, ln1 + ln2);
          context = a2 ? ctx_first(q2.sp) : c2;
          u_pair_initial(vlc, mel, true, a2, q1.res, q2.res, u1, u2);
        } else {
          const int cA1 = ctx_above(aN, aNE, j1);
          const int cA2 = a2 ? ctx_above(aN, aNE, j2) : 0;
          const int ln1 = cxt_quad(pk & 0x7Fu, cA1 | (wprev << 1), true, mel,
                                   t, q1);
          const int ln2 = cxt_quad((pk >> ln1) & 0x7Fu,
                                   cA2 | (west(q1.sp) << 1), a2, mel, t, q2);
          bb_skip(vlc, ln1 + ln2);
          u_pair_noninit(vlc, true, a2, q1.res, q2.res, u1, u2);
          wprev = a2 ? west(q2.sp) : west(q1.sp);
        }
      } else {
        q1 = q2 = Quad{0, 0, 0, 0};
      }
      cN |= (uint32_t)((q1.sp >> 1) & 1) << j1;
      cNE |= (uint32_t)((q1.sp >> 3) & 1) << j1;
      row[j1] = record(q1, u1);
      if (j2 < qw) {
        cN |= (uint32_t)((q2.sp >> 1) & 1) << j2;
        cNE |= (uint32_t)((q2.sp >> 3) & 1) << j2;
        row[j2] = record(q2, u2);
      }
    }
    aN = cN;
    aNE = cNE;
  }
}

}  // namespace

// Plain C entry point (ctypes): device pointers from torch tensors, the
// CUDA stream from torch.cuda.current_stream().cuda_stream. Launches on
// that stream without synchronising; returns cudaGetLastError().
extern "C" int ht_vlc_pass_launch(const void* melw, int mel_W,
                                  const void* vlcw, int vlc_W,
                                  const void* mel_lim, const void* qws,
                                  const void* qhs, const void* tables, int N,
                                  int qw, int qh, void* rec, void* stream) {
  const int blocks = (N + kWarps * KPW - 1) / (kWarps * KPW);
  ht_vlc_pass_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)melw, mel_W, (const uint32_t*)vlcw, vlc_W,
      (const int32_t*)mel_lim, (const int32_t*)qws, (const int32_t*)qhs,
      (const int32_t*)tables, N, qw, qh, (int32_t*)rec);
  return (int)cudaGetLastError();
}
