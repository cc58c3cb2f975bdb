// HT cleanup decode, launch 2 of 2: the MagSgn pass (exponent prediction,
// U bound, magnitude and sign recovery), one warp per codeblock.
//
// Replaces, with ht_vlc_pass.cu, the TPU kernel
// ffmpeg_ht_tpu/ops/ht_scan_pallas.py:192 decode_cleanup_pallas and its XLA
// twins ht_scan._cleanup_impl / decode_cleanup_scan_dims(_2d). The plain
// PyTorch version is ffmpeg_ht_tpu_torch/ops/ht_scan.py:magsgn_pass_ref.
//
// What bounds it on the H100: memory, the mu / sig writes (4 words + 1 word
// per quad, 137 MB for a DCI-4K 4:4:4 frame) beside the 4-byte records and
// the MagSgn words it reads.
//
// What the design does about it: the serial part of the cleanup pass (MEL,
// CxtVLC, U-VLC) already ran in ht_vlc_pass and left one record per quad.
// What remains is parallel across a quad row once each quad's MagSgn bit
// offset is known, and the host has already unstuffed the stream
// (ops/ht_batch.py), so offsets are plain sums:
//  * one warp per codeblock, lane = quad column, a loop over quad rows;
//    4 warps (4 codeblocks) per block;
//  * each lane loads its record (one 128-byte row per warp), takes kmax
//    from the row above's corner-1 / corner-3 exponents of lanes q-1, q and
//    q+1 by warp shuffles, computes U and the 4 sample counts;
//  * a 5-step warp exclusive scan of the per-quad bit counts gives each
//    lane its MagSgn offset; each sample is cut from a 64-bit window of two
//    words; the stream position advances by lane 31's inclusive total;
//  * mu rows are written as one uint2 per lane (256 contiguous bytes per
//    raster row for 32 quads), sig as 128 contiguous bytes.
// Lanes >= qw idle; quads outside the codeblock's (qws, qhs) read no bits,
// write zeros and take no part in the ok test. Reads follow the reference's
// end-of-segment rule: a word index >= lim reads all ones, any other index
// >= W reads zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // codeblocks per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fetch(const uint32_t* w, int W, int lim,
                                          int idx) {
  if (idx >= lim) return 0xFFFFFFFFu;
  if (idx >= W) return 0u;
  return __ldg(w + idx);
}

__global__ void __launch_bounds__(32 * kWarps)
ht_magsgn_pass_kernel(const int32_t* __restrict__ rec_in,
                      const uint32_t* __restrict__ msw, int ms_W,
                      const int32_t* __restrict__ pLSB_v,
                      const int32_t* __restrict__ maxbp_v,
                      const int32_t* __restrict__ ms_lim,
                      const int32_t* __restrict__ qws,
                      const int32_t* __restrict__ qhs, int N, int qw, int qh,
                      int clamp, uint32_t* __restrict__ mu_out,
                      int32_t* __restrict__ sig_out,
                      uint8_t* __restrict__ ok_out) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;                      // whole warps leave together

  const int QW = qws[n], QH = qhs[n];
  const int pLSB = pLSB_v[n], maxbp = maxbp_v[n], lim = ms_lim[n];
  const uint32_t* ms = msw + (size_t)n * ms_W;
  const int32_t* rec = rec_in + (size_t)n * (qh * qw);
  uint32_t* mu = mu_out + (size_t)n * (4 * qh * qw);
  int32_t* sig = sig_out + (size_t)n * (qh * qw);
  const bool col = lane < QW;

  int pos = 0;                             // MagSgn bit position (uniform)
  int eN = 0, eNE = 0;                     // row above: corner 1 / 3 exps
  bool bad = false;
  for (int r = 0; r < qh; ++r) {
    const bool act = col && r < QH;
    const int q = act ? rec[r * qw + lane] : 0;
    const int sp = q & 0xF, ek = (q >> 4) & 0xF, e1 = (q >> 8) & 0xF;
    const int u = q >> 12;
    int U;
    if (r == 0) {
      U = 1 + u;
    } else {
      int eNW = __shfl_up_sync(kFull, eNE, 1);
      int eNF = __shfl_down_sync(kFull, eN, 1);
      if (lane == 0) eNW = 0;
      if (lane == 31) eNF = 0;
      const int kmax = max(max(eNW, eN), max(eNE, eNF));
      U = max(1, (__popc(sp) > 1) * (kmax - 1)) + u;
    }
    bad |= act && U > maxbp;

    int m[4], nb = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mi = act ? min(((sp >> i) & 1) * U - ((ek >> i) & 1), clamp)
                         : 0;
      m[i] = mi > 0 ? mi : 0;
      nb += m[i];
    }
    int incl = nb;                         // warp inclusive scan of nb
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int bit = pos + incl - nb;
    pos += __shfl_sync(kFull, incl, 31);

    uint32_t v4[4];
    int e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v4[i] = 0u;
      e[i] = 0;
      if (m[i] == 0) continue;
      const int wi = bit >> 5;
      const uint64_t win =
          ((uint64_t)fetch(ms, ms_W, lim, wi) |
           ((uint64_t)fetch(ms, ms_W, lim, wi + 1) << 32)) >> (bit & 31);
      uint32_t v = (uint32_t)win & ((1u << m[i]) - 1u);
      bit += m[i];
      v += (uint32_t)((e1 >> i) & 1) << m[i];
      e[i] = 32 - __clz(v | 1u);
      v4[i] = (((v >> 1) + 1u) << pLSB) | (1u << (pLSB - 1)) |
              ((v & 1u) << 31);
    }
    eN = e[1];
    eNE = e[3];
    if (lane < qw) {
      // corner i sits at (dy, dx) = (i & 1, i >> 1): raster rows 2r, 2r+1
      uint32_t* row0 = mu + (size_t)(2 * r) * (2 * qw) + 2 * lane;
      *reinterpret_cast<uint2*>(row0) = make_uint2(v4[0], v4[2]);
      *reinterpret_cast<uint2*>(row0 + 2 * qw) = make_uint2(v4[1], v4[3]);
      sig[r * qw + lane] = sp;
    }
  }
  const bool any_bad = __any_sync(kFull, bad);
  if (lane == 0) ok_out[n] = any_bad ? 0 : 1;
}

}  // namespace

// Plain C entry point (ctypes): device pointers from torch tensors, the
// CUDA stream from torch.cuda.current_stream().cuda_stream. Launches on
// that stream without synchronising; returns cudaGetLastError().
extern "C" int ht_magsgn_pass_launch(const void* rec, const void* msw,
                                     int ms_W, const void* pLSB,
                                     const void* maxbp, const void* ms_lim,
                                     const void* qws, const void* qhs, int N,
                                     int qw, int qh, int ms_class, void* mu,
                                     void* sig, void* ok, void* stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  ht_magsgn_pass_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rec, (const uint32_t*)msw, ms_W, (const int32_t*)pLSB,
      (const int32_t*)maxbp, (const int32_t*)ms_lim, (const int32_t*)qws,
      (const int32_t*)qhs, N, qw, qh, ms_class < 25 ? ms_class : 25,
      (uint32_t*)mu, (int32_t*)sig, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
