// HT refinement passes, SigProp + MagRef, over the cleanup output: one warp
// per codeblock.
//
// Replaces ffmpeg_ht_tpu/ops/ht_refine.py:58 decode_refinement_scan (XLA
// ops, not Pallas, in the JAX package). The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/ht_refine.py:refine_ref; the contract (inputs,
// layouts, the one deliberate difference from the JAX function) is in that
// module's docstring.
//
// What bounds it on the H100: by bytes, the mu raster read and written
// (4 bytes a sample) beside the quad patterns and the refinement words; but
// SigProp is serial within a codeblock (a sample's magnitude bit depends on
// the bits of the samples scanned before it), so the latency of one
// thread's walk over its codeblock sets the time.
//
// What the design does about it:
//  * the significance of a codeblock lives in 64-bit row masks in shared
//    memory (built from the quad patterns with one warp ballot per corner
//    and quad row), so a sample's 8-neighbourhood is a few shifts and ORs;
//  * SigProp: lane 0 walks the stripes, 4x4 blocks along each, with the
//    static neighbourhood sigma of the stripe's rows and the REF masks of
//    the stripe and of the row above it in registers; one 32-bit peek of
//    the (host-unstuffed) SigProp words per block serves its magnitude and
//    sign bits; words past the end read as zeros. It leaves REF and sign
//    row masks in shared memory;
//  * MagRef and the write-back run on the whole warp, stripe by stripe:
//    lane l owns raster columns 2l and 2l+1; a warp scan of its columns'
//    significant-sample counts gives every sample its rank in MagRef's scan
//    order, hence its bit in the MagRef words; each lane then writes its
//    two samples of every row as one uint2 (zero outside the codeblock).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // codeblocks per block
constexpr int kRows = 64;                  // raster rows at most
constexpr unsigned kFull = 0xFFFFFFFFu;

struct WarpSmem {
  uint64_t sig[kRows];                     // cleanup significance
  uint64_t ref[kRows];                     // SigProp: became significant
  uint64_t sgn[kRows];                     // SigProp: its sign bit
};

// bit q of m -> bit 2q
__device__ __forceinline__ uint64_t spread(uint32_t m) {
  uint64_t x = m;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  x = (x | (x << 1)) & 0x5555555555555555ull;
  return x;
}

// bits x-1, x, x+1 of a row mask (nonzero when any is set)
__device__ __forceinline__ uint64_t around(uint64_t r, int x) {
  return x ? (r >> (x - 1)) & 7u : (r << 1) & 7u;
}

__device__ __forceinline__ uint32_t sp_word(const uint32_t* w, int W,
                                            int idx) {
  return idx < W ? __ldg(w + idx) : 0u;
}

// SigProp over one codeblock (lane 0): REF and sign masks into smem.
__device__ void sigprop(WarpSmem& s, const uint32_t* spw, int sp_W, int w,
                        int h, bool causal) {
  int pos = 0;                             // SigProp bit position
  uint64_t ref_above = 0;                  // REF of the row above the stripe
  for (int r0 = 0; r0 < h; r0 += 4) {
    const int sh = min(4, h - r0);
    uint64_t sg[6];                        // sigma, rows r0-1 .. r0+4
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int y = r0 - 1 + k;
      sg[k] = (y >= 0 && y < h) ? s.sig[y] : 0ull;
    }
    uint64_t nb[4];                        // static neighbourhood sigma
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint64_t up = sg[r], mid = sg[r + 1], dn = sg[r + 2];
      const uint64_t or5 = (up << 1) | up | (up >> 1) | (mid << 1) |
                           (mid >> 1);
      const bool last = r == sh - 1;       // the stripe's last row
      nb[r] = or5 | ((causal && last) ? 0ull : ((dn << 1) | dn | (dn >> 1)));
    }
    uint64_t R[4] = {0, 0, 0, 0}, S[4] = {0, 0, 0, 0};
    for (int x0 = 0; x0 < w; x0 += 4) {
      const int wi = pos >> 5;
      const uint32_t win = (uint32_t)(
          ((uint64_t)sp_word(spw, sp_W, wi) |
           ((uint64_t)sp_word(spw, sp_W, wi + 1) << 32)) >> (pos & 31));
      int cnt = 0;
      const int x1 = min(x0 + 4, w);
      for (int x = x0; x < x1; ++x) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r >= sh || ((sg[r + 1] >> x) & 1u)) continue;
          // REF of the neighbours scanned so far: the row above (the
          // stripe above: all three; this stripe: up-left and up), the
          // left, the down-left; the others are still zero in the masks
          const uint64_t above = r == 0 ? ref_above : R[r > 0 ? r - 1 : 0];
          const uint64_t below = r + 1 < sh ? R[r < 3 ? r + 1 : 3] : 0ull;
          const uint64_t dyn = around(above, x) | around(R[r], x) |
                               around(below, x);
          if (((nb[r] >> x) & 1u) || dyn) {
            R[r] |= (uint64_t)((win >> cnt) & 1u) << x;
            ++cnt;
          }
        }
      }
      int off = cnt;                       // then the signs, same order
      for (int x = x0; x < x1; ++x) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < sh && ((R[r] >> x) & 1u)) {
            S[r] |= (uint64_t)((win >> off) & 1u) << x;
            ++off;
          }
        }
      }
      pos += off;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < sh) {
        s.ref[r0 + r] = R[r];
        s.sgn[r0 + r] = S[r];
      }
    }
    ref_above = R[sh - 1];
  }
}

__global__ void __launch_bounds__(32 * kWarps)
ht_refine_kernel(const uint32_t* __restrict__ mu_in,
                 const int32_t* __restrict__ sig_in,
                 const uint32_t* __restrict__ spw_all, int sp_W,
                 const uint32_t* __restrict__ mrw_all, int mr_W,
                 const int32_t* __restrict__ pLSB_v,
                 const uint8_t* __restrict__ has_sp_v,
                 const uint8_t* __restrict__ has_mr_v,
                 const uint8_t* __restrict__ causal_v, int N, int qw, int qh,
                 int w, int h, uint32_t* __restrict__ mu_out) {
  __shared__ WarpSmem smem[kWarps];
  const int wid = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarps + wid;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;                      // whole warps leave together
  WarpSmem& s = smem[wid];
  const int H = 2 * qh, W = 2 * qw;
  const uint32_t* mu = mu_in + (size_t)n * H * W;
  uint32_t* out = mu_out + (size_t)n * H * W;
  const int32_t* sig = sig_in + (size_t)n * qh * qw;
  const uint64_t wmask = w >= 64 ? ~0ull : (1ull << w) - 1ull;

  // sigma row masks: corner i of a quad sits at (dy, dx) = (i & 1, i >> 1)
  for (int qr = 0; qr < qh; ++qr) {
    const int sp = lane < qw ? __ldg(sig + qr * qw + lane) : 0;
    const uint32_t c0 = __ballot_sync(kFull, sp & 1);
    const uint32_t c1 = __ballot_sync(kFull, sp & 2);
    const uint32_t c2 = __ballot_sync(kFull, sp & 4);
    const uint32_t c3 = __ballot_sync(kFull, sp & 8);
    if (lane == 0) {
      s.sig[2 * qr] = 2 * qr < h ? (spread(c0) | (spread(c2) << 1)) & wmask
                                 : 0ull;
      s.sig[2 * qr + 1] = 2 * qr + 1 < h
                              ? (spread(c1) | (spread(c3) << 1)) & wmask
                              : 0ull;
    }
  }
  for (int y = lane; y < H; y += 32) s.ref[y] = s.sgn[y] = 0ull;
  __syncwarp();
  if (lane == 0 && has_sp_v[n])
    sigprop(s, spw_all + (size_t)n * sp_W, sp_W, w, h, causal_v[n] != 0);
  __syncwarp();

  const uint32_t pL = (uint32_t)(pLSB_v[n] - 1);
  const uint32_t half = 1u << (pL - 1);
  const bool has_mr = has_mr_v[n] != 0;
  const uint32_t* mrw = mrw_all + (size_t)n * mr_W;
  const int x = 2 * lane;                  // this lane's columns x, x + 1
  const bool mine = x < W;
  int base = 0;                            // MagRef rank of the stripe
  for (int r0 = 0; r0 < h; r0 += 4) {
    const int sh = min(4, h - r0);
    uint32_t col0 = 0, col1 = 0;           // sigma of columns x, x + 1
    for (int r = 0; r < sh; ++r) {
      const uint64_t row = s.sig[r0 + r];
      col0 |= (uint32_t)((row >> x) & 1u) << r;
      col1 |= (uint32_t)((row >> (x + 1)) & 1u) << r;
    }
    const int cnt = __popc(col0) + __popc(col1);
    int incl = cnt;                        // warp inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    const int rank0 = base + incl - cnt;   // rank of column x's first
    base += __shfl_sync(kFull, incl, 31);
    if (mine) {
      for (int r = 0; r < sh; ++r) {
        const int y = r0 + r;
        const uint2 in = *reinterpret_cast<const uint2*>(mu + y * W + x);
        uint32_t v[2] = {in.x, in.y};
        const uint32_t col[2] = {col0, col1};
        const int rk[2] = {rank0 + __popc(col0 & ((1u << r) - 1u)),
                           rank0 + __popc(col0) +
                               __popc(col1 & ((1u << r) - 1u))};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (x + k >= w) {
            v[k] = 0u;
            continue;
          }
          if (has_mr && ((col[k] >> r) & 1u)) {
            const int wi = min(rk[k] >> 5, mr_W - 1);
            const uint32_t bit = (__ldg(mrw + wi) >> (rk[k] & 31)) & 1u;
            v[k] = (v[k] & ((0xFFFFFFFEu | bit) << pL)) | half;
          }
          if ((s.ref[y] >> (x + k)) & 1u) v[k] |= (1u << pL) | half;
          if ((s.sgn[y] >> (x + k)) & 1u) v[k] |= 0x80000000u;
        }
        *reinterpret_cast<uint2*>(out + y * W + x) = make_uint2(v[0], v[1]);
      }
    }
  }
  if (mine)
    for (int y = h; y < H; ++y)
      *reinterpret_cast<uint2*>(out + y * W + x) = make_uint2(0u, 0u);
}

}  // namespace

// Plain C entry point (ctypes): device pointers from torch tensors (bool
// tensors are one byte per element), the CUDA stream from
// torch.cuda.current_stream().cuda_stream. Launches on that stream without
// synchronising; returns cudaGetLastError().
extern "C" int ht_refine_launch(const void* mu, const void* sig,
                                const void* spw, int sp_W, const void* mrw,
                                int mr_W, const void* pLSB,
                                const void* has_sp, const void* has_mr,
                                const void* causal, int N, int qw, int qh,
                                int w, int h, void* out, void* stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  ht_refine_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mu, (const int32_t*)sig, (const uint32_t*)spw, sp_W,
      (const uint32_t*)mrw, mr_W, (const int32_t*)pLSB,
      (const uint8_t*)has_sp, (const uint8_t*)has_mr,
      (const uint8_t*)causal, N, qw, qh, w, h, (uint32_t*)out);
  return (int)cudaGetLastError();
}
