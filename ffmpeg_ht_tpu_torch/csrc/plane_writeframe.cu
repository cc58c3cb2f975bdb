// DC shift + clip + the frame write of every plane without MCT of a device
// program, in one launch.
//
// Replaces the tail of the JAX package's programs for planes that no RCT
// or ICT takes (ffmpeg_ht_tpu/models/assembly.py:389 `finish` and the
// packing concatenation at :442-445; the v2 assembly's, decoder.py:546
// and :602-604): float samples rounded half to even, + (1 << (cbps - 1)) in
// int32 (wrapping), clipped to [0, 2^cbps - 1], shifted left to the
// frame's precision and narrowed to uint8, int16 holding uint16 bits, or
// int32, at the plane's place in the frame (frame_store.cuh: sample (r, c)
// at out[dst + r*rs + c*cs]). The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/mct_cuda.py:plane_writeframe_ref.
//
// Planes come from several buffers (a DWT scratch buffer, the flat
// coefficient buffer, a band buffer), so the host passes each plane as an
// element offset from one base address, with its shape and where it goes
// in the output; the table rides in the launch's parameters (120 planes a
// launch, 32 bytes each).
//
// What bounds it on the H100: device-memory bytes, 4 read and 1 or 2
// written a sample; a rounding, an add, a clamp and a shift a sample are
// far below the card's rates. The design: each plane cut into row
// segments of 2048 samples (a plane whose rows lie back to back in the
// output is one row), a block a segment, the plane found by a binary
// search of the table; a thread loads 8 samples 256 apart, so every
// warp-wide load is 128 consecutive bytes, and a segment that lands in
// one run of the output (planar formats, the program's own layout) is
// staged in shared memory and written as whole 16-byte words. A plane of
// a packed format (a gray or alpha component beside others) is written a
// sample at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "frame_store.cuh"

namespace {

using namespace frame_store;

constexpr int kThreads = 256;
constexpr int kPix = 8;                   // samples a thread
constexpr int kSeg = kThreads * kPix;     // samples a block
constexpr int kMaxPlanes = 120;           // planes a launch (3.8 KB of
                                          // params, within 4 KB)

struct Plane {
  int64_t src, dst;        // element offsets: from the base; of sample
                           // (0, 0) in the output
  int32_t rs, w;           // row stride in the output; samples a row
  int32_t block0;          // first block
  int16_t cs, sh;          // component stride; left shift
};

struct Launch {
  Plane p[kMaxPlanes];
  int nplanes;
};

template <bool Float, typename OutT>
__global__ void __launch_bounds__(kThreads)
writeframe_kernel(const __grid_constant__ Launch L, const char* base,
                  int cbps, OutT* __restrict__ out) {
  constexpr int V = 16 / sizeof(OutT);
  __shared__ __align__(16) OutT st[kSeg + V];
  int lo = 0, hi = L.nplanes - 1;                      // last block0 <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.p[mid].block0 <= (int)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Plane& P = L.p[lo];
  const int chunks = (int)(((int64_t)P.w + kSeg - 1) / kSeg);
  const int b = (int)blockIdx.x - P.block0;
  const int row = b / chunks;
  const int c0 = (b - row * chunks) * kSeg;
  const int m = P.w - c0 < kSeg ? P.w - c0 : kSeg;
  const int64_t src = P.src + (int64_t)row * P.w + c0;
  OutT* const g = out + P.dst + (int64_t)row * P.rs + (int64_t)c0 * P.cs;
  const bool run = P.cs == 1;                          // uniform
  const int a = word_offset(g);
  const uint32_t dc = 1u << (cbps - 1);
  const int32_t top = (int32_t)((1u << cbps) - 1u);
  int32_t in[kPix];                      // every load in flight at once
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    if (p < m) {
      if (Float)
        in[j] = __float2int_rn(reinterpret_cast<const float*>(base)[src + p]);
      else
        in[j] = reinterpret_cast<const int32_t*>(base)[src + p];
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    if (p >= m) break;
    int32_t v = (int32_t)((uint32_t)in[j] + dc);
    const OutT o = (OutT)((v < 0 ? 0 : v > top ? top : v) << P.sh);
    if (run)
      st[a + p] = o;
    else
      g[(int64_t)p * P.cs] = o;
  }
  if (!run) return;
  __syncthreads();
  store_run(st, g, m);
}

template <bool Float, typename OutT>
int launch(const Launch& L, int blocks, const void* base, int cbps,
           void* out, cudaStream_t s) {
  writeframe_kernel<Float, OutT><<<blocks, kThreads, 0, s>>>(
      L, static_cast<const char*>(base), cbps, static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

template <bool Float>
int launch_kind(const Launch& L, int blocks, const void* base, int cbps,
                void* out, int kind, cudaStream_t s) {
  switch (kind) {
    case 0: return launch<Float, int32_t>(L, blocks, base, cbps, out, s);
    case 1: return launch<Float, uint16_t>(L, blocks, base, cbps, out, s);
    default: return launch<Float, uint8_t>(L, blocks, base, cbps, out, s);
  }
}

}  // namespace

// Plain C entry point (ctypes). `table`: host array of 7 int64 values a
// plane: its first sample's element offset from `base` (int32 samples, or
// float32 with src_float 1), its rows h and columns w (h * w samples, 1 ..
// 2^31 - 1), and where it goes in `out`, (dst, rs, cs, sh) as in
// rct_writeframe_launch. kind: 0 int32, 1 int16 (uint16 bits), 2 uint8
// output, `size` samples; cbps 1 .. 30 (int32), 16 (int16), 8 (uint8),
// cbps + sh at most as many. One launch each kMaxPlanes planes on
// `stream`, without synchronising; *launches gets the launches made.
// Returns the first cudaGetLastError() that is not cudaSuccess, or
// cudaErrorInvalidValue for a bad kind, depth, shape or dest.
extern "C" int plane_writeframe_launch(const int64_t* table, int nplanes,
                                       const void* base, int src_float,
                                       int cbps, void* out, int64_t size,
                                       int kind, void* stream,
                                       int* launches) {
  *launches = 0;
  const int max_bits = kind == 0 ? 30 : kind == 1 ? 16 : 8;
  if (nplanes < 0 || kind < 0 || kind > 2 || (src_float & ~1) || cbps < 1
      || cbps > max_bits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int p0 = 0; p0 < nplanes; p0 += kMaxPlanes) {
    Launch L;
    L.nplanes = 0;
    int64_t blocks = 0;
    for (int p = p0; p < nplanes && p < p0 + kMaxPlanes; ++p) {
      const int64_t* d = table + 7 * (int64_t)p;
      int64_t h = d[1], w = d[2];
      const Dest D = dest_from(d + 3);
      if (h < 1 || w < 1 || h * w > INT32_MAX || D.rs > INT32_MAX ||
          D.cs > INT16_MAX || !dest_ok(D, h, w, size, cbps, max_bits))
        return (int)cudaErrorInvalidValue;
      if (flat(&D, 1, h, w)) w *= h, h = 1;
      Plane& P = L.p[L.nplanes++];
      P.src = d[0], P.dst = D.dst;
      P.rs = (int32_t)D.rs, P.w = (int32_t)w;
      P.cs = (int16_t)D.cs, P.sh = (int16_t)D.sh;
      P.block0 = (int)blocks;
      blocks += h * ((w + kSeg - 1) / kSeg);
      if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    }
    const int n = (int)blocks;
    const int err = src_float
        ? launch_kind<true>(L, n, base, cbps, out, kind, s)
        : launch_kind<false>(L, n, base, cbps, out, kind, s);
    if (err != 0) return err;
    ++*launches;
  }
  return 0;
}
