// Inverse reversible colour transform + DC shift + clip + the frame write.
//
// Replaces the TPU kernel ffmpeg_ht_tpu/ops/mct_pallas.py rct_writeframe
// (itself the analog of the reference's x86/jpeg2000dsp.asm ff_rct_int_*
// plus write_frame_8/16, jpeg2000dec.c:2301-2364). Per pixel, in
// wraparound int32:
//     g = y0 - ((y2 + y1) >> 2),  r = g + y2,  b = g + y1
// then each plane + (1 << (cbps-1)), clipped to [0, 2^cbps - 1], shifted
// left to the frame's precision and stored at its place in the frame
// (frame_store.cuh: R, G, B interleaved in rgb48le / rgb24, or three
// planes back to back in the program's tile-component layout). The plain
// PyTorch version is ffmpeg_ht_tpu_torch/ops/mct_cuda.py:rct_writeframe_ref.
//
// What bounds it on the H100: device-memory bytes. A DCI-4K frame is 8.8 M
// pixels x (12 B read + 6 B written as uint16) ~ 160 MB per frame, with
// three integer operations per sample. The design moves the fewest bytes
// it can: a block a row segment of 1024 pixels, coalesced 4-byte loads of
// the three planes (4 pixels a thread, 256 apart), and the clipped samples
// staged in shared memory in the frame's order and written out as whole
// 16-byte words, instead of three int32 planes that a later pass would
// narrow and interleave again.

#include <cstdint>
#include <cuda_runtime.h>

#include "frame_store.cuh"

namespace {

using namespace frame_store;

constexpr int kThreads = 256;
constexpr int kPix = 4;                  // pixels a thread
constexpr int kSeg = kThreads * kPix;    // pixels a block

struct Dests3 {
  Dest d[3];
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
rct_kernel(const int32_t* __restrict__ y0, const int32_t* __restrict__ y1,
           const int32_t* __restrict__ y2, int64_t w, int64_t chunks,
           const Dests3 D, int mode, int dc, int maxval,
           OutT* __restrict__ out) {
  constexpr int V = 16 / sizeof(OutT);
  __shared__ __align__(16) OutT st[3 * (kSeg + V)];
  const int64_t row = blockIdx.x / chunks;
  const int64_t c0 = (blockIdx.x - row * chunks) * kSeg;
  const int m = (int)(w - c0 < kSeg ? w - c0 : kSeg);
  const int64_t src = row * w + c0;
  OutT* g[3];
  int at[3];                             // where each run starts in st
  for (int k = 0; k < 3; ++k) {
    g[k] = out + D.d[k].dst + row * D.d[k].rs + c0 * D.d[k].cs;
    at[k] = mode == kInterleaved ? word_offset(g[0]) + k
                                 : k * (kSeg + V) + word_offset(g[k]);
  }
  const int step = mode == kInterleaved ? 3 : 1;
  uint32_t in[3][kPix];                  // every load in flight at once
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    if (p < m) {
      in[0][j] = (uint32_t)y0[src + p];
      in[1][j] = (uint32_t)y1[src + p];
      in[2][j] = (uint32_t)y2[src + p];
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    if (p >= m) break;
    const uint32_t a = in[0][j], b = in[1][j], c = in[2][j];
    // wraparound int32 arithmetic, arithmetic right shift
    const int32_t gg = (int32_t)(a - (uint32_t)((int32_t)(c + b) >> 2));
    const int32_t v[3] = {(int32_t)((uint32_t)gg + c), gg,
                          (int32_t)((uint32_t)gg + b)};
    for (int k = 0; k < 3; ++k) {
      const OutT o = (OutT)(clip((int32_t)((uint32_t)v[k] + dc), maxval)
                            << D.d[k].sh);
      if (mode == kScattered)
        g[k][(int64_t)p * D.d[k].cs] = o;
      else
        st[at[k] + step * p] = o;
    }
  }
  if (mode == kScattered) return;        // uniform across the block
  __syncthreads();
  if (mode == kInterleaved) {
    store_run(st, g[0], 3 * m);
  } else {
    for (int k = 0; k < 3; ++k) store_run(st + k * (kSeg + V), g[k], m);
  }
}

template <typename OutT>
int launch(const void* y0, const void* y1, const void* y2, int64_t h,
           int64_t w, int cbps, const Dests3& D, void* out,
           cudaStream_t stream) {
  if (h == 0 || w == 0) return 0;
  if (flat(D.d, 3, h, w)) w *= h, h = 1;
  const int64_t chunks = (w + kSeg - 1) / kSeg;
  if (h * chunks > INT32_MAX) return (int)cudaErrorInvalidValue;
  rct_kernel<OutT><<<(unsigned)(h * chunks), kThreads, 0, stream>>>(
      (const int32_t*)y0, (const int32_t*)y1, (const int32_t*)y2, w, chunks,
      D, mode_of(D.d, 3), 1 << (cbps - 1), (1 << cbps) - 1, (OutT*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (ctypes). y0, y1, y2: h x w int32 planes. out_kind:
// 0 = int32 samples, 1 = uint16 samples (held by an int16 tensor), 2 =
// uint8 samples; `out` holds `size` of them. `dests`: 3 x 4 int64, each
// output plane's (dst, rs, cs, sh): sample (r, c) of plane k goes to
// out[dst + r*rs + c*cs], shifted left by sh (frame_store.cuh); the three
// planes back to back are ((k*h*w, w, 1, 0) for k = 0, 1, 2). Launches on
// `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown out_kind, a cbps or shift the
// output type cannot hold, or a dest that leaves `out`).
extern "C" int rct_writeframe_launch(const void* y0, const void* y1,
                                     const void* y2, int64_t h, int64_t w,
                                     int cbps, void* out, int64_t size,
                                     int out_kind, const int64_t* dests,
                                     void* stream) {
  const int max_bits = out_kind == 0 ? 30 : out_kind == 1 ? 16 : 8;
  if (cbps < 1 || cbps > max_bits || h < 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  Dests3 D;
  for (int k = 0; k < 3; ++k) {
    D.d[k] = dest_from(dests + 4 * k);
    if (!dest_ok(D.d[k], h, w, size, cbps, max_bits))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (out_kind) {
    case 0: return launch<int32_t>(y0, y1, y2, h, w, cbps, D, out, s);
    case 1: return launch<uint16_t>(y0, y1, y2, h, w, cbps, D, out, s);
    case 2: return launch<uint8_t>(y0, y1, y2, h, w, cbps, D, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
