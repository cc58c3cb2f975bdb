// Inverse irreversible colour transform + DC shift + clip + the frame write.
//
// Replaces the XLA-op tail of the JAX package's v3 program for 9/7 frames
// with MCT (ffmpeg_ht_tpu/models/assembly.py:390-408: ict_int or
// ict_float, then finish), itself the analog of the reference's
// ict_int / ict_float (jpeg2000dsp.c:43-76) plus write_frame_8/16
// (jpeg2000dec.c:2301-2364). Two modes, per pixel:
//
//   int (9/7 integer, int32 planes), wraparound int32 with
//     qmul(c, v) = (int32)((uint32)c * (uint32)v + 2^15) >> 16:
//     i0 = y0 + y2 + qmul(26345, y2)
//     i1 = y0 - qmul(22553, y1) - qmul(46802, y2)
//     i2 = y0 + 2*y1 + qmul(-14942, y1)
//   float (9/7 float, float32 planes), each operation rounded to float32:
//     i0 = y0 + 1.402f*y2
//     i1 = (y0 - 0.34413f*y1) - 0.71414f*y2
//     i2 = y0 + 1.772f*y1
//     then rint (round half to even) to int32.
//
// then each plane + (1 << (cbps-1)), clipped to [0, 2^cbps - 1], shifted
// left to the frame's precision and stored at its place in the frame
// (frame_store.cuh: interleaved in rgb24, or three planes back to back in
// the program's tile-component layout). The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/mct_cuda.py:ict_writeframe_ref.
//
// The float mode spells every multiply and add as __fmul_rn / __fadd_rn /
// __fsub_rn: nvcc contracts a*b + c into one FMA by default, which rounds
// once instead of twice and moves results by up to one LSB against the
// plain version and the JAX package. Those intrinsics are never contracted.
// __float2int_rn is rint's half-to-even rounding.
//
// What bounds it on the H100: device-memory bytes. A 1080p RGB frame is
// 2.07 M pixels x (12 B read + 3 B written as uint8); a few dozen integer
// or float operations per pixel are far below the card's rates. As in
// rct_writeframe.cu, a block a row segment of 1024 pixels, coalesced
// 4-byte loads of the three planes, and the clipped samples staged in
// shared memory in the frame's order and written out as whole 16-byte
// words. One launch covers every frame of a batch (blockIdx.y is the
// frame): the planes of each frame are separate tensors, so the launch
// takes their addresses by value, and each frame's output sits
// `frame_stride` samples after the previous one's, in the same layout.
// At 1080p a launch's fixed cost is a large part of one frame's 9 us
// bound, so a batch of F frames in one launch comes closer to it.

#include <cstdint>
#include <cuda_runtime.h>

#include "frame_store.cuh"

namespace {

using namespace frame_store;

constexpr int kThreads = 256;
constexpr int kPix = 4;                  // pixels a thread
constexpr int kSeg = kThreads * kPix;    // pixels a block
constexpr int kMaxFrames = 32;   // frames per launch: 96 pointers, 768 B
                                 // of kernel parameters

struct FramePlanes {
  const void* y[3][kMaxFrames];  // y0, y1, y2 of each frame
};

struct Dests3 {
  Dest d[3];
};

__device__ __forceinline__ uint32_t qmul(uint32_t c, uint32_t v) {
  return (uint32_t)((int32_t)(c * v + (1u << 15)) >> 16);
}

struct IctInt {
  using In = int32_t;
  __device__ __forceinline__ static void apply(In a, In b, In c,
                                               int32_t* r) {
    const uint32_t y0 = (uint32_t)a, y1 = (uint32_t)b, y2 = (uint32_t)c;
    r[0] = (int32_t)(y0 + y2 + qmul(26345u, y2));
    r[1] = (int32_t)(y0 - qmul(22553u, y1) - qmul(46802u, y2));
    r[2] = (int32_t)(y0 + 2u * y1 + qmul((uint32_t)-14942, y1));
  }
};

struct IctFloat {
  using In = float;
  __device__ __forceinline__ static void apply(In y0, In y1, In y2,
                                               int32_t* r) {
    r[0] = __float2int_rn(__fadd_rn(y0, __fmul_rn(1.402f, y2)));
    r[1] = __float2int_rn(__fsub_rn(__fsub_rn(y0, __fmul_rn(0.34413f, y1)),
                                    __fmul_rn(0.71414f, y2)));
    r[2] = __float2int_rn(__fadd_rn(y0, __fmul_rn(1.772f, y1)));
  }
};

template <typename Mode, typename OutT>
__global__ void __launch_bounds__(kThreads)
ict_kernel(const FramePlanes planes, int64_t w, int64_t chunks,
           int64_t frame_stride, const Dests3 D, int mode, int dc,
           int maxval, OutT* __restrict__ out) {
  using In = typename Mode::In;
  constexpr int V = 16 / sizeof(OutT);
  __shared__ __align__(16) OutT st[3 * (kSeg + V)];
  const int f = blockIdx.y;
  const In* __restrict__ y0 = (const In*)planes.y[0][f];
  const In* __restrict__ y1 = (const In*)planes.y[1][f];
  const In* __restrict__ y2 = (const In*)planes.y[2][f];
  const int64_t row = blockIdx.x / chunks;
  const int64_t c0 = (blockIdx.x - row * chunks) * kSeg;
  const int m = (int)(w - c0 < kSeg ? w - c0 : kSeg);
  const int64_t src = row * w + c0;
  OutT* g[3];
  int at[3];                             // where each run starts in st
  for (int k = 0; k < 3; ++k) {
    g[k] = out + f * frame_stride + D.d[k].dst + row * D.d[k].rs
           + c0 * D.d[k].cs;
    at[k] = mode == kInterleaved ? word_offset(g[0]) + k
                                 : k * (kSeg + V) + word_offset(g[k]);
  }
  const int step = mode == kInterleaved ? 3 : 1;
  In in[3][kPix];                        // every load in flight at once
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    if (p < m) {
      in[0][j] = y0[src + p];
      in[1][j] = y1[src + p];
      in[2][j] = y2[src + p];
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = j * kThreads + threadIdx.x;
    if (p >= m) break;
    int32_t r[3];
    Mode::apply(in[0][j], in[1][j], in[2][j], r);
    for (int k = 0; k < 3; ++k) {
      // DC shift in wraparound int32, as the JAX package's int32 add
      const OutT o = (OutT)(clip((int32_t)((uint32_t)r[k] + dc), maxval)
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

template <typename Mode, typename OutT>
int launch(const void* const* ys[3], int frames, int64_t h, int64_t w,
           int cbps, void* out, int64_t frame_stride, const Dests3& D,
           cudaStream_t stream) {
  if (h == 0 || w == 0) return 0;
  if (flat(D.d, 3, h, w)) w *= h, h = 1;
  const int64_t chunks = (w + kSeg - 1) / kSeg;
  if (h * chunks > INT32_MAX) return (int)cudaErrorInvalidValue;
  for (int f0 = 0; f0 < frames; f0 += kMaxFrames) {
    const int nf = frames - f0 < kMaxFrames ? frames - f0 : kMaxFrames;
    FramePlanes planes;
    for (int c = 0; c < 3; ++c)
      for (int f = 0; f < nf; ++f) planes.y[c][f] = ys[c][f0 + f];
    ict_kernel<Mode, OutT><<<dim3((unsigned)(h * chunks), (unsigned)nf),
                             kThreads, 0, stream>>>(
        planes, w, chunks, frame_stride, D, mode_of(D.d, 3),
        1 << (cbps - 1), (1 << cbps) - 1, (OutT*)out + f0 * frame_stride);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename Mode>
int launch_kind(const void* const* ys[3], int frames, int64_t h, int64_t w,
                int cbps, void* out, int64_t frame_stride, const Dests3& D,
                int out_kind, cudaStream_t s) {
  switch (out_kind) {
    case 0: return launch<Mode, int32_t>(ys, frames, h, w, cbps, out,
                                         frame_stride, D, s);
    case 1: return launch<Mode, uint16_t>(ys, frames, h, w, cbps, out,
                                          frame_stride, D, s);
    case 2: return launch<Mode, uint8_t>(ys, frames, h, w, cbps, out,
                                         frame_stride, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (ctypes). y0s, y1s, y2s: host arrays of `frames`
// device pointers, the h x w planes of each frame. mode: 0 = integer ICT
// on int32 planes, 1 = float ICT on float32 planes. out_kind: 0 = int32
// samples, 1 = uint16 samples (held by an int16 tensor), 2 = uint8
// samples; `out` holds `size` of them. `dests`: 3 x 4 int64, frame 0's
// output planes' (dst, rs, cs, sh) as in rct_writeframe_launch; frame f's
// sit `frame_stride` samples after frame f-1's. One launch per kMaxFrames
// frames, on `stream`, without synchronising; returns the first
// cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue for
// an unknown mode or out_kind, a cbps or shift the output type cannot
// hold, frames < 1, or a dest of the last frame that leaves `out`).
extern "C" int ict_writeframe_launch(const void* const* y0s,
                                     const void* const* y1s,
                                     const void* const* y2s, int frames,
                                     int64_t h, int64_t w, int cbps,
                                     void* out, int64_t size,
                                     int64_t frame_stride,
                                     const int64_t* dests, int out_kind,
                                     int mode, void* stream) {
  const int max_bits = out_kind == 0 ? 30 : out_kind == 1 ? 16 : 8;
  if (cbps < 1 || cbps > max_bits || frames < 1 || h < 0 || w < 0 ||
      frame_stride < 0)
    return (int)cudaErrorInvalidValue;
  Dests3 D;
  for (int k = 0; k < 3; ++k) {
    D.d[k] = dest_from(dests + 4 * k);
    Dest last = D.d[k];
    last.dst += (frames - 1) * frame_stride;
    if (!dest_ok(last, h, w, size, cbps, max_bits))
      return (int)cudaErrorInvalidValue;
  }
  const void* const* ys[3] = {y0s, y1s, y2s};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_kind<IctInt>(ys, frames, h, w, cbps, out,
                                       frame_stride, D, out_kind, s);
    case 1: return launch_kind<IctFloat>(ys, frames, h, w, cbps, out,
                                         frame_stride, D, out_kind, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
