// DC shift + clip + narrow pack of every plane without MCT of a device
// program, in one launch.
//
// Replaces the tail of the JAX package's programs for planes that no RCT
// or ICT takes (ffmpeg_ht_tpu/models/assembly.py:389 `finish` and the
// packing concatenation at :442-445; the v2 assembly's, decoder.py:546
// and :602-604): float samples rounded half to even, + (1 << (cbps - 1)) in
// int32 (wrapping), clipped to [0, 2^cbps - 1], and narrowed to uint8,
// int16 holding uint16 bits, or int32, at the plane's offset in the packed
// output. The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/mct_cuda.py:plane_writeframe_ref (dc_shift_clip
// + narrow, a plane at a time).
//
// Planes come from several buffers (a DWT scratch buffer, the flat
// coefficient buffer, a band buffer), so the host passes each plane as an
// element offset from one base address, with its sample count and its
// offset in the output; the table rides in the launch's parameters (160
// planes a launch: a c4 8K batch of 4 frames, 40 tiles each, in one).
//
// What bounds it on the H100: device-memory bytes, 4 read and 1 or 2
// written a sample; a rounding, an add and a clamp a sample are far below
// the card's rates. The design: the planes cut into chunks of 4096
// samples, a block a chunk, the plane found by a binary search of the
// table; a thread handles 16 samples 256 apart, so every warp-wide load
// is 128 consecutive bytes and every store 32 or 64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16 * kThreads;    // samples a block
constexpr int kMaxPlanes = 160;          // planes a launch (3.8 KB of
                                         // params, within 4 KB)

struct Plane {
  int64_t src, dst;                      // element offsets: from the base,
                                         // into the output
  int n, block0;                         // samples; first block
};

struct Launch {
  Plane p[kMaxPlanes];
  int nplanes;
};

template <bool Float, int Kind>
__global__ void __launch_bounds__(kThreads)
writeframe_kernel(const __grid_constant__ Launch L, const char* base,
                  int cbps, void* out) {
  int lo = 0, hi = L.nplanes - 1;                      // last block0 <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.p[mid].block0 <= (int)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Plane& P = L.p[lo];
  const int64_t first = (int64_t)(blockIdx.x - P.block0) * kChunk;
  const int64_t end = first + kChunk < P.n ? first + kChunk : P.n;
  const uint32_t shift = 1u << (cbps - 1);
  const int32_t top = (int32_t)((1u << cbps) - 1u);
  for (int64_t i = first + threadIdx.x; i < end; i += kThreads) {
    int32_t v;
    if (Float)
      v = __float2int_rn(reinterpret_cast<const float*>(base)[P.src + i]);
    else
      v = reinterpret_cast<const int32_t*>(base)[P.src + i];
    v = (int32_t)((uint32_t)v + shift);
    v = v < 0 ? 0 : v > top ? top : v;
    if (Kind == 0)
      static_cast<int32_t*>(out)[P.dst + i] = v;
    else if (Kind == 1)
      static_cast<uint16_t*>(out)[P.dst + i] = (uint16_t)v;
    else
      static_cast<uint8_t*>(out)[P.dst + i] = (uint8_t)v;
  }
}

template <bool Float, int Kind>
int launch(const Launch& L, int blocks, const void* base, int cbps,
           void* out, cudaStream_t s) {
  writeframe_kernel<Float, Kind><<<blocks, kThreads, 0, s>>>(
      L, static_cast<const char*>(base), cbps, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (ctypes). `table`: host array of 3 int64 values a
// plane: its first sample's element offset from `base` (int32 samples, or
// float32 with src_float 1), its sample count (1 .. 2^31 - 1), and its
// element offset in `out`. kind: 0 int32, 1 int16 (uint16 bits), 2 uint8
// output; cbps 1 .. 30 (int32), 16 (int16), 8 (uint8). One launch each
// kMaxPlanes planes on `stream`, without synchronising; *launches gets the
// launches made. Returns the first cudaGetLastError() that is not
// cudaSuccess, or cudaErrorInvalidValue for a bad kind, depth or count.
extern "C" int plane_writeframe_launch(const int64_t* table, int nplanes,
                                       const void* base, int src_float,
                                       int cbps, void* out, int kind,
                                       void* stream, int* launches) {
  *launches = 0;
  const int max_cbps = kind == 0 ? 30 : kind == 1 ? 16 : 8;
  if (nplanes < 0 || kind < 0 || kind > 2 || (src_float & ~1) || cbps < 1
      || cbps > max_cbps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int p0 = 0; p0 < nplanes; p0 += kMaxPlanes) {
    Launch L;
    L.nplanes = 0;
    int64_t blocks = 0;
    for (int p = p0; p < nplanes && p < p0 + kMaxPlanes; ++p) {
      const int64_t* d = table + 3 * (int64_t)p;
      if (d[1] < 1 || d[1] > INT32_MAX) return (int)cudaErrorInvalidValue;
      Plane& P = L.p[L.nplanes++];
      P.src = d[0], P.dst = d[2], P.n = (int)d[1];
      P.block0 = (int)blocks;
      blocks += (d[1] + kChunk - 1) / kChunk;
      if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    }
    int err;
    const int key = 3 * src_float + kind;
    switch (key) {
      case 0: err = launch<false, 0>(L, (int)blocks, base, cbps, out, s); break;
      case 1: err = launch<false, 1>(L, (int)blocks, base, cbps, out, s); break;
      case 2: err = launch<false, 2>(L, (int)blocks, base, cbps, out, s); break;
      case 3: err = launch<true, 0>(L, (int)blocks, base, cbps, out, s); break;
      case 4: err = launch<true, 1>(L, (int)blocks, base, cbps, out, s); break;
      default: err = launch<true, 2>(L, (int)blocks, base, cbps, out, s); break;
    }
    if (err != 0) return err;
    ++*launches;
  }
  return 0;
}
