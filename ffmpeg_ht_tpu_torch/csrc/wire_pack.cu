// Wire bit-pack of the decode program's output: uint16 samples of
// `depth` bits (8 < depth < 16) -> uint32 words.
//
// Replaces the XLA-op stage ffmpeg_ht_tpu/ops/wirepack.py pack_words
// (a static shift/or of the 32 sample columns of each group, run inside
// the JAX decode programs when Decoder(wire_pack=True)). Each group of 32
// samples becomes `depth` words, LSB first: sample i of a group fills
// bits [i*depth, (i+1)*depth) of the group's bit string; the tail group
// is padded with zeros. The element after the n samples is the program's
// ok flag; the same launch writes it as one more word after the packed
// ones (this replaces a concatenation). The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/wirepack.py:pack_words_ref.
//
// What bounds it on the H100: device-memory bytes. A 4-frame DCI-4K
// 4:4:4 batch is 106.2 M samples: 212.3 MB read, 132.7 MB written at
// 10 bits, a few shifts and ors a sample. A thread packs one 32-sample
// group, but it neither loads nor stores its own bytes: a lane's 64
// input bytes and 4*depth output bytes would put every warp instruction
// on 32 sectors, half or a tenth used. Instead a block of 256 threads
// owns a tile of 256 consecutive groups (16 KB in, 1024*depth bytes out,
// a contiguous, 16-byte-aligned run that no other block touches):
//   1. the tile is loaded with consecutive 16-byte vectors (a warp reads
//      512 contiguous bytes an instruction) into shared memory, as is;
//   2. each thread reads its group's four vectors from shared memory in
//      an order rotated by (thread >> 1) & 3, so the 8 threads of a
//      quarter-warp hit 8 different 16-byte bank groups (in plain order
//      they would meet 4 ways), and un-rotates them in registers;
//   3. packs them with shifts that a template on depth makes constants;
//   4. stages its `depth` words in the same shared buffer, in stores as
//      wide as depth allows (4, 8 or 16 bytes) so that no two lanes of a
//      store's phase share a bank;
//   5. the tile's words leave in consecutive 16-byte stores.
// Blocks are short-lived, one tile each, 12960 of them on the c5 batch:
// at 32 registers a thread and 16 KB a block, eight sit on each SM and
// each has its 16 KB of loads in flight at once while others pack and
// store. On an H100 80GB HBM3 at 700 W this moves the c5 batch as fast
// as a plain copy of its input streams; persistent grids that stride
// over tiles with cp.async or bulk-copy (TMA) double buffers were slower
// (PERF.md, section 6).
// The last tile of a ragged n, and an input that is not 16-byte aligned
// (a slice at an odd sample offset), take scalar 2-byte loads and 4-byte
// stores through the same shared-memory path. `out` must be 16-byte
// aligned, as every fresh allocation of the wrapper's is.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // groups a tile
constexpr int kGroup = 32;                    // samples a group
constexpr int kTile = kThreads * kGroup;      // samples a tile (16 KB)
constexpr int kVecs = kTile / 8;              // 16-byte vectors a tile

__device__ __forceinline__ void swap4(uint4& a, uint4& b) {
  const uint4 t = a;
  a = b;
  b = t;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
wire_pack_kernel(const uint16_t* __restrict__ in, int64_t n,
                 int64_t ngroups, bool vec, uint32_t* __restrict__ out) {
  __shared__ uint4 buf[kVecs];
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x;
  if (tile == 0 && t == 0) out[ngroups * D] = (uint32_t)in[n];
  const int64_t base = tile * kTile;          // first sample of the tile
  if (base >= n) return;                      // n == 0: the flag only
  const bool full = vec && base + kTile <= n;

  // 1. the tile into shared memory, zeros past n
  if (full) {
    const uint4* src = reinterpret_cast<const uint4*>(in + base);
    uint4 v[kVecs / kThreads];
#pragma unroll
    for (int k = 0; k < kVecs / kThreads; ++k) v[k] = src[t + k * kThreads];
#pragma unroll
    for (int k = 0; k < kVecs / kThreads; ++k) buf[t + k * kThreads] = v[k];
  } else {
    uint16_t* b16 = reinterpret_cast<uint16_t*>(buf);
    for (int i = t; i < kTile; i += kThreads)
      b16[i] = base + i < n ? in[base + i] : (uint16_t)0;
  }
  __syncthreads();

  // 2. this thread's group, its vectors read in rotated order
  const int rot = (t >> 1) & 3;
  uint4 u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) u[k] = buf[4 * t + (k ^ rot)];
  if (rot & 1) { swap4(u[0], u[1]); swap4(u[2], u[3]); }
  if (rot & 2) { swap4(u[0], u[2]); swap4(u[1], u[3]); }

  // 3. pack
  uint32_t s[kGroup];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x[4] = {u[k].x, u[k].y, u[k].z, u[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[8 * k + 2 * j] = x[j] & 0xFFFFu;
      s[8 * k + 2 * j + 1] = x[j] >> 16;
    }
  }
  uint32_t w[D];
#pragma unroll
  for (int j = 0; j < D; ++j) w[j] = 0u;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int off = i * D, lo = off >> 5, sh = off & 31;
    w[lo] |= s[i] << sh;
    if (sh + D > 32) w[lo + 1] |= s[i] >> (32 - sh);
  }

  // 4. stage the words where the group's input was; the widest store
  // that keeps a thread's run aligned: D / width is then odd, so the
  // lanes of one store phase fall on distinct banks
  __syncthreads();
  uint32_t* stage = reinterpret_cast<uint32_t*>(buf) + t * D;
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int j = 0; j < D; j += 4)
      *reinterpret_cast<uint4*>(stage + j) =
          make_uint4(w[j], w[j + 1], w[j + 2], w[j + 3]);
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int j = 0; j < D; j += 2)
      *reinterpret_cast<uint2*>(stage + j) = make_uint2(w[j], w[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) stage[j] = w[j];
  }
  __syncthreads();

  // 5. the tile's words out
  uint32_t* dst = out + tile * kThreads * D;
  if (full) {
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = t; i < kThreads * D / 4; i += kThreads) dst4[i] = buf[i];
  } else {
    const int64_t left = (ngroups - tile * kThreads) * D;
    const int nw = left < kThreads * D ? (int)left : kThreads * D;
    const uint32_t* b32 = reinterpret_cast<const uint32_t*>(buf);
    for (int i = t; i < nw; i += kThreads) dst[i] = b32[i];
  }
}

template <int D>
void launch(const uint16_t* in, int64_t n, uint32_t* out,
            cudaStream_t stream) {
  const int64_t ngroups = (n + kGroup - 1) / kGroup;
  const int64_t blocks = ngroups > 0 ? (ngroups + kThreads - 1) / kThreads
                                     : 1;
  const bool vec = (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  wire_pack_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, n, ngroups, vec, out);
}

}  // namespace

// Plain C entry point (ctypes). `in` holds n uint16 samples (an int16
// tensor's bits) followed by the ok flag; `out` receives
// ceil(n / 32) * depth words, then the flag word. Launches on
// `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for a depth outside 9..15 or a negative n).
extern "C" int wire_pack_launch(const void* in, int64_t n, int depth,
                                void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const uint16_t* src = (const uint16_t*)in;
  uint32_t* dst = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
    case 9: launch<9>(src, n, dst, s); break;
    case 10: launch<10>(src, n, dst, s); break;
    case 11: launch<11>(src, n, dst, s); break;
    case 12: launch<12>(src, n, dst, s); break;
    case 13: launch<13>(src, n, dst, s); break;
    case 14: launch<14>(src, n, dst, s); break;
    case 15: launch<15>(src, n, dst, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
