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
// 10 bits, a few shifts and ors a sample. The design is the simple one:
// one thread per 32-sample group, four 16-byte loads of its 64 input
// bytes (scalar loads for a tail group or an unaligned input), the
// shifts made compile-time constants by a template on depth, and
// `depth` 32-bit stores. A warp-cooperative layout with coalesced
// loads and stores would be the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
wire_pack_kernel(const uint16_t* __restrict__ in, int64_t n,
                 int64_t ngroups, bool vec, uint32_t* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g == 0) out[ngroups * D] = (uint32_t)in[n];
  if (g >= ngroups) return;
  const int64_t base = g * kGroup;
  uint32_t s[kGroup];
  if (vec && base + kGroup <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(in + base);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 v = p[k];
      const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[8 * k + 2 * j] = x[j] & 0xFFFFu;
        s[8 * k + 2 * j + 1] = x[j] >> 16;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      s[i] = base + i < n ? (uint32_t)in[base + i] : 0u;
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
  uint32_t* o = out + g * D;
#pragma unroll
  for (int j = 0; j < D; ++j) o[j] = w[j];
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
