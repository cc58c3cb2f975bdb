// Dequant + scatter of every bucket of the v2 device program, after the
// sparse prefill, into one flat coefficient buffer.
//
// Replaces the XLA-op stages of the JAX package's v2 assembly between the
// entropy stage and the inverse DWT (ffmpeg_ht_tpu/models/decoder.py:
// 481-519, in _compiled_assembly at :460): a zero buffer of total + 1
// samples, the prefill of host-decoded samples (flat.at[pf_idx].set), and
// each bucket's lanes dequantized (csrc/dequant.cuh, the three modes) and
// scattered, raster sample (y, x) of a lane with y < h and x < w to
// dest + y * stride + x. The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/coef_cuda.py:bucket_scatter_ref.
//
// Order. The plain version writes the prefill, then the buckets in order,
// so a lane sample wins over a prefill entry at the same index. Here a
// memset, the prefill launch and the bucket launch follow one another on
// one stream, which keeps that order. Pad lanes (dest < 0), raster
// samples outside the codeblock and the prefill's pads (index total) are
// written nowhere: the trash slot, out[total], stays 0 (the plain version
// clears it last). Codeblocks never share a sample, so no two lanes write
// one index.
//
// What bounds it on the H100: device-memory bytes. The real samples' mu is
// read once (4 B a sample) and the flat buffer written once (4 B a
// sample), plus the prefill; a c4 8K frame (~33.2 M samples) is ~0.08 ms
// at 3.35 TB/s, and a few integer operations a sample are far below the
// card's rates. The design: one block a lane, its threads walking the
// lane's raster row by row, so that a warp loads 32 consecutive mu words
// and stores 32 consecutive samples of one codeblock row (coalesced for
// the 64-wide codeblocks that carry almost every sample); the buckets (a
// few to a few dozen a program) ride in the launch's parameters, 48 a
// launch, so nothing is uploaded per call. The zeros are a memset: the
// lanes do not cover the samples of codeblocks that code no pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 48;          // buckets a launch (3.8 KB of
                                         // params, within 4 KB)
constexpr int kBucketInts = 12;          // int64 values a bucket in the table

struct Bucket {
  const int32_t* mu;                     // n x bh x bw
  const int32_t* dest;                   // n lane vectors
  const int32_t* stride;
  const int32_t* magb;
  const int32_t* istep;
  const int32_t* scale97;
  const float* fscale;
  int n, bh, bw, h, w, block0;           // lanes, raster, codeblock, first
                                         // block
};

struct Launch {
  Bucket b[kMaxBuckets];
  int nbuckets;
};

template <int Mode>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const __grid_constant__ Launch L, int64_t total, int no_istep,
               int32_t* __restrict__ out) {
  int k = 0;
  while (k + 1 < L.nbuckets && L.b[k + 1].block0 <= (int)blockIdx.x) ++k;
  const Bucket& B = L.b[k];
  const int64_t lane = blockIdx.x - B.block0;
  const int64_t dest = B.dest[lane];
  if (dest < 0) return;                                // a pad lane
  const int64_t stride = B.stride[lane];
  const int magb = B.magb[lane], istep = B.istep[lane];
  const int s97 = B.scale97[lane];
  const float fs = B.fscale[lane];
  const int32_t* src = B.mu + lane * B.bh * B.bw;
  for (int i = threadIdx.x; i < B.h * B.bw; i += blockDim.x) {
    const int y = i / B.bw, x = i - y * B.bw;
    if (x >= B.w) continue;                            // outside the block
    const int64_t at = dest + y * stride + x;
    if (at >= total) continue;                         // the trash slot
    out[at] = dequant<Mode>(src[i], magb, istep, s97, fs, no_istep);
  }
}

__global__ void __launch_bounds__(kThreads)
prefill_kernel(const int32_t* __restrict__ pf_idx,
               const int32_t* __restrict__ pf_val, int64_t n_pf,
               int64_t total, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pf) return;
  const int64_t idx = pf_idx[i];
  if (idx < 0 || idx >= total) return;                 // a pad entry
  out[idx] = pf_val[i];
}

template <int Mode>
int launch_buckets(const int64_t* table, int nbuckets, int64_t total,
                   int no_istep, void* out, cudaStream_t s, int* launches) {
  for (int b0 = 0; b0 < nbuckets; b0 += kMaxBuckets) {
    Launch L;
    L.nbuckets = 0;
    int64_t blocks = 0;
    for (int b = b0; b < nbuckets && b < b0 + kMaxBuckets; ++b) {
      const int64_t* d = table + (int64_t)b * kBucketInts;
      Bucket& B = L.b[L.nbuckets++];
      B.mu = (const int32_t*)d[0];
      B.dest = (const int32_t*)d[1];
      B.stride = (const int32_t*)d[2];
      B.magb = (const int32_t*)d[3];
      B.istep = (const int32_t*)d[4];
      B.scale97 = (const int32_t*)d[5];
      B.fscale = (const float*)d[6];
      B.n = (int)d[7], B.bh = (int)d[8], B.bw = (int)d[9];
      B.h = (int)d[10], B.w = (int)d[11];
      B.block0 = (int)blocks;
      blocks += B.n;
    }
    if (blocks > 0) {
      scatter_kernel<Mode><<<(unsigned)blocks, kThreads, 0, s>>>(
          L, total, no_istep, (int32_t*)out);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++*launches;
    }
  }
  return 0;
}

}  // namespace

// Plain C entry point (ctypes). `table`: host array of kBucketInts int64
// values a bucket: the device addresses of its mu (n x bh x bw int32, the
// uint32 words' bits) and of its n-lane vectors dest, stride, magb, istep,
// scale97 (int32) and fscale (float32), then n, bh, bw, h, w (h <= bh,
// w <= bw, the codeblock). pf_idx, pf_val: n_pf int32 (pf_val holds
// float32 bits in mode 2). out: total + 1 int32 or float32 samples. mode:
// 0 reversible, 1 9/7 integer, 2 9/7 float. On `stream`, without
// synchronising: a memset of out, the prefill when n_pf > 0, then every
// bucket's lanes (one launch each kMaxBuckets buckets with lanes, counted
// in *launches; the memset and the prefill ride on the call, as
// coef_mosaic's prefill does). Returns the first
// error that is not cudaSuccess (cudaErrorInvalidValue for an unknown mode,
// a bad size, or a bucket of more than 2^31 - 1 lanes or samples).
extern "C" int bucket_scatter_launch(const int64_t* table, int nbuckets,
                                     const void* pf_idx, const void* pf_val,
                                     int64_t n_pf, int64_t total, int mode,
                                     int no_istep, void* out, void* stream,
                                     int* launches) {
  *launches = 0;
  if (nbuckets < 0 || n_pf < 0 || total < 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  int64_t lanes = 0;
  for (int b = 0; b < nbuckets; ++b) {
    const int64_t* d = table + (int64_t)b * kBucketInts;
    if (d[7] < 0 || d[8] < 1 || d[9] < 1 || d[10] < 0 || d[11] < 0
        || d[10] > d[8] || d[11] > d[9] || d[8] * d[9] > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    lanes += d[7];
  }
  if (lanes > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(total + 1) * 4, s);
  if (err != cudaSuccess) return (int)err;
  if (n_pf > 0) {
    prefill_kernel<<<(unsigned)((n_pf + kThreads - 1) / kThreads), kThreads,
                     0, s>>>((const int32_t*)pf_idx, (const int32_t*)pf_val,
                             n_pf, total, (int32_t*)out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  switch (mode) {
    case 0:
      return launch_buckets<0>(table, nbuckets, total, no_istep, out, s,
                               launches);
    case 1:
      return launch_buckets<1>(table, nbuckets, total, no_istep, out, s,
                               launches);
    default:
      return launch_buckets<2>(table, nbuckets, total, no_istep, out, s,
                               launches);
  }
}
