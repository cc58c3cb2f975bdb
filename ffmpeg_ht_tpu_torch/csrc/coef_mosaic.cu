// Dequant + prefill + band mosaic of the v3 device program's coefficients.
//
// Replaces three XLA-op stages of the JAX package's v3 program: the dequant
// of the mu words and the sparse prefill scatter of host-decoded lanes
// (ffmpeg_ht_tpu/models/assembly.py:326-357) and the band mosaics that cut
// every subband out of the lane rasters (_mosaic_band, assembly.py:200).
// The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/coef_cuda.py:coef_mosaic_ref.
//
// Per lane, the map table (built once per program from its AssemblyPlan,
// ops/coef_cuda.CoefLayout) gives six int64 values: the offset of the
// lane's subband in one band buffer, that band's width, the codeblock's
// origin (by0, bx0) in the band and its height and width after the
// precinct crop (0 x 0 for lanes that land in no band: pads). Raster sample
// (y, x) of the lane, y < h and x < w, goes to
//     out[off + (by0 + y) * band_w + bx0 + x]
// dequantized as the reference does it (jpeg2000dec.c:2098-2181), from the
// uint32 mu word (bit 31 the sign, held as int32 bits):
//   mode 0, reversible:  m = mag >> (31 - magb); +-m; (m * istep) >> 16
//                        unless istep is 32768 or no_istep (int32 wrap);
//   mode 1, 9/7 integer: m = (+-mag + 32) >> 6; p = (int64)m * scale97;
//                        (p + 2^15) >> 16 if p > 0 else (p + 2^15 - 1) >> 16,
//                        truncated to int32;
//   mode 2, 9/7 float:   (float)(+-mag) * fscale, one float32 rounding.
// A second launch on the same stream then maps each prefill entry
// (pf_idx, an index into the lane rasters, with pf_val's 32 bits) through
// the same table and writes it over the dequantized sample; entries past
// the rasters (the pads) or outside the crop are dropped, as the mosaic of
// the plain version drops them.
//
// What bounds it on the H100: device-memory bytes. A c3 frame (DCI 4K
// 4:4:4, 6708 lanes of 64 x 64) reads 110 MB of mu and writes 106 MB of
// bands; a handful of integer operations a sample is far below the card's
// rates. The design reads mu once and writes each band sample once: one
// block a lane, its threads walking the cropped raster row by row, so a
// warp's loads and stores are 32 consecutive words of one row (coalesced).
// Pad lanes exit before reading anything. Every sample of every band is
// written by exactly one lane (CoefLayout checks the plan once), so the
// buffer needs no zero fill.

#include <cstdint>
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMapCols = 6;   // off, band_w, by0, bx0, h, w

template <int Mode>
__global__ void __launch_bounds__(kThreads)
coef_mosaic_kernel(const int32_t* __restrict__ mu,
                   const int64_t* __restrict__ map,
                   const int32_t* __restrict__ magb,
                   const int32_t* __restrict__ istep,
                   const int32_t* __restrict__ scale97,
                   const float* __restrict__ fscale, int bh, int bw,
                   int no_istep, int32_t* __restrict__ out) {
  const int64_t lane = blockIdx.x;
  const int64_t* m = map + lane * kMapCols;
  const int h = (int)m[4], w = (int)m[5];
  if (h <= 0 || w <= 0) return;
  const int64_t band_w = m[1];
  int32_t* dst = out + m[0] + m[2] * band_w + m[3];
  const int32_t* src = mu + lane * (int64_t)bh * bw;
  const int lmagb = magb[lane], lstep = istep[lane], ls97 = scale97[lane];
  const float lfs = fscale[lane];
  for (int k = threadIdx.x; k < h * bw; k += blockDim.x) {
    const int y = k / bw, x = k - y * bw;
    if (x >= w) continue;
    dst[y * band_w + x] =
        dequant<Mode>(src[k], lmagb, lstep, ls97, lfs, no_istep);
  }
}

__global__ void __launch_bounds__(kThreads)
prefill_kernel(const int32_t* __restrict__ pf_idx,
               const int32_t* __restrict__ pf_val, int64_t n_pf,
               const int64_t* __restrict__ map, int64_t n_lanes, int bh,
               int bw, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pf) return;
  const int64_t idx = pf_idx[i];
  const int64_t span = (int64_t)bh * bw;
  if (idx < 0 || idx >= n_lanes * span) return;     // a pad entry
  const int64_t lane = idx / span;
  const int r = (int)(idx - lane * span);
  const int y = r / bw, x = r - (r / bw) * bw;
  const int64_t* m = map + lane * kMapCols;
  if (y >= m[4] || x >= m[5]) return;               // outside the crop
  out[m[0] + (m[2] + y) * m[1] + m[3] + x] = pf_val[i];
}

template <int Mode>
void launch_mosaic(const void* mu, const void* map, const void* magb,
                   const void* istep, const void* scale97,
                   const void* fscale, int64_t n_lanes, int bh, int bw,
                   int no_istep, void* out, cudaStream_t s) {
  coef_mosaic_kernel<Mode><<<(unsigned)n_lanes, kThreads, 0, s>>>(
      (const int32_t*)mu, (const int64_t*)map, (const int32_t*)magb,
      (const int32_t*)istep, (const int32_t*)scale97, (const float*)fscale,
      bh, bw, no_istep, (int32_t*)out);
}

}  // namespace

// Plain C entry point (ctypes). mu: n_lanes x bh x bw int32 (uint32 bits);
// map: n_lanes x 6 int64 (see above); magb, istep, scale97: n_lanes int32;
// fscale: n_lanes float32; pf_idx, pf_val: n_pf int32 (pf_val holds
// float32 bits in mode 2); out: the band buffer, int32 or float32 bits.
// mode: 0 reversible, 1 9/7 integer, 2 9/7 float. Launches the mosaic and,
// when n_pf > 0, the prefill on `stream` without synchronising; returns
// the first cudaGetLastError() that is not cudaSuccess
// (cudaErrorInvalidValue for an unknown mode or a bad size).
extern "C" int coef_mosaic_launch(const void* mu, const void* map,
                                  const void* magb, const void* istep,
                                  const void* scale97, const void* fscale,
                                  int64_t n_lanes, int bh, int bw, int mode,
                                  int no_istep, const void* pf_idx,
                                  const void* pf_val, int64_t n_pf,
                                  void* out, void* stream) {
  if (n_lanes < 0 || n_lanes > 0x7FFFFFFF || bh < 1 || bw < 1 || n_pf < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_lanes > 0) {
    switch (mode) {
      case 0: launch_mosaic<0>(mu, map, magb, istep, scale97, fscale,
                               n_lanes, bh, bw, no_istep, out, s); break;
      case 1: launch_mosaic<1>(mu, map, magb, istep, scale97, fscale,
                               n_lanes, bh, bw, no_istep, out, s); break;
      case 2: launch_mosaic<2>(mu, map, magb, istep, scale97, fscale,
                               n_lanes, bh, bw, no_istep, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_pf > 0) {
    prefill_kernel<<<(unsigned)((n_pf + kThreads - 1) / kThreads), kThreads,
                     0, s>>>((const int32_t*)pf_idx, (const int32_t*)pf_val,
                             n_pf, (const int64_t*)map, n_lanes, bh, bw,
                             (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
