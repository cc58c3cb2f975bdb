// The dequant of one mu word, shared by csrc/coef_mosaic.cu (the v3
// program) and csrc/bucket_scatter.cu (the v2 program).
//
// From the uint32 mu word (bit 31 the sign, held as int32 bits), as the
// reference does it (jpeg2000dec.c:2098-2181; ops/coef_cuda.dequant):
//   mode 0, reversible:  m = mag >> (31 - magb); +-m; (m * istep) >> 16
//                        unless istep is 32768 or no_istep (int32 wrap);
//   mode 1, 9/7 integer: m = (+-mag + 32) >> 6; p = (int64)m * scale97;
//                        (p + 2^15) >> 16 if p > 0 else (p + 2^15 - 1) >> 16,
//                        truncated to int32;
//   mode 2, 9/7 float:   (float)(+-mag) * fscale, one float32 rounding,
//                        returned as its bits.

#pragma once

#include <cstdint>

namespace {

template <int Mode>
__device__ __forceinline__ int32_t dequant(int32_t v, int magb, int istep,
                                           int scale97, float fscale,
                                           int no_istep) {
  const bool neg = v < 0;
  const int32_t mag = v & 0x7FFFFFFF;
  if (Mode == 2) {
    const float m = __int2float_rn(neg ? -mag : mag);
    return __float_as_int(__fmul_rn(m, fscale));
  }
  if (Mode == 1) {
    const int32_t m = (int32_t)((uint32_t)(neg ? -mag : mag) + 32u) >> 6;
    const int64_t p = (int64_t)m * (int64_t)scale97;
    const int64_t c = p > 0 ? (p + (1 << 15)) >> 16
                            : (p + (1 << 15) - 1) >> 16;
    return (int32_t)(uint32_t)(uint64_t)c;
  }
  // reversible; a shift outside [0, 31) leaves 0 of a non-negative
  // magnitude, as torch's and XLA's shifts do
  const int sh = 31 - magb;
  const int32_t m = (sh < 0 || sh >= 31) ? 0 : mag >> sh;
  int32_t c = neg ? -m : m;
  if (!no_istep && istep != 32768)
    c = (int32_t)((uint32_t)c * (uint32_t)istep) >> 16;
  return c;
}

}  // namespace
