// The inverse DWT's lifting arithmetic (5/3, integer 9/7, float 9/7),
// shared by csrc/dwt_lift.cu (levels of at least 8 x 8) and
// csrc/dwt_small.cu (levels under 8 in a dimension).
//
// It follows the plain version (ffmpeg_ht_tpu_torch/ops/dwt_torch.py, the
// reference's sr_1d53 / sr_1d97_int / sr_1d97_float, jpeg2000dwt.c:
// 309-537) exactly: int32 with wraparound, the Q16 products of the integer
// 9/7 in int64 where the reference widens them, and the float 9/7 in
// float32 with one rounding per operation in the reference's order, spelt
// __fadd_rn / __fsub_rn / __fmul_rn so that nvcc cannot contract a
// multiply and an add into one FMA.

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// (coef * (a + b) + 2^15) >> 16 in int64, truncated to int32 (_q16j)
__device__ __forceinline__ int32_t q16(int64_t coef, int32_t a, int32_t b) {
  const int64_t s = (int64_t)a + (int64_t)b;
  return (int32_t)(uint32_t)(uint64_t)((coef * s + (1 << 15)) >> 16);
}

// A transform: its lifting steps, alternately E from O (even steps) and
// O from E (odd steps), x the sample updated, a and b its neighbours;
// `single`, a line of one sample at an even or odd position; `preshift`,
// the integer 9/7's final rounding shift.
struct Lift53 {
  using T = int32_t;
  static constexpr int kSteps = 2;
  __device__ static T step(int st, T x, T a, T b) {
    if (st == 0) return wsub(x, wadd(wadd(a, b), 2) >> 2);
    return wadd(x, wadd(a, b) >> 1);
  }
  __device__ static T single(T x, int odd) { return odd ? x >> 1 : x; }
  __device__ static T preshift(T v) { return v; }
};

struct Lift97i {
  using T = int32_t;
  static constexpr int kSteps = 4;
  __device__ static T step(int st, T x, T a, T b) {
    switch (st) {
      case 0: return wsub(x, q16(29066, a, b));       // I_LFTG_DELTA
      case 1: return wsub(x, q16(57862, a, b));       // I_LFTG_GAMMA
      case 2: return wadd(x, q16(3472, a, b));        // I_LFTG_BETA
      default: {                                      // I_LFTG_ALPHA'
        const int64_t s = (int64_t)a + (int64_t)b;
        const int32_t d = wadd((int32_t)(uint32_t)(uint64_t)s,
                               (int32_t)(uint32_t)(uint64_t)(
                                   (38413 * s + (1 << 15)) >> 16));
        return wadd(x, d);
      }
    }
  }
  __device__ static T single(T x, int odd) {         // I_LFTG_K, I_LFTG_X
    return odd ? (int32_t)(uint32_t)(uint64_t)(((int64_t)x * 80621
                                                + (1 << 16)) >> 17)
               : (int32_t)(uint32_t)(uint64_t)(((int64_t)x * 53274
                                                + (1 << 15)) >> 16);
  }
  __device__ static T preshift(T v) {                // I_PRESHIFT = 8
    return (int32_t)(uint32_t)(uint64_t)(((int64_t)v + 128) >> 8);
  }
};

struct Lift97f {
  using T = float;
  static constexpr int kSteps = 4;
  __device__ static T step(int st, T x, T a, T b) {
    const float s = __fadd_rn(a, b);
    switch (st) {                                     // float32 constants
      case 0: return __fsub_rn(x, __fmul_rn(0x1.c626aap-2f, s));  // DELTA
      case 1: return __fsub_rn(x, __fmul_rn(0x1.c40cecp-1f, s));  // GAMMA
      case 2: return __fadd_rn(x, __fmul_rn(0x1.b2035cp-5f, s));  // BETA
      default: return __fadd_rn(x, __fmul_rn(0x1.960ce6p+0f, s)); // ALPHA
    }
  }
  __device__ static T single(T x, int odd) {         // K / 2, X
    return __fmul_rn(x, odd ? 0x1.3aecb0p-1f : 0x1.a03386p-1f);
  }
  __device__ static T preshift(T v) { return v; }
};

}  // namespace
