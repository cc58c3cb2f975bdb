// The inverse DWT's levels under 8 samples in a dimension (5/3, integer
// 9/7, float 9/7): every such level of every plane of a program in one
// launch.
//
// Replaces the interleaved line-buffer branch of the JAX package's flat
// inverse DWT (ffmpeg_ht_tpu/ops/dwt_jax.py:362 _dwt_decode_traced, the
// levels whose width or height is under 8, with _interleave, _extend and
// _sr53 / _sr97i / _sr97f; the reference's sr_1d*, jpeg2000dwt.c:309-537).
// The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/dwt_torch.py:dwt_level_small_ref; the wrapper is
// ops/dwt_cuda.py (dwt_lift_program, dwt_small).
//
// A job is one plane's level as in csrc/dwt_lift.cu (the same table row:
// the previous LL, HL, LH and HH as bands of rows at row strides, and the
// next LL, h x w, contiguous), but w < 8 or h < 8; either may be long
// (5 x 70000 decodes). The reference lifts a line of n >= 2 samples on a
// buffer extended by 2 (5/3) or 4 (9/7) samples, where for n < 5 the
// extension reads samples that earlier writes of the extension made: the
// result is the whole-sample symmetric extension of period 2 (n - 1). Each
// lifting step writes one parity and reads the other, and keeps that
// extension symmetric, so lifting the line in place, a step at a time,
// with every neighbour read from its mirror inside the line (period 2 (n -
// 1)), gives the reference's samples bit for bit. A line of one sample is
// scaled instead (the reference's n = 1 rules: the 5/3 halves an odd
// sample, the 9/7 multiplies by K / 2 or X).
//
// What bounds it on the H100: nothing the card's rates see. A small level
// of a real plane holds a few hundred samples (the 8K frame's bottom tiles:
// 32 x 7 and 16 x 7), so the launch and one dependent chain of reads are
// the time. The design therefore puts all of a program's small levels in
// one launch, a block a plane: the block walks its plane's small levels in
// order (each reads the one before from the output buffer), a thread a
// row, then, after a barrier, a thread a column. A row thread gathers its
// band row's L and H halves into the output row at their interleaved
// positions (and the row's interleaved position), then lifts it in place;
// a column thread lifts its column in place and applies the integer 9/7's
// final shift on a plane's last level. No line is held whole anywhere but
// in device memory (L1 and L2 keep these few samples), so a level has no
// length limit. The plane's levels of at least 8 x 8 follow in
// csrc/dwt_lift.cu's launches on the same stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "dwt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kJobInts = 14;             // the table row of csrc/dwt_lift.cu

// i (an offset from the line's first sample) mirrored into [0, n), n >= 2:
// the whole-sample symmetric extension, period 2 (n - 1)
__device__ __forceinline__ int reflect(int i, int n) {
  const int period = 2 * (n - 1);
  int r = i % period;
  if (r < 0) r += period;
  return r < n ? r : period - r;
}

// Inverse lifting of the n samples p[k * s], k < n, which sit at the
// absolute positions i0 + k (i0's parity is what counts), in place.
template <class Op>
__device__ void lift_line(typename Op::T* p, int64_t s, int n, int i0) {
  if (n == 1) {
    p[0] = Op::single(p[0], i0 & 1);
    return;
  }
  for (int st = 0; st < Op::kSteps; ++st) {
    // even steps update the even absolute positions, odd steps the odd
    for (int k = ((i0 ^ st) & 1); k < n; k += 2) {
      const typename Op::T a = p[reflect(k - 1, n) * s];
      const typename Op::T b = p[reflect(k + 1, n) * s];
      p[k * s] = Op::step(st, p[k * s], a, b);
    }
  }
}

// One level: `d` its table row, `in` the input buffer, `out` the output
// buffer (element offsets into them).
template <class Op>
__device__ void small_level(const int64_t* __restrict__ d,
                            const typename Op::T* in,
                            typename Op::T* out) {
  using T = typename Op::T;
  const int w = (int)d[7], h = (int)d[8], mh = (int)d[9], mv = (int)d[10];
  const int nE = (w + 1 - mh) >> 1, nO = w - nE, nEv = (h + 1 - mv) >> 1;
  const T* ll = (d[1] ? out : in) + d[2];
  const T* hl = in + d[3];
  const T* lh = in + d[4];
  const T* hh = in + d[5];
  T* dst = out + d[6];
  const int64_t lls = d[12] ? d[12] : nE;
  const int64_t hls = d[13] ? d[13] : nO;
  const int64_t lhs = d[13] ? d[13] : nE;
  const int64_t hhs = d[13] ? d[13] : nO;
  // rows: band row r (L rows first, then H rows) to its interleaved row
  for (int r = threadIdx.x; r < h; r += blockDim.x) {
    const bool low = r < nEv;
    const int rr = low ? r : r - nEv;
    const int y = low ? 2 * rr + mv : 2 * rr + 1 - mv;
    const T* L = low ? ll + rr * lls : lh + rr * lhs;
    const T* H = low ? hl + rr * hls : hh + rr * hhs;
    T* row = dst + (int64_t)y * w;
    for (int j = 0; j < nE; ++j) row[2 * j + mh] = L[j];
    for (int j = 0; j < nO; ++j) row[2 * j + 1 - mh] = H[j];
    lift_line<Op>(row, 1, w, mh);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    lift_line<Op>(dst + c, w, h, mv);
    if (d[11])
      for (int y = 0; y < h; ++y)
        dst[c + (int64_t)y * w] = Op::preshift(dst[c + (int64_t)y * w]);
  }
  __syncthreads();
}

// A block a plane: its small levels, table rows [chains[b], chains[b + 1]),
// in order.
template <class Op>
__global__ void __launch_bounds__(kThreads)
small_levels(const int64_t* __restrict__ table,
             const int64_t* __restrict__ chains, const void* in, void* out) {
  using T = typename Op::T;
  for (int64_t j = chains[blockIdx.x]; j < chains[blockIdx.x + 1]; ++j)
    small_level<Op>(table + j * kJobInts, static_cast<const T*>(in),
                    static_cast<T*>(out));
}

}  // namespace

// Plain C entry point (ctypes). `table`: device array of kJobInts int64
// values a job (csrc/dwt_lift.cu's row: level, ll_out, ll, hl, lh, hh, out,
// w, h, mh, mv, preshift, ll_stride, band_stride; offsets and strides in
// elements), grouped by plane, each plane's levels in order; `chains`:
// device array of nchains + 1 int64 row indices, plane b's rows from
// chains[b] to chains[b + 1]. Every row must be a level of 1 to 2^31 - 1
// samples on each side with w < 8 or h < 8, parities and flags 0 or 1,
// preshift only in mode 1, the first row of a plane reading its LL from
// `in` (ll_out 0): ops/dwt_cuda.LiftPlan builds and checks the table on
// the host. `in` and `out` must not overlap. mode: 0 = 5/3, 1 = integer
// 9/7, 2 = float 9/7 (int32 or float32 samples). One launch on `stream`,
// no synchronisation; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode or no plane.
extern "C" int dwt_small_launch(const int64_t* table, const int64_t* chains,
                                int nchains, const void* in, void* out,
                                int mode, void* stream) {
  if (nchains < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      small_levels<Lift53><<<nchains, kThreads, 0, s>>>(table, chains, in,
                                                        out);
      break;
    case 1:
      small_levels<Lift97i><<<nchains, kThreads, 0, s>>>(table, chains, in,
                                                         out);
      break;
    default:
      small_levels<Lift97f><<<nchains, kThreads, 0, s>>>(table, chains, in,
                                                         out);
      break;
  }
  return (int)cudaGetLastError();
}
