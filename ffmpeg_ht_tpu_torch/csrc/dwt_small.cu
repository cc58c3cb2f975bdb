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
// with every neighbour read from its mirror inside the line gives the
// reference's samples bit for bit. A step's neighbours are one sample
// away, so only a line's two ends reflect: position -1 reads 1 and n
// reads n - 2, with no modulo. A line of one sample is scaled instead (the
// reference's n = 1 rules: the 5/3 halves an odd sample, the 9/7
// multiplies by K / 2 or X).
//
// What bounds it on the H100: latency, not bytes or operations. A small
// level of a real plane holds a few hundred samples (the 8K frame's bottom
// tiles: 32 x 7 and 16 x 7), so a plane's levels are one chain of
// dependent steps: levels x (the row steps + the column steps) rounds
// through memory, plus one load of the bands and one store of each
// output. The design keeps that chain short and on chip:
//
//   Parity-parallel steps. A step updates every sample of one parity of
//     every line of the level at once, a thread a sample (the block's 256
//     threads loop over larger levels), then one barrier; a level takes
//     its row steps, then its column steps. Threads map to samples by
//     shifts and masks (a line's positions of one parity rounded up to a
//     power of two), no division.
//   Shared memory. A block takes a plane's small levels in order. Those
//     that fit kSharedBytes together (ops/dwt_cuda.LiftPlan decides,
//     staging a prefix of the plane's levels, and gives each its offset)
//     live in dynamic shared memory: the block first loads every staged
//     level's HL, LH and HH samples, and the first level's LL, to their
//     interleaved places in one wave, then lifts; a level's output is
//     written to device memory once, and into the next level's LL places
//     in shared memory in the same pass. A level that does not fit (the
//     5 x 70000 lines) runs the same steps on its output in device memory,
//     with the same barriers (a block sees its own writes after one):
//     one algorithm, two places for the samples. A level has no length
//     limit.
//   The table. A plane's rows sit at a fixed place in the device table
//     (kSmallInts int64 a row, maxchain rows a plane), so a block reads
//     them in one load; they live in static shared memory.
//
// A program's small levels take one launch, a block a plane, a
// programmatic dependent of the kernel before it; the plane's levels of
// at least 8 x 8 follow in csrc/dwt_lift.cu's launches on the same stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "dwt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmallInts = 15;           // csrc/dwt_lift.cu's 14 + the
                                         // shared-memory offset (-1: device
                                         // memory)
constexpr int kMaxChain = 33;            // small levels a plane
constexpr int kSharedBytes = 40960;      // dynamic shared memory a block
                                         // (with the rows, under 48 KB)

// ceil(log2(n)) for n >= 1
__device__ __forceinline__ int ceil_log2(int n) {
  return n > 1 ? 32 - __clz(n - 1) : 0;
}

// A level's samples into P (its output, h x w, in shared or device memory)
// from its bands, each at its interleaved place; the LL's only `with_ll`.
template <class Op>
__device__ __forceinline__ void gather(const int64_t* d,
                                       const typename Op::T* in,
                                       const typename Op::T* out,
                                       typename Op::T* P, bool with_ll) {
  using T = typename Op::T;
  const int w = (int)d[7], h = (int)d[8], mh = (int)d[9], mv = (int)d[10];
  const int nE = (w + 1 - mh) >> 1, nO = w - nE;
  const T* ll = (d[1] ? out : in) + d[2];
  const T* hl = in + d[3];
  const T* lh = in + d[4];
  const T* hh = in + d[5];
  const int64_t lls = d[12] ? d[12] : nE;
  const int64_t hls = d[13] ? d[13] : nO;
  const int64_t lhs = d[13] ? d[13] : nE;
  const int64_t hhs = d[13] ? d[13] : nO;
  const int lg = ceil_log2(w);
  for (int i = threadIdx.x; i < (h << lg); i += kThreads) {
    const int x = i & ((1 << lg) - 1), y = i >> lg;
    if (x >= w) continue;
    // absolute positions p, q: E (low) at even ones
    const int p = y + mv, q = x + mh;
    const bool lr = !(p & 1), lc = !(q & 1);
    const int64_t r = (p >> 1) - (lr ? mv : 0), c = (q >> 1) - (lc ? mh : 0);
    if (lr && lc && !with_ll) continue;
    const T* s = lr ? (lc ? ll + r * lls : hl + r * hls)
                    : (lc ? lh + r * lhs : hh + r * hhs);
    P[y * w + x] = s[c];
  }
}

// The level's row steps, then its column steps, in place on P (h x w), a
// barrier after each.
template <class Op>
__device__ __forceinline__ void lift(typename Op::T* P, int w, int h, int mh,
                                     int mv) {
  using T = typename Op::T;
  if (w == 1) {
    for (int y = threadIdx.x; y < h; y += kThreads)
      P[y] = Op::single(P[y], mh & 1);
    __syncthreads();
  } else {
    const int lg = ceil_log2((w + 1) >> 1);
#pragma unroll
    for (int st = 0; st < Op::kSteps; ++st) {
      // even steps update the even absolute positions, odd steps the odd
      const int o = (st ^ mh) & 1;
      for (int i = threadIdx.x; i < (h << lg); i += kThreads) {
        const int x = 2 * (i & ((1 << lg) - 1)) + o;
        if (x >= w) continue;
        T* row = P + (i >> lg) * w;
        const T a = row[x == 0 ? 1 : x - 1];
        const T b = row[x == w - 1 ? w - 2 : x + 1];
        row[x] = Op::step(st, row[x], a, b);
      }
      __syncthreads();
    }
  }
  if (h == 1) {
    for (int x = threadIdx.x; x < w; x += kThreads)
      P[x] = Op::single(P[x], mv & 1);
    __syncthreads();
  } else {
    const int lg = ceil_log2(w);
#pragma unroll
    for (int st = 0; st < Op::kSteps; ++st) {
      const int o = (st ^ mv) & 1;
      for (int i = threadIdx.x; i < (((h + 1) >> 1) << lg); i += kThreads) {
        const int x = i & ((1 << lg) - 1), y = 2 * (i >> lg) + o;
        if (x >= w || y >= h) continue;
        const T a = P[(y == 0 ? 1 : y - 1) * w + x];
        const T b = P[(y == h - 1 ? h - 2 : y + 1) * w + x];
        P[y * w + x] = Op::step(st, P[y * w + x], a, b);
      }
      __syncthreads();
    }
  }
}

// A block a plane: its small levels, rows [0, n) of its maxchain rows, in
// order.
template <class Op>
__global__ void __launch_bounds__(kThreads)
small_levels(const int64_t* __restrict__ table, int maxchain,
             const void* in_v, void* out_v) {
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t rows[kMaxChain * kSmallInts];
  T* S = reinterpret_cast<T*>(smem);
  const T* in = static_cast<const T*>(in_v);
  T* out = static_cast<T*>(out_v);
  // let the next launch (dwt_lift's first level) be scheduled now; read
  // nothing before the kernel before this one has finished
  asm volatile("griddepcontrol.launch_dependents;\n");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t* mine = table + (int64_t)blockIdx.x * maxchain * kSmallInts;
  for (int i = threadIdx.x; i < maxchain * kSmallInts; i += kThreads)
    rows[i] = mine[i];
  __syncthreads();
  int n = 0;                               // the plane's levels (w > 0)
  while (n < maxchain && rows[n * kSmallInts + 7] > 0) ++n;
  // every staged level's bands in one wave (a later level's LL comes from
  // the level before it)
  for (int k = 0; k < n && rows[k * kSmallInts + 14] >= 0; ++k) {
    const int64_t* d = rows + k * kSmallInts;
    gather<Op>(d, in, out, S + d[14], k == 0);
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const int64_t* d = rows + k * kSmallInts;
    const int w = (int)d[7], h = (int)d[8];
    T* dst = out + d[6];
    if (d[14] < 0) {                       // in device memory
      gather<Op>(d, in, out, dst, true);
      __syncthreads();
      lift<Op>(dst, w, h, (int)d[9], (int)d[10]);
      if (d[11])
        for (int i = threadIdx.x; i < w * h; i += kThreads)
          dst[i] = Op::preshift(dst[i]);
      __syncthreads();
      continue;
    }
    T* P = S + d[14];
    lift<Op>(P, w, h, (int)d[9], (int)d[10]);
    // the output, once; and the next staged level's LL
    const int64_t* nx = k + 1 < n && d[kSmallInts + 14] >= 0
                            ? d + kSmallInts : nullptr;
    T* N = nx ? S + nx[14] : nullptr;
    const int w2 = nx ? (int)nx[7] : 0, mh2 = nx ? (int)nx[9] : 0;
    const int mv2 = nx ? (int)nx[10] : 0;
    const int lg = ceil_log2(w);
    for (int i = threadIdx.x; i < (h << lg); i += kThreads) {
      const int x = i & ((1 << lg) - 1), y = i >> lg;
      if (x >= w) continue;
      const T v = P[y * w + x];
      dst[y * w + x] = d[11] ? Op::preshift(v) : v;
      if (N) N[(2 * y + mv2) * w2 + 2 * x + mh2] = v;
    }
    __syncthreads();
  }
}

template <class Op>
int launch(const int64_t* table, int nplanes, int maxchain, int smem,
           const void* in, void* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(nplanes);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, small_levels<Op>, table,
                                             maxchain, in, out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Plain C entry point (ctypes). `table`: device array of nplanes x maxchain
// rows of kSmallInts int64 values (csrc/dwt_lift.cu's row: level, ll_out,
// ll, hl, lh, hh, out, w, h, mh, mv, preshift, ll_stride, band_stride;
// offsets and strides in elements; then the level's offset in the block's
// shared memory, in elements, or -1 for device memory): plane b's levels in
// order from row b * maxchain, the rest of its rows 0 (w = 0 ends a plane).
// Every level must have 1 to 2^31 - 1 samples on each side with w < 8 or
// h < 8, parities and flags 0 or 1, preshift only in mode 1, the first
// level of a plane reading its LL from `in` (ll_out 0), the staged levels
// a prefix of the plane's within `smem` bytes, and h << ceil(log2(w)) and
// w << ceil(log2(h)) under 2^31: ops/dwt_cuda.LiftPlan builds and checks
// the table on the host. `in` and `out` must not overlap. mode: 0 = 5/3,
// 1 = integer 9/7, 2 = float 9/7 (int32 or float32 samples). One launch on
// `stream`, no synchronisation; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode, no plane, a chain longer than
// kMaxChain or more than kSharedBytes of shared memory.
extern "C" int dwt_small_launch(const int64_t* table, int nplanes,
                                int maxchain, int smem, const void* in,
                                void* out, int mode, void* stream) {
  if (nplanes < 1 || maxchain < 1 || maxchain > kMaxChain || smem < 0
      || smem > kSharedBytes || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch<Lift53>(table, nplanes, maxchain, smem, in, out, s);
    case 1:
      return launch<Lift97i>(table, nplanes, maxchain, smem, in, out, s);
    default:
      return launch<Lift97f>(table, nplanes, maxchain, smem, in, out, s);
  }
}
