// One level of the band-direct inverse DWT (5/3, integer 9/7, float 9/7)
// for several planes in one launch pair.
//
// Replaces the XLA-op polyphase lifting of the JAX package's v3 program
// (ffmpeg_ht_tpu/ops/dwt_jax.py:330 dwt_decode_bands, itself the
// reference's sr_1d53 / sr_1d97_int / sr_1d97_float, jpeg2000dwt.c:
// 309-537). The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/dwt_torch.py:dwt_level_ref.
//
// A job is one plane's level: the previous LL (nEv x nEh), HL (nEv x nOh),
// LH (nOv x nEh) and HH (nOv x nOh), contiguous, and the output, the next
// LL (h x w, w = nEh + nOh, h = nEv + nOv). The line [m, m + n) of a level
// whose origin parity is m (mh across, mv down) holds its L samples at even
// positions: nE = (n + 1 - m) / 2 of them, E[k] = p[2k]; O[k] = p[2k + 1].
// The lifting runs on those polyphase halves. The symmetric extension is
// never stored: a neighbour outside the valid range is read from its
// mirror inside it (lifting commutes with the mirror), exactly as
// _poly_ranges / _mpad_pair do.
//
//   lift_rows: a block per output row. Row r < nEv takes (LL | HL) row r,
//     else (LH | HH) row r - nEv; its E and O halves go into shared memory,
//     every horizontal lifting step runs there with __syncthreads between
//     steps, and the row is stored interleaved into the output row r. The
//     output then holds the vertical E rows, then the O rows.
//   lift_cols: a block per strip of S adjacent columns (S a power of two,
//     at most 32, chosen so that h x S samples fit in 96 KB). The strip's
//     E and O rows go into shared memory, every vertical step runs there,
//     and the strip is stored back interleaved, in place: a block reads
//     and writes only its own columns. The integer 9/7's final rounding
//     shift (I_PRESHIFT) is applied here on the last level.
//
// Arithmetic follows the plain version exactly: int32 with wraparound,
// the Q16 products of the integer 9/7 in int64 where the reference widens
// them, and the float 9/7 in float32 with one rounding per operation in
// the order of _poly_sr97f, spelt __fadd_rn / __fsub_rn / __fmul_rn so
// that nvcc cannot contract a multiply and an add into one FMA.
//
// What bounds it on the H100: device-memory bytes (a few operations a
// sample). A single-pass design would read each band sample once and
// write each output sample once; this one is two passes, so it moves
// about twice that (the row pass writes and the column pass reads and
// writes the level once more). Up to 32 jobs (the planes of every frame
// of a program) share a launch pair: blockIdx.y is the job.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 32;
constexpr int kColBytes = 96 * 1024;     // shared memory of a column strip
constexpr int kMaxBytes = 227 * 1024;    // a block's shared memory

struct Job {
  const void* ll;
  const void* hl;
  const void* lh;
  const void* hh;
  void* out;
  int w, h, mh, mv, preshift;
};

struct Jobs {
  Job j[kMaxJobs];                       // 2 KB of kernel parameters
};

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
// O from E (odd steps); x is the sample updated, a and b its neighbours.
struct Lift53 {
  using T = int32_t;
  static constexpr int kSteps = 2;
  __device__ static T step(int st, T x, T a, T b) {
    if (st == 0) return wsub(x, wadd(wadd(a, b), 2) >> 2);
    return wadd(x, wadd(a, b) >> 1);
  }
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
  __device__ static T preshift(T v) { return v; }
};

// The lifting of one line, or of S lines side by side (sample k of line s
// at [k * S + s]), on its polyphase halves E (nE) and O (nO) in shared
// memory; the line is [i0, i1) with i1 - i0 = nE + nO.
template <class Op>
__device__ void lift(typename Op::T* E, typename Op::T* O, int nE, int nO,
                     int i0, int log2S) {
  using T = typename Op::T;
  const int S = 1 << log2S, i1 = i0 + nE + nO;
  const int e_lo = (i0 + 1) >> 1, o_lo = i0 >> 1;
  const int e_hi = e_lo + nE, o_hi = o_lo + nO;
  // polyphase index -> array row, mirrored into the valid range
  auto o_row = [&](int i) {
    return (i < o_lo ? i0 - i - 1 : i >= o_hi ? i1 - i - 2 : i) - o_lo;
  };
  auto e_row = [&](int i) {
    return (i < e_lo ? i0 - i : i >= e_hi ? i1 - 1 - i : i) - e_lo;
  };
  for (int st = 0; st < Op::kSteps; ++st) {
    if ((st & 1) == 0) {
      for (int idx = threadIdx.x; idx < (nE << log2S); idx += blockDim.x) {
        const int k = (idx >> log2S) + e_lo, s = idx & (S - 1);
        const T a = O[(o_row(k - 1) << log2S) + s];
        const T b = O[(o_row(k) << log2S) + s];
        E[idx] = Op::step(st, E[idx], a, b);
      }
    } else {
      for (int idx = threadIdx.x; idx < (nO << log2S); idx += blockDim.x) {
        const int k = (idx >> log2S) + o_lo, s = idx & (S - 1);
        const T a = E[(e_row(k) << log2S) + s];
        const T b = E[(e_row(k + 1) << log2S) + s];
        O[idx] = Op::step(st, O[idx], a, b);
      }
    }
    __syncthreads();
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads) lift_rows(Jobs jobs) {
  using T = typename Op::T;
  const Job jb = jobs.j[blockIdx.y];
  const int r = blockIdx.x;
  if (r >= jb.h) return;
  extern __shared__ __align__(16) unsigned char smem[];
  T* E = reinterpret_cast<T*>(smem);
  const int nEh = (jb.w + 1 - jb.mh) >> 1, nOh = jb.w - nEh;
  const int nEv = (jb.h + 1 - jb.mv) >> 1;
  T* O = E + nEh;
  const T* lo;
  const T* hi;
  if (r < nEv) {
    lo = (const T*)jb.ll + (int64_t)r * nEh;
    hi = (const T*)jb.hl + (int64_t)r * nOh;
  } else {
    lo = (const T*)jb.lh + (int64_t)(r - nEv) * nEh;
    hi = (const T*)jb.hh + (int64_t)(r - nEv) * nOh;
  }
  for (int k = threadIdx.x; k < nEh; k += blockDim.x) E[k] = lo[k];
  for (int k = threadIdx.x; k < nOh; k += blockDim.x) O[k] = hi[k];
  __syncthreads();
  lift<Op>(E, O, nEh, nOh, jb.mh, 0);
  T* dst = (T*)jb.out + (int64_t)r * jb.w;
  for (int j = threadIdx.x; j < jb.w; j += blockDim.x)
    dst[j] = (((j ^ jb.mh) & 1) == 0 ? E : O)[j >> 1];
}

template <class Op>
__global__ void __launch_bounds__(kThreads) lift_cols(Jobs jobs,
                                                      int log2S) {
  using T = typename Op::T;
  const Job jb = jobs.j[blockIdx.y];
  const int S = 1 << log2S, c0 = blockIdx.x << log2S;
  if (c0 >= jb.w) return;
  extern __shared__ __align__(16) unsigned char smem[];
  T* E = reinterpret_cast<T*>(smem);
  const int nEv = (jb.h + 1 - jb.mv) >> 1, nOv = jb.h - nEv;
  T* O = E + (nEv << log2S);
  T* buf = (T*)jb.out;
  const int n = jb.h << log2S;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx >> log2S, c = c0 + (idx & (S - 1));
    E[idx] = c < jb.w ? buf[(int64_t)r * jb.w + c] : T(0);
  }
  __syncthreads();
  lift<Op>(E, O, nEv, nOv, jb.mv, log2S);
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx >> log2S, s = idx & (S - 1), c = c0 + s;
    if (c >= jb.w) continue;
    T v = (((j ^ jb.mv) & 1) == 0 ? E : O)[((j >> 1) << log2S) + s];
    if (jb.preshift) v = Op::preshift(v);
    buf[(int64_t)j * jb.w + c] = v;
  }
}

template <class Op>
int launch(const Jobs& jobs, int n, cudaStream_t s) {
  using T = typename Op::T;
  int max_w = 0, max_h = 0;
  for (int i = 0; i < n; ++i) {
    max_w = jobs.j[i].w > max_w ? jobs.j[i].w : max_w;
    max_h = jobs.j[i].h > max_h ? jobs.j[i].h : max_h;
  }
  const int64_t row_bytes = (int64_t)max_w * sizeof(T);
  if (row_bytes > kMaxBytes || (int64_t)max_h * sizeof(T) > kMaxBytes)
    return (int)cudaErrorInvalidValue;
  int log2S = 5;
  while (log2S > 0 && ((int64_t)max_h << log2S) * (int64_t)sizeof(T)
                          > kColBytes)
    --log2S;
  while (log2S > 0 && (1 << (log2S - 1)) >= max_w) --log2S;
  const int64_t col_bytes = ((int64_t)max_h << log2S) * sizeof(T);
  // above 48 KB a block's dynamic shared memory needs the opt-in
  cudaError_t err = cudaSuccess;
  if (row_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(lift_rows<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)row_bytes);
  if (err == cudaSuccess && col_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(lift_cols<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)col_bytes);
  if (err != cudaSuccess) return (int)err;
  lift_rows<Op><<<dim3((unsigned)max_h, (unsigned)n), kThreads,
                  (size_t)row_bytes, s>>>(jobs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int strips = (max_w + (1 << log2S) - 1) >> log2S;
  lift_cols<Op><<<dim3((unsigned)strips, (unsigned)n), kThreads,
                  (size_t)col_bytes, s>>>(jobs, log2S);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (ctypes). ll, hl, lh, hh, out: host arrays of
// `njobs` device pointers (int32 planes in modes 0 and 1, float32 in mode
// 2); dims: host array of 5 ints a job: w, h, mh, mv, preshift (the
// output's width and height, the level's origin parities, and 1 to apply
// the integer 9/7's final shift). mode: 0 = 5/3, 1 = integer 9/7, 2 =
// float 9/7. The output must not overlap the inputs. One row launch and
// one column launch per kMaxJobs jobs, on `stream`, without
// synchronising; returns the first cudaGetLastError() that is not
// cudaSuccess, or cudaErrorInvalidValue for an unknown mode, njobs < 1, a
// level below 8 x 8 (the flat fallback's), a parity other than 0 or 1, a
// preshift outside mode 1, or a line too long for shared memory.
extern "C" int dwt_lift_launch(const void* const* ll, const void* const* hl,
                               const void* const* lh, const void* const* hh,
                               void* const* out, const int* dims, int njobs,
                               int mode, void* stream) {
  if (njobs < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  for (int j0 = 0; j0 < njobs; j0 += kMaxJobs) {
    const int n = njobs - j0 < kMaxJobs ? njobs - j0 : kMaxJobs;
    Jobs jobs;
    for (int i = 0; i < n; ++i) {
      const int* d = dims + 5 * (j0 + i);
      if (d[0] < 8 || d[1] < 8 || (d[2] & ~1) || (d[3] & ~1)
          || (d[4] & ~1) || (d[4] && mode != 1))
        return (int)cudaErrorInvalidValue;
      jobs.j[i] = Job{ll[j0 + i], hl[j0 + i], lh[j0 + i], hh[j0 + i],
                      out[j0 + i], d[0], d[1], d[2], d[3], d[4]};
    }
    int err;
    switch (mode) {
      case 0: err = launch<Lift53>(jobs, n, s); break;
      case 1: err = launch<Lift97i>(jobs, n, s); break;
      default: err = launch<Lift97f>(jobs, n, s); break;
    }
    if (err != 0) return err;
  }
  return 0;
}
