// Dequant + scatter of every bucket of the v2 device program into one flat
// coefficient buffer, with the sparse prefill and the zeros of the
// codeblocks that no lane decodes.
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
// What bounds it on the H100: device-memory bytes. The real samples' mu is
// read once (4 B a sample) and the flat buffer written once (4 B a
// sample); the c4 batch (16.8 M samples) is ~0.040 ms at 3.35 TB/s, and a
// few integer operations a sample are far below the card's rates. So each
// sample is written once, in wide rows, with many loads in flight:
//
//   Coverage, not a memset. Almost every sample of a v2 program belongs
//     to a codeblock that a device lane decodes; only the codeblocks that
//     code no pass on the device (none at all, or decoded on the host
//     into the prefill) need zeros. Which ones those are follows this
//     call's lanes, so the lane pass marks what it writes in a bitmap of
//     one bit a sample (1/32 of the buffer, cleared by a memset of its own
//     ~2 MB on the c4 batch): a row's words that it covers whole are
//     stored, the two at its ends OR-ed in atomically (a neighbouring
//     codeblock may share them). The BucketProgram's key (the bucket
//     shapes and the planes) does not fix the codeblock partition, so the
//     bitmap is taken from the lanes rather than from a cached grid.
//   Order: the lanes, then the zeros, then the prefill. The zero pass,
//     a thread four bitmap words, writes 0 to each sample whose bit is clear
//     (16-byte stores for a word clear of lanes), out[total] included,
//     and the prefill writes an entry only where no lane did, so a lane
//     sample wins over a prefill entry at the same index, as in the plain
//     version. Pad lanes (dest < 0), raster samples outside the codeblock
//     and the prefill's pads (index total) are written nowhere. The three
//     launches follow one another on one stream, each a programmatic
//     dependent of the one before (griddepcontrol.wait before it reads
//     anything), so the next grid is scheduled while one drains.
//   The lane pass. A warp takes a task: kUnroll groups of rows of one
//     lane, each group as many rows as 32 threads cover at 4 samples a
//     thread (two rows of a 64-wide codeblock, four of a 32-wide one);
//     it issues the task's 16-byte loads of mu (a lane's raster is
//     contiguous, so its rows are 16-byte aligned when bw is a multiple
//     of 4) before its first store, and stores 16 bytes where the
//     destination is aligned and the four samples are inside the
//     codeblock, 4 bytes otherwise. The grid is the tasks of every bucket
//     of the launch, 8 warps a block; a warp finds its bucket by a binary
//     search over the buckets' first tasks and its lane with one
//     division, no per-sample division. The blocks are short-lived, so
//     what sets the bytes in flight is how many warps an SM holds: the
//     registers are capped for four blocks an SM (64 a thread), which
//     tools/sweep_scatter.py found the fastest of the unroll and cap
//     pairs it tried. The buckets ride in the launch's parameters, 48 a
//     launch (80 bytes each, within the classic 4 KB), so nothing is
//     uploaded per call; the bitmap is scratch the wrapper allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

// The lane pass's shape: the row groups of a warp task, and the blocks
// an SM must hold at once (which caps the registers a thread, and so sets
// the loads in flight); tools/sweep_scatter.py builds other values with
// -D and times them on the card
#ifndef SCATTER_UNROLL
#define SCATTER_UNROLL 4
#endif
#ifndef SCATTER_MIN_BLOCKS
#define SCATTER_MIN_BLOCKS 4
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = SCATTER_UNROLL;  // row groups a warp task
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
  int bh, bw, h, w;                      // raster, codeblock
  int tpl;                               // warp tasks a lane
  int task0;                             // the bucket's first task
};

struct Launch {
  Bucket b[kMaxBuckets];
  int nbuckets, ntasks;
};

// ceil(log2(n)) for n >= 1
__host__ __device__ __forceinline__ int ceil_log2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// The lanes of a row in a warp: 4-sample chunks a row, rounded up to a
// power of two, at most 32 (a longer row takes several passes of the warp)
__host__ __device__ __forceinline__ int row_lg(int w) {
  const int l = ceil_log2((w + 3) >> 2);
  return l < 5 ? l : 5;
}

// launched as a programmatic dependent of the kernel before it: let the
// next grid be scheduled now, and read nothing before this one's
// predecessor has finished and its writes are visible
__device__ __forceinline__ void dependent_start() {
  asm volatile("griddepcontrol.launch_dependents;\n");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int Mode>
__device__ __forceinline__ void put(int32_t* __restrict__ out, int64_t at,
                                    int x, int w, int64_t total, int4 v,
                                    int magb, int istep, int s97, float fs,
                                    int no_istep) {
  int4 c;
  c.x = dequant<Mode>(v.x, magb, istep, s97, fs, no_istep);
  c.y = dequant<Mode>(v.y, magb, istep, s97, fs, no_istep);
  c.z = dequant<Mode>(v.z, magb, istep, s97, fs, no_istep);
  c.w = dequant<Mode>(v.w, magb, istep, s97, fs, no_istep);
  if (!(at & 3) && x + 4 <= w && at + 4 <= total) {
    *reinterpret_cast<int4*>(out + at) = c;
    return;
  }
  const int32_t cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (x + k < w && at + k < total) out[at + k] = cs[k];
}

template <int Mode>
__global__ void __launch_bounds__(kThreads, SCATTER_MIN_BLOCKS)
scatter_lanes(const __grid_constant__ Launch L, int64_t total, int no_istep,
              int32_t* __restrict__ out, uint32_t* __restrict__ bits) {
  dependent_start();
  const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= L.ntasks) return;
  int lo = 0, hi = L.nbuckets - 1;       // the last bucket with task0 <= task
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.b[mid].task0 <= task) lo = mid; else hi = mid - 1;
  }
  const Bucket& B = L.b[lo];
  const int t = task - B.task0;
  const int lane = t / B.tpl;
  const int64_t dest = B.dest[lane];
  if (dest < 0) return;                                // a pad lane
  const int64_t stride = B.stride[lane];
  const int magb = B.magb[lane], istep = B.istep[lane];
  const int s97 = B.scale97[lane];
  const float fs = B.fscale[lane];
  const int lg = row_lg(B.w), cw = (B.w + 3) >> 2;
  const int rpw = 32 >> lg;                            // rows a group
  const int r = (threadIdx.x & 31) >> lg;
  const int c0 = threadIdx.x & ((1 << lg) - 1);
  const int y0 = (t - lane * B.tpl) * rpw * kUnroll + r;
  const int32_t* src = B.mu + (int64_t)lane * B.bh * B.bw;
  const bool vec = !(B.bw & 3);
  for (int c = c0; c < cw; c += 32) {
    const int x = 4 * c;
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int y = y0 + u * rpw;
      if (y >= B.h) continue;
      const int32_t* p = src + (int64_t)y * B.bw + x;
      if (vec) {
        v[u] = __ldg(reinterpret_cast<const int4*>(p));
      } else {
        v[u].x = p[0];
        v[u].y = x + 1 < B.w ? p[1] : 0;
        v[u].z = x + 2 < B.w ? p[2] : 0;
        v[u].w = x + 3 < B.w ? p[3] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int y = y0 + u * rpw;
      if (y >= B.h) continue;
      put<Mode>(out, dest + y * stride + x, x, B.w, total, v[u], magb,
                istep, s97, fs, no_istep);
    }
  }
  // the rows' coverage: word k of a row by its lane k (mod the row's
  // lanes); a word the row covers whole is stored, one it shares with a
  // neighbouring codeblock OR-ed in
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int y = y0 + u * rpw;
    if (y >= B.h) continue;
    const int64_t a0 = dest + y * stride;
    const int64_t a1 = a0 + B.w < total ? a0 + B.w : total;
    if (a0 >= a1) continue;
    const int64_t wa = a0 >> 5, nw = ((a1 - 1) >> 5) - wa + 1;
    for (int64_t k = c0; k < nw; k += 1 << lg) {
      const int64_t s = (wa + k) << 5;
      const int lo_bit = a0 > s ? (int)(a0 - s) : 0;
      const int hi_bit = a1 < s + 32 ? (int)(a1 - s) : 32;
      if (lo_bit == 0 && hi_bit == 32) {
        bits[wa + k] = 0xFFFFFFFFu;
      } else {
        const uint32_t m = (hi_bit == 32 ? 0xFFFFFFFFu
                                         : (1u << hi_bit) - 1u)
                           & ~((1u << lo_bit) - 1u);
        atomicOr(bits + wa + k, m);
      }
    }
  }
}

// 0 to each sample of bitmap word i that no lane wrote
__device__ __forceinline__ void zero_word(uint32_t b, int64_t i,
                                          int64_t total,
                                          int32_t* __restrict__ out) {
  if (b == 0xFFFFFFFFu) return;
  const int64_t s = i << 5;
  if (b == 0 && s + 32 <= total + 1) {
    int4* o = reinterpret_cast<int4*>(out + s);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = make_int4(0, 0, 0, 0);
    return;
  }
  for (int k = 0; k < 32 && s + k <= total; ++k)
    if (!((b >> k) & 1u)) out[s + k] = 0;
}

// A thread four bitmap words (one 16-byte load)
__global__ void __launch_bounds__(kThreads)
scatter_zeros(const uint32_t* __restrict__ bits, int64_t nwords,
              int64_t total, int32_t* __restrict__ out) {
  dependent_start();
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= nwords) return;
  if (i + 4 <= nwords) {
    const uint4 b = *reinterpret_cast<const uint4*>(bits + i);
    zero_word(b.x, i, total, out);
    zero_word(b.y, i + 1, total, out);
    zero_word(b.z, i + 2, total, out);
    zero_word(b.w, i + 3, total, out);
    return;
  }
  for (int64_t k = i; k < nwords; ++k) zero_word(bits[k], k, total, out);
}

// A thread a prefill entry: written where no lane wrote
__global__ void __launch_bounds__(kThreads)
scatter_prefill(const int32_t* __restrict__ pf_idx,
                const int32_t* __restrict__ pf_val, int64_t n_pf,
                int64_t total, const uint32_t* __restrict__ bits,
                int32_t* __restrict__ out) {
  dependent_start();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pf) return;
  const int64_t idx = pf_idx[i];
  if (idx < 0 || idx >= total) return;                 // a pad entry
  if ((bits[idx >> 5] >> (idx & 31)) & 1u) return;     // under a lane
  out[idx] = pf_val[i];
}

template <class... Params, class... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), int64_t blocks,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int Mode>
int launch_buckets(const int64_t* table, int nbuckets, int64_t total,
                   int no_istep, int32_t* out, uint32_t* bits,
                   cudaStream_t s, int* launches) {
  for (int b0 = 0; b0 < nbuckets; b0 += kMaxBuckets) {
    Launch L;
    L.nbuckets = 0;
    int64_t tasks = 0;
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
      B.bh = (int)d[8], B.bw = (int)d[9], B.h = (int)d[10], B.w = (int)d[11];
      const int rows = (32 >> row_lg(B.w)) * kUnroll;
      B.tpl = B.h > 0 ? (B.h + rows - 1) / rows : 0;
      B.task0 = (int)tasks;
      tasks += d[7] * B.tpl;
      if (tasks > INT32_MAX - kWarps) return (int)cudaErrorInvalidValue;
    }
    L.ntasks = (int)tasks;
    if (tasks > 0) {
      const cudaError_t err = launch_dependent(
          scatter_lanes<Mode>, (tasks + kWarps - 1) / kWarps, s, L, total,
          no_istep, out, bits);
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
// float32 bits in mode 2). out: total + 1 int32 or float32 samples, 16-byte
// aligned; bits: (total + 32) / 32 words of scratch, 16-byte aligned. mode:
// 0 reversible, 1 9/7 integer, 2 9/7 float. On `stream`, without
// synchronising: a memset of bits, the lane pass (one launch each
// kMaxBuckets buckets with warp tasks, counted in *launches), the zero pass
// and, when n_pf > 0, the prefill (these two ride on the call, as
// coef_mosaic's prefill does). Returns the first error that is not
// cudaSuccess (cudaErrorInvalidValue for an unknown mode, a bad size, or
// more than 2^31 - 1 warp tasks or raster samples a lane).
extern "C" int bucket_scatter_launch(const int64_t* table, int nbuckets,
                                     const void* pf_idx, const void* pf_val,
                                     int64_t n_pf, int64_t total, int mode,
                                     int no_istep, void* out, void* bits,
                                     void* stream, int* launches) {
  *launches = 0;
  if (nbuckets < 0 || n_pf < 0 || total < 0 || total > INT64_MAX / 2
      || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < nbuckets; ++b) {
    const int64_t* d = table + (int64_t)b * kBucketInts;
    if (d[7] < 0 || d[7] > INT32_MAX || d[8] < 1 || d[9] < 1 || d[10] < 0
        || d[11] < 0 || d[10] > d[8] || d[11] > d[9]
        || d[8] * d[9] > INT32_MAX)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = static_cast<int32_t*>(out);
  uint32_t* w = static_cast<uint32_t*>(bits);
  const int64_t nwords = (total + 32) >> 5;
  cudaError_t err = cudaMemsetAsync(w, 0, (size_t)nwords * 4, s);
  if (err != cudaSuccess) return (int)err;
  int rc;
  switch (mode) {
    case 0:
      rc = launch_buckets<0>(table, nbuckets, total, no_istep, o, w, s,
                             launches);
      break;
    case 1:
      rc = launch_buckets<1>(table, nbuckets, total, no_istep, o, w, s,
                             launches);
      break;
    default:
      rc = launch_buckets<2>(table, nbuckets, total, no_istep, o, w, s,
                             launches);
      break;
  }
  if (rc != 0) return rc;
  err = launch_dependent(scatter_zeros,
                         (nwords + 4 * kThreads - 1) / (4 * kThreads), s,
                         (const uint32_t*)w, nwords, total, o);
  if (err != cudaSuccess) return (int)err;
  if (n_pf > 0) {
    err = launch_dependent(scatter_prefill, (n_pf + kThreads - 1) / kThreads,
                           s, (const int32_t*)pf_idx, (const int32_t*)pf_val,
                           n_pf, total, (const uint32_t*)w, o);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
