// The band-direct inverse DWT (5/3, integer 9/7, float 9/7): every level
// of every plane of a program, one pass a level over 2-D tiles.
//
// Replaces the XLA-op polyphase lifting of the JAX package's v3 program
// (ffmpeg_ht_tpu/ops/dwt_jax.py:330 dwt_decode_bands, itself the
// reference's sr_1d53 / sr_1d97_int / sr_1d97_float, jpeg2000dwt.c:
// 309-537). The plain PyTorch version is
// ffmpeg_ht_tpu_torch/ops/dwt_torch.py:dwt_level_ref; ops/dwt_cuda.py
// is the wrapper and holds the tile shape and halo passed in here.
//
// A job is one plane's level: the previous LL (nEv x nEh), HL (nEv x nOh),
// LH (nOv x nEh) and HH (nOv x nOh), each a band of rows at a row stride
// (the LL's own, one the other three share, or each band's own width: a
// band buffer's bands, or a flat quadrant pyramid's, where every band is
// a corner of the plane), and the output, the next
// LL (h x w, w = nEh + nOh, h = nEv + nOv), contiguous. The level covers the absolute
// positions [mh, mh + w) across and [mv, mv + h) down (mh, mv its origin
// parities); E (L) samples sit at even positions, O (H) samples at odd
// ones. Rows are lifted first (LL | HL, LH | HH), then columns, and the
// integer 9/7's final rounding shift follows on a plane's last level.
//
// What bounds it on the H100: device-memory bytes, a few operations a
// sample: each band sample read once and each output sample written once,
// 8 bytes a sample. The design moves about that:
//
//   Tiles. A block owns a tile of tile_rows x tile_cols output samples
//     and lifts it from a window that reaches `halo` samples past it on
//     every side (2 for the 5/3's two lifting steps, 4 for the 9/7's
//     four: a step spoils one more sample at a window's edge, so the
//     tile's own samples come out exact and equal, bit for bit, to what
//     a neighbouring tile recomputes in its halo). The window starts at
//     an even absolute position on both axes, so its even rows and
//     columns are E and its odd ones O, whatever the origin parities. A
//     level is read once plus the halos (14% more for the 5/3 at 32 x
//     252, 29% for the 9/7 at 32 x 248, mostly from L2: neighbouring
//     tiles run at about the same time) and written once: no
//     intermediate goes to device memory. A window is 40 rows: a tile
//     of 32 rows and the 9/7's halos, two blocks an SM. The tile height
//     was swept on the card up to those 32 rows
//     (tools/sweep_dwt_tiles.py): 32 was the fastest on c3 and c2.
//   Borders. A window position outside the level, within `halo` of it,
//     is loaded from its mirror inside the level (_poly_ranges' maps:
//     lifting commutes with the symmetric extension); farther positions
//     are not loaded. So a window wider than a short level (8 x 8 at odd
//     parities) never reads past the mirrored range, and the lifting
//     itself needs no border case.
//   Shared memory. A window row holds its 128 E samples, then, 16 words
//     on (so that E[p] and O[p] fall in banks 16 apart), its 128 O
//     samples: 272 words a row. The row pass gives a warp a window row,
//     4 (E, O) pairs a lane (pair l + 32 j), the neighbours from the next
//     lanes by shuffles, in registers; the column pass gives a thread a
//     tile column, the whole window column in registers, and stores the
//     tile's rows coalesced across the warp.
//   Copies. A persistent grid (as many blocks as fit on the card) walks
//     the level's tiles, every job's in one grid, so that c3's 3 planes
//     and c2's 12 fill the card alike. Each block keeps two windows: the
//     next tile's is loaded with 4-byte cp.async (band rows sit at any
//     offset, so no wider copy is aligned in general) while the current
//     one is lifted.
//   Levels. A program's levels are one launch each, in order on one
//     stream, each a programmatic dependent of the one before: its grid
//     is scheduled while the previous level runs and waits
//     (griddepcontrol.wait) before it reads anything. A small level
//     costs ~8 us, most of it one tile's load-lift-store chain.
//
// Levels under 8 in a dimension are csrc/dwt_small.cu's; a plane's small
// levels run before its first level here (ops/dwt_cuda.dwt_lift_program).
// Arithmetic (csrc/dwt_common.cuh) follows the plain version exactly, the
// float 9/7 in the order of _poly_sr97f.

#include <cstdint>
#include <cuda_runtime.h>

#include "dwt_common.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps; one window column each
constexpr int kPairs = 128;              // (E, O) pairs of a window row
constexpr int kOddOff = kPairs + 16;     // a window row's O half
constexpr int kRowWords = kOddOff + kPairs;
constexpr int kMaxJobs = 48;             // jobs a launch (3.8 KB of params,
                                         // within the classic 4 KB limit)
constexpr int kRows = 40;                // window rows: a 32-row tile and
                                         // the 9/7's halos
constexpr int kJobInts = 14;             // int64 values a job in the table
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Job {
  int64_t ll, hl, lh, hh, out;           // byte offsets from the bases
  int w, h, mh, mv;
  int preshift, ll_out;                  // ll_out: ll lies in `out`
  int tiles_x, tile0;                    // tile columns; first tile
  int ll_stride, band_stride;            // row strides in samples; 0: the
                                         // band's own width
};

struct Launch {
  Job j[kMaxJobs];
  int njobs, ntiles;
  int tile_rows, tile_cols, halo;        // halo in samples (even)
};

// Where a tile lies: its job's bands and output, and the absolute row
// and column of its window's first sample (both even).
struct Tile {
  const char* ll;
  const char* hl;
  const char* lh;
  const char* hh;
  char* out;
  int w, h, mh, mv, preshift;
  int a0, b0;
  int64_t lls, hls, lhs, hhs;            // the bands' row strides
};

__device__ __forceinline__ Tile locate(const Launch& L, int t,
                                       const char* in, char* out) {
  int jb = 0;
  while (jb + 1 < L.njobs && L.j[jb + 1].tile0 <= t) ++jb;
  const Job& J = L.j[jb];
  const int ti = t - J.tile0, ty = ti / J.tiles_x, tx = ti - ty * J.tiles_x;
  Tile g;
  g.ll = (J.ll_out ? out : in) + J.ll;
  g.hl = in + J.hl;
  g.lh = in + J.lh;
  g.hh = in + J.hh;
  g.out = out + J.out;
  g.w = J.w, g.h = J.h, g.mh = J.mh, g.mv = J.mv, g.preshift = J.preshift;
  const int nE = (J.w + 1 - J.mh) >> 1, nO = J.w - nE;
  g.lls = J.ll_stride ? J.ll_stride : nE;
  g.hls = J.band_stride ? J.band_stride : nO;
  g.lhs = J.band_stride ? J.band_stride : nE;
  g.hhs = J.band_stride ? J.band_stride : nO;
  g.a0 = ty * L.tile_rows - L.halo;
  g.b0 = tx * L.tile_cols - L.halo;
  return g;
}

// i mirrored into [lo, hi) (the symmetric extension; |i| reaches past the
// range by at most the halo, less than the 8 samples of a level)
__device__ __forceinline__ int mirror(int i, int lo, int hi) {
  return i < lo ? 2 * lo - i : i >= hi ? 2 * (hi - 1) - i : i;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}

// Start the copy of a tile's window into `buf`: a thread per window
// column (its E or O half, pair p), every row of the window that lies
// within `halo` of the level, mirrored into it.
template <class T>
__device__ void load_window(const Tile& g, const Launch& L, T* buf) {
  const int halo = L.halo, nrows = L.tile_rows + 2 * halo;
  const int odd = threadIdx.x / kPairs, p = threadIdx.x % kPairs;
  const int x = g.b0 + 2 * p + odd;
  if (x < g.mh - halo || x >= g.mh + g.w + halo) return;
  const int xm = mirror(x, g.mh, g.mh + g.w);
  const int col = odd ? ((xm - 1) >> 1) - (g.mh >> 1)
                      : (xm >> 1) - ((g.mh + 1) >> 1);
  const int64_t e_stride = odd ? g.hls : g.lls;
  const int64_t o_stride = odd ? g.hhs : g.lhs;
  const T* e_rows = reinterpret_cast<const T*>(odd ? g.hl : g.ll) + col;
  const T* o_rows = reinterpret_cast<const T*>(odd ? g.hh : g.lh) + col;
  T* dst = buf + (odd ? kOddOff : 0) + p;
  for (int r = 0; r < nrows; ++r) {
    const int y = g.a0 + r;
    if (y < g.mv - halo || y >= g.mv + g.h + halo) continue;
    const int ym = mirror(y, g.mv, g.mv + g.h);
    const T* src = (r & 1)
        ? o_rows + (((ym - 1) >> 1) - (g.mv >> 1)) * o_stride
        : e_rows + ((ym >> 1) - ((g.mv + 1) >> 1)) * e_stride;
    cp_async4(dst + r * kRowWords, src);
  }
}

// Every horizontal step on every window row, in place: a warp a row,
// pair l + 32 j in lane l. A window edge's neighbour is whatever the
// shuffle brings (the halo absorbs it).
template <class Op>
__device__ void lift_rows(typename Op::T* buf, int nrows) {
  using T = typename Op::T;
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < nrows; r += kThreads / 32) {
    T* row = buf + r * kRowWords;
    T e[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = row[lane + 32 * j];
      o[j] = row[kOddOff + lane + 32 * j];
    }
#pragma unroll
    for (int st = 0; st < Op::kSteps; ++st) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((st & 1) == 0) {        // E[p] from O[p - 1], O[p]
          const T a = __shfl_sync(kFull, (lane == 31 && j > 0)
                                  ? o[j > 0 ? j - 1 : 0] : o[j],
                                  (lane + 31) % 32);
          e[j] = Op::step(st, e[j], a, o[j]);
        } else {                    // O[p] from E[p], E[p + 1]
          const T b = __shfl_sync(kFull, (lane == 0 && j < 3)
                                  ? e[j < 3 ? j + 1 : 3] : e[j],
                                  (lane + 1) % 32);
          o[j] = Op::step(st, o[j], e[j], b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      row[lane + 32 * j] = e[j];
      row[kOddOff + lane + 32 * j] = o[j];
    }
  }
}

// Every vertical step on the tile's columns, a thread a column with the
// whole window column in registers; the tile's rows that lie in the
// level are stored (with the integer 9/7's shift on a last level).
template <class Op>
__device__ void lift_cols(const Tile& g, const Launch& L,
                          const typename Op::T* buf) {
  using T = typename Op::T;
  const int c = threadIdx.x, x = L.halo + c, X = g.b0 + x;
  if (c >= L.tile_cols || X < g.mh || X >= g.mh + g.w) return;
  const T* col = buf + ((x & 1) ? kOddOff : 0) + (x >> 1);
  T v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = col[r * kRowWords];
#pragma unroll
  for (int st = 0; st < Op::kSteps; ++st) {
#pragma unroll
    for (int r = 2 - (st & 1); r + 1 < kRows; r += 2)
      v[r] = Op::step(st, v[r], v[r - 1], v[r + 1]);
  }
  T* dst = reinterpret_cast<T*>(g.out) + (X - g.mh);
  const int lo = max(L.halo, g.mv - g.a0);
  const int hi = min(L.halo + L.tile_rows, g.mv + g.h - g.a0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < lo || r >= hi) continue;
    dst[(int64_t)(g.a0 + r - g.mv) * g.w] =
        g.preshift ? Op::preshift(v[r]) : v[r];
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads, 2)
lift_tiles(const __grid_constant__ Launch L, const char* in, char* out) {
  using T = typename Op::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem);
  constexpr int kBuf = kRows * kRowWords;
  // launched as a programmatic dependent of the previous level: let the
  // next level's grid be scheduled now, and read nothing before this
  // one's predecessor has finished and its writes are visible
  asm volatile("griddepcontrol.launch_dependents;\n");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  int t = blockIdx.x;
  if (t >= L.ntiles) return;
  load_window(locate(L, t, in, out), L, bufs);
  asm volatile("cp.async.commit_group;\n");
  for (int it = 0; t < L.ntiles; ++it) {
    const int next = t + gridDim.x;
    if (next < L.ntiles)
      load_window(locate(L, next, in, out), L, bufs + ((it + 1) & 1) * kBuf);
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    T* buf = bufs + (it & 1) * kBuf;
    lift_rows<Op>(buf, L.tile_rows + 2 * L.halo);
    __syncthreads();
    lift_cols<Op>(locate(L, t, in, out), L, buf);
    __syncthreads();
    t = next;
  }
}

// One launch: a persistent grid of as many blocks as fit on the current
// device (its attribute set and occupancy read once a device).
template <class Op>
int launch(const Launch& L, const char* in, char* out, cudaStream_t s) {
  static int grid[kMaxDevices];
  const size_t smem = 2 * (size_t)kRows * kRowWords * sizeof(typename Op::T);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(lift_tiles<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lift_tiles<Op>, kThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid[dev] = per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(L.ntiles < grid[dev] ? L.ntiles : grid[dev]);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lift_tiles<Op>, L, in, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (ctypes). `table`: host array of kJobInts int64
// values a job, sorted by level: level, ll_out, ll, hl, lh, hh, out, w,
// h, mh, mv, preshift, ll_stride, band_stride (the LL's row stride and
// the one HL, LH and HH share, in samples; 0 for a band's own width).
// ll, hl, lh, hh, out are element offsets (int32
// in modes 0 and 1, float32 in mode 2) from `in`, or from `out` for ll
// when ll_out is 1 (a previous level's output) and for out; w, h the
// output's width and height, mh, mv the level's origin parities,
// preshift 1 for the integer 9/7's final shift. mode: 0 = 5/3, 1 =
// integer 9/7, 2 = float 9/7. tile_rows x tile_cols: a tile's output
// samples (even; the window, tile_rows + 4 halo_pairs rows, at most
// kRows); halo_pairs: the (E, O) pairs a window reaches past its
// tile on each side. The levels run in order on `stream`, one launch a
// level (a level of more than kMaxJobs jobs takes one more launch each
// kMaxJobs), without synchronising; *launches gets the launches made.
// An output must not overlap an input of its level. Returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaErrorInvalidValue
// for an unknown mode, a level below 8 x 8 (the flat fallback's), a
// parity or flag other than 0 or 1, a preshift outside mode 1, a
// negative or over-int32 stride, levels
// out of order, or a tile shape and halo the window does not hold.
extern "C" int dwt_lift_launch(const int64_t* table, int njobs,
                               const void* in, void* out, int mode,
                               int tile_rows, int tile_cols, int halo_pairs,
                               void* stream, int* launches) {
  *launches = 0;
  const int halo = 2 * halo_pairs;
  if (njobs < 1 || mode < 0 || mode > 2 || halo_pairs < 0
      || tile_rows < 2 || (tile_rows & 1) || tile_cols < 2 || (tile_cols & 1)
      || tile_rows + 2 * halo > kRows || tile_cols + 2 * halo > 2 * kPairs)
    return (int)cudaErrorInvalidValue;
  const int64_t size = mode == 2 ? sizeof(float) : sizeof(int32_t);
  cudaStream_t s = (cudaStream_t)stream;
  int64_t prev_level = table[0];
  for (int j0 = 0; j0 < njobs;) {
    Launch L;
    L.tile_rows = tile_rows, L.tile_cols = tile_cols, L.halo = halo;
    L.njobs = 0;
    int64_t tiles = 0;
    const int64_t level = table[(int64_t)j0 * kJobInts];
    if (level < prev_level) return (int)cudaErrorInvalidValue;
    prev_level = level;
    for (; j0 < njobs && L.njobs < kMaxJobs
           && table[(int64_t)j0 * kJobInts] == level; ++j0) {
      const int64_t* d = table + (int64_t)j0 * kJobInts;
      if (d[7] < 8 || d[8] < 8 || d[7] > INT32_MAX / 2 || d[8] > INT32_MAX / 2
          || (d[1] & ~1) || (d[9] & ~1) || (d[10] & ~1) || (d[11] & ~1)
          || (d[11] && mode != 1) || d[12] < 0 || d[12] > INT32_MAX
          || d[13] < 0 || d[13] > INT32_MAX)
        return (int)cudaErrorInvalidValue;
      Job& J = L.j[L.njobs++];
      J.ll_out = (int)d[1];
      J.ll = d[2] * size, J.hl = d[3] * size, J.lh = d[4] * size;
      J.hh = d[5] * size, J.out = d[6] * size;
      J.w = (int)d[7], J.h = (int)d[8], J.mh = (int)d[9], J.mv = (int)d[10];
      J.preshift = (int)d[11];
      J.ll_stride = (int)d[12], J.band_stride = (int)d[13];
      J.tiles_x = (J.mh + J.w + tile_cols - 1) / tile_cols;
      J.tile0 = (int)tiles;
      tiles += (int64_t)J.tiles_x * ((J.mv + J.h + tile_rows - 1) / tile_rows);
      if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
    }
    L.ntiles = (int)tiles;
    const char* src = static_cast<const char*>(in);
    char* dst = static_cast<char*>(out);
    int err;
    switch (mode) {
      case 0: err = launch<Lift53>(L, src, dst, s); break;
      case 1: err = launch<Lift97i>(L, src, dst, s); break;
      default: err = launch<Lift97f>(L, src, dst, s); break;
    }
    if (err != 0) return err;
    ++*launches;
  }
  return 0;
}
