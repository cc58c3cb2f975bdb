// The stores of the three write kernels (rct_writeframe.cu,
// ict_writeframe.cu, plane_writeframe.cu): each writes a plane's clipped
// samples, shifted left to the frame's precision, where a frame layout
// puts them. Sample (r, c) of a plane goes to out[dst + r*rs + c*cs]:
// rs is the row stride and cs the component stride of the frame plane it
// lands in (1 for planar formats and for the program's tile-component
// layout, the number of components for packed formats such as rgb48le).
//
// A block takes one row segment of up to kSeg samples of its plane (or of
// its three planes). Interleaved samples written one per thread leave
// gaps in every warp store (R, G and B each 2 bytes in 6), so the block
// stages its segment in shared memory in the frame's order first, then
// writes it out as one contiguous run: whole 16-byte words, with the
// run's ragged head and tail written a sample at a time. The run starts
// in shared memory at the same offset within a 16-byte word as in the
// output, so both sides of each word copy are aligned. Where a launch's
// planes interleave with planes of another launch (a fourth, alpha,
// component beside RCT), the samples are stored one by one.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace frame_store {

// How a launch stores its segments.
enum Mode : int {
  kScattered = 0,      // sample by sample, at out[dst + r*rs + c*cs]
  kRuns = 1,           // every plane's row segment is one run (cs == 1)
  kInterleaved = 2,    // the planes' samples interleave into one run
                       // (cs == planes, dst_k == dst_0 + k, one rs)
};

// Where a plane's samples go: (0, 0) at dst, row stride rs, component
// stride cs, left shift sh.
struct Dest {
  int64_t dst, rs;
  int cs, sh;
};

// A Dest from its four int64 values in a host table.
inline Dest dest_from(const int64_t* d) {
  return Dest{d[0], d[1], (int)d[2], (int)d[3]};
}

// Whether a dest is one the kernels take: every sample of an h x w plane
// inside out[0, size), a positive component stride, and a shift that
// keeps cbps-bit samples inside the output type's max_bits.
inline bool dest_ok(const Dest& d, int64_t h, int64_t w, int64_t size,
                    int cbps, int max_bits) {
  if (d.dst < 0 || d.rs < 0 || d.cs < 1 || d.sh < 0 ||
      cbps + d.sh > max_bits)
    return false;
  if (h == 0 || w == 0) return true;
  return d.dst + (h - 1) * d.rs + (w - 1) * (int64_t)d.cs < size;
}

// The launch's store mode for n planes of h x w samples at dests d.
inline int mode_of(const Dest* d, int n) {
  bool runs = true, inter = d[0].cs == n;
  for (int k = 0; k < n; ++k) {
    runs &= d[k].cs == 1;
    inter &= d[k].cs == n && d[k].rs == d[0].rs && d[k].dst == d[0].dst + k;
  }
  return runs ? kRuns : (inter && n > 1) ? kInterleaved : kScattered;
}

// Whether the planes' rows lie back to back in the output (or there is
// one row), so that each plane can be taken as one row of h*w samples.
inline bool flat(const Dest* d, int n, int64_t h, int64_t w) {
  bool ok = true;
  for (int k = 0; k < n; ++k) ok &= d[k].rs == w * d[k].cs;
  return ok || h == 1;
}

// The sample offset of p within its 16-byte word.
template <typename OutT>
__device__ __forceinline__ int word_offset(const OutT* p) {
  return (int)(((uintptr_t)p / sizeof(OutT)) & (16 / sizeof(OutT) - 1));
}

// The block copies a run of m samples, staged at st[a + j] for a =
// word_offset(g) (st 16-byte aligned), to g[j]: each whole 16-byte word
// of the run in one store, the samples of its ragged ends one by one.
template <typename OutT>
__device__ __forceinline__ void store_run(const OutT* __restrict__ st,
                                          OutT* __restrict__ g, int m) {
  constexpr int V = 16 / sizeof(OutT);
  const int a = word_offset(g), end = a + m;
  OutT* const base = g - a;                    // 16-byte aligned
  const int words = (end + V - 1) / V;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int lo = w * V;
    if (lo >= a && lo + V <= end) {
      *reinterpret_cast<uint4*>(base + lo) =
          *reinterpret_cast<const uint4*>(st + lo);
    } else {
      const int j1 = lo + V < end ? lo + V : end;
      for (int j = lo > a ? lo : a; j < j1; ++j) base[j] = st[j];
    }
  }
}

__device__ __forceinline__ int clip(int v, int maxval) {
  return min(max(v, 0), maxval);
}

}  // namespace frame_store
