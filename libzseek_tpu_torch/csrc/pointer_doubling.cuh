// Copy resolution by in-place pointer doubling, shared by the LZ4 decoder
// (csrc/lz4_decode.cu), K4's execute arm (csrc/decode.cu) and K6
// (csrc/exec_blocks.cu).
//
// Each output byte i of a segment holds in srcs[i] the index (within its
// segment) of the byte it copies, or -1 for a byte already written (a
// literal).  Every index points strictly backward (a match byte's source
// is folded back before the match start), so the chains end at literals.
// pd_round_kernel runs one round, srcs[i] <- srcs[srcs[i]] wherever that
// is not -1, in place (a thread may read a value another thread already
// advanced: it is an ancestor all the same); a round whose predecessor
// changed nothing returns at once.  After ceil(log2(longest chain))
// rounds every index names a literal, and pd_finish_kernel copies it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace pd {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int MAX_BLOCKS = 132 * 8;   // one wave of the H100: a round that
                                      // returns at once costs its launch

// grid (ceil(max lim / (THREADS * ITEMS)) up to MAX_BLOCKS, segments), each
// block striding over its segment's items by the grid's width: segment b is
// srcs[b * stride, b * stride + lim_b), lim_b = lims[b] (or lim0 when
// lims is null); changed[r] is set (once a block) when round r moved any
// index
__global__ void pd_round_kernel(int* __restrict__ srcs, long long stride,
                                const int* __restrict__ lims, int lim0,
                                int* changed, int r) {
  if (r > 0 && changed[r - 1] == 0) return;
  const int b = blockIdx.y;
  const int lim = lims ? lims[b] : lim0;
  int* fs = srcs + (size_t)b * stride;
  bool ch = false;
  for (int i0 = blockIdx.x * THREADS * ITEMS + threadIdx.x; i0 < lim;
       i0 += gridDim.x * THREADS * ITEMS) {
    for (int t = 0; t < ITEMS; ++t) {
      const int i = i0 + t * THREADS;
      if (i >= lim) break;
      const int s = fs[i];
      if (s < 0) continue;
      const int u = fs[s];
      if (u >= 0) {
        fs[i] = u;
        ch = true;
      }
    }
  }
  if (__syncthreads_or(ch) && threadIdx.x == 0) changed[r] = 1;
}

// the same grid: out[b * stride + i] = out[b * stride + srcs[...]] for
// every byte that copies
__global__ void pd_finish_kernel(const int* __restrict__ srcs,
                                 long long stride,
                                 const int* __restrict__ lims, int lim0,
                                 uint8_t* __restrict__ out) {
  const int b = blockIdx.y;
  const int lim = lims ? lims[b] : lim0;
  const int* fs = srcs + (size_t)b * stride;
  uint8_t* fo = out + (size_t)b * stride;
  for (int i0 = blockIdx.x * THREADS * ITEMS + threadIdx.x; i0 < lim;
       i0 += gridDim.x * THREADS * ITEMS) {
    for (int t = 0; t < ITEMS; ++t) {
      const int i = i0 + t * THREADS;
      if (i >= lim) break;
      const int s = fs[i];
      if (s >= 0) fo[i] = fo[s];
    }
  }
}

// rounds of pd_round_kernel then pd_finish_kernel on stream st; changed
// holds `rounds` zeroed ints
inline cudaError_t resolve(int* srcs, long long stride, const int* lims,
                           int lim0, int max_lim, int segments,
                           int* changed, int rounds, uint8_t* out,
                           cudaStream_t st) {
  const dim3 grid(
      min((max_lim + THREADS * ITEMS - 1) / (THREADS * ITEMS), MAX_BLOCKS),
      segments);
  if (grid.x == 0) return cudaGetLastError();
  for (int r = 0; r < rounds; ++r) {
    pd_round_kernel<<<grid, THREADS, 0, st>>>(srcs, stride, lims, lim0,
                                              changed, r);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  pd_finish_kernel<<<grid, THREADS, 0, st>>>(srcs, stride, lims, lim0, out);
  return cudaGetLastError();
}

}  // namespace pd
}  // namespace
