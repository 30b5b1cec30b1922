// greedy_select: the sort parser's greedy left-to-right coverage of each
// row's segment candidates.
//
// Replaces libzseek_tpu/ops/match.py greedy_select (:213), a lax.scan over
// the segments whose carry is each row's cover end c (not a Pallas kernel;
// in eager PyTorch it would be tens of thousands of dependent launches a
// batch).  Per row, for k = 0 .. nseg-1, with c starting at c0:
//
//   s = max(p[k], c)
//   ok = has[k] && e[k] - s >= min_match && s <= lengths - min_tail
//   sel[k] = ok; start[k] = s; lit_from[k] = c; if (ok) c = e[k]
//
// and c_final = c.  The plain version is ops/match.py greedy_select_plain.
//
// Bound: the walk is one dependent chain a row (c), so the card's memory
// rate is far away (4 bytes in and 9 bytes out a segment) and the time is
// one lane's latency per segment.  Design, simple first: one warp a row;
// the warp stages TILE segments of p, e and has in shared memory with
// coalesced loads, lane 0 walks the tile from shared memory and writes
// sel/start/lit_from back there, and the warp stores them coalesced.
// Static shared memory only (no per-launch attribute), so threads of the
// host may launch it at once.  Launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;    // rows a CUDA block
constexpr int TILE = 256;   // segments a warp stages at a time

__global__ void __launch_bounds__(32 * WARPS)
greedy_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ e,
              const uint8_t* __restrict__ has,
              const int32_t* __restrict__ lengths, int B, int nseg,
              int min_tail, int min_match, int c0,
              uint8_t* __restrict__ sel, int32_t* __restrict__ start,
              int32_t* __restrict__ lit_from,
              int32_t* __restrict__ c_final) {
  __shared__ int32_t s_p[WARPS][TILE];
  __shared__ int32_t s_e[WARPS][TILE];
  __shared__ int32_t s_start[WARPS][TILE];
  __shared__ int32_t s_lit[WARPS][TILE];
  __shared__ uint8_t s_flag[WARPS][TILE];   // has in, sel out
  const int w = threadIdx.y;
  const int lane = threadIdx.x;
  const int row = blockIdx.x * WARPS + w;
  if (row >= B) return;   // the whole warp; only __syncwarp below
  const size_t base = (size_t)row * nseg;
  const int tail = lengths[row] - min_tail;
  int c = c0;               // lane 0's cover end
  for (int t0 = 0; t0 < nseg; t0 += TILE) {
    const int n = min(TILE, nseg - t0);
    for (int i = lane; i < n; i += 32) {
      s_p[w][i] = p[base + t0 + i];
      s_e[w][i] = e[base + t0 + i];
      s_flag[w][i] = has[base + t0 + i];
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = max(s_p[w][i], c);
        const int ei = s_e[w][i];
        const bool ok = s_flag[w][i] && ei - s >= min_match && s <= tail;
        s_start[w][i] = s;
        s_lit[w][i] = c;
        s_flag[w][i] = ok;
        c = ok ? ei : c;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      sel[base + t0 + i] = s_flag[w][i];
      start[base + t0 + i] = s_start[w][i];
      lit_from[base + t0 + i] = s_lit[w][i];
    }
    __syncwarp();
  }
  if (lane == 0) c_final[row] = c;
}

}  // namespace

extern "C" int zk_greedy_select(const void* p, const void* e,
                                const void* has, const void* lengths, int B,
                                int nseg, int min_tail, int min_match, int c0,
                                void* sel, void* start, void* lit_from,
                                void* c_final, void* stream) {
  const dim3 block(32, WARPS);
  const dim3 grid((B + WARPS - 1) / WARPS);
  greedy_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p, (const int32_t*)e, (const uint8_t*)has,
      (const int32_t*)lengths, B, nseg, min_tail, min_match, c0,
      (uint8_t*)sel, (int32_t*)start, (int32_t*)lit_from,
      (int32_t*)c_final);
  return (int)cudaGetLastError();
}
