// K6: executes each block's decoded sequences into the frame's bytes.
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_match.py
// _exec_kernel_smem (:954; wrapper execute_blocks_smem :1066, pallas_call
// at :1090).  It takes the reference's rows (a block's literal bytes, its
// ll / ml / off sequences with a trailing literals-only pseudo-sequence,
// meta = (n_seq, content, d_off)) plus the chain layout of K4: the first
// row of each frame, rows frame-major, and each frame's byte offset in one
// flat uint8 output.
//
// The TPU runs its grid in order and keeps the frame's recent output in a
// 256 KiB ring that persists from block to block.  Here one warp per
// frame walks the frame's blocks in order and copies straight into the
// output at frame_off + d_off: literals from the block's row, matches
// from the output already written (no ring, no scratch).  A copy is
// spread over the warp's 32 lanes; where the source overlaps the
// destination (off < ml), an offset >= 32 copies in rounds of 32 bytes
// (each round reads bytes written by earlier rounds or before the
// match), and a shorter one repeats the off bytes before the match
// (dst[j] = dst[j % off - off]).
//
// Failure: ok = 0 for a block whose sequence leaves its literal row or
// its content, whose match reaches before the frame's first byte, or
// whose sequences do not end at d_off + content; the rest of its chain is
// skipped.  Every write stays inside the block's bytes of its frame.
//
// Bound: the bytes moved (literals and sequences in, the frame's bytes
// out) over the card's memory rate; one warp walks each frame's
// sequences in order, so this simple form is bound by that walk's
// latency, not by bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src,
                                          int n, int lane) {
  for (int j = lane; j < n; j += 32) dst[j] = src[j];
  __threadfence_block();
  __syncwarp();
}

// dst[j] = dst[j - off] for j < ml, overlapping copies repeating the last
// off bytes; every source byte lies before dst or in an earlier round
__device__ __forceinline__ void warp_match(uint8_t* dst, int off, int ml,
                                           int lane) {
  if (off >= ml) {
    for (int j = lane; j < ml; j += 32) dst[j] = dst[j - off];
  } else if (off >= 32) {
    for (int j0 = 0; j0 < ml; j0 += 32) {
      const int j = j0 + lane;
      if (j < ml) dst[j] = dst[j - off];
      __threadfence_block();
      __syncwarp();
    }
  } else {
    for (int j = lane; j < ml; j += 32) dst[j] = dst[j % off - off];
  }
  __threadfence_block();
  __syncwarp();
}

__global__ void exec_kernel(const uint8_t* __restrict__ lit, int LW,
                            const int* __restrict__ lla,
                            const int* __restrict__ mla,
                            const int* __restrict__ offa, int S,
                            const int* __restrict__ meta,
                            const int* __restrict__ chain,
                            const long long* __restrict__ frame_off,
                            uint8_t* out, int* __restrict__ ok) {
  const int f = blockIdx.x;
  const int lane = threadIdx.x;
  uint8_t* fout = out + frame_off[f];
  const long long fsize = frame_off[f + 1] - frame_off[f];
  bool failed = false;
  for (int r = chain[f]; r < chain[f + 1]; ++r) {
    if (failed) {
      if (lane == 0) ok[r] = 0;
      continue;
    }
    const int n_seq = meta[3 * r];
    const int content = meta[3 * r + 1];
    const int d_off = meta[3 * r + 2];
    const long long end = (long long)d_off + content;
    bool good = n_seq >= 0 && n_seq <= S && d_off >= 0 && content >= 0 &&
                end <= fsize;
    long long op = d_off;
    int lp = 0;
    const uint8_t* row = lit + (size_t)r * LW;
    const int* ll = lla + (size_t)r * S;
    const int* ml = mla + (size_t)r * S;
    const int* of = offa + (size_t)r * S;
    for (int j = 0; good && j < n_seq; ++j) {
      const int a = ll[j], m = ml[j], o = of[j];
      if (a < 0 || m < 0 || (long long)lp + a > LW ||
          op + a + m > end || (m > 0 && (o < 1 || o > op + a))) {
        good = false;
        break;
      }
      warp_copy(fout + op, row + lp, a, lane);
      warp_match(fout + op + a, o, m, lane);
      op += a + m;
      lp += a;
    }
    if (good && op != end) good = false;
    if (lane == 0) ok[r] = good ? 1 : 0;
    failed = !good;
  }
}

}  // namespace

extern "C" int zk_exec_blocks(const void* lit, const void* ll, const void* ml,
                              const void* off, const void* meta,
                              const void* chain, const void* frame_off,
                              int LW, int S, int F, void* out, void* ok,
                              void* stream) {
  exec_kernel<<<F, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)lit, LW, (const int*)ll, (const int*)ml,
      (const int*)off, S, (const int*)meta, (const int*)chain,
      (const long long*)frame_off, (uint8_t*)out, (int*)ok);
  return (int)cudaGetLastError();
}
