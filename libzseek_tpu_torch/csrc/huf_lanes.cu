// Huffman lane decoder of the lane decode route.
//
// Replaces two XLA while_loops of libzseek_tpu/ops/zstd_decode.py (not
// TPU kernels): huf_decode_lanes (:401), one lane per Huffman stream from
// its sentinel, and huf_decode_anchored (:578), one lane per 512-symbol
// chunk from the Writer's anchor bit positions (format/hints.py).  As
// torch ops each of their steps would be a dozen tiny launches and a host
// sync (the any(t < n) condition), so the walk is one kernel.
//
// One thread per lane: it walks its stream backward, peeking 12 bits into
// its table of dtabs (T, 4096) int32 (nb << 8 | sym) and writing one
// symbol a step to its row of out (L, cap).  ok = the whole stream was
// consumed (exact, pass A) or the walk stayed at or above bit 0 (pass A').
//
// Bound: a chain of two dependent loads (window, table entry) per symbol,
// so a lane is latency-bound; the tables are read through L1 (__ldg), not
// staged in shared memory, since a block's lanes may use different
// tables.  Parallelism comes from the number of lanes: thousands in the
// anchored pass, one per stream in the plain one.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_bits.cuh"

namespace {

constexpr int HUF_PEEK = 12;

__global__ void huf_lanes_kernel(const uint8_t* __restrict__ bank, int SB,
                                 int NS, const int* __restrict__ sid,
                                 const int* __restrict__ bits,
                                 const int* __restrict__ n,
                                 const int* __restrict__ tid,
                                 const int* __restrict__ dtabs, int T, int L,
                                 int cap, int exact,
                                 uint8_t* __restrict__ out,
                                 uint8_t* __restrict__ ok) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int s = min(max(sid[l], 0), NS - 1);
  const uint8_t* row = bank + (size_t)s * SB;
  const long long last = (long long)T * (1 << HUF_PEEK) - 1;
  const long long tbase = (long long)tid[l] << HUF_PEEK;
  uint8_t* o = out + (size_t)l * cap;
  int pos = bits[l];
  const int cnt = min(n[l], cap);
  for (int t = 0; t < cnt; ++t) {
    const int v = (int)lanebits::read_at(row, SB, pos - HUF_PEEK, HUF_PEEK);
    long long k = tbase + v;
    k = k < 0 ? 0 : (k > last ? last : k);
    const int e = __ldg(dtabs + k);
    o[t] = (uint8_t)(e & 255);
    pos -= e >> 8;
  }
  ok[l] = exact ? (pos == 0) : (pos >= 0);
}

}  // namespace

extern "C" int zk_huf_lanes(const void* bank, const void* sid,
                            const void* bits, const void* n, const void* tid,
                            const void* dtabs, int SB, int NS, int T, int L,
                            int cap, int exact, void* out, void* ok,
                            void* stream) {
  const int threads = 128;
  huf_lanes_kernel<<<(L + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)bank, SB, NS, (const int*)sid, (const int*)bits,
      (const int*)n, (const int*)tid, (const int*)dtabs, T, L, cap, exact,
      (uint8_t*)out, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
