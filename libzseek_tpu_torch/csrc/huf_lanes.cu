// Huffman lane decoder of the lane decode route.
//
// Replaces two XLA while_loops of libzseek_tpu/ops/zstd_decode.py (not
// TPU kernels): huf_decode_lanes (:401), one lane per Huffman stream from
// its sentinel, and huf_decode_anchored (:578), one lane per 512-symbol
// chunk from the Writer's anchor bit positions (format/hints.py).  As
// torch ops each of their steps would be a dozen tiny launches and a host
// sync (the any(t < n) condition), so the walk is one kernel.
//
// Each lane walks its stream backward, peeking 12 bits into its table of
// dtabs (T, 4096) int32 (nb << 8 | sym) and emitting one symbol a step
// into its row of out (L, cap).  ok = the whole stream was consumed
// (exact, pass A) or the walk stayed at or above bit 0 (pass A').
//
// Bound: a chain of dependent loads per symbol (the stream's bits, then
// the table entry), so a walk is latency-bound and the card needs many
// walks at once.
//
// Pass A' (anchored, exact = 0): thousands of chunk lanes of <= 512
// symbols, a thread a lane (huf_anchored_kernel).  Read a load at a time
// (a peek as two __ldg of stream words, then its entry) a symbol takes
// ~500 cycles, two thirds of them the peek (each lane's cold lines from
// L2, and a warp waits for its slowest lane).  The route
// emits a stream's chunks contiguously and a block's streams share one
// table, so a block of ANCHOR_THREADS lanes stages the tables of its
// first and last lanes as uint16 (sym | nb << 8) in shared memory while
// each lane prefetches its stretch of the stream into L1.  Then every
// lane reloads four stream words once every GROUP symbols, at the same
// step as the warp's other lanes, and peeks the GROUP symbols out of
// them in registers, storing four symbols to a word where it owns the
// word.  A lane whose table is not staged (or holds an nb outside [0,
// GROUP_NB], which a group's window cannot serve), or that starts past
// its row's end, walks a symbol a step through read_at and __ldg: the
// same symbols and verdict, slower.
//
// Pass A (plain, exact = 1): one stream a lane, ~8-32k symbols each, so
// one thread a stream would leave the card idle (~500 cycles a symbol
// walked from L2: a window load and a table load).  So one block a
// stream (huf_plain_kernel), its table staged in shared memory as
// uint16 (sym | nb << 8) and each thread walking one piece of the
// stream's bits from a 64-bit window in registers (one refill of two
// aligned words every ~6 symbols).  Huffman codes self-synchronise
// (Weissenberger and Schmidt, "Massively Parallel Huffman Decoding on
// GPUs", ICPP 2018): the positions in (0, bits] are cut into np pieces
// (np = ceil(bits / PIECE_MIN_BITS), at most PIECES); piece j's thread
// walks from its top, a guessed code boundary, to its exit (the first
// position at or below the piece's bottom), recording its first RECORD
// positions; then in rounds each piece whose entry (the exit of the
// piece above) differs from the one it holds walks from the new entry
// until it meets a recorded position (from there the walks agree, so
// only its count changes) or else walks the whole piece again, until no
// entry changes.  A block scan of the counts places each piece's
// symbols; each thread walks its piece once more to emit them, four to a
// word store where it owns the word.  At positions <= 0 the peek is 0
// (bits below 0 read as zeros), so past the last exit the walk repeats
// table entry 0: the tail's symbols and final position are closed form.
// The verdict is the serial walk's: the final position after cnt
// symbols must be 0.  A table with an nb outside [1, 32], or bits past
// the row's end, takes the serial walk on thread 0.  The
// numpy mirror is testing/huf_mirror.py.  Static shared memory only.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_bits.cuh"

namespace {

constexpr int HUF_PEEK = 12;

// --- pass A: a block a stream, pieces that self-synchronise ---

constexpr int PIECES = 128;          // threads (pieces) a block
constexpr int RECORD = 32;           // positions a piece records
constexpr int PIECE_MIN_BITS = 512;  // the least bits a piece

// the stream's bits [base, base + 64) in registers, base a multiple of
// 32 (zeros past the row's end), refilled when a peek would leave it
struct Window {
  const uint32_t* w;
  int nw;          // words in the row
  int base;
  uint64_t bits;

  __device__ __forceinline__ void fill(int q) {
    base = max(0, ((q - 33) >> 5) << 5);   // base <= q - 33, base >= q - 64
    const int wi = base >> 5;
    const uint32_t lo = wi < nw ? __ldg(w + wi) : 0u;
    const uint32_t hi = wi + 1 < nw ? __ldg(w + wi + 1) : 0u;
    bits = (uint64_t)lo | ((uint64_t)hi << 32);
  }

  // the 12 bits below position q >= 1 (read_at(q - 12, 12))
  __device__ __forceinline__ int peek(int q) {
    if ((q - HUF_PEEK < base && base > 0) || q > base + 64) fill(q);
    if (q >= HUF_PEEK) return (int)(bits >> (q - HUF_PEEK - base)) & 0xFFF;
    return (int)((uint32_t)bits << (HUF_PEEK - q)) & 0xFFF;   // base 0
  }
};

// positions from q while q > lo: the count and the exit; the first
// RECORD positions go to rec[k][j]
__device__ __forceinline__ int walk(Window& win, const uint16_t* tab, int q,
                                    int lo, int (*rec)[PIECES], int j,
                                    int& exit) {
  int c = 0;
  while (q > lo) {
    if (c < RECORD) rec[c][j] = q;
    q -= tab[win.peek(q)] >> 8;
    ++c;
  }
  exit = q;
  return c;
}

__global__ void __launch_bounds__(PIECES)
huf_plain_kernel(const uint8_t* __restrict__ bank, int SB, int NS,
                 const int* __restrict__ sid, const int* __restrict__ bits,
                 const int* __restrict__ n, const int* __restrict__ tid,
                 const int* __restrict__ dtabs, int T, int cap,
                 uint8_t* __restrict__ out, uint8_t* __restrict__ ok) {
  __shared__ uint16_t tab[1 << HUF_PEEK];
  __shared__ int rec[RECORD][PIECES];
  __shared__ int xs[PIECES];
  __shared__ int warp_sum[PIECES / 32];
  __shared__ int fin;
  const int l = blockIdx.x;
  const int j = threadIdx.x;
  const int s = min(max(sid[l], 0), NS - 1);
  const uint8_t* row = bank + (size_t)s * SB;
  const long long last = (long long)T * (1 << HUF_PEEK) - 1;
  const long long tbase = (long long)tid[l] << HUF_PEEK;
  const int b0 = bits[l];
  const int cnt = max(min(n[l], cap), 0);
  uint8_t* o = out + (size_t)l * cap;
  bool bad = j == 0 && b0 > 8 * SB;
  for (int v = j; v < (1 << HUF_PEEK); v += PIECES) {
    long long k = tbase + v;
    k = k < 0 ? 0 : (k > last ? last : k);
    const int e = __ldg(dtabs + k);
    const int nb = e >> 8;
    bad |= nb < 1 || nb > 32;
    tab[v] = (uint16_t)(((nb & 63) << 8) | (e & 255));
  }
  if (__syncthreads_or(bad)) {
    // the serial walk, one symbol a step
    if (j == 0) {
      int pos = b0;
      for (int t = 0; t < cnt; ++t) {
        const int v = (int)lanebits::read_at(row, SB, pos - HUF_PEEK,
                                             HUF_PEEK);
        long long k = tbase + v;
        k = k < 0 ? 0 : (k > last ? last : k);
        const int e = __ldg(dtabs + k);
        o[t] = (uint8_t)(e & 255);
        pos -= e >> 8;
      }
      ok[l] = pos == 0;
    }
    return;
  }
  if (cnt == 0) {
    if (j == 0) ok[l] = b0 == 0;
    return;
  }
  const int np = b0 > 0 ? min(PIECES, (b0 + PIECE_MIN_BITS - 1) /
                                          PIECE_MIN_BITS) : 0;
  const int w = np ? (b0 + np - 1) / np : 0;
  const bool active = j < np;
  const int lo = max(b0 - (j + 1) * w, 0);
  Window win{reinterpret_cast<const uint32_t*>(row), SB >> 2, 0, 0};
  win.base = 1 << 30;   // empty: the first peek fills
  int entry = b0 - j * w, x = 0, c_walk = 0, count = 0;
  if (active) {
    c_walk = walk(win, tab, entry, lo, rec, j, x);
    count = c_walk;
  }
  // rounds: a piece takes the exit above it as its entry
  while (true) {
    if (active) xs[j] = x;
    __syncthreads();
    bool changed = false;
    if (active && j > 0 && xs[j - 1] != entry) {
      changed = true;
      const int t = xs[j - 1];
      const int rn = min(c_walk, RECORD);
      int q = t, i = 0, steps = 0, got = -1;
      while (q > lo) {
        while (i < rn && rec[i][j] > q) ++i;
        if (i == rn) break;
        if (rec[i][j] == q) {
          got = steps + c_walk - i;
          break;
        }
        q -= tab[win.peek(q)] >> 8;
        ++steps;
      }
      entry = t;
      if (got >= 0) {
        count = got;
      } else {
        c_walk = walk(win, tab, t, lo, rec, j, x);
        count = c_walk;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  // exclusive scan of the counts
  int incl = count;
  const int lane = j & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[j >> 5] = incl;
  if (j == 0) fin = b0;
  __syncthreads();
  int off = incl - count, S = 0;
#pragma unroll
  for (int k = 0; k < PIECES / 32; ++k) {
    const int ws = warp_sum[k];
    if (k < (j >> 5)) off += ws;
    S += ws;
  }
  // emit: the piece's symbols at [off, off + count), cut at cnt; a word
  // of out is stored whole where the piece owns all four of its bytes
  if (active && off < cnt) {
    const size_t g0 = (size_t)l * cap + off;     // out's flat byte index
    const int m = min(count, cnt - off);
    uint32_t word = 0;
    size_t wstart = g0;      // the first byte the word holds
    int q = entry;
    for (int k = 0; k < m; ++k) {
      const int e = tab[win.peek(q)];
      q -= e >> 8;
      const size_t g = g0 + k;
      word |= (uint32_t)(e & 255) << (8 * (g & 3));
      if ((g & 3) == 3 || k == m - 1) {
        if ((g & 3) == 3 && g - 3 >= g0) {
          *reinterpret_cast<uint32_t*>(out + (g - 3)) = word;
        } else {
          for (size_t b = wstart; b <= g; ++b)
            out[b] = (uint8_t)(word >> (8 * (b & 3)));
        }
        word = 0;
        wstart = g + 1;
      }
      if (off + k == cnt - 1) fin = q;
    }
  }
  // the tail past the last piece: table entry 0 repeated
  if (S < cnt) {
    const int e0 = tab[0];
    for (int t = S + j; t < cnt; t += PIECES) o[t] = (uint8_t)(e0 & 255);
    if (j == 0) fin = (np ? xs[np - 1] : b0) - (cnt - S) * (e0 >> 8);
  }
  __syncthreads();
  if (j == 0) ok[l] = fin == 0;
}

// --- pass A': a thread a chunk, the block's tables staged ---

constexpr int ANCHOR_THREADS = 128;   // chunk lanes a block
constexpr int GROUP = 8;              // symbols a window serves
constexpr int GROUP_NB = 12;          // the longest code a staged table holds
constexpr int GROUP_BITS = GROUP * GROUP_NB;   // 96: bits a group may read
constexpr int STAGE_UNROLL = 8;

// stage table t (clamped indices) as uint16 (sym | nb << 8) by the block's
// threads; true where an entry's nb lies outside [0, GROUP_NB]
__device__ __forceinline__ bool stage_table(uint16_t* tab, const int* dtabs,
                                            long long last, int t) {
  const long long tb = (long long)t << HUF_PEEK;
  bool bad = false;
  for (int v0 = threadIdx.x; v0 < (1 << HUF_PEEK);
       v0 += ANCHOR_THREADS * STAGE_UNROLL) {
    int e[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      long long j = tb + v0 + u * ANCHOR_THREADS;
      j = j < 0 ? 0 : (j > last ? last : j);
      e[u] = __ldg(dtabs + j);
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int nb = e[u] >> 8;
      bad |= nb < 0 || nb > GROUP_NB;
      tab[v0 + u * ANCHOR_THREADS] =
          (uint16_t)(((nb & 255) << 8) | (e[u] & 255));
    }
  }
  return bad;
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int nw,
                                            int i) {
  return (unsigned)i < (unsigned)nw ? __ldg(w + i) : 0u;
}

__global__ void __launch_bounds__(ANCHOR_THREADS)
huf_anchored_kernel(const uint8_t* __restrict__ bank, int SB, int NS,
                    const int* __restrict__ sid, const int* __restrict__ bits,
                    const int* __restrict__ n, const int* __restrict__ tid,
                    const int* __restrict__ dtabs, int T, int L, int cap,
                    uint8_t* __restrict__ out, uint8_t* __restrict__ ok) {
  __shared__ uint16_t tab[2][1 << HUF_PEEK];
  const int first = blockIdx.x * ANCHOR_THREADS;
  const int lastl = min(first + ANCHOR_THREADS, L) - 1;
  const int l = first + threadIdx.x;
  const int s = min(max(sid[min(l, lastl)], 0), NS - 1);
  const uint8_t* row = bank + (size_t)s * SB;
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
  const int nw = SB >> 2;
  int pos = bits[min(l, lastl)];
  const int cnt = min(n[min(l, lastl)], cap);
  // the lane's stretch of the stream into L1 while the tables stage
  if (l <= lastl && pos <= 8 * SB) {
    const int hi = min((pos >> 5) + 1, nw - 1);
    const int lo = max((pos - GROUP_NB * cnt - 128) >> 5, 0);
    for (int i = hi; i >= lo; i -= 32)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(rw + i));
  }
  const int t0 = tid[first], t1 = tid[lastl];
  const bool two = t1 != t0;
  const long long last = (long long)T * (1 << HUF_PEEK) - 1;
  const bool bad0 = stage_table(tab[0], dtabs, last, t0);
  const bool bad1 = two && stage_table(tab[1], dtabs, last, t1);
  const bool use0 = !__syncthreads_or(bad0);
  const bool use1 = two && !__syncthreads_or(bad1);
  if (l > lastl) return;
  const int me = tid[l];
  const uint16_t* tb = me == t0 && use0 ? tab[0]
                                        : (me == t1 && use1 ? tab[1] : nullptr);
  const size_t g0 = (size_t)l * cap;      // out's flat byte index
  if (tb == nullptr || pos > 8 * SB) {
    // a symbol a step through read_at and __ldg
    const long long tbase = (long long)me << HUF_PEEK;
    for (int t = 0; t < cnt; ++t) {
      const int v = (int)lanebits::read_at(row, SB, pos - HUF_PEEK, HUF_PEEK);
      long long k = tbase + v;
      k = k < 0 ? 0 : (k > last ? last : k);
      const int e = __ldg(dtabs + k);
      out[g0 + t] = (uint8_t)(e & 255);
      pos -= e >> 8;
    }
  } else {
    // GROUP symbols from the four words from floor32(pos - 97), the
    // stream's bits with zeros below bit 0 and past the row (read_at's
    // peeks, since pos <= 8 * SB and positions only fall)
    uint32_t word = 0;
    size_t wstart = g0;   // the first byte the word holds
    for (int t0g = 0; t0g < cnt; t0g += GROUP) {
      const int wi = (pos - GROUP_BITS - 1) >> 5;
      const int wb = wi << 5;
      const uint32_t w0 = word_at(rw, nw, wi), w1 = word_at(rw, nw, wi + 1),
                     w2 = word_at(rw, nw, wi + 2),
                     w3 = word_at(rw, nw, wi + 3);
      const int m = min(GROUP, cnt - t0g);
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        if (k < m) {
          const int o = pos - HUF_PEEK - wb;
          const int i = o >> 5;
          const uint32_t lo = i == 0 ? w0 : (i == 1 ? w1 : (i == 2 ? w2 : w3));
          const uint32_t hi = i == 0 ? w1 : (i == 1 ? w2 : (i == 2 ? w3 : 0u));
          const int e = tb[__funnelshift_r(lo, hi, o) & 0xFFF];
          pos -= e >> 8;
          const int t = t0g + k;
          const size_t g = g0 + t;
          word |= (uint32_t)(e & 255) << (8 * (g & 3));
          if ((g & 3) == 3 || t == cnt - 1) {
            if ((g & 3) == 3 && g - 3 >= g0) {
              *reinterpret_cast<uint32_t*>(out + (g - 3)) = word;
            } else {
              for (size_t q = wstart; q <= g; ++q)
                out[q] = (uint8_t)(word >> (8 * (q & 3)));
            }
            word = 0;
            wstart = g + 1;
          }
        }
      }
    }
  }
  ok[l] = pos >= 0;
}

}  // namespace

extern "C" int zk_huf_lanes(const void* bank, const void* sid,
                            const void* bits, const void* n, const void* tid,
                            const void* dtabs, int SB, int NS, int T, int L,
                            int cap, int exact, void* out, void* ok,
                            void* stream) {
  if (L <= 0) return (int)cudaGetLastError();
  if (exact) {
    huf_plain_kernel<<<L, PIECES, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bank, SB, NS, (const int*)sid, (const int*)bits,
        (const int*)n, (const int*)tid, (const int*)dtabs, T, cap,
        (uint8_t*)out, (uint8_t*)ok);
    return (int)cudaGetLastError();
  }
  huf_anchored_kernel<<<(L + ANCHOR_THREADS - 1) / ANCHOR_THREADS,
                        ANCHOR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bank, SB, NS, (const int*)sid, (const int*)bits,
      (const int*)n, (const int*)tid, (const int*)dtabs, T, L, cap,
      (uint8_t*)out, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
