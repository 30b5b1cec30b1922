// Huffman literal placement shared by K2's literal half (csrc/entropy.cu)
// and K3 (csrc/place_literals.cu), and the block scans and bit packers both
// kernels use.
//
// A row's literal payload: 4 streams (1 with MODE_HUF1) of Huffman codes,
// each stream pushed LSB-first from its last literal to its first,
// byte-aligned back to back, one sentinel bit after each; a literal decode
// anchor (the bits of the stream from that literal on) at every 512th
// literal of a stream.  The two kernels differ only in how they find
// literal g's source byte, the Src policy: K2 through the sequences' run
// table (RunSrc), K3 through the parse's coverage bitmask (MaskSrc).  Each
// has `seek(g)` (a binary search of its table) and `next()` (a step).
//
// A stream is cut into chunks of CHUNK consecutive literals, THREADS threads
// of PER literals each.  Phase 1 (chunk_sums, one block a row, after the
// row's table): each chunk's code-length sum.  Phase 2 (place_chunk, one
// block a chunk): from the row's chunk sums, the stream sizes, the stream's
// byte base and the bits of its later chunks; a block scan of the threads'
// sums gives each thread the bits after its literals (streams run backward);
// each thread packs its codes in a 64-bit register and ORs them into the
// chunk's words staged in shared memory (shared atomics: two threads' ranges
// meet inside a word); the block then stores the words wholly inside the
// chunk's bit range and leaves its two edge words, which it shares with the
// neighbouring chunks, to a per-row fix-up (fixup_row), which ORs each edge
// word's parts and stores it.  No word is written by two writers and no
// global atomic is used.  The payload is zeroed before phase 1.  Raw literal
// rows (K2's MODE_RAWLIT) copy PER bytes a thread (raw_chunk).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace hp {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int PER = 16;
constexpr int CHUNK = THREADS * PER;   // a multiple of the anchor interval
constexpr int ANCHOR = 512;
// a chunk's words in shared memory: its codes (at most 15 bits each, the
// packed length field's limit), the sentinel and two part-words
constexpr int WIN = (CHUNK * 15 + 1) / 32 + 3;
static_assert(ANCHOR % PER == 0, "an anchor starts a thread's range");

// the chunk slots of a row of N bytes: stream 0 has up to N literals (one
// stream; up to ceil(N / 4) when the kernel takes only 4-stream rows, as
// K3 does), streams 1-3 up to ceil(N / 4); slot j < cps1 is (stream 0,
// chunk j), then cps4 slots for each of streams 1, 2 and 3
struct Slots {
  int cps1, cps4, nch;
};

__host__ __device__ inline Slots slots(int N, bool four_only) {
  Slots S;
  S.cps4 = (((N + 3) >> 2) + CHUNK - 1) / CHUNK;
  S.cps1 = four_only ? S.cps4 : (N + CHUNK - 1) / CHUNK;
  S.nch = S.cps1 + 3 * S.cps4;
  return S;
}

__device__ __forceinline__ int slot_of(const Slots& S, int s, int c) {
  return s == 0 ? c : S.cps1 + (s - 1) * S.cps4 + c;
}

__device__ __forceinline__ void slot_sc(const Slots& S, int j, int& s,
                                        int& c) {
  if (j < S.cps1) {
    s = 0;
    c = j;
  } else {
    j -= S.cps1;
    s = 1 + j / S.cps4;
    c = j % S.cps4;
  }
}

// the row's stream layout: lc literals, `per` a stream (lc with one stream)
struct Lay {
  int lc, per, one;
  __device__ int streams() const { return one ? 1 : 4; }
  __device__ int count(int k) const {
    return k > 0 && one ? 0 : max(0, min(per, lc - k * per));
  }
  __device__ int cps(const Slots& S) const { return one ? S.cps1 : S.cps4; }
};

__device__ __forceinline__ Lay lay(int lc, bool one) {
  Lay L;
  L.lc = lc;
  L.one = one;
  L.per = one ? lc : (lc + 3) >> 2;
  return L;
}

// ---- K2: the run table.  Run r < n holds literals [cum[r], cum[r + 1]) at
// input bytes from pos[r]; run n is the tail, its literals from pos[n].
struct RunSrc {
  const int* cum;
  const int* pos;
  const uint8_t* x;
  int n;
  int g, r, nxt, p;
  __device__ void at_run() {
    p = pos[r] + (g - cum[r]);
    nxt = r < n ? cum[r + 1] : INT_MAX;
  }
  __device__ void seek(int g0) {
    int lo = 0, hi = n;   // the last run starting at or before g0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cum[mid] <= g0) lo = mid;
      else hi = mid - 1;
    }
    g = g0;
    r = lo;
    at_run();
  }
  __device__ int byte() const { return x[p]; }
  __device__ void next() {
    ++g;
    ++p;
    while (g >= nxt) {   // past the run: skip the empty ones
      ++r;
      at_run();
    }
  }
};

// ---- K3: the coverage bitmask (bit i of word w = byte 32w + i, 1 = a
// literal), cut to the row's length, all zero on a row K3 does not take;
// rank[w] = the literals in the words before w.
struct MaskSrc {
  const int* rank;
  const uint32_t* mask;
  const uint8_t* x;
  int nw, len, on;
  int w;
  uint32_t bits;
  __device__ uint32_t word(int i) const {
    if (!on) return 0u;
    const int lo = i << 5;
    if (lo >= len) return 0u;
    const uint32_t m = mask[i];
    return lo + 32 <= len ? m : m & ((1u << (len - lo)) - 1u);
  }
  __device__ void seek(int g0) {
    int lo = 0, hi = nw - 1;   // the last word whose rank is <= g0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rank[mid] <= g0) lo = mid;
      else hi = mid - 1;
    }
    w = lo;
    bits = word(w);
    for (int k = g0 - rank[w]; k > 0; --k) bits &= bits - 1u;
  }
  __device__ int byte() const { return x[(w << 5) + __ffs(bits) - 1]; }
  __device__ void next() {
    bits &= bits - 1u;
    while (bits == 0u && w + 1 < nw) bits = word(++w);
  }
};

// ---- block scans (blockDim.x a multiple of 32, at most 1024; ws: 32 ints
// of shared memory; every thread of the block calls them)
__device__ __forceinline__ int warp_incl(int v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// inclusive prefix sum over the block's threads; *total: the block's sum
__device__ int block_incl(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_incl(v);
  if (lane == 31) ws[wid] = v;
  __syncthreads();
  if (wid == 0) ws[lane] = warp_incl(lane < nw ? ws[lane] : 0);
  __syncthreads();
  const int r = v + (wid > 0 ? ws[wid - 1] : 0);
  *total = ws[nw - 1];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int warp_incl_max(int v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, y);
  }
  return v;
}

// the largest v of the threads before this one (INT_MIN for thread 0)
__device__ int block_excl_max(int v, int* ws) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int inc = warp_incl_max(v);
  if (lane == 31) ws[wid] = inc;
  __syncthreads();
  if (wid == 0) ws[lane] = warp_incl_max(lane < nw ? ws[lane] : INT_MIN);
  __syncthreads();
  int r = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) r = INT_MIN;
  if (wid > 0) r = max(r, ws[wid - 1]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// ---- bit packers, codes LSB-first in a 64-bit register (v < 2^nbits,
// nbits <= 32).  WinOut ORs a thread's words into a shared-memory window
// starting at word wl; WordOut walks a stream from bit `from` and stores
// only the words [w0, w1), each whole (the words before w0 are another
// thread's).
struct WinOut {
  uint32_t* win;
  int wl, w, n;
  uint64_t acc;
  __device__ WinOut(uint32_t* win_, int wl_, int lo)
      : win(win_), wl(wl_), w(lo >> 5), n(lo & 31), acc(0) {}
  __device__ void emit() {
    const uint32_t v = (uint32_t)acc;
    if (v) atomicOr(win + (w - wl), v);
    ++w;
  }
  __device__ void put(uint32_t v, int nbits) {
    acc |= (uint64_t)v << n;
    n += nbits;
    if (n >= 32) {
      emit();
      acc >>= 32;
      n -= 32;
    }
  }
  __device__ void close() {
    if (n > 0) emit();
  }
};

struct WordOut {
  uint32_t* out;
  int w0, w1, w, n;
  uint64_t acc;
  __device__ WordOut(uint32_t* o, int from, int w0_, int w1_)
      : out(o), w0(w0_), w1(w1_), w(from >> 5), n(from & 31), acc(0) {}
  __device__ bool done() const { return w >= w1; }
  __device__ void emit() {
    if (w >= w0 && w < w1) out[w] = (uint32_t)acc;
    ++w;
  }
  __device__ void put(uint32_t v, int nbits) {
    acc |= (uint64_t)v << n;
    n += nbits;
    if (n >= 32) {
      emit();
      acc >>= 32;
      n -= 32;
    }
  }
  __device__ void close() {
    if (n > 0) emit();
  }
};

// ---- phase 1: each chunk's code-length sum into cbits (the row's nch
// slots; a slot of a stream past its literals gets 0).  All threads of the
// block (a multiple of THREADS) call it; codes: the row's 256 packed codes
// (value << 4 | length) in shared memory.
template <class Src>
__device__ void chunk_sums(Src src, const int* codes, const Lay& L,
                           const Slots& S, int* cbits, int* ws) {
  const int groups = blockDim.x / THREADS;
  const int grp = threadIdx.x / THREADS, t = threadIdx.x % THREADS;
  const int cps = L.cps(S);
  const int V = L.streams() * cps;
  for (int v0 = 0; v0 < V; v0 += groups) {
    const int v = v0 + grp;
    int sum = 0;
    if (v < V) {
      const int s = v / cps, c = v % cps;
      const int k0 = c * CHUNK + t * PER;
      const int k1 = min(k0 + PER, L.count(s));
      if (k0 < k1) {
        src.seek(s * L.per + k0);
        for (int k = k0; k < k1; ++k) {
          sum += codes[src.byte()] & 15;
          if (k + 1 < k1) src.next();
        }
      }
    }
    sum = warp_sum(sum);
    if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (t == 0 && v < V) {
      int tot = 0;
      for (int i = 0; i < THREADS / 32; ++i) tot += ws[grp * (THREADS / 32) + i];
      cbits[slot_of(S, v / cps, v % cps)] = tot;
    }
    __syncthreads();
  }
}

// ---- phase 2: chunk c of stream s (a block of THREADS threads).  cbits:
// the row's chunk sums; out: the row's words (zeroed); parts: the chunk's
// two edge words (word, value) for fixup_row (preset to -1); osz: the row's
// 4 stream sizes; lanch: the row's (4, LMAXA) anchors (preset to -1).
template <class Src>
__device__ void place_chunk(Src src, const int* codes, const Lay& L,
                            const Slots& S, int s, int c, const int* cbits,
                            uint32_t* out, int* parts, int* osz, int* lanch,
                            int LMAXA, int* ws) {
  __shared__ int bps_s[5];
  __shared__ uint32_t win[WIN];
  const int t = threadIdx.x;
  const int ns = L.streams(), cps = L.cps(S);
  const int cnt = L.count(s);
  if (s >= ns || c >= cps || (c > 0 && c * CHUNK >= cnt)) return;
  if (t < 32) {
    int b[4] = {0, 0, 0, 0}, later = 0;
    for (int i = t; i < ns * cps; i += 32) {
      const int ss = i / cps, cc = i % cps;
      const int v = cbits[slot_of(S, ss, cc)];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ss == k) b[k] += v;
      if (ss == s && cc > c) later += v;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = warp_sum(b[k]);
    later = warp_sum(later);
    if (t == 0) {
      for (int k = 0; k < 4; ++k) bps_s[k] = b[k];
      bps_s[4] = later;
    }
  }
  __syncthreads();
  int base = 0;
  for (int k = 0; k < s; ++k) base += (bps_s[k] + 8) >> 3;
  const int k0 = c * CHUNK + t * PER, k1 = min(k0 + PER, cnt);
  int p[PER];
  int sum = 0;
  if (k0 < k1) src.seek(s * L.per + k0);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    p[j] = 0;
    if (k0 + j < k1) {
      p[j] = codes[src.byte()];
      sum += p[j] & 15;
      if (k0 + j + 1 < k1) src.next();
    }
  }
  int total;
  const int incl = block_incl(sum, ws, &total);
  // the stream's bits after this thread's literals
  const int after = bps_s[4] + total - incl;
  if (k0 < k1 && k0 > 0 && (k0 & (ANCHOR - 1)) == 0 &&
      k0 / ANCHOR - 1 < LMAXA)
    lanch[s * LMAXA + k0 / ANCHOR - 1] = after + sum;
  // the chunk's bits [lo, hi), chunk 0 with the stream's sentinel on top
  const int lo = 8 * base + bps_s[4];
  const int hi = lo + total + (c == 0 ? 1 : 0);
  const int wl = lo >> 5, nw = hi > lo ? ((hi - 1) >> 5) - wl + 1 : 0;
  for (int i = t; i < nw; i += blockDim.x) win[i] = 0u;
  __syncthreads();
  WinOut o(win, wl, 8 * base + after);
#pragma unroll
  for (int j = PER - 1; j >= 0; --j)
    if (p[j] & 15) o.put((uint32_t)(p[j] >> 4), p[j] & 15);
  o.close();
  if (c == 0 && t == 0) {
    osz[s] = (bps_s[s] + 8) >> 3;
    atomicOr(win + ((hi - 1) >> 5) - wl, 1u << ((hi - 1) & 31));
  }
  __syncthreads();
  for (int i = t; i < nw; i += blockDim.x) {
    const int w = wl + i;
    if ((w << 5) >= lo && ((w + 1) << 5) <= hi) out[w] = win[i];
  }
  if (t == 0) {   // the edge words: the first, and the last if another
    const int wh = wl + nw - 1;
    const bool whole_l = (wl << 5) >= lo && ((wl + 1) << 5) <= hi;
    const bool whole_h = (wh << 5) >= lo && ((wh + 1) << 5) <= hi;
    if (nw > 0 && !whole_l) {
      parts[0] = wl;
      parts[1] = (int)win[0];
    }
    if (nw > 1 && !whole_h) {
      parts[2] = wh;
      parts[3] = (int)win[nw - 1];
    }
  }
}

// ---- the fix-up (a block a row, after phase 2): each edge word gets the
// OR of its parts (2 * nch (word, value) pairs, -1: none), stored once
__device__ void fixup_row(const int* parts, int nch, uint32_t* out) {
  const int M = 2 * nch;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int w = parts[2 * i];
    if (w < 0) continue;
    uint32_t v = 0u;
    bool first = true;
    for (int j = 0; j < M && first; ++j) {
      if (parts[2 * j] != w) continue;
      if (j < i) first = false;
      else v |= (uint32_t)parts[2 * j + 1];
    }
    if (first) out[w] = v;
  }
}

// ---- raw literals: chunk c copies literals [c * CHUNK, ...) of lc to the
// bytes of the same rank (the words past lc stay zero)
template <class Src>
__device__ void raw_chunk(Src src, int lc, int c, uint32_t* out) {
  const int k0 = c * CHUNK + threadIdx.x * PER, k1 = min(k0 + PER, lc);
  if (k0 >= k1) return;
  src.seek(k0);
  uint32_t w[PER / 4];
#pragma unroll
  for (int j = 0; j < PER / 4; ++j) w[j] = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (k0 + j < k1) {
      w[j >> 2] |= (uint32_t)src.byte() << (8 * (j & 3));
      if (k0 + j + 1 < k1) src.next();
    }
  }
#pragma unroll
  for (int j = 0; j < PER / 4; ++j)
    if (k0 + 4 * j < k1) out[(k0 >> 2) + j] = w[j];
}

}  // namespace hp
}  // namespace
