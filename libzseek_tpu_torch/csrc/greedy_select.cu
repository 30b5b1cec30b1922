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
// and c_final = c.  The plain version is ops/match.py greedy_select_plain,
// the round walk's numpy mirror testing/greedy_mirror.py.
//
// Bound: the walk is one dependent chain a row (c), so the card's memory
// rate is far away (9 bytes in and 9 out a segment) and the time is the
// chain's latency (~61 cycles a segment walked by one lane).  Design:
// warp rounds, and each row split over the warps of one CUDA block.
//
// Rounds.  ok(c) holds iff c <= T with T = min(e - min_match, tail) when
// has, e - p >= min_match and p <= tail (tail = lengths - min_tail), so
// it can only turn false as c grows (c never shrinks: a selected e is >=
// s + min_match >= c).  A round takes 32 consecutive segments, one a
// lane: a ballot under the round's c is a superset of its selections (a
// lane that fails now fails for every later c); its lowest lane j is
// selected, c = e[j] by a shuffle, j and the lanes below it are cleared
// and the mask is ANDed with a fresh ballot under the new c, until it is
// empty.  A lane's lit_from is the e of the highest selected lane below
// it (__clz of the selections below it), or the round's c.  That costs a
// step a selection, and the sort parser's repeats and zeros rows select
// almost every segment (each match reaches 4 bytes past the one before),
// so a second ballot marks the lanes that are selected right after the
// lane below them (tested under its e): from a selected lane, its run of
// such lanes is selected in one step.
//
// Chunks.  Each of the block's WARPS warps walks a chunk of the row from
// a guessed entry g (the end of the previous segment's candidate, else
// its own start; chunk 0 from c0, exact) and writes its outputs.  A
// chunk's walk depends on its entry only until its first selection kf:
// before it c is the entry, from it on c = e[kf], whatever the entry.
// So the walk from an entry c' agrees with the one from g from kf on iff
// kf is also c''s first selection: max(T before kf) < c' <= T[kf] (with
// no selection from g: max(T) < c', and then the exit is c').  The warp
// keeps those three numbers; then one thread resolves the true entries
// chunk after chunk by that test alone.  A chunk that fails it walks
// again from its true entry (the others wait), comparing each
// segment's c (its lit_from) with the one stored: from the first equal
// one the walks agree, so it rewrites only the segments before it and
// its exit stays; else it rewrites the chunk and its exit changes.  Last,
// each chunk whose true entry differs from its guess rewrites lit_from
// and start up to kf (the segments before it are not selected).
// Each lane holds R rounds' p, e and has in registers while the next R
// rounds' loads are in flight; loads and stores are coalesced.
// Positions are assumed far from int32's limits (|p|, |e|, |lengths| <
// 2^30), as the parsers' rows are.  Static shared memory only (no
// per-launch attribute), so threads of the host may launch it at once.
// Launches on the caller's stream and returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 32;       // warps (chunks) a row
constexpr int MIN_CHUNK = 256;  // the least segments a chunk
constexpr int R = 4;            // rounds a lane holds in registers

struct Tile {
  int p[R];
  int e[R];
  unsigned has;   // bit i: round i's segment has a candidate
};

__device__ __forceinline__ void load_tile(Tile& t, const int32_t* p,
                                          const int32_t* e,
                                          const uint8_t* has, int k0,
                                          int k1, int lane) {
  t.has = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int k = k0 + 32 * i + lane;
    const bool in = k < k1;
    t.p[i] = in ? __ldg(p + k) : 0;
    t.e[i] = in ? __ldg(e + k) : 0;
    t.has |= (in && __ldg(has + k)) ? 1u << i : 0u;
  }
}

// one round from cover end c (updated), each lane's threshold T (INT_MIN
// where it never holds): the selections' lane mask, and this lane's
// lit_from
__device__ __forceinline__ unsigned round_walk(int ek, int T, unsigned below,
                                               int& c, int& lf) {
  const int cr = c;
  unsigned m = __ballot_sync(FULL, cr <= T);
  // bit k: lane k is selected right after lane k - 1 (its test under the
  // e of lane k - 1), so a selected lane's run of such lanes follows it
  // without a shuffle each
  const int e_up = __shfl_up_sync(FULL, ek, 1);
  const unsigned next = __ballot_sync(FULL, (below & 1u) && e_up <= T);
  unsigned selm = 0;
  while (m) {
    const int j = __ffs(m) - 1;
    const int jj = j + __ffs(~((next >> j) >> 1)) - 1;   // the run's end
    selm |= ((2u << jj) - 1u) & (~0u << j);
    c = __shfl_sync(FULL, ek, jj);
    m &= __ballot_sync(FULL, c <= T) & (0xFFFFFFFEu << jj);
  }
  const unsigned lower = selm & below;
  const int le = __shfl_sync(FULL, ek, lower ? 31 - __clz(lower) : 0);
  lf = lower ? le : cr;
  return selm;
}

__device__ __forceinline__ int threshold(int pk, int ek, bool hk, int tail,
                                         int min_match) {
  return hk && ek - pk >= min_match && pk <= tail
             ? min(ek - min_match, tail) : INT_MIN;
}

__global__ void __launch_bounds__(32 * WARPS)
greedy_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ e,
              const uint8_t* __restrict__ has,
              const int32_t* __restrict__ lengths, int nseg, int min_tail,
              int min_match, int c0, uint8_t* __restrict__ sel,
              int32_t* __restrict__ start, int32_t* __restrict__ lit_from,
              int32_t* __restrict__ c_final) {
  // per chunk: the entry its outputs hold, its first selection (k1 for
  // none), max T before it, T there, its exit, its true entry
  __shared__ int s_g[WARPS], s_kf[WARPS], s_mpre[WARPS], s_tkf[WARPS];
  __shared__ int s_exit[WARPS], s_true[WARPS];
  __shared__ int s_need;
  const int row = blockIdx.x;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)row * nseg;
  p += base;
  e += base;
  has += base;
  sel += base;
  start += base;
  lit_from += base;
  const int tail = lengths[row] - min_tail;
  const unsigned below = (1u << lane) - 1u;
  const int chunk = max(MIN_CHUNK, ((nseg + WARPS - 1) / WARPS + 31) & ~31);
  const int nch = (nseg + chunk - 1) / chunk;
  const bool active = w < nch;
  const int k0 = w * chunk;
  const int k1 = min(nseg, k0 + chunk);
  if (active) {
    const int g = w == 0 ? c0 : (has[k0 - 1] ? e[k0 - 1] : p[k0]);
    int c = g, kf = k1, mpre = INT_MIN, tkf = INT_MIN;
    Tile cur, nxt;
    load_tile(cur, p, e, has, k0, k1, lane);
    for (int t0 = k0; t0 < k1; t0 += 32 * R) {
      if (t0 + 32 * R < k1) load_tile(nxt, p, e, has, t0 + 32 * R, k1, lane);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (t0 + 32 * i >= k1) break;   // the chunk's last round was earlier
        const int k = t0 + 32 * i + lane;
        const int T = threshold(cur.p[i], cur.e[i], (cur.has >> i) & 1u,
                                tail, min_match);
        int lf;
        const unsigned selm = round_walk(cur.e[i], T, below, c, lf);
        if (kf == k1) {   // no selection yet: track the entry's reach
          const int j0 = selm ? __ffs(selm) - 1 : 32;
          mpre = max(mpre, __reduce_max_sync(FULL, lane < j0 ? T : INT_MIN));
          if (selm) {
            kf = t0 + 32 * i + j0;
            tkf = __shfl_sync(FULL, T, j0);
          }
        }
        if (k < k1) {
          sel[k] = (selm >> lane) & 1u;
          start[k] = max(cur.p[i], lf);
          lit_from[k] = lf;
        }
      }
      cur = nxt;
    }
    if (lane == 0) {
      s_g[w] = g;
      s_kf[w] = kf;
      s_mpre[w] = mpre;
      s_tkf[w] = tkf;
      s_exit[w] = c;
    }
  }
  __syncthreads();
  // resolve the true entries in chunk order; walk again where the test
  // fails
  for (int from = 1;;) {
    if (threadIdx.x == 0) {
      int c = s_exit[from - 1], need = nch;
      for (int v = from; v < nch; ++v) {
        s_true[v] = c;
        const bool kf = s_kf[v] < min(nseg, (v + 1) * chunk);
        if (!(s_mpre[v] < c && (!kf || c <= s_tkf[v]))) {
          need = v;
          break;
        }
        if (kf) c = s_exit[v];
        else s_exit[v] = c;
      }
      s_need = need;
    }
    __syncthreads();
    const int need = s_need;
    if (need >= nch) break;
    if (w == need) {
      int c = s_true[w];
      bool met = false;
      for (int r0 = k0; r0 < k1 && !met; r0 += 32) {
        const int k = r0 + lane;
        const bool in = k < k1;
        const int pk = in ? p[k] : 0;
        const int ek = in ? e[k] : 0;
        const int old = in ? lit_from[k] : 0;
        int lf;
        const unsigned selm = round_walk(
            ek, threshold(pk, ek, in && has[k], tail, min_match), below, c,
            lf);
        const unsigned same = __ballot_sync(FULL, in && lf == old);
        met = same != 0;
        // rewrite the segments before the first that agrees
        if (in && (!met || lane < __ffs(same) - 1)) {
          sel[k] = (selm >> lane) & 1u;
          start[k] = max(pk, lf);
          lit_from[k] = lf;
        }
      }
      if (lane == 0) {
        if (!met) s_exit[w] = c;
        s_g[w] = s_true[w];
      }
    }
    __syncthreads();
    from = need + 1;
  }
  // the chunks whose guess was not their entry: c up to kf is the entry
  if (active && w > 0 && s_true[w] != s_g[w]) {
    const int t = s_true[w];
    const int kend = s_kf[w] < k1 ? s_kf[w] + 1 : k1;
    for (int k = k0 + lane; k < kend; k += 32) {
      lit_from[k] = t;
      start[k] = max(p[k], t);
    }
  }
  if (threadIdx.x == 0) c_final[row] = s_exit[nch - 1];
}

}  // namespace

extern "C" int zk_greedy_select(const void* p, const void* e,
                                const void* has, const void* lengths, int B,
                                int nseg, int min_tail, int min_match, int c0,
                                void* sel, void* start, void* lit_from,
                                void* c_final, void* stream) {
  greedy_kernel<<<B, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p, (const int32_t*)e, (const uint8_t*)has,
      (const int32_t*)lengths, nseg, min_tail, min_match, c0, (uint8_t*)sel,
      (int32_t*)start, (int32_t*)lit_from, (int32_t*)c_final);
  return (int)cudaGetLastError();
}
