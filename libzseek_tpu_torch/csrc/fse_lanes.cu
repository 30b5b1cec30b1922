// FSE sequence lane decoder of the lane decode route.
//
// Replaces two XLA while_loops of libzseek_tpu/ops/zstd_decode.py (not
// TPU kernels): fse_decode_seq_lanes (:443), one lane per block's
// sequence stream with tagged repcodes that the host resolves later
// (_resolve_tags, :762), and fse_decode_anchored (:620), one lane per
// 128-sequence chunk from the Writer's (bit position, states, rep1)
// checkpoints (format/hints.py).  As torch ops each step would be dozens
// of tiny launches and a host sync, so the walk is one kernel.
//
// A lane walks the 3-state tANS stream backward: table entries (sym | nb
// << 8 | base << 16) of tabs (T, 512), extra bits OF then ML then LL (up
// to 31 offset bits, ofv = (1 << min(ofc, 30)) + extra in int32), the
// repcode step, then the state updates LL, ML, OF except after the
// lane's last sequence (t = n - 1).
//   tagged = 1 (pass B): the initial states are read from the top of the
//     stream (log 0, an RLE table: state 0) and the repcodes start as the
//     tags -(k << 20); the full three-rep rule runs on them; ok = exact
//     consumption.
//   tagged = 0 (pass B'): states and rep1 come from the checkpoint, and
//     off = ofv - 3 or rep1 (the encoder emits no other repcode); ok =
//     pos >= 0.
//
// Bound: the FSE states carry from one sequence to the next, so a lane
// is a serial chain: table entries, then the bits they size, then the
// next states.  Read a load at a time from L2 (an entry through __ldg,
// then its code's ctab row, then two loads a bit field) a sequence takes
// ~1,500-2,000 cycles.  So:
// - Table entries are staged in shared memory with ctab's extra-bit
//   count and baseline folded in (uint2: the raw entry, base | bits << 24
//   | WIDE), so a sequence's tables are three shared loads and nothing
//   after them.  WIDE marks an entry a window cannot serve (below).
// - Once a sequence's entries are loaded, all six bit counts are known,
//   so the six fields come from distances found by addition, out of the
//   128 stream bits below pos held in registers as two 64-bit values
//   (reloaded every sequence from five words at the next position, which
//   is known before this sequence's fields are extracted): the extra
//   bits from the top 64, the states from the 64 below their start,
//   each field one 64-bit shift and a mask.
// - The step is branch-free but for one test: a step whose entries are
//   WIDE (an offset code above 31 or a state read above NARROW_NB bits,
//   from a damaged or RLE table), whose states lie outside [0, 512) on a
//   staged lane, or whose position lies past the row's end (a damaged
//   checkpoint) reloads its entries from tabs and reads its fields
//   through read_at (lane_bits.cuh).
// - The tagged arm (one lane a stream, ~1-16k sequences) runs a block a
//   lane: its 128 threads stage the lane's tables and the stream words
//   the walk can reach (rows of up to SEQ_STAGE bytes; a longer row is
//   read from global memory), and thread 0 walks.  The anchored arm
//   (chunks of <= 128 sequences, a stream's chunks contiguous) runs a
//   thread a lane, 64 lanes a block: the block stages the tables of its
//   first and last lanes, and each lane prefetches its stretch of the
//   stream (and the lines of its tables where they are not staged) into
//   L1 before it walks.
// - Staging loads STAGE_UNROLL values a thread before it stores any, so
//   the loads overlap.
// Every value equals a walk through read_at / read_wide alone, for every
// input: the window holds the stream's bits with zeros below bit 0 and
// past the row's end, which is what read_at returns for a read of <= 25
// bits starting below 8 * SB (and read_wide for <= 31).  The numpy
// mirror is testing/seq_mirror.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_bits.cuh"

namespace {

// the windowed step's pieces (lane_bits.cuh), shared with K4's transcode
// row walk
using lanebits::FSE_TAB;
using lanebits::N_CTAB;
using lanebits::PAD;
using lanebits::STAGE_UNROLL;
using lanebits::WIDE;
using lanebits::fold;
using lanebits::stage_tables;
using lanebits::SmemWords;
using lanebits::GmemWords;
using lanebits::window;
using lanebits::window_fields;

constexpr int REP_TAG = 1 << 20;
constexpr int TAGGED_THREADS = 128;     // a block a tagged lane
constexpr int ANCHOR_THREADS = 64;      // anchored lanes a block
constexpr int SEQ_STAGE = 96 * 1024;    // stream bytes a tagged block stages
constexpr int WIN_BITS = 96;            // bits a step may read below pos
constexpr int ANCHOR_SPAN = 128 * WIN_BITS + 256;   // bits a chunk may read

// a lane's three tables: staged entries (sh[k * 512 + state]) or none
struct Tables {
  const uint2* sh;
  const int* tabs;
  const int* ct;
  long long last;
  long long b[3];

  // the exact entry (clamped index into tabs where not staged)
  __device__ __forceinline__ uint2 get(int k, int s) const {
    if (sh != nullptr && (unsigned)s < (unsigned)FSE_TAB)
      return sh[k * FSE_TAB + s];
    long long i = b[k] + s;
    i = i < 0 ? 0 : (i > last ? last : i);
    const int e = __ldg(tabs + i);
    return make_uint2((uint32_t)e, fold(ct, k, e));
  }
};

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// one lane's walk from (pos, states, reps); writes its rows of ll, ml,
// off, its final reps and its verdict.  STAGED: the lane's tables are
// T.sh (else every entry comes from tabs).
template <int TAGGED, bool STAGED, class Words>
__device__ __forceinline__ void walk(
    const Words& src, const Tables& T, const uint8_t* row, int SB, int pos,
    int s_ll, int s_of, int s_ml, int r1, int r2, int r3, int n_l, int cap,
    int* lo, int* mo, int* oo, int* rep, uint8_t* ok) {
  using lanebits::read_at;
  using lanebits::read_wide;
  const int cnt = min(n_l, cap);
  const int end_bits = 8 * SB;
  unsigned long long X, Y;
  window(src, pos, X, Y);
  for (int t = 0; t < cnt; ++t) {
    uint2 a, b, c;
    bool in = true;
    if (STAGED) {
      a = T.sh[s_ll & (FSE_TAB - 1)];
      b = T.sh[FSE_TAB + (s_of & (FSE_TAB - 1))];
      c = T.sh[2 * FSE_TAB + (s_ml & (FSE_TAB - 1))];
      in = (unsigned)(s_ll | s_of | s_ml) < (unsigned)FSE_TAB;
    } else {
      a = T.get(0, s_ll);
      b = T.get(1, s_of);
      c = T.get(2, s_ml);
    }
    const bool fast =
        in && !((a.y | b.y | c.y) & WIDE) && pos <= end_bits;
    if (!fast) {    // the exact entries (clamped indices into tabs)
      a = T.get(0, s_ll);
      b = T.get(1, s_of);
      c = T.get(2, s_ml);
    }
    const int um = t < n_l - 1 ? 0xFF : 0;    // the states update
    const int ofc = (int)(b.x & 255u);
    const int mlb = (int)((c.y >> 24) & 31u);
    const int llb = (int)((a.y >> 24) & 31u);
    const int nll = (int)(a.x >> 8) & um;
    const int nml = (int)(c.x >> 8) & um;
    const int nof = (int)(b.x >> 8) & um;
    // distances below pos (the extra bits) and below p3 (the states)
    const int d1 = ofc, d2 = d1 + mlb, d3 = d2 + llb;
    const int e1 = nll, e2 = e1 + nml, e3 = e2 + nof;
    const int p3 = pos - d3;
    uint32_t xo, xm, xl, yl, ym, yo;
    if (fast) {     // d3 <= 63 and e3 <= 33
      window_fields(X, Y, ofc, mlb, llb, nll, nml, nof, xo, xm, xl, yl, ym,
                    yo);
    } else {
      xo = read_wide(row, SB, pos - d1, ofc);
      xm = read_at(row, SB, pos - d2, mlb);
      xl = read_at(row, SB, p3, llb);
      yl = read_at(row, SB, p3 - e1, nll);
      ym = read_at(row, SB, p3 - e2, nml);
      yo = read_at(row, SB, p3 - e3, nof);
    }
    pos = p3 - e3;
    window(src, pos, X, Y);
    const int ofv = (int)((1u << min(ofc, 30)) + xo);
    const int ml = (int)(c.y & 0xFFFFFFu) + (int)xm;
    const int ll = (int)(a.y & 0xFFFFFFu) + (int)xl;
    int off;
    if (TAGGED) {
      const int idx = (int)((uint32_t)ofv + (ll == 0 ? 1u : 0u));
      const bool big = ofv > 3;
      off = big ? ofv - 3
                : (idx == 1 ? r1 : (idx == 2 ? r2 : (idx == 3 ? r3 : r1 - 1)));
      const int n_r2 = big ? r1 : (idx == 1 ? r2 : r1);
      const int n_r3 = big || (idx != 1 && idx != 2) ? r2 : r3;
      r2 = n_r2;
      r3 = n_r3;
    } else {
      off = ofv > 3 ? ofv - 3 : r1;
    }
    r1 = off;
    if (um) {
      s_ll = ((int)a.x >> 16) + (int)yl;
      s_ml = ((int)c.x >> 16) + (int)ym;
      s_of = ((int)b.x >> 16) + (int)yo;
    }
    lo[t] = ll;
    mo[t] = ml;
    oo[t] = off;
  }
  rep[0] = r1;
  rep[1] = r2;
  rep[2] = r3;
  *ok = TAGGED ? (pos == 0) : (pos >= 0);
}

// pass B: a block a lane; the tables and the reachable stream words (of a
// row of up to SEQ_STAGE bytes) staged, thread 0 walks
__global__ void __launch_bounds__(TAGGED_THREADS) seq_tagged_kernel(
    const uint8_t* __restrict__ bank, int SB, int NS,
    const int* __restrict__ sid, const int* __restrict__ bits,
    const int* __restrict__ n, const int* __restrict__ tids,
    const int* __restrict__ tls, const int* __restrict__ tabs, int T,
    const int* __restrict__ ctab, int cap, int* __restrict__ ll_out,
    int* __restrict__ ml_out, int* __restrict__ off_out,
    int* __restrict__ rep_out, uint8_t* __restrict__ ok) {
  __shared__ uint2 sh[3 * FSE_TAB];
  __shared__ int ct[N_CTAB];
  extern __shared__ uint32_t stage[];
  const int l = blockIdx.x;
  const int s = min(max(sid[l], 0), NS - 1);
  const uint8_t* row = bank + (size_t)s * SB;
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
  const int nw = SB >> 2;
  const long long last = (long long)T * FSE_TAB - 1;
  // the walk starts at pos0 and never climbs, so its windows end by word
  // pos0 / 32: the words above stay unstaged
  const int pos0 = bits[l] - tls[3 * l] - tls[3 * l + 1] - tls[3 * l + 2];
  const bool staged = SB <= SEQ_STAGE;
  const int nst = staged ? min(nw, max(pos0, 0) / 32 + 4) : 0;
  for (int i = threadIdx.x; i < N_CTAB; i += blockDim.x) ct[i] = ctab[i];
  if (staged) {
    if (threadIdx.x < PAD) {
      stage[threadIdx.x] = 0u;
      stage[PAD + nst + threadIdx.x] = 0u;
    }
    for (int i0 = threadIdx.x; i0 < nst;
         i0 += TAGGED_THREADS * STAGE_UNROLL) {
      uint32_t v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * TAGGED_THREADS;
        v[u] = i < nst ? __ldg(rw + i) : 0u;
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * TAGGED_THREADS;
        if (i < nst) stage[PAD + i] = v[u];
      }
    }
  }
  __syncthreads();
  stage_tables(sh, tabs, last, ct, tids + 3 * l);
  __syncthreads();
  if (threadIdx.x != 0) return;
  using lanebits::read_at;
  int pos = bits[l];
  const int tl_ll = tls[3 * l], tl_of = tls[3 * l + 1], tl_ml = tls[3 * l + 2];
  const int s_ll = (int)read_at(row, SB, pos - tl_ll, tl_ll);
  pos -= tl_ll;
  const int s_of = (int)read_at(row, SB, pos - tl_of, tl_of);
  pos -= tl_of;
  const int s_ml = (int)read_at(row, SB, pos - tl_ml, tl_ml);
  pos -= tl_ml;
  Tables tb{sh, tabs, ct, last,
            {(long long)tids[3 * l] * FSE_TAB,
             (long long)tids[3 * l + 1] * FSE_TAB,
             (long long)tids[3 * l + 2] * FSE_TAB}};
  const size_t o = (size_t)l * cap;
  if (staged)
    walk<1, true>(SmemWords{stage, nst}, tb, row, SB, pos, s_ll, s_of, s_ml,
                  -REP_TAG, -2 * REP_TAG, -3 * REP_TAG, n[l], cap,
                  ll_out + o, ml_out + o, off_out + o, rep_out + 3 * l,
                  ok + l);
  else
    walk<1, true>(GmemWords{rw, nw}, tb, row, SB, pos, s_ll, s_of, s_ml,
                  -REP_TAG, -2 * REP_TAG, -3 * REP_TAG, n[l], cap,
                  ll_out + o, ml_out + o, off_out + o, rep_out + 3 * l,
                  ok + l);
}

// pass B': a thread a lane, ANCHOR_THREADS lanes a block; the tables of
// the block's first and last lanes staged
__global__ void __launch_bounds__(ANCHOR_THREADS) seq_anchored_kernel(
    const uint8_t* __restrict__ bank, int SB, int NS,
    const int* __restrict__ sid, const int* __restrict__ bits,
    const int* __restrict__ n, const int* __restrict__ states,
    const int* __restrict__ rep1, const int* __restrict__ tids,
    const int* __restrict__ tabs, int T, const int* __restrict__ ctab,
    int L, int cap, int* __restrict__ ll_out, int* __restrict__ ml_out,
    int* __restrict__ off_out, int* __restrict__ rep_out,
    uint8_t* __restrict__ ok) {
  __shared__ uint2 sh[2][3 * FSE_TAB];
  __shared__ int ct[N_CTAB];
  const int first = blockIdx.x * ANCHOR_THREADS;
  const int lastl = min(first + ANCHOR_THREADS, L) - 1;
  const long long last = (long long)T * FSE_TAB - 1;
  const int l = first + threadIdx.x;
  const int s = min(max(sid[min(l, lastl)], 0), NS - 1);
  const uint8_t* row = bank + (size_t)s * SB;
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(row);
  const int nw = SB >> 2;
  const int pos = bits[min(l, lastl)];
  // the lane's stretch of the stream into L1 while the tables stage
  if (l <= lastl && pos <= 8 * SB) {
    const int hi = min((pos >> 5) + 1, nw - 1);
    const int lo = max((pos - ANCHOR_SPAN) >> 5, 0);
    for (int i = hi; i >= lo; i -= 32) prefetch_l1(rw + i);
  }
  for (int i = threadIdx.x; i < N_CTAB; i += blockDim.x) ct[i] = ctab[i];
  __syncthreads();
  const int* t0 = tids + 3 * first;
  const int* t1 = tids + 3 * lastl;
  const bool two = t0[0] != t1[0] || t0[1] != t1[1] || t0[2] != t1[2];
  stage_tables(sh[0], tabs, last, ct, t0);
  if (two) stage_tables(sh[1], tabs, last, ct, t1);
  __syncthreads();
  if (l > lastl) return;
  const int* tl3 = tids + 3 * l;
  const uint2* mine = nullptr;
  if (tl3[0] == t0[0] && tl3[1] == t0[1] && tl3[2] == t0[2])
    mine = sh[0];
  else if (two && tl3[0] == t1[0] && tl3[1] == t1[1] && tl3[2] == t1[2])
    mine = sh[1];
  Tables tb{mine, tabs, ct, last,
            {(long long)tl3[0] * FSE_TAB, (long long)tl3[1] * FSE_TAB,
             (long long)tl3[2] * FSE_TAB}};
  const size_t o = (size_t)l * cap;
  const GmemWords src{rw, nw};
  if (mine != nullptr) {
    walk<0, true>(src, tb, row, SB, pos, states[3 * l], states[3 * l + 1],
                  states[3 * l + 2], rep1[l], 0, 0, n[l], cap, ll_out + o,
                  ml_out + o, off_out + o, rep_out + 3 * l, ok + l);
  } else {
    // the lines of its tables into L1 first
    for (int k = 0; k < 3; ++k) {
      long long j = tb.b[k];
      j = j < 0 ? 0 : (j > last ? last : j);
      for (int i = 0; i < FSE_TAB; i += 32)
        prefetch_l1(tabs + min(j + i, last));
    }
    walk<0, false>(src, tb, row, SB, pos, states[3 * l], states[3 * l + 1],
                   states[3 * l + 2], rep1[l], 0, 0, n[l], cap, ll_out + o,
                   ml_out + o, off_out + o, rep_out + 3 * l, ok + l);
  }
}

}  // namespace

extern "C" int zk_fse_lanes(const void* bank, const void* sid,
                            const void* bits, const void* n,
                            const void* states, const void* rep1,
                            const void* tids, const void* tls,
                            const void* tabs, const void* ctab, int SB,
                            int NS, int T, int L, int cap, int tagged,
                            void* ll, void* ml, void* off, void* rep,
                            void* ok, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 0) return (int)cudaGetLastError();
  if (tagged) {
    // the kernel's most, set before every launch: the attribute is the
    // kernel's in the current device's context, shared by every host
    // thread, so no launch lowers it under another's and every device has it
    constexpr int SMEM_MAX = SEQ_STAGE + 2 * PAD * 4;
    const cudaError_t attr = cudaFuncSetAttribute(
        seq_tagged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (attr != cudaSuccess) return (int)attr;
    const int smem = SB <= SEQ_STAGE ? SB + 2 * PAD * 4 : 0;
    seq_tagged_kernel<<<L, TAGGED_THREADS, smem, st>>>(
        (const uint8_t*)bank, SB, NS, (const int*)sid, (const int*)bits,
        (const int*)n, (const int*)tids, (const int*)tls, (const int*)tabs, T,
        (const int*)ctab, cap, (int*)ll, (int*)ml, (int*)off, (int*)rep,
        (uint8_t*)ok);
    return (int)cudaGetLastError();
  }
  seq_anchored_kernel<<<(L + ANCHOR_THREADS - 1) / ANCHOR_THREADS,
                        ANCHOR_THREADS, 0, st>>>(
      (const uint8_t*)bank, SB, NS, (const int*)sid, (const int*)bits,
      (const int*)n, (const int*)states, (const int*)rep1, (const int*)tids,
      (const int*)tabs, T, (const int*)ctab, L, cap, (int*)ll, (int*)ml,
      (int*)off, (int*)rep, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
