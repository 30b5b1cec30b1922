// plan: the zstd write's per-block plans for one device batch in one
// launch: the Huffman literal plan (ops/huffman_plan.py plan_blocks) and
// the FSE sequence-table plan (ops/fse_plan.py plan_seq_tables).
//
// Replaces no TPU kernel: the JAX package builds both plans from plain
// jnp ops (libzseek_tpu/ops/huffman_plan.py plan_blocks, :250;
// libzseek_tpu/ops/fse_plan.py plan_seq_tables, :157).  In eager PyTorch
// those are a few thousand launches a batch, and the Kraft moves read a
// flag back to the host after each step; here they are one launch that
// the host does not wait for.  The outputs equal the torch plans' array
// for array; the torch plans stay the CPU path and the tests' reference,
// and testing/plan_mirror.py mirrors this kernel's phases in numpy.
//
// Bound: the work is a 256-symbol histogram and three small code
// histograms a row, so the card's rates are far away (the inputs are the
// rows' sequences, read once, ~100 KiB a row); the time is the Kraft
// assignment's dependent chain of warp reductions (8 rounds of a 24-step
// bisection, then up to 64 single moves).
//
// Design: a block of 256 threads a row, every row at once.  First all
// threads count the row's LL, OF and ML codes into shared memory
// (shared-memory atomics).  Then, with no barrier between them, warp 0
// builds the Huffman plan and warps 1-3 the three sequence tables:
//   * Huffman (one warp): lane l holds symbols 8l .. 8l+7 in registers,
//     so a reduction is a 5-step butterfly shuffle and "the first index"
//     is the lowest lane whose local best (taken in ascending order)
//     equals the warp's (a ballot).  The bisection is the torch plan's
//     float32 arithmetic step for step: prio = hist / k with an
//     IEEE-rounded divide, mid = 0.5f * (lo + hi) by the _rn intrinsics
//     (never contracted), costs summed as integers below 2^24 (exact in
//     any order).  The single moves stop per row when its budget is
//     exact or no move applies (the torch loop changes nothing for such
//     a row).  The balanced fallback's stable argsort is a rank count
//     over (key, index) from shared memory.  Canonical codes: per code
//     length, from the longest, a warp scan of the lanes' counts.
//   * FSE (a warp a stream): lane l holds symbols 2l, 2l+1; normalisation
//     at the predefined and the largest accuracy log, the costs from the
//     COST16 tables, the choice, and FSE_buildCTable with the state
//     table built directly: slot k's symbol by a binary search of the
//     symbols' cumulative counts, spread to (k * step) & (tab - 1), then
//     positions in rounds of 32 ascending, each position's rank among
//     its symbol's by __match_any_sync and a per-symbol running count.
//
// Launches on the caller's stream, allocates nothing, static shared
// memory only, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MAX_BITS = 11, TAB = 1 << MAX_BITS, KMAX = 1 << 10;
constexpr int BIG = 1 << 30;
constexpr int MOVES = 64, ROUNDS = 8, STEPS = 24;

// literal-section modes (ops/huffman_plan.py M_*)
constexpr int M_SKIP = 0, M_RLEBLOCK = 1, M_NONE = 2, M_RLE = 3, M_RAW = 4,
              M_HUF = 5, M_HUF1 = 6;
constexpr int MIN_SEQ_FSE = 32;

// the constant table (ops/huffman_plan.py _plan_table): LL and ML code
// tables, the predefined costs in 1/16 bits, COST16 at logs 5, 6, 8, 9,
// the predefined sequence-table pack
constexpr int T_LL_CODE = 0, T_ML_CODE = 64, T_PD16 = 192;
constexpr int T_COST5 = 310, T_COST6 = 343, T_COST8 = 408, T_COST9 = 665;
constexpr int T_PREDEF = 1178;

// a row's sequence-table pack (ops/entropy.py CTAB_OFF) and norms
// (ops/fse_plan.py NORM_WIDTH)
constexpr int CTAB_W = 1516, NORM_W = 118;

// streams LL, OF, ML: symbols, predefined and largest log, mode bits,
// offsets in the pack, the norms and the histograms
template <int ST>
struct Stream;
template <>
struct Stream<0> {
  static constexpr int NS = 36, LG = 6, LM = 9, SHIFT = 12, RLE = 16,
                       FSE = 128, ST_OFF = 0, DNB = 512, DFS = 548, NO = 0,
                       COST_D = T_COST6, COST_M = T_COST9;
};
template <>
struct Stream<1> {
  static constexpr int NS = 29, LG = 5, LM = 8, SHIFT = 16, RLE = 32,
                       FSE = 256, ST_OFF = 584, DNB = 840, DFS = 869,
                       NO = 36, COST_D = T_COST5, COST_M = T_COST8;
};
template <>
struct Stream<2> {
  static constexpr int NS = 53, LG = 6, LM = 9, SHIFT = 20, RLE = 64,
                       FSE = 512, ST_OFF = 898, DNB = 1410, DFS = 1463,
                       NO = 65, COST_D = T_COST6, COST_M = T_COST9;
};

struct Args {
  const int32_t *hist, *hist_q, *lit_count, *n_seq, *cnst, *lens, *ll, *ml,
      *offv, *tabs;
  int S, mode_huf, mode_huf1, mode_rawlit, mode_seq;
  int32_t *mode, *mb, *codes, *wpk, *rle, *sizes4, *sflags, *ctabs, *norms,
      *rle_syms, *gain;
};

struct Shared {
  int hist[NORM_W];          // the row's LL, OF, ML code histograms
  int keys[256];             // the Huffman warp's histogram (fallback)
  int cum_in[3][64];         // a stream's inclusive cumulative norms
  int next[3][64];           // a stream's next state-table slot a symbol
  unsigned char spread[3][512];
  int flags[3], gain[3];
};

__device__ __forceinline__ int wsum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int wmax(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int wmin(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float wmaxf(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// inclusive scan over the lanes
__device__ __forceinline__ int wscan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// the index of the warp's best value, the first on ties: each lane's
// best is the first of its own in ascending index order
__device__ __forceinline__ int first_of(int best, int idx, bool is_max) {
  const int g = is_max ? wmax(best) : wmin(best);
  const unsigned b = __ballot_sync(FULL, best == g);
  return __shfl_sync(FULL, idx, __ffs(b) - 1);
}

// floor(log2(max(x, 1)))
__device__ __forceinline__ int flog2(int x) { return 31 - __clz(max(x, 1)); }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// ---------------------------------------------------------------- Huffman

__device__ void huffman_row(const Args& a, Shared& sh, int row, int lane) {
  const int base = lane * 8;
  int h[8], k[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) h[t] = a.hist[row * 256 + base + t];
  int m = 0, total = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    m += h[t] > 0;
    total += h[t];
  }
  m = wsum(m);
  total = wsum(total);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int sc = max(h[t] * TAB / max(total, 1), 1);
    const int k0 = clampi(1 << clampi(flog2(sc), 0, 10), 1, KMAX);
    k[t] = (h[t] > 0 && m >= 2) ? k0 : 0;
  }
  float hf[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) hf[t] = __int2float_rn(h[t]);

  // bulk grow rounds: a 24-step bisection of the priority threshold
  for (int r = 0; r < ROUNDS; ++r) {
    int ks = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) ks += k[t];
    const int D = max(TAB - wsum(ks), 0);
    float prio[8], pm = 0.f;
    int cost[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const bool el = k[t] > 0 && k[t] < KMAX;
      prio[t] = el ? __fdiv_rn(hf[t], __int2float_rn(max(k[t], 1))) : -1e30f;
      cost[t] = el ? k[t] : 0;
      pm = fmaxf(pm, el ? prio[t] : 0.f);
    }
    float hi = __fadd_rn(wmaxf(pm), 1.0f), lo = 0.f;
    for (int s = 0; s < STEPS; ++s) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int c = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) c += prio[t] >= mid ? cost[t] : 0;
      if (wsum(c) <= D)
        hi = mid;
      else
        lo = mid;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (k[t] > 0 && k[t] < KMAX && prio[t] >= hi) k[t] *= 2;
  }

  // single moves until the row's budget is exact (at most 64)
  const int neg = __float_as_int(-1e30f), pos = __float_as_int(1e30f);
  for (int it = 0; it < MOVES; ++it) {
    int ks = 0, np = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      ks += k[t];
      np += k[t] > 0;
    }
    const int K = wsum(ks);
    if (K == TAB || wsum(np) < 2) break;
    const int D = TAB - K;
    const int lim_g = 1 << clampi(flog2(max(D, 1)), 0, 10);
    const int lim_s = 2 << clampi(flog2(max(-D, 1)), 0, 10);
    int bg = 0, ig = base, bs = 0, is = base, bp = 0, ip = base;
    bool any_g = false, any_s = false, any_p = false;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int pr = __float_as_int(
          __fdiv_rn(hf[t], __int2float_rn(max(k[t], 1))));
      const bool eg = k[t] > 0 && k[t] <= lim_g && k[t] < KMAX;
      const bool es = k[t] >= 2 && k[t] <= lim_s;
      const bool ep = k[t] > 0 && k[t] < KMAX;
      const int vg = eg ? pr : neg, vs = es ? pr : pos, vp = ep ? k[t] : BIG;
      if (t == 0 || vg > bg) bg = vg, ig = base + t;
      if (t == 0 || vs < bs) bs = vs, is = base + t;
      if (t == 0 || vp < bp) bp = vp, ip = base + t;
      any_g |= eg;
      any_s |= es;
      any_p |= ep;
    }
    const bool ok_g = __any_sync(FULL, any_g);
    const bool ok_s = __any_sync(FULL, any_s);
    const bool ok_p = __any_sync(FULL, any_p);
    const bool grow = D > 0;
    const bool can = grow ? ok_g : (ok_s || ok_p);
    if (!can) break;  // no move applies: the row stays as it is
    const int pick = grow ? first_of(bg, ig, true)
                          : (ok_s ? first_of(bs, is, false)
                                  : first_of(bp, ip, false));
    const bool do_grow = grow || !ok_s;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (base + t == pick) k[t] = do_grow ? k[t] * 2 : k[t] / 2;
  }

  // balanced-code fallback for a row the moves did not repair: a used
  // symbol's rank is the count of used symbols with a larger count, or an
  // equal count and a lower index (the stable argsort of -hist)
  {
    int ks = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) ks += k[t];
    if (wsum(ks) != TAB && m >= 2) {
      const int L = max(flog2(max(m - 1, 1)) + 1, 1);
      const int n_short = (1 << L) - m;
      const int k_hi = 1 << clampi(12 - L, 1, 11);
      const int k_lo = 1 << clampi(11 - L, 0, 10);
#pragma unroll
      for (int t = 0; t < 8; ++t) sh.keys[base + t] = h[t];
      __syncwarp();
      int rank[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int j = 0; j < 256; ++j) {
        const int hj = sh.keys[j];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          rank[t] += hj > 0 && (hj > h[t] || (hj == h[t] && j < base + t));
      }
#pragma unroll
      for (int t = 0; t < 8; ++t)
        k[t] = h[t] > 0 ? (rank[t] < n_short ? k_hi : k_lo) : 0;
    }
  }

  // a flat code over > 127 symbols cannot be serialized: double the most
  // frequent, halve the two rarest
  {
    int kx = 0, kn = BIG;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (k[t] > 0) kx = max(kx, k[t]), kn = min(kn, k[t]);
    kx = wmax(kx);
    kn = wmin(kn);
    if (m > 127 && kx == kn && kn >= 2 && kx < KMAX) {
      int bt = 0, it = base;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int v = k[t] > 0 ? h[t] : -1;
        if (t == 0 || v > bt) bt = v, it = base + t;
      }
      const int top = first_of(bt, it, true);
      int b1 = 0, i1 = base;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int v = (k[t] > 0 && base + t != top) ? h[t] : BIG;
        if (t == 0 || v < b1) b1 = v, i1 = base + t;
      }
      const int r1 = first_of(b1, i1, false);
      int b2 = 0, i2 = base;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int v =
            (k[t] > 0 && base + t != top && base + t != r1) ? h[t] : BIG;
        if (t == 0 || v < b2) b2 = v, i2 = base + t;
      }
      const int r2 = first_of(b2, i2, false);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (base + t == top) k[t] *= 2;
        if (base + t == r1 || base + t == r2) k[t] /= 2;
      }
    }
  }

  // canonical codes: HUF_buildCTable's values per rank, longest first,
  // symbol order within a length
  int len[8], code[8], lmax = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    len[t] = k[t] > 0 ? MAX_BITS - flog2(k[t]) : 0;
    code[t] = 0;
    lmax = max(lmax, len[t]);
  }
  const int max_bits = wmax(lmax);
  int mn = 0;
  for (int nb = MAX_BITS; nb >= 1; --nb) {
    int c = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) c += len[t] == nb;
    const int incl = wscan(c, lane);
    const int tot = __shfl_sync(FULL, incl, 31);
    int run = mn + incl - c;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (len[t] == nb) code[t] = run++;
    mn = (mn + tot) >> 1;
  }
  unsigned word = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    a.codes[row * 256 + base + t] = (code[t] << 4) | len[t];
    const int w = k[t] > 0 ? max_bits + 1 - len[t] : 0;
    word |= unsigned(w) << (4 * t);
  }
  a.wpk[row * 32 + lane] = int(word);

  // literal-section mode and the exact per-stream sizes
  int br = 0, ir = base, last = -1, eb = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t == 0 || h[t] > br) br = h[t], ir = base + t;
    if (h[t] > 0) last = base + t;
    eb += h[t] * len[t];
  }
  const int rle_byte = first_of(br, ir, true);
  last = wmax(last);
  const int est_bits = wsum(eb);
  int bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int v = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v += a.hist_q[(row * 4 + q) * 256 + base + t] * len[t];
    bq[q] = wsum(v);
  }
  if (lane != 0) return;
  const int lc = a.lit_count[row], blen = a.lens[row];
  const int tree_bound = last <= 127 ? 1 + (max(last, 0) + 1) / 2 : 128;
  const bool one = lc < 256;
  int s4[4];
  if (one) {
    s4[0] = (est_bits + 1 + 7) >> 3;
    s4[1] = s4[2] = s4[3] = 0;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) s4[q] = (bq[q] + 1 + 7) >> 3;
  }
  const int est_payload =
      s4[0] + s4[1] + s4[2] + s4[3] + tree_bound + (one ? 0 : 6);
  const int raw_hdr = lc < 32 ? 1 : (lc < 4096 ? 2 : 3);
  const int huf_hdr = (lc <= 1023 && est_payload <= 1023)
                          ? 3
                          : ((lc <= 16383 && est_payload <= 16383) ? 4 : 5);
  const bool huf_ok = m >= 2 && lc >= 64 && est_payload < lc &&
                      huf_hdr + est_payload < raw_hdr + lc;
  int md = huf_ok ? (one ? M_HUF1 : M_HUF) : M_RAW;
  if (md == M_RAW && lc > 0 && raw_hdr + lc + 1 >= blen) md = M_SKIP;
  if (m == 1) md = M_RLE;
  if (lc == 0) md = M_NONE;
  if (a.cnst[row] >= 0 && blen > 4) md = M_RLEBLOCK;
  int mb = md == M_HUF ? (a.mode_huf | a.mode_seq) : 0;
  if (md == M_HUF1) mb = a.mode_huf | a.mode_huf1 | a.mode_seq;
  if (md == M_RAW && lc > 0) mb = a.mode_rawlit | a.mode_seq;
  if (md == M_NONE || md == M_RLE || (md == M_RAW && lc == 0))
    mb = a.mode_seq;
  if (md == M_SKIP || md == M_RLEBLOCK) mb = 0;
  if (blen == 0) mb = 0, md = M_SKIP;
  const bool huf = md == M_HUF || md == M_HUF1;
  a.mode[row] = md;
  a.mb[row] = mb;
  a.rle[row] = rle_byte;
#pragma unroll
  for (int q = 0; q < 4; ++q) a.sizes4[row * 4 + q] = huf ? s4[q] : 0;
}

// -------------------------------------------------------------------- FSE

// normalisation at accuracy log lg: every used symbol at least one slot,
// the remainder on the most frequent symbol (top); ok is false when that
// would push it below 1 or the slots do not add up
__device__ __forceinline__ bool normalize(int lg, const int h[2], int total,
                                          int top, int lane, int n[2]) {
  const int tab = 1 << lg;
#pragma unroll
  for (int u = 0; u < 2; ++u)
    n[u] = h[u] > 0 ? max(h[u] * tab / max(total, 1), 1) : 0;
  const int d = tab - wsum(n[0] + n[1]);
  const int at = __shfl_sync(FULL, (top & 1) ? n[1] : n[0], top >> 1);
  const int fixed = at + d;
  if (lane == top >> 1) {
    if (top & 1)
      n[1] = max(fixed, 1);
    else
      n[0] = max(fixed, 1);
  }
  return fixed >= 1 && wsum(n[0] + n[1]) == tab;
}

__device__ __forceinline__ int table_cost(const int32_t* cost16, int lg,
                                          const int h[2], const int n[2],
                                          int last) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < 2; ++u)
    c += n[u] > 0 ? h[u] * cost16[clampi(n[u], 0, 1 << lg)] : 0;
  return (wsum(c) >> 4) + ((4 + (last + 1) * (lg + 2) + 7) >> 3) * 8;
}

// FSE_buildCTable for norms n (no -1 entries) at log lg into the row's
// pack: the state table (zero-padded to the largest log), deltaNbBits and
// deltaFindState
template <int ST>
__device__ void build_ctable(const Args& a, Shared& sh, int row, int lane,
                             int lg, const int n[2]) {
  using X = Stream<ST>;
  const int tab = 1 << lg, mask = tab - 1;
  const int step = (tab >> 1) + (tab >> 3) + 3;
  int32_t* out = a.ctabs + row * CTAB_W;
  int* cum_in = sh.cum_in[ST];
  int* next = sh.next[ST];
  unsigned char* spread = sh.spread[ST];
  const int incl = wscan(n[0] + n[1], lane);
  const int cumul[2] = {incl - n[0] - n[1], incl - n[1]};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = 2 * lane + u;
    if (s >= X::NS) continue;
    cum_in[s] = cumul[u] + n[u];
    next[s] = cumul[u];
    const int c = n[u];
    const int mb = lg - flog2(max(c - 1, 1));
    out[X::DNB + s] = c == 0   ? ((lg + 1) << 16) - tab
                      : c == 1 ? (lg << 16) - tab
                               : (mb << 16) - (c << clampi(mb, 0, 31));
    out[X::DFS + s] = c == 0 ? 0 : (c == 1 ? cumul[u] - 1 : cumul[u] - c);
  }
  __syncwarp();
  // slot k belongs to the symbol whose cumulative range holds it
  for (int k = lane; k < tab; k += 32) {
    int lo = 0, hi = X::NS;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum_in[mid] <= k)
        lo = mid + 1;
      else
        hi = mid;
    }
    spread[(k * step) & mask] = (unsigned char)lo;
  }
  __syncwarp();
  // a position's state-table entry: its symbol's start plus the count of
  // that symbol's lower positions (next[s] runs from the start)
  const unsigned below = (1u << lane) - 1;
  for (int p0 = 0; p0 < tab; p0 += 32) {
    const int p = p0 + lane;
    const int s = spread[p];
    const unsigned grp = __match_any_sync(FULL, s);
    out[X::ST_OFF + next[s] + __popc(grp & below)] = tab + p;
    __syncwarp();
    if (lane == __ffs(grp) - 1) next[s] += __popc(grp);
    __syncwarp();
  }
  for (int j = tab + lane; j < (1 << X::LM); j += 32) out[X::ST_OFF + j] = 0;
}

template <int ST>
__device__ void seq_table(const Args& a, Shared& sh, int row, int lane) {
  using X = Stream<ST>;
  int h[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = 2 * lane + u;
    h[u] = s < X::NS ? sh.hist[X::NO + s] : 0;
  }
  int nz = 0, tot = 0, bp = 0, last = 0, best = -1, bi = 2 * lane;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = 2 * lane + u;
    if (s >= X::NS) continue;
    nz += h[u] > 0;
    tot += h[u];
    bp += h[u] * a.tabs[T_PD16 + X::NO + s];
    if (h[u] > 0) last = s;
    if (h[u] > best) best = h[u], bi = s;
  }
  nz = wsum(nz);
  const int total = wsum(tot);
  const int bits_pd = wsum(bp) >> 4;
  last = wmax(last);
  const int sym = first_of(best, bi, true);
  const int n_seq = a.n_seq[row];

  int nd[2], nm[2];
  bool ok_d = normalize(X::LG, h, total, sym, lane, nd);
  bool ok_m = normalize(X::LM, h, total, sym, lane, nm);
  const int cost_d = table_cost(a.tabs + X::COST_D, X::LG, h, nd, last);
  const int cost_m = table_cost(a.tabs + X::COST_M, X::LM, h, nm, last);
  const bool base_ok = nz >= 2 && n_seq >= MIN_SEQ_FSE;
  ok_d = ok_d && base_ok && cost_d + 16 < bits_pd;
  ok_m = ok_m && base_ok && cost_m + 16 < bits_pd;
  const bool pick_m = ok_m && (!ok_d || cost_m < cost_d);
  const bool rle = nz == 1 && n_seq > 0;
  const bool use_m = pick_m && !rle, use_d = ok_d && !pick_m && !rle;

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int s = 2 * lane + u;
    if (s < X::NS)
      a.norms[row * NORM_W + X::NO + s] = use_m ? nm[u] : nd[u];
  }
  if (use_m) {
    build_ctable<ST>(a, sh, row, lane, X::LM, nm);
  } else if (use_d) {
    build_ctable<ST>(a, sh, row, lane, X::LG, nd);
  } else {
    const int32_t* pd = a.tabs + T_PREDEF;
    int32_t* out = a.ctabs + row * CTAB_W;
    for (int j = lane; j < (1 << X::LM); j += 32)
      out[X::ST_OFF + j] = pd[X::ST_OFF + j];
    for (int j = lane; j < X::NS; j += 32) {
      out[X::DNB + j] = pd[X::DNB + j];
      out[X::DFS + j] = pd[X::DFS + j];
    }
  }
  if (lane == 0) {
    a.rle_syms[row * 3 + ST] = sym;
    sh.flags[ST] = (rle ? X::RLE : 0) | ((use_m || use_d) ? X::FSE : 0) |
                   (use_m ? X::LM << X::SHIFT : 0) |
                   (use_d ? X::LG << X::SHIFT : 0);
    sh.gain[ST] = use_m ? bits_pd - cost_m : (use_d ? bits_pd - cost_d : 0);
  }
}

__global__ void __launch_bounds__(THREADS) plan_kernel(Args a) {
  __shared__ Shared sh;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < NORM_W; i += THREADS) sh.hist[i] = 0;
  __syncthreads();
  // the row's LL, OF and ML codes (ops/fse_plan.py seq_codes), clamped
  // to each alphabet as the torch plan's scatter
  const int n = clampi(a.n_seq[row], 0, a.S);
  const int32_t* ll = a.ll + (size_t)row * a.S;
  const int32_t* ml = a.ml + (size_t)row * a.S;
  const int32_t* of = a.offv + (size_t)row * a.S;
  for (int i = tid; i < n; i += THREADS) {
    const int l = ll[i], m = ml[i], o = of[i];
    const int lc = l > 63 ? flog2(l) + 19 : a.tabs[T_LL_CODE + clampi(l, 0, 63)];
    int mc = 0;
    if (m >= 3) {
      const int mb = m - 3;
      mc = mb > 127 ? flog2(mb) + 36 : a.tabs[T_ML_CODE + mb];
    }
    const int oc = o > 0 ? flog2(o) : 0;
    atomicAdd(&sh.hist[Stream<0>::NO + clampi(lc, 0, Stream<0>::NS - 1)], 1);
    atomicAdd(&sh.hist[Stream<1>::NO + clampi(oc, 0, Stream<1>::NS - 1)], 1);
    atomicAdd(&sh.hist[Stream<2>::NO + clampi(mc, 0, Stream<2>::NS - 1)], 1);
  }
  __syncthreads();
  if (warp == 0)
    huffman_row(a, sh, row, lane);
  else if (warp == 1)
    seq_table<0>(a, sh, row, lane);
  else if (warp == 2)
    seq_table<1>(a, sh, row, lane);
  else if (warp == 3)
    seq_table<2>(a, sh, row, lane);
  __syncthreads();
  if (tid == 0) {
    a.sflags[row] = sh.flags[0] | sh.flags[1] | sh.flags[2];
    a.gain[row] = sh.gain[0] + sh.gain[1] + sh.gain[2];
  }
}

}  // namespace

extern "C" int zk_plan(const int32_t* hist, const int32_t* hist_q,
                       const int32_t* lit_count, const int32_t* n_seq,
                       const int32_t* cnst, const int32_t* lens,
                       const int32_t* ll, const int32_t* ml,
                       const int32_t* offv, const int32_t* tabs, int B, int S,
                       int mode_huf, int mode_huf1, int mode_rawlit,
                       int mode_seq, int32_t* mode, int32_t* mb,
                       int32_t* codes, int32_t* wpk, int32_t* rle,
                       int32_t* sizes4, int32_t* sflags, int32_t* ctabs,
                       int32_t* norms, int32_t* rle_syms, int32_t* gain,
                       cudaStream_t stream) {
  if (B <= 0) return 0;
  const Args a{hist,   hist_q,  lit_count, n_seq,       cnst,     lens,
               ll,     ml,      offv,      tabs,        S,        mode_huf,
               mode_huf1, mode_rawlit, mode_seq, mode,   mb,       codes,
               wpk,    rle,     sizes4,    sflags,      ctabs,    norms,
               rle_syms, gain};
  plan_kernel<<<B, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
