// K2: fused entropy emission per block row.
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_entropy.py
// _entropy_kernel (pallas_call at :645, wrapper entropy_emit_smem :578):
//   * the 4-stream (or, with MODE_HUF1, 1-stream) Huffman literal payload:
//     codes pushed LSB-first in reverse symbol order per stream, streams
//     byte-aligned back to back, literal decode anchors every 512
//     literals;
//   * MODE_RAWLIT: the literal bytes copied verbatim;
//   * MODE_SEQ: the 3-state FSE sequence stream (predefined, RLE or
//     per-block tables with per-stream accuracy logs), its state flushes
//     and sequence decode anchors [bits, ll, of, ml state, rep1] every
//     128 sequences.
// Literals are read straight out of the raw block through the sequence
// list (the run table), as in the reference.
//
// Pushed bit by bit, one thread a row, a literal costs ~340 cycles (its run
// and its code reloaded from L2 and L1 on the dependent chain), so here
// every output bit's position is computed in parallel:
//   * the output buffers are zeroed and the anchors set to -1 by memsets;
//   * tables_kernel (a block of 1024 threads a row): the run table by a
//     block scan of ll and ll + ml, then each literal chunk's code-length
//     sum (csrc/huf_place.cuh, phase 1);
//   * emit_kernel: blocks 0..B-1 emit the rows' sequence streams, the
//     other blocks place one literal chunk each (huf_place.cuh, phase 2, or
//     a raw copy), so the two halves run at once.  A sequence block computes
//     every sequence's codes in parallel, walks the three FSE state chains
//     (ll, of, ml) on three lanes with the row's tables in shared memory,
//     recording each step's state bits, takes each sequence's first bit from
//     a block scan of the widths, then builds the stream word by word: a
//     thread packs the pushes of the sequences its words hold and stores
//     each word whole; rep1 comes from a max-scan of the last explicit
//     offset;
//   * fixup_kernel: the literal chunks' shared edge words (huf_place.cuh).
// No output word has two writers, and no global atomic is used.
// Bound: the bytes (the zeroed buffers) on rows with few literals; on
// literal rows the lookups a literal (its run, byte and code, twice); on
// sequence rows the state chains, one shared-memory load a step.

#include <cstdint>
#include <cuda_runtime.h>

#include "huf_place.cuh"

namespace {

constexpr int MODE_HUF = 1, MODE_RAWLIT = 2, MODE_SEQ = 4, MODE_HUF1 = 8;
constexpr int MODE_LL_RLE = 16, MODE_OF_RLE = 32, MODE_ML_RLE = 64;
constexpr int LL_DEFAULT_LOG = 6, OF_DEFAULT_LOG = 5, ML_DEFAULT_LOG = 6;
constexpr int CT_MAX = 1536;    // a row's sequence-table pack, ints
constexpr int TABS_MAX = 1024;  // the constant tables, ints

// offsets into the constant table pack (ops/entropy.py TAB_OFF)
struct TabOff {
  int ll_code, ml_code, ll_bits, ll_base, ml_bits, ml_base;
};
// offsets into a row's sequence-table pack (ops/entropy.py CTAB_OFF)
struct CtOff {
  int ll_st, ll_dnb, ll_dfs, of_st, of_dnb, of_dfs, ml_st, ml_dnb, ml_dfs;
};

__device__ __forceinline__ int exp_of(int v) {
  int e = 0;
  for (int t = 16; t >= 1; t >>= 1) {
    if ((v >> t) != 0) {
      e += t;
      v >>= t;
    }
  }
  return e;
}

// a row's literal half, phase 1: the run table and the chunk sums
__global__ void __launch_bounds__(1024)
tables_kernel(const uint8_t* __restrict__ x, const int* __restrict__ sll,
              const int* __restrict__ sml, const int* __restrict__ meta,
              const int* __restrict__ codes, int N, int S, int* run_pos,
              int* run_cum, int* cbits, int* parts) {
  __shared__ int ws[32];
  __shared__ int cs[256];
  const int b = blockIdx.x;
  const int* m = meta + 8 * b;
  const int lc = m[1], n = m[2], mode = m[3];
  const hp::Slots SL = hp::slots(N, false);
  for (int i = threadIdx.x; i < 4 * SL.nch; i += blockDim.x)
    parts[(size_t)b * 4 * SL.nch + i] = -1;
  if (!(mode & (MODE_HUF | MODE_RAWLIT))) return;
  const size_t rs = (size_t)b * S;
  int* cum = run_cum + (size_t)b * (S + 1);
  int* pos = run_pos + (size_t)b * (S + 1);
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int j0 = min(n, (int)threadIdx.x * per), j1 = min(n, j0 + per);
  int a = 0, q = 0;
  for (int j = j0; j < j1; ++j) {
    a += sll[rs + j];
    q += sll[rs + j] + sml[rs + j];
  }
  int ta, tq;
  int ea = hp::block_incl(a, ws, &ta) - a;
  int eq = hp::block_incl(q, ws, &tq) - q;
  for (int j = j0; j < j1; ++j) {
    cum[j] = ea;
    pos[j] = eq;
    ea += sll[rs + j];
    eq += sll[rs + j] + sml[rs + j];
  }
  if (threadIdx.x == 0) {
    cum[n] = ta;
    pos[n] = tq;
  }
  if (!(mode & MODE_HUF)) return;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cs[i] = codes[256 * b + i];
  __syncthreads();
  hp::RunSrc src{cum, pos, x + (size_t)b * N, n};
  hp::chunk_sums(src, cs, hp::lay(lc, (mode & MODE_HUF1) != 0), SL,
                 cbits + (size_t)b * SL.nch, ws);
}

struct SeqArgs {
  const int *sll, *sml, *soff, *meta, *tabs, *ctabs;
  int S, SEQW, SMAXA, CTW, CTS, NTABS;   // CTS: ctabs' row stride (0: shared)
  TabOff TO;
  CtOff CO;
  int* scode;        // (B, S): llc | mlc << 8 | ofc << 16
  uint16_t* srec;    // (B, 3, S): a step's state bits nb | bv << 4
  int* sbits;        // (B, S + 1): sequence t's first bit (t = n: the flushes)
  uint32_t* seq_o;
  int *osz, *sanch;
};

// lane k walks one FSE state chain (0: of, 1: ml, 2: ll) over the row's n
// sequences, last to first, as the serial encoder does; it records each
// step's state bits and writes its state anchors
__device__ void state_chain(int k, int n, int mode, const int* ct,
                            const CtOff& CO, const int* code, uint16_t* rec,
                            int* sa, int SMAXA, int* fin) {
  const int sh = k == 0 ? 16 : k == 1 ? 8 : 0;
  const int st = k == 0 ? CO.of_st : k == 1 ? CO.ml_st : CO.ll_st;
  const int dn = k == 0 ? CO.of_dnb : k == 1 ? CO.ml_dnb : CO.ll_dnb;
  const int df = k == 0 ? CO.of_dfs : k == 1 ? CO.ml_dfs : CO.ll_dfs;
  const bool rle =
      (mode & (k == 0 ? MODE_OF_RLE : k == 1 ? MODE_ML_RLE : MODE_LL_RLE)) != 0;
  int tl = (mode >> (k == 0 ? 16 : k == 1 ? 20 : 12)) & 15;
  if (tl == 0) tl = k == 0 ? OF_DEFAULT_LOG : k == 1 ? ML_DEFAULT_LOG
                                                     : LL_DEFAULT_LOG;
  int* arow = sa + (k == 0 ? 2 : k == 1 ? 3 : 1) * SMAXA;
  int c = (code[n - 1] >> sh) & 255;
  int d = ct[dn + c];
  int nb = (d + (1 << 15)) >> 16;
  int s = ct[st + (((nb << 16) - d) >> nb) + ct[df + c]];
  rec[0] = 0;
  if (n - 1 > 0 && ((n - 1) & 127) == 0)
    arow[((n - 1) >> 7) - 1] = s - (1 << tl);
  int cn = n > 1 ? (code[n - 2] >> sh) & 255 : 0;
  for (int t = 1; t < n; ++t) {
    const int i = n - 1 - t;
    d = ct[dn + cn];
    const int f = ct[df + cn];
    cn = i > 0 ? (code[i - 1] >> sh) & 255 : 0;   // the next step's code
    nb = (s + d) >> 16;
    const int bv = s & ((1 << nb) - 1);
    s = ct[st + (s >> nb) + f];
    rec[t] = rle ? (uint16_t)0 : (uint16_t)(nb | bv << 4);
    if (i > 0 && (i & 127) == 0) arow[(i >> 7) - 1] = s - (1 << tl);
  }
  fin[k] = s;
}

// a row's sequence stream (a block of hp::THREADS threads)
__device__ void seq_block(int b, const SeqArgs& A, int* ws) {
  __shared__ int ct[CT_MAX];
  __shared__ int tb[TABS_MAX];
  __shared__ int fin[3];
  const int tid = threadIdx.x;
  const int* m = A.meta + 8 * b;
  const int n = m[2], mode = m[3];
  if (!(mode & MODE_SEQ) || n == 0) return;
  const TabOff& TO = A.TO;
  const int* ctr = A.ctabs + (size_t)b * A.CTS;
  for (int i = tid; i < A.CTW; i += blockDim.x) ct[i] = ctr[i];
  for (int i = tid; i < A.NTABS; i += blockDim.x) tb[i] = A.tabs[i];
  const size_t rs = (size_t)b * A.S;
  const int *ll = A.sll + rs, *ml = A.sml + rs, *of = A.soff + rs;
  int* code = A.scode + rs;
  uint16_t* rec = A.srec + (size_t)b * 3 * A.S;
  uint32_t* so = A.seq_o + (size_t)b * A.SEQW;
  int* sa = A.sanch + (size_t)b * 5 * A.SMAXA;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int ll_v = ll[i], mb = ml[i] - 3;
    const int llc = ll_v > 63 ? exp_of(ll_v) + 19 : tb[TO.ll_code + ll_v];
    const int mlc = mb > 127 ? exp_of(mb) + 36
                             : tb[TO.ml_code + max(mb, 0)];
    code[i] = llc | mlc << 8 | exp_of(of[i]) << 16;
  }
  __syncthreads();
  if (tid < 3)
    state_chain(tid, n, mode, ct, A.CO, code, rec + tid * A.S, sa, A.SMAXA,
                fin);
  __syncthreads();
  // sequence t (emitted t-th, i = n - 1 - t) pushes four fields; a thread
  // takes a contiguous run of t, its bit offset from a scan of the widths
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int t0 = min(n, tid * per), t1 = min(n, t0 + per);
  const uint16_t *r_of = rec, *r_ml = rec + A.S, *r_ll = rec + 2 * A.S;
  int* sb = A.sbits + (size_t)b * (A.S + 1);
  auto width = [&](int t) {
    const int cd = code[n - 1 - t];
    return (r_of[t] & 15) + (r_ml[t] & 15) + (r_ll[t] & 15) +
           tb[TO.ll_bits + (cd & 255)] + tb[TO.ml_bits + ((cd >> 8) & 255)] +
           (cd >> 16);
  };
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += width(t);
  int T;
  int cur = hp::block_incl(sum, ws, &T) - sum;
  for (int t = t0; t < t1; ++t) {
    sb[t] = cur;
    cur += width(t);
    const int i = n - 1 - t;
    if (i > 0 && (i & 127) == 0) sa[(i >> 7) - 1] = cur;
  }
  // the state flushes (ml, of, ll) and the sentinel after the sequences
  const bool rle_ll = (mode & MODE_LL_RLE) != 0;
  const bool rle_of = (mode & MODE_OF_RLE) != 0;
  const bool rle_ml = (mode & MODE_ML_RLE) != 0;
  int tl_ll = (mode >> 12) & 15, tl_of = (mode >> 16) & 15,
      tl_ml = (mode >> 20) & 15;
  if (tl_ll == 0) tl_ll = LL_DEFAULT_LOG;
  if (tl_of == 0) tl_of = OF_DEFAULT_LOG;
  if (tl_ml == 0) tl_ml = ML_DEFAULT_LOG;
  const int nml = rle_ml ? 0 : tl_ml, nof = rle_of ? 0 : tl_of,
            nll = rle_ll ? 0 : tl_ll;
  const int end = T + nml + nof + nll + 1;
  if (tid == 0) {
    sb[n] = T;
    A.osz[8 * b + 4] = (end + 7) >> 3;
  }
  __syncthreads();
  // a thread builds whole words [w0, w1) of the stream: from the sequence
  // holding bit 32 * w0 on, through the flushes if they reach its words
  const int nwd = (end + 31) >> 5, pw = (nwd + blockDim.x - 1) / blockDim.x;
  const int w0 = min(nwd, tid * pw), w1 = min(nwd, w0 + pw);
  if (w0 < w1) {
    int lo = 0, hi = n;   // the last t whose first bit is <= 32 * w0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (sb[mid] <= (w0 << 5)) lo = mid;
      else hi = mid - 1;
    }
    hp::WordOut o(so, sb[lo], w0, w1);
    for (int t = lo; t < n && !o.done(); ++t) {
      const int i = n - 1 - t;
      const int cd = code[i];
      const int llc = cd & 255, mlc = (cd >> 8) & 255, ofc = cd >> 16;
      const int a = r_of[t], bm = r_ml[t], c = r_ll[t];
      const int nof_ = a & 15, nml_ = bm & 15, nll_ = c & 15;
      o.put((uint32_t)((a >> 4) | (bm >> 4) << nof_), nof_ + nml_);
      o.put((uint32_t)((c >> 4) | (ll[i] - tb[TO.ll_base + llc]) << nll_),
            nll_ + tb[TO.ll_bits + llc]);
      o.put((uint32_t)(ml[i] - tb[TO.ml_base + mlc]), tb[TO.ml_bits + mlc]);
      o.put((uint32_t)(of[i] - (1 << ofc)), ofc);
    }
    if (!o.done()) {
      o.put(rle_ml ? 0u : (uint32_t)(fin[1] & ((1 << tl_ml) - 1)), nml);
      o.put(rle_of ? 0u : (uint32_t)(fin[0] & ((1 << tl_of) - 1)), nof);
      o.put(rle_ll ? 0u : (uint32_t)(fin[2] & ((1 << tl_ll) - 1)), nll);
      o.put(1u, 1);
      o.close();
    }
  }
  // rep1 before sequence 128(ka + 1): the last explicitly coded offset
  int last = -1;
  for (int i = t0; i < t1; ++i)
    if (of[i] > 3) last = i;
  const int prev = hp::block_excl_max(last, ws);
  int r1 = prev >= 0 ? of[prev] - 3 : 1;
  for (int i = t0; i < t1; ++i) {
    if (i > 0 && (i & 127) == 0) sa[4 * A.SMAXA + (i >> 7) - 1] = r1;
    if (of[i] > 3) r1 = of[i] - 3;
  }
}

// blocks 0..B-1: the rows' sequence streams; then B * nch blocks, one a
// literal chunk slot of a row
__global__ void __launch_bounds__(hp::THREADS)
emit_kernel(const uint8_t* __restrict__ x, const int* __restrict__ codes,
            int B, int N, int S, int LITW, int LMAXA,
            const int* __restrict__ run_pos, const int* __restrict__ run_cum,
            const int* __restrict__ cbits, int* parts, uint32_t* lit_o,
            int* lanch, SeqArgs A) {
  __shared__ int ws[32];
  __shared__ int cs[256];
  if ((int)blockIdx.x < B) {
    seq_block(blockIdx.x, A, ws);
    return;
  }
  const hp::Slots SL = hp::slots(N, false);
  const int id = blockIdx.x - B;
  const int b = id / SL.nch, j = id % SL.nch;
  const int* m = A.meta + 8 * b;
  const int lc = m[1], n = m[2], mode = m[3];
  int s, c;
  hp::slot_sc(SL, j, s, c);
  uint32_t* lo = lit_o + (size_t)b * LITW;
  hp::RunSrc src{run_cum + (size_t)b * (S + 1), run_pos + (size_t)b * (S + 1),
                 x + (size_t)b * N, n};
  if (mode & MODE_RAWLIT) {
    if (s == 0) {
      if (c == 0 && threadIdx.x == 0) A.osz[8 * b] = lc;
      hp::raw_chunk(src, lc, c, lo);
    }
    return;
  }
  if (!(mode & MODE_HUF)) return;
  const hp::Lay L = hp::lay(lc, (mode & MODE_HUF1) != 0);
  if (s >= L.streams() || c >= L.cps(SL) ||
      (c > 0 && c * hp::CHUNK >= L.count(s)))
    return;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cs[i] = codes[256 * b + i];
  __syncthreads();
  hp::place_chunk(src, cs, L, SL, s, c, cbits + (size_t)b * SL.nch, lo,
                  parts + ((size_t)b * SL.nch + j) * 4, A.osz + 8 * b,
                  lanch + (size_t)b * 4 * LMAXA, LMAXA, ws);
}

// the literal chunks' shared edge words, a block a row
__global__ void fixup_kernel(const int* __restrict__ parts, int N, int LITW,
                             uint32_t* lit_o) {
  const int nch = hp::slots(N, false).nch;
  hp::fixup_row(parts + (size_t)blockIdx.x * 4 * nch, nch,
                lit_o + (size_t)blockIdx.x * LITW);
}

// the scratch, in int32 words: the run table (B, S + 1) twice, the chunk
// sums (B, nch), the sequence codes (B, S), the (B, 3, S) int16 state
// records, the sequences' first bits (B, S + 1), the chunks' edge words
// (B, nch, 4)
struct Scratch {
  size_t run_pos, run_cum, cbits, scode, srec, sbits, parts, words;
};

Scratch scratch_layout(int B, int N, int S) {
  const size_t b = B, s = S, nch = hp::slots(N, false).nch;
  Scratch L;
  size_t at = 0;
  L.run_pos = at;
  at += b * (s + 1);
  L.run_cum = at;
  at += b * (s + 1);
  L.cbits = at;
  at += b * nch;
  L.scode = at;
  at += b * s;
  L.srec = at;
  at += (3 * b * s + 1) / 2;
  L.sbits = at;
  at += b * (s + 1);
  L.parts = at;
  at += b * nch * 4;
  L.words = at;
  return L;
}

}  // namespace

// the int32 words of scratch zk_entropy_emit needs
extern "C" long long zk_entropy_scratch(int B, int N, int S) {
  return (long long)scratch_layout(B, N, S).words;
}

// ctab_stride: ctabs' row stride in ints (0: one table for every row)
extern "C" int zk_entropy_emit(const void* x, const void* sll,
                               const void* sml, const void* soff,
                               const void* meta, const void* codes,
                               const void* tabs, const void* ctabs, int B,
                               int N, int S, int LITW, int SEQW, int LMAXA,
                               int SMAXA, int ctab_stride, const void* offsets,
                               void* scratch, void* lit_o, void* seq_o,
                               void* osz, void* lanch, void* sanch,
                               void* stream) {
  // offsets (host memory): 6 TabOff fields, 9 CtOff fields, CTAB_WIDTH,
  // the constant tables' length
  const int* o = (const int*)offsets;
  if (o[15] > CT_MAX || o[16] > TABS_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t b = (size_t)B;
  cudaError_t e;
  if ((e = cudaMemsetAsync(lit_o, 0, b * LITW * 4, st)) ||
      (e = cudaMemsetAsync(seq_o, 0, b * SEQW * 4, st)) ||
      (e = cudaMemsetAsync(osz, 0, b * 8 * 4, st)) ||
      (e = cudaMemsetAsync(lanch, 0xFF, b * 4 * LMAXA * 4, st)) ||
      (e = cudaMemsetAsync(sanch, 0xFF, b * 5 * SMAXA * 4, st)))
    return (int)e;
  if (B == 0) return 0;
  const Scratch L = scratch_layout(B, N, S);
  int* tmp = (int*)scratch;
  int *run_pos = tmp + L.run_pos, *run_cum = tmp + L.run_cum,
      *cbits = tmp + L.cbits, *parts = tmp + L.parts;
  SeqArgs A;
  A.sll = (const int*)sll;
  A.sml = (const int*)sml;
  A.soff = (const int*)soff;
  A.meta = (const int*)meta;
  A.tabs = (const int*)tabs;
  A.ctabs = (const int*)ctabs;
  A.S = S;
  A.SEQW = SEQW;
  A.SMAXA = SMAXA;
  A.CTW = o[15];
  A.CTS = ctab_stride;
  A.NTABS = o[16];
  A.TO = TabOff{o[0], o[1], o[2], o[3], o[4], o[5]};
  A.CO = CtOff{o[6], o[7], o[8], o[9], o[10], o[11], o[12], o[13], o[14]};
  A.scode = tmp + L.scode;
  A.srec = (uint16_t*)(tmp + L.srec);
  A.sbits = tmp + L.sbits;
  A.seq_o = (uint32_t*)seq_o;
  A.osz = (int*)osz;
  A.sanch = (int*)sanch;
  tables_kernel<<<B, 1024, 0, st>>>(
      (const uint8_t*)x, (const int*)sll, (const int*)sml, (const int*)meta,
      (const int*)codes, N, S, run_pos, run_cum, cbits, parts);
  if ((e = cudaGetLastError())) return (int)e;
  const int nch = hp::slots(N, false).nch;
  emit_kernel<<<B + B * nch, hp::THREADS, 0, st>>>(
      (const uint8_t*)x, (const int*)codes, B, N, S, LITW, LMAXA, run_pos,
      run_cum, cbits, parts, (uint32_t*)lit_o, (int*)lanch, A);
  if ((e = cudaGetLastError())) return (int)e;
  fixup_kernel<<<B, 128, 0, st>>>(parts, N, LITW, (uint32_t*)lit_o);
  return (int)cudaGetLastError();
}
