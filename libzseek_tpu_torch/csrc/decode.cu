// K4: fused zstd block decode (Huffman literals, FSE sequences, repcodes,
// sequence execution).
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_decode.py _decode_kernel
// (:94; wrapper decode_blocks_smem :514, pallas_call at :543) in its
// execute mode.  It takes the reference's packed rows unchanged (lp_words,
// sq_words, dtabs, ftabs, meta; layout at pallas_decode.py:72-76) plus a
// chain layout: the first row of each frame, rows frame-major, and each
// frame's byte offset in one flat uint8 output.
//
// The TPU runs its grid in order and carries the repcodes and a 256 KiB
// output ring from one block to the next.  There is no ring here: a match
// copy reads output already written, so an offset is valid up to the
// bytes produced in the frame so far (the TPU's ring limited it to
// 128 KiB, MAX_OFFSET), and blocks need no word alignment.  A block's
// output offset is the sum of the advances before it in its frame (meta[2]
// is not read), and meta[1] is checked only where it is >= 0 (a raw or
// RLE block's size from its header).
//
// What bounded the first version (5.9 ms at 64 blocks of level 3, 19.1 ms
// at 128 blocks of level 9 on an H100): one warp walked each frame, row
// after row and sequence after sequence, all 32 lanes repeating the same
// FSE step from global memory (1,387 cycles a sequence at level 9), then
// copying each sequence's literals and match with a barrier every 32
// bytes; and 4 lanes a row decoded the Huffman literals with two global
// loads and a table load a symbol (~4 ms of the level-3 launch, whose
// text blocks hold almost no sequences).
//
// This version splits the decode into phases, as the LZ4 decoder does:
//  1. huf_kernel, one CUDA block a row: the row's peek table and literal
//     payload staged in shared memory, lane 0 of warps 0-3 walks the four
//     streams (warp 0 the single stream; a warp each, so one stream's
//     window reload does not stall the others) into a 128 KiB scratch
//     row, peeking from a 64-bit window of two staged words.
//  2. rec_kernel, one warp a row: the row's sequence stream, FSE tables
//     and CTAB staged in shared memory; lane 0 walks the stream once and
//     writes one record a sequence (ll, ml, row-local literal and output
//     positions) and its offset, resolved against the row's repcodes
//     SYMBOLICALLY: a repcode the row inherits is "input slot j minus d"
//     (d counts idx == 4's rep1 - 1).  The row's advance, its exact-
//     consumption verdict and its first literal-bound failure, and its
//     repcode transform (the three output slots, symbolic or concrete)
//     come with them.  Every row of a batch walks at once.
//  3. frame_kernel, a thread a frame: composes its rows' transforms in
//     order (resetting at DMODE_FRAME_START) into each row's input
//     repcodes, and places each row at the sum of the full advances
//     before it.  check_kernel resolves every offset in parallel and
//     marks each row's first sequence whose offset leaves [1, produced]
//     or whose output leaves the frame.  final_kernel, a thread a frame,
//     applies the first failure along the chain exactly as the serial
//     walk does: the advance up to the failing sequence, ok = 0, and
//     [0, 0, 0, 0] for the rest of the chain (no later byte is written).
//  4. expand_kernel writes the literals of every executed sequence and
//     the trailing literals, and gives each match byte the flat index of
//     its source, folded back before the match (dst - off + j % off);
//     pointer doubling resolves the chains and copies from their roots
//     (csrc/pointer_doubling.cuh, shared with the LZ4 decoder).
// The record scratch is sized by the caller from its host copy of the
// rows (seq_total, the sum of meta[:, 13]); a row whose records would
// pass it fails.
//
// Failure: ok = 0 in stat[row] for leftover or missing bits after a
// Huffman stream or the sequence walk (exact consumption), an offset
// code > 31, an offset outside [1, produced], literals past the section
// or output past the frame.  The wrapper raises.
//
// Bound: the bytes moved (payload and tables in, decompressed bytes out).
// What bounds it now (2.5 ms at 64 level-3 blocks, 1.7 ms at 128 level-9
// blocks on an H100, against 5.8 and 18.9 before): the literal section's
// four serial streams a row, ~110 cycles a symbol (a shared-memory table
// load and the peek's shifts a step; 1.9 and 0.9 ms), then at level 9 the
// longest row's record walk (0.35 ms) and the doubling rounds (0.22 ms).
//
// Transcode mode (zk_transcode; the reference's DMODE_TRANSCODE and
// DMODE_LIT_HOST arms, pallas_decode.py:48-54, :426-457, :494-497): the
// kernel decodes Huffman and FSE only and executes nothing.  Each
// sequence becomes one packed 2-word token,
//   w0 = ll | (ml & 0x3FFF) << 18      w1 = off | (ml >> 14) << 28,
// which the host executor (native zn_zir_execute) expands.  Where the
// reference emits a (B, 32768)-word row per block ([literal words][token
// words]) and gathers them densely after (zstd_decode.py _gather_rows
// :926), this writes straight into the two dense arrays at host-computed
// word offsets: a row with literals on the card (HUF4 / HUF1, or DIRECT
// without DMODE_LIT_HOST) writes its (regen + 3) >> 2 literal words at
// lit_prefix[r] (a Huffman row's last word zero past regen), and every
// row its 2 * n_seq token words at tok_prefix[r].
//   * kernel 1 is huf_kernel with those offsets; rows with DMODE_LIT_HOST
//     emit no literals (their Huffman streams decode on the host, or the
//     host holds them raw), and with no literal payload at all (lp null:
//     every row's literals on the host, the codec's default) it does not
//     run;
//   * then every row's sequence section in two kernels, phased as the
//     execute arm's records are: nothing is executed, so only the three
//     repcodes carry from row to row, along a chain (the rows from one
//     DMODE_FRAME_START to the next; the host marks a frame's first row
//     and each chunk start, zstd_decode.py :1033-1043).
//     tc_walk_kernel, one CUDA block a row, every row at once: the row's
//     three FSE tables are staged in shared memory with ctab's baseline
//     and extra-bit count folded in (and a WIDE flag), and the stream
//     words its walk can reach (rows of up to SEQ_STAGE bytes); thread 0
//     walks the stream with the sequence lanes' windowed step (lane_bits
//     .cuh: a sequence's six fields by 64-bit shifts out of the 128 bits
//     below it) and its repcodes SYMBOLIC, as rec_kernel does.  It writes
//     each token's w0 and, for a concrete offset, w1 after checking it;
//     a symbolic offset goes to a per-row list (offset, sequence, limit)
//     with w1's ml bits only.  The row's stat (advance, ok so far) and
//     its repcode transform, taken where the walk stopped, come with it.
//     tc_chain_kernel, one CUDA block a chain: thread 0 composes the
//     chain's transforms into each row's input repcodes (reset at
//     DMODE_FRAME_START), then the block resolves the symbolic offsets,
//     checks them, ORs them into w1 and clears a failing row's ok with
//     one atomicAnd.
// A row's position comes from meta[2] (its offset in its frame, which
// the host predicts), not from a running sum: chunks start mid-frame and
// literal-only blocks never reach the card.  stat[row] = [advance, ok,
// 0, 0]: the advance counts the trailing literals; ok = 0 for a Huffman
// stream not consumed exactly, an offset outside [1, min(op + ll,
// 2^28 - 1)] (op frame-absolute: any offset in the frame that the
// token's 28 bits hold), an offset code > 31 (the walk stops there) or
// a sequence stream not consumed exactly.  As in the reference, a
// failing row still emits its tokens up to where its walk stops and the
// chain walks on with the repcodes it reached; an out-of-range offset
// does not stop the walk, and the literal count is not checked: the
// host checks stat before it executes anything.  Rows outside every
// chain keep the literal pass's stat (or the caller's zeros).
// Bound: bytes (the sequence streams in, 8 bytes of token a sequence
// out).  The first version walked each chain on one thread from global
// memory (8 threads in one warp for 8 frames; such a walk takes
// ~1,500-2,000 cycles a sequence, as the sequence lanes' first version
// did); this one runs every row at once, each at the windowed step's
// ~330 cycles a sequence (the sequence lanes' tagged arm), so a launch
// takes about its longest row.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_bits.cuh"
#include "pointer_doubling.cuh"

namespace {

constexpr int DMODE_HUF4 = 1;
constexpr int DMODE_HUF1 = 2;
constexpr int DMODE_DIRECT = 4;
constexpr int DMODE_SEQ = 8;
constexpr int DMODE_FRAME_START = 16;
constexpr int DMODE_LIT_HOST = 64;
constexpr int MAX_TOKEN_OFFSET = 0x0FFFFFFF;   // the token's 28 bits
constexpr int HUF_PEEK = 12;
constexpr int DT_SIZE = 1 << HUF_PEEK;
constexpr int META_W = 16;
constexpr int LIT_MAX = 1 << 17;   // literal scratch row (128 KiB)
constexpr int HUF_THREADS = 128;
constexpr int HUF_STAGE = 160 * 1024;   // literal payload bytes staged
constexpr int SEQ_STAGE = 96 * 1024;    // sequence stream bytes staged
constexpr int CHECK_SPLIT = 4;          // CUDA blocks a row
constexpr int EXPAND_SPLIT = 8;
constexpr int EXPAND_THREADS = 256;
constexpr int NO_FAIL = 0x7FFFFFFF;
constexpr int TC_THREADS = 128;         // transcode: threads a row or chain
constexpr int TC_STAGE = SEQ_STAGE;     // stream bytes a row walk stages

// ctab layout (ops/decode.py CTAB): LL bits | LL base | ML bits | ML base
constexpr int N_LL = 36;
constexpr int N_ML = 53;
constexpr int C_LL_BITS = 0;
constexpr int C_LL_BASE = N_LL;
constexpr int C_ML_BITS = 2 * N_LL;
constexpr int C_ML_BASE = 2 * N_LL + N_ML;
constexpr int N_CTAB = 2 * N_LL + 2 * N_ML;
constexpr int FT_SIZE = 1536;           // a row's LL | OF | ML tables
// the most dynamic shared memory huf_kernel and rec_kernel launch with.
// Their attributes are set to these, not to a launch's own size: an
// attribute is the kernel's, shared by the reader's threads, and one
// thread lowering it under another's larger launch fails that launch.
constexpr int HUF_SMEM_MAX = (DT_SIZE + HUF_STAGE / 4) * 4;
constexpr int SEQ_SMEM_MAX = (FT_SIZE + N_CTAB + 2 + SEQ_STAGE / 4) * 4;
constexpr int TC_SMEM_MAX = TC_STAGE + 2 * lanebits::PAD * 4;

// a row's summary (int32, RI_W a row): written by rec_kernel (NWALK ..
// LPOS, REC), frame_kernel (BASE, FSZ, FOFF), check_kernel (FAIL) and
// final_kernel (NEXEC, TRAIL)
constexpr int RI_NWALK = 0;   // sequences decoded (the walk stops at an
                              // offset code > 31)
constexpr int RI_EXACT = 1;   // walked all n_seq and consumed exactly
constexpr int RI_FAIL = 2;    // first failing sequence, or NO_FAIL
constexpr int RI_OP = 3;      // output bytes of the walked sequences
constexpr int RI_LPOS = 4;    // literals they take
constexpr int RI_REC = 5;     // first record
constexpr int RI_BASE = 6;    // position in the frame if every row before
                              // it succeeds
constexpr int RI_FSZ = 7;     // the frame's size
constexpr int RI_FOFF = 8;    // the frame's offset in the output
constexpr int RI_NEXEC = 9;   // sequences executed
constexpr int RI_TRAIL = 10;  // trailing literals written
constexpr int RI_W = 12;

// symbolic repcodes: SYM + (j << SYM_SH) - d is "input slot j minus d"
// (d < 2^SYM_SH), so rep1 - 1 is one subtraction for concrete and
// symbolic slots alike; concrete values stay far below SYM
constexpr long long SYM = 1LL << 40;
constexpr int SYM_SH = 20;

__device__ __forceinline__ int clampi(long long v) {
  return v > 0x7FFFFFFFLL ? 0x7FFFFFFF : (int)v;
}

// word sources for the bit reads: a row in global memory, or a row whose
// first SW words are staged in shared memory
struct GRow {
  const uint32_t* g;
  int W;
  __device__ __forceinline__ uint32_t word(int q) const { return g[q]; }
};

struct SRow {
  const uint32_t* g;
  const uint32_t* s;
  int W, SW;
  __device__ __forceinline__ uint32_t word(int q) const {
    return q < SW ? s[q] : g[q];
  }
};

// LE32 starting at byte b of a row of W words (indices clamped to the row)
template <class RW>
__device__ __forceinline__ uint32_t u32_at(const RW& r, int b) {
  const int q = min(b >> 2, r.W - 1);
  const int sh = (b & 3) * 8;
  const uint32_t lo = r.word(q);
  const uint32_t hi = r.word(min(q + 1, r.W - 1));
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}

// bits [a, a + nb) of the row, nb <= 16; bits below bit 0 read as zero
// (the last symbols of a valid backward stream peek past its start)
template <class RW>
__device__ __forceinline__ int read_at(const RW& r, int a, int nb) {
  const uint32_t mask = (1u << nb) - 1u;
  if (a >= 0) return (int)((u32_at(r, a >> 3) >> (a & 7)) & mask);
  const int under = min(-a, 31);
  return (int)((u32_at(r, 0) << under) & mask);
}

// a staged row read through a 64-bit window of two words.  A reload puts
// the read near the window's top: backward streams read downward, so the
// window then serves the next reads too.  A read that would reach the
// row's last word or below bit 0 takes read_at's clamped path, so every
// value equals read_at's.
struct WRow {
  SRow r;
  unsigned long long w;
  int wb;   // the window's first bit
  __device__ __forceinline__ int read(int a, int nb) {
    const int mask = (1 << nb) - 1;
    if (a >= wb && a + nb <= wb + 64) return (int)(w >> (a - wb)) & mask;
    const int q = ((a + 16) >> 5) - 1;
    if (a >= 0 && q >= 0 && a + 16 <= 32 * (r.W - 1)) {
      w = r.word(q) | ((unsigned long long)r.word(q + 1) << 32);
      wb = q << 5;
      return (int)(w >> (a - wb)) & mask;
    }
    return read_at(r, a, nb);
  }
};

__device__ __forceinline__ WRow wrow(const SRow& r) {
  return WRow{r, 0, -(1 << 30)};
}

// bits [a, a + nb) of a stream, nb <= 16: a row in global memory, or a
// staged one through its window
template <class RW>
__device__ __forceinline__ int rd(RW& r, int a, int nb) {
  return read_at(r, a, nb);
}

__device__ __forceinline__ int rd(WRow& r, int a, int nb) {
  return r.read(a, nb);
}

// nb <= 32 (an offset code reaches 31): two reads of <= 16 bits
template <class RW>
__device__ __forceinline__ uint32_t rd_wide(RW& r, int a, int nb) {
  const int lo_nb = min(nb, 16);
  const uint32_t lo = (uint32_t)rd(r, a, lo_nb);
  const uint32_t hi = (uint32_t)rd(r, a + 16, nb - lo_nb);
  return lo | (hi << 16);
}

// The FSE sequence stream of one row (RFC 8878 §3.1.1.3.2), walked
// backward from bit meta[12]: three states, one (ll, ml, offset value) a
// step.
template <class RW>
struct SeqStream {
  RW row;
  const int* ft;   // the row's LL | OF | ML tables
  int pos, s_ll, s_of, s_ml;
};

template <class RW>
__device__ __forceinline__ SeqStream<RW> seq_open(RW row, const int* ft,
                                                  const int* m) {
  const int tlp = m[14];
  const int tl_ll = tlp & 255, tl_of = (tlp >> 8) & 255,
            tl_ml = (tlp >> 16) & 255;
  SeqStream<RW> z{row, ft, m[12], 0, 0, 0};
  z.s_ll = rd(z.row, z.pos - tl_ll, tl_ll);
  z.pos -= tl_ll;
  z.s_of = rd(z.row, z.pos - tl_of, tl_of);
  z.pos -= tl_of;
  z.s_ml = rd(z.row, z.pos - tl_ml, tl_ml);
  z.pos -= tl_ml;
  return z;
}

// Decode the next sequence and, unless it is the last, advance the three
// states.  false for an offset code > 31: the walk stops there.  The
// caller checks exact consumption (z.pos == 0) after the last step.
template <class RW>
__device__ __forceinline__ bool seq_next(SeqStream<RW>& z, const int* ctab,
                                         bool last, int& ll, int& ml,
                                         long long& ofv) {
  const int e_ll = z.ft[z.s_ll];
  const int e_of = z.ft[512 + z.s_of];
  const int e_ml = z.ft[1024 + z.s_ml];
  const int llc = min(e_ll & 255, N_LL - 1);
  const int ofc = e_of & 255;
  const int mlc = min(e_ml & 255, N_ML - 1);
  if (ofc > 31) return false;
  const long long of_extra = rd_wide(z.row, z.pos - ofc, ofc);
  z.pos -= ofc;
  ofv = (1LL << min(ofc, 30)) + of_extra;
  const int mlb = ctab[C_ML_BITS + mlc];
  ml = ctab[C_ML_BASE + mlc] + rd(z.row, z.pos - mlb, mlb);
  z.pos -= mlb;
  const int llb = ctab[C_LL_BITS + llc];
  ll = ctab[C_LL_BASE + llc] + rd(z.row, z.pos - llb, llb);
  z.pos -= llb;
  if (!last) {   // state updates: LL, ML, OF
    const int nb_ll = (e_ll >> 8) & 255;
    z.s_ll = (e_ll >> 16) + rd(z.row, z.pos - nb_ll, nb_ll);
    z.pos -= nb_ll;
    const int nb_ml = (e_ml >> 8) & 255;
    z.s_ml = (e_ml >> 16) + rd(z.row, z.pos - nb_ml, nb_ml);
    z.pos -= nb_ml;
    const int nb_of = (e_of >> 8) & 255;
    z.s_of = (e_of >> 16) + rd(z.row, z.pos - nb_of, nb_of);
    z.pos -= nb_of;
  }
  return true;
}

// the offset of a sequence against the repcodes (RFC 8878 §3.1.1.5),
// rep updated in place; concrete or symbolic slots alike
__device__ __forceinline__ long long rep_apply(long long ofv, int ll,
                                               long long& rep1,
                                               long long& rep2,
                                               long long& rep3) {
  const long long idx = ofv + (ll == 0 ? 1 : 0);
  long long off;
  if (ofv > 3) {
    off = ofv - 3;
    rep3 = rep2;
    rep2 = rep1;
  } else if (idx == 1) {
    off = rep1;
  } else if (idx == 2) {
    off = rep2;
    rep2 = rep1;
  } else if (idx == 3) {
    off = rep3;
    rep3 = rep2;
    rep2 = rep1;
  } else {
    off = rep1 - 1;
    rep3 = rep2;
    rep2 = rep1;
  }
  rep1 = off;
  return off;
}

// a slot against the row's input repcodes
__device__ __forceinline__ long long resolve(long long v,
                                             const long long* in) {
  if (v < SYM / 2) return v;
  const long long u = v - SYM;
  const long long j = (u + (1LL << SYM_SH) - 1) >> SYM_SH;
  return in[j] - ((j << SYM_SH) - u);
}

// Transcode mode's row walk (tc_walk_kernel's thread 0): where its tokens
// go, and what it leaves for the chain kernel
struct TcOut {
  uint2* tok;         // the row's tokens (w0, w1)
  long long* sym;     // its symbolic offsets: (offset, t << 32 | limit)
  long long base;     // meta[2], the row's offset in its frame
};

struct TcWalk {
  // the repcode transform where the walk stopped (the identity before it)
  long long r1 = SYM, r2 = SYM + (1LL << SYM_SH), r3 = SYM + (2LL << SYM_SH);
  long long op = 0, lpos = 0;  // output bytes, literals of the sequences
  int ns = 0;                  // symbolic offsets listed
  bool ok = true;              // consumed exactly, concrete offsets in range
};

// the exact entry of table k at state s and its folded half, from the
// row's tables in global memory (unclamped: the first version's reads)
__device__ __forceinline__ uint2 tc_entry(const int* ftg, const int* ct,
                                          int k, int s) {
  const int e = ftg[k * lanebits::FSE_TAB + s];
  return make_uint2((uint32_t)e, lanebits::fold(ct, k, e));
}

// One row's sequence stream with its repcodes symbolic: the windowed
// step of the sequence lanes (lane_bits.cuh) over `src`, the row's stream
// words (staged or global), and its tables staged in `tab`.  A step whose
// entries are WIDE (an offset code above 31, a state read above
// NARROW_NB bits), whose states lie outside [0, 512) or whose position
// lies past the row's last bit reloads its entries from ftg and reads its
// fields through read_at on G, as seq_open / seq_next do, so every value
// equals theirs; an offset code above 31 stops the walk there.
template <class Words>
__device__ __forceinline__ TcWalk tc_walk(const Words& src, const GRow G,
                                          const uint2* tab, const int* ftg,
                                          const int* ct, const int* m,
                                          const TcOut& o) {
  using lanebits::FSE_TAB;
  const int n_seq = m[13];
  const int tlp = m[14];
  const int tl_ll = tlp & 255, tl_of = (tlp >> 8) & 255,
            tl_ml = (tlp >> 16) & 255;
  int pos = m[12];
  int s_ll = rd(G, pos - tl_ll, tl_ll);
  pos -= tl_ll;
  int s_of = rd(G, pos - tl_of, tl_of);
  pos -= tl_of;
  int s_ml = rd(G, pos - tl_ml, tl_ml);
  pos -= tl_ml;
  // past the row's words read_at repeats its last one; the window reads
  // zeros there, so a step starting above the row takes read_at
  const int end_bits = 32 * G.W;
  TcWalk w;
  unsigned long long X, Y;
  lanebits::window(src, pos, X, Y);
  int t = 0;
  for (; t < n_seq; ++t) {
    uint2 a = tab[s_ll & (FSE_TAB - 1)];
    uint2 b = tab[FSE_TAB + (s_of & (FSE_TAB - 1))];
    uint2 c = tab[2 * FSE_TAB + (s_ml & (FSE_TAB - 1))];
    const bool fast = (unsigned)(s_ll | s_of | s_ml) < (unsigned)FSE_TAB &&
                      !((a.y | b.y | c.y) & lanebits::WIDE) &&
                      pos <= end_bits;
    if (!fast) {
      a = tc_entry(ftg, ct, 0, s_ll);
      b = tc_entry(ftg, ct, 1, s_of);
      c = tc_entry(ftg, ct, 2, s_ml);
      if ((b.x & 255u) > 31u) break;   // an offset code > 31 stops the walk
    }
    const int um = t < n_seq - 1 ? 0xFF : 0;    // the states update
    const int ofc = (int)(b.x & 255u);
    const int mlb = (int)((c.y >> 24) & 31u);
    const int llb = (int)((a.y >> 24) & 31u);
    const int nll = (int)(a.x >> 8) & um;
    const int nml = (int)(c.x >> 8) & um;
    const int nof = (int)(b.x >> 8) & um;
    const int d1 = ofc, d2 = d1 + mlb, d3 = d2 + llb;
    const int e1 = nll, e2 = e1 + nml, e3 = e2 + nof;
    const int p3 = pos - d3;
    uint32_t xo, xm, xl, yl, ym, yo;
    if (fast) {     // d3 <= 63 and e3 <= 33
      lanebits::window_fields(X, Y, ofc, mlb, llb, nll, nml, nof, xo, xm,
                              xl, yl, ym, yo);
    } else {
      xo = rd_wide(G, pos - d1, ofc);
      xm = (uint32_t)rd(G, pos - d2, mlb);
      xl = (uint32_t)rd(G, p3, llb);
      yl = (uint32_t)rd(G, p3 - e1, nll);
      ym = (uint32_t)rd(G, p3 - e2, nml);
      yo = (uint32_t)rd(G, p3 - e3, nof);
    }
    pos = p3 - e3;
    lanebits::window(src, pos, X, Y);
    const long long ofv = (1LL << min(ofc, 30)) + (long long)xo;
    const int ml = (int)(c.y & 0xFFFFFFu) + (int)xm;
    const int ll = (int)(a.y & 0xFFFFFFu) + (int)xl;
    const long long off = rep_apply(ofv, ll, w.r1, w.r2, w.r3);
    if (um) {
      s_ll = ((int)a.x >> 16) + (int)yl;
      s_ml = ((int)c.x >> 16) + (int)ym;
      s_of = ((int)b.x >> 16) + (int)yo;
    }
    const long long lim =
        min(o.base + w.op + ll, (long long)MAX_TOKEN_OFFSET);
    uint32_t w1 = (uint32_t)(ml >> 14) << 28;
    if (off < SYM / 2) {   // concrete: checked here
      w.ok = w.ok && off >= 1 && off <= lim;
      w1 |= (uint32_t)off;
    } else {               // symbolic: the chain kernel resolves it
      o.sym[2 * w.ns] = off;
      o.sym[2 * w.ns + 1] = ((long long)t << 32) | (uint32_t)(int)lim;
      ++w.ns;
    }
    o.tok[t] = make_uint2((uint32_t)ll | ((uint32_t)(ml & 0x3FFF) << 18),
                          w1);
    w.op += ll + ml;
    w.lpos += ll;
  }
  // stopped (the row's later tokens zero, as the plain version leaves
  // them), or the stream not consumed exactly
  for (int u = t; u < n_seq; ++u) o.tok[u] = make_uint2(0u, 0u);
  if (t < n_seq || pos != 0) w.ok = false;
  return w;
}

// lit_prefix null (execute mode): a Huffman row's literals go to its
// LIT_MAX scratch row.  Else (transcode mode): every row with literals on
// the card writes them at lit_prefix[r] words of the dense output, whole
// words as the reference does (a DIRECT row copies its payload words);
// DMODE_LIT_HOST rows write nothing.  A Huffman row stages its peek table
// and the first HUF_STAGE bytes of its payload in shared memory.
__global__ void __launch_bounds__(HUF_THREADS) huf_kernel(
    const uint32_t* __restrict__ lp, int LPW, const int* __restrict__ dtabs,
    const int* __restrict__ meta, const int* __restrict__ lit_prefix,
    uint8_t* __restrict__ lits, int* stat) {
  extern __shared__ uint32_t hsm[];   // peek table, then payload words
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int st = tid >> 5;   // the stream lane 0 of warp st decodes
  const int* m = meta + (size_t)r * META_W;
  const int mode = lit_prefix && (m[0] & DMODE_LIT_HOST) ? 0 : m[0];
  const int regen = m[3];
  __shared__ int ok_s;
  const bool huf4 = (mode & DMODE_HUF4) != 0;
  const bool huf1 = (mode & DMODE_HUF1) != 0;
  const bool decode = (huf4 || huf1) && regen <= LIT_MAX;
  uint8_t* row_lits = lit_prefix ? lits + 4LL * lit_prefix[r]
                                 : lits + (size_t)r * LIT_MAX;
  const uint32_t* row = lp + (size_t)r * LPW;
  const int SW = decode ? min(LPW, HUF_STAGE / 4) : 0;
  if (tid == 0) ok_s = 1;
  if (decode) {
    const int* dt = dtabs + (size_t)r * DT_SIZE;
    for (int i = tid; i < DT_SIZE; i += blockDim.x) hsm[i] = (uint32_t)dt[i];
    for (int i = tid; i < SW; i += blockDim.x) hsm[DT_SIZE + i] = row[i];
  }
  __syncthreads();
  if ((huf4 || huf1) && regen > LIT_MAX) {
    if (tid == 0) ok_s = 0;
  } else if (lit_prefix && !huf4 && !huf1 && (mode & DMODE_DIRECT)) {
    if (regen > 4 * LPW) {
      if (tid == 0) ok_s = 0;
    } else {
      // whole words, as the reference copies them
      const uint8_t* src = (const uint8_t*)row;
      const int nb = 4 * ((regen + 3) >> 2);
      for (int j = tid; j < nb; j += blockDim.x) row_lits[j] = src[j];
    }
  } else if ((tid & 31) == 0 && ((huf4 && st < 4) || (huf1 && st == 0))) {
    const SRow R{row, hsm + DT_SIZE, LPW, SW};
    const int* dt = (const int*)hsm;
    uint8_t* dst = row_lits;
    int n_out = regen;
    if (huf4) {
      const int per = (regen + 3) >> 2;
      n_out = st < 3 ? per : max(regen - 3 * per, 0);
      dst += st * per;
    }
    int pos = m[4 + st];
    const int base8 = m[8 + st] * 8;
    // peeks from a 64-bit window of two staged words, sh bits above its
    // first bit: a symbol's shift is one subtraction; the window reloads
    // below the peek when sh runs negative (WRow's rule), and a peek near
    // the row's last word or below bit 0 takes read_at's clamped path
    unsigned long long w = 0;
    int sh = -1;
    for (int i = 0; i < n_out; ++i) {
      int v;
      if (sh >= 0) {
        v = (int)(w >> sh) & (DT_SIZE - 1);
      } else {
        const int a = base8 + pos - HUF_PEEK;
        const int q = ((a + 16) >> 5) - 1;
        if (a >= 0 && q >= 0 && a + 16 <= 32 * (LPW - 1)) {
          w = R.word(q) | ((unsigned long long)R.word(q + 1) << 32);
          sh = a - (q << 5);
          v = (int)(w >> sh) & (DT_SIZE - 1);
        } else {
          v = read_at(R, a, HUF_PEEK);
        }
      }
      const int e = dt[v];
      pos -= e >> 8;
      sh -= e >> 8;
      dst[i] = (uint8_t)(e & 255);
    }
    if (pos != 0) atomicAnd(&ok_s, 0);
  }
  __syncthreads();
  if (tid < 4) stat[4 * r + tid] = tid == 1 ? ok_s : 0;
}

// Execute mode, phase 2: one warp a row (see the header).
__global__ void rec_kernel(const uint32_t* __restrict__ sq, int SQW,
                           const int* __restrict__ ftabs,
                           const int* __restrict__ meta,
                           const int* __restrict__ ctab, long long seq_total,
                           int4* __restrict__ rec, long long* __restrict__ sym,
                           int* __restrict__ rinfo,
                           long long* __restrict__ xform) {
  extern __shared__ uint32_t ssm[];   // ftab, ctab, then stream words
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int* m = meta + (size_t)r * META_W;
  const int mode = m[0], regen = m[3], n_seq = m[13];
  // this row's first record: the sequences of the rows before it
  long long rec0 = 0;
  for (int u = lane; u < r; u += 32)
    rec0 += max(meta[(size_t)u * META_W + 13], 0);
  for (int o = 16; o > 0; o >>= 1)
    rec0 += __shfl_xor_sync(0xFFFFFFFFu, rec0, o);
  const bool has = (mode & DMODE_SEQ) && n_seq > 0;
  int* ri = rinfo + (size_t)r * RI_W;
  long long* xf = xform + 3 * (size_t)r;
  if (!has || rec0 + n_seq > seq_total) {
    if (lane == 0) {
      ri[RI_NWALK] = 0;
      ri[RI_EXACT] = 1;
      ri[RI_FAIL] = has ? 0 : NO_FAIL;   // no room for its records
      ri[RI_OP] = 0;
      ri[RI_LPOS] = 0;
      ri[RI_REC] = 0;
      xf[0] = SYM;
      xf[1] = SYM + (1LL << SYM_SH);
      xf[2] = SYM + (2LL << SYM_SH);
    }
    return;
  }
  int* ft = (int*)ssm;
  int* ct = ft + FT_SIZE;
  uint32_t* words = ssm + FT_SIZE + N_CTAB + 2;
  const int SW = min(SQW, SEQ_STAGE / 4);
  const int* ftg = ftabs + (size_t)r * FT_SIZE;
  const uint32_t* row = sq + (size_t)r * SQW;
  for (int i = lane; i < FT_SIZE; i += 32) ft[i] = ftg[i];
  for (int i = lane; i < N_CTAB; i += 32) ct[i] = ctab[i];
  for (int i = lane; i < SW; i += 32) words[i] = row[i];
  __syncwarp();
  if (lane != 0) return;
  SeqStream<WRow> z = seq_open(wrow(SRow{row, words, SQW, SW}), ft, m);
  long long r1 = SYM, r2 = SYM + (1LL << SYM_SH), r3 = SYM + (2LL << SYM_SH);
  long long op = 0, lpos = 0;
  int fail = NO_FAIL, t = 0;
  int4* rc = rec + rec0;
  long long* sy = sym + rec0;
  for (; t < n_seq; ++t) {
    int ll, ml;
    long long ofv;
    if (!seq_next(z, ct, t == n_seq - 1, ll, ml, ofv)) {
      fail = min(fail, t);   // an offset code > 31 stops the walk
      break;
    }
    sy[t] = rep_apply(ofv, ll, r1, r2, r3);
    if (fail == NO_FAIL && lpos + ll > regen) fail = t;
    rc[t] = make_int4(ll, ml, clampi(lpos), clampi(op));
    op += ll + ml;
    lpos += ll;
  }
  ri[RI_NWALK] = t;
  ri[RI_EXACT] = t == n_seq && z.pos == 0;
  ri[RI_FAIL] = fail;
  ri[RI_OP] = clampi(op);
  ri[RI_LPOS] = clampi(lpos);
  ri[RI_REC] = (int)rec0;
  xf[0] = r1;
  xf[1] = r2;
  xf[2] = r3;
}

// Phase 3a: a thread a frame, its rows in order: input repcodes and the
// row's place if every row before it succeeds.
__global__ void frame_kernel(int F, const int* __restrict__ meta,
                             const int* __restrict__ chain,
                             const long long* __restrict__ frame_off,
                             int* __restrict__ rinfo,
                             const long long* __restrict__ xform,
                             long long* __restrict__ instate) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  long long st[3] = {1, 4, 8};
  long long base = 0;
  const long long fsz = frame_off[f + 1] - frame_off[f];
  for (int r = chain[f]; r < chain[f + 1]; ++r) {
    const int* m = meta + (size_t)r * META_W;
    if (m[0] & DMODE_FRAME_START) {
      st[0] = 1;
      st[1] = 4;
      st[2] = 8;
    }
    long long* in = instate + 3 * (size_t)r;
    const long long* xf = xform + 3 * (size_t)r;
    for (int j = 0; j < 3; ++j) in[j] = st[j];
    for (int j = 0; j < 3; ++j) st[j] = resolve(xf[j], in);
    int* ri = rinfo + (size_t)r * RI_W;
    ri[RI_BASE] = clampi(base);
    ri[RI_FSZ] = clampi(fsz);
    ri[RI_FOFF] = (int)frame_off[f];
    base += (long long)ri[RI_OP] + max((long long)m[3] - ri[RI_LPOS], 0LL);
  }
}

// Phase 3b: every walked sequence's offset resolved and checked; the
// row's first failure by atomicMin.  grid (B, CHECK_SPLIT)
__global__ void check_kernel(const int4* __restrict__ rec,
                             const long long* __restrict__ sym,
                             const long long* __restrict__ instate,
                             int* __restrict__ rinfo,
                             int* __restrict__ res_off) {
  const int r = blockIdx.x;
  int* ri = rinfo + (size_t)r * RI_W;
  const int n = min(ri[RI_NWALK], ri[RI_FAIL]);
  const long long base = ri[RI_BASE], fsz = ri[RI_FSZ];
  const long long in[3] = {instate[3 * r], instate[3 * r + 1],
                           instate[3 * r + 2]};
  const long long rec0 = ri[RI_REC];
  for (int t = blockIdx.y * blockDim.x + threadIdx.x; t < n;
       t += gridDim.y * blockDim.x) {
    const int4 q = rec[rec0 + t];
    const long long off = resolve(sym[rec0 + t], in);
    const long long op = base + q.w;
    res_off[rec0 + t] = (int)max(min(off, 0x7FFFFFFFLL), 0LL);
    if (off < 1 || off > op + q.x || op + q.x + q.y > fsz)
      atomicMin(ri + RI_FAIL, t);
  }
}

// Phase 3c: a thread a frame, the serial walk's verdicts along the chain
__global__ void final_kernel(int F, int LPW, const int* __restrict__ meta,
                             const int* __restrict__ chain,
                             const int4* __restrict__ rec,
                             int* __restrict__ rinfo, int* stat) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  bool dead = false;
  for (int r = chain[f]; r < chain[f + 1]; ++r) {
    int* st = stat + 4 * r;
    int* ri = rinfo + (size_t)r * RI_W;
    if (dead) {
      st[0] = st[1] = st[2] = st[3] = 0;
      ri[RI_NEXEC] = 0;
      ri[RI_TRAIL] = 0;
      continue;
    }
    const int* m = meta + (size_t)r * META_W;
    const int mode = m[0], regen = m[3], n_seq = m[13];
    bool ok = st[1] != 0;   // the literal section's verdict (huf_kernel)
    if ((mode & DMODE_DIRECT) && regen > 4 * LPW) ok = false;
    const bool has = (mode & DMODE_SEQ) && n_seq > 0;
    long long adv = 0;
    int nx = 0, tr = 0;
    if (ok && has) {
      const int tf = ri[RI_FAIL];
      if (tf < n_seq) {
        ok = false;
        nx = tf;
        adv = tf < ri[RI_NWALK] ? rec[(long long)ri[RI_REC] + tf].w
                                : ri[RI_OP];
      } else {
        nx = n_seq;
        adv = ri[RI_OP];
        if (!ri[RI_EXACT]) ok = false;
      }
    }
    if (ok) {
      const long long trail = max((long long)regen - (has ? ri[RI_LPOS] : 0),
                                  0LL);
      if (ri[RI_BASE] + adv + trail > ri[RI_FSZ]) {
        ok = false;
      } else {
        tr = (int)trail;
        adv += trail;
      }
    }
    if (ok && m[1] >= 0 && adv != m[1]) ok = false;
    st[0] = (int)adv;
    st[1] = ok ? 1 : 0;
    st[2] = 0;
    st[3] = 0;
    ri[RI_NEXEC] = nx;
    ri[RI_TRAIL] = tr;
    dead = !ok;
  }
}

// Phase 4: grid (B, EXPAND_SPLIT).  Literal bytes go to the output; each
// match byte's srcs entry names its source (srcs holds -1 elsewhere).
__global__ void __launch_bounds__(EXPAND_THREADS) expand_kernel(
    const uint32_t* __restrict__ lp, int LPW, const int* __restrict__ meta,
    const uint8_t* __restrict__ lits, const int4* __restrict__ rec,
    const int* __restrict__ res_off, const int* __restrict__ rinfo,
    uint8_t* __restrict__ out, int* __restrict__ srcs) {
  const int r = blockIdx.x;
  const int* ri = rinfo + (size_t)r * RI_W;
  const int nx = ri[RI_NEXEC], tr = ri[RI_TRAIL];
  if (nx == 0 && tr == 0) return;
  const int mode = meta[(size_t)r * META_W];
  const uint8_t* lit = (mode & DMODE_DIRECT)
                           ? (const uint8_t*)(lp + (size_t)r * LPW)
                           : lits + (size_t)r * LIT_MAX;
  const long long dst0 = (long long)ri[RI_FOFF] + ri[RI_BASE];
  const long long rec0 = ri[RI_REC];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.y * (EXPAND_THREADS / 32);
  for (int t = blockIdx.y * (EXPAND_THREADS / 32) + threadIdx.x / 32; t < nx;
       t += warps) {
    const int4 q = rec[rec0 + t];
    const long long d = dst0 + q.w;
    for (int j = lane; j < q.x; j += 32) out[d + j] = lit[q.z + j];
    const long long md = d + q.x;
    const int off = res_off[rec0 + t];
    for (int j = lane; j < q.y; j += 32)
      srcs[md + j] = (int)(md - off + (off < q.y ? j % off : j));
  }
  if (tr > 0) {
    const bool has = (mode & DMODE_SEQ) && meta[(size_t)r * META_W + 13] > 0;
    const long long td = dst0 + (has ? ri[RI_OP] : 0);
    const uint8_t* ts = lit + (has ? ri[RI_LPOS] : 0);
    for (int i = blockIdx.y * EXPAND_THREADS + threadIdx.x; i < tr;
         i += gridDim.y * EXPAND_THREADS)
      out[td + i] = ts[i];
  }
}

// Transcode mode, phase 1: a block a row (see the header).  rowx (B, 4)
// int64: the row's repcode transform (three slots, symbolic or concrete),
// then its count of symbolic offsets; syms: the row's list at
// tok_prefix[r] / 2 pairs, (offset, sequence << 32 | limit).
// lits_on_card 0: huf_kernel did not run (every row's literals stay on
// the host), so a row starts from ok = 1 unless it asks for card
// literals.
__global__ void __launch_bounds__(TC_THREADS) tc_walk_kernel(
    int lits_on_card, const uint32_t* __restrict__ sq, int SQW,
    const int* __restrict__ ftabs, const int* __restrict__ meta,
    const int* __restrict__ chain, int C, const int* __restrict__ ctab,
    const int* __restrict__ tok_prefix, uint32_t* __restrict__ toks,
    int* stat, long long* __restrict__ rowx, long long* __restrict__ syms) {
  __shared__ uint2 tab[3 * lanebits::FSE_TAB];
  __shared__ int ct[N_CTAB];
  extern __shared__ uint32_t tstage[];   // PAD zeros, words, PAD zeros
  const int r = blockIdx.x;
  if (r < chain[0] || r >= chain[C]) return;   // outside every chain
  const int* m = meta + (size_t)r * META_W;
  const int mode = m[0], regen = m[3], n_seq = m[13];
  const bool has = (mode & DMODE_SEQ) && n_seq > 0;
  const int* ftg = ftabs + (size_t)r * FT_SIZE;
  const uint32_t* row = sq + (size_t)r * SQW;
  // the walk starts below meta[12] and never climbs, so its windows end
  // by word meta[12] / 32: the words above stay unstaged
  const int reach = min(SQW, max(m[12], 0) / 32 + 2);
  const bool staged = reach <= TC_STAGE / 4;
  if (has) {
    for (int i = threadIdx.x; i < N_CTAB; i += blockDim.x) ct[i] = ctab[i];
    if (staged) {
      if (threadIdx.x < lanebits::PAD) {
        tstage[threadIdx.x] = 0u;
        tstage[lanebits::PAD + reach + threadIdx.x] = 0u;
      }
      for (int i0 = threadIdx.x; i0 < reach;
           i0 += TC_THREADS * lanebits::STAGE_UNROLL) {
        uint32_t v[lanebits::STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < lanebits::STAGE_UNROLL; ++u) {
          const int i = i0 + u * TC_THREADS;
          v[u] = i < reach ? __ldg(row + i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < lanebits::STAGE_UNROLL; ++u) {
          const int i = i0 + u * TC_THREADS;
          if (i < reach) tstage[lanebits::PAD + i] = v[u];
        }
      }
    }
    __syncthreads();
    const int tid3[3] = {0, 1, 2};
    lanebits::stage_tables(tab, ftg, FT_SIZE - 1, ct, tid3);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int* st = stat + 4 * r;
  const bool lit_ok =
      lits_on_card ? st[1] != 0   // the literal section's verdict (kernel 1)
                   : (mode & DMODE_LIT_HOST) ||
                         !(mode & (DMODE_HUF4 | DMODE_HUF1 | DMODE_DIRECT));
  TcWalk w;
  if (has) {
    const int t0 = tok_prefix[r];
    const TcOut o{(uint2*)(toks + t0), syms + t0, (long long)m[2]};
    const GRow G{row, SQW};
    w = staged
        ? tc_walk(lanebits::SmemWords{tstage, reach}, G, tab, ftg, ct, m, o)
        : tc_walk(lanebits::GmemWords{row, SQW}, G, tab, ftg, ct, m, o);
  }
  st[0] = (int)(w.op + max((long long)regen - w.lpos, 0LL));
  st[1] = lit_ok && w.ok ? 1 : 0;
  st[2] = 0;
  st[3] = 0;
  long long* x = rowx + 4 * (size_t)r;
  x[0] = w.r1;
  x[1] = w.r2;
  x[2] = w.r3;
  x[3] = w.ns;
}

// Transcode mode, phases 2 and 3: a block a chain.  Thread 0 composes the
// rows' transforms in order into their input repcodes (rowx's slots,
// overwritten); then every symbolic offset of the chain's rows is
// resolved against its row's, checked and ORed into its w1.
__global__ void __launch_bounds__(TC_THREADS) tc_chain_kernel(
    const int* __restrict__ meta, const int* __restrict__ chain,
    const int* __restrict__ tok_prefix, uint32_t* __restrict__ toks,
    int* stat, long long* __restrict__ rowx,
    const long long* __restrict__ syms) {
  const int c = blockIdx.x;
  const int r0 = chain[c], r1 = chain[c + 1];
  if (threadIdx.x == 0) {
    long long s0 = 1, s1 = 4, s2 = 8;
    for (int r = r0; r < r1; ++r) {
      if (meta[(size_t)r * META_W] & DMODE_FRAME_START) {
        s0 = 1;
        s1 = 4;
        s2 = 8;
      }
      long long* x = rowx + 4 * (size_t)r;
      const long long in[3] = {s0, s1, s2};
      s0 = resolve(x[0], in);
      s1 = resolve(x[1], in);
      s2 = resolve(x[2], in);
      x[0] = in[0];
      x[1] = in[1];
      x[2] = in[2];
    }
  }
  __syncthreads();
  for (int r = r0; r < r1; ++r) {
    const long long* x = rowx + 4 * (size_t)r;
    const int n = (int)x[3];
    if (n == 0) continue;
    const long long in[3] = {x[0], x[1], x[2]};
    const int t0 = tok_prefix[r];
    const long long* e = syms + t0;
    bool bad = false;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const long long off = resolve(e[2 * k], in);
      const long long info = e[2 * k + 1];
      const int t = (int)(info >> 32);
      const int lim = (int)(uint32_t)info;
      bad |= off < 1 || off > lim;
      toks[t0 + 2 * t + 1] |= (uint32_t)off;
    }
    if (bad) atomicAnd(stat + 4 * r + 1, 0);
  }
}

}  // namespace

// scratch (the wrapper's): lits (B, LIT_MAX) uint8; rec (seq_total) int4,
// sym (seq_total) int64, res_off (seq_total) int32; rinfo (B, RI_W)
// int32; xform, instate (B, 3) int64; srcs (out_size) int32; changed
// (rounds) int32, zeroed here
extern "C" int zk_decode(const void* lp, const void* sq, const void* dtabs,
                         const void* ftabs, const void* meta,
                         const void* chain, const void* frame_off,
                         const void* ctab, int B, int F, int LPW, int SQW,
                         int seq_total, int out_size, int rounds, void* lits,
                         void* out, void* stat, void* rec, void* sym,
                         void* res_off, void* rinfo, void* xform,
                         void* instate, void* srcs, void* changed,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0) return (int)cudaGetLastError();
  const int hsm = (DT_SIZE + min(LPW, HUF_STAGE / 4)) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      huf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      HUF_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  huf_kernel<<<B, HUF_THREADS, hsm, s>>>(
      (const uint32_t*)lp, LPW, (const int*)dtabs, (const int*)meta, nullptr,
      (uint8_t*)lits, (int*)stat);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int ssm = (FT_SIZE + N_CTAB + 2 + min(SQW, SEQ_STAGE / 4)) * 4;
  e = cudaFuncSetAttribute(rec_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SEQ_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  rec_kernel<<<B, 32, ssm, s>>>(
      (const uint32_t*)sq, SQW, (const int*)ftabs, (const int*)meta,
      (const int*)ctab, seq_total, (int4*)rec, (long long*)sym, (int*)rinfo,
      (long long*)xform);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (F > 0) {
    frame_kernel<<<(F + 127) / 128, 128, 0, s>>>(
        F, (const int*)meta, (const int*)chain, (const long long*)frame_off,
        (int*)rinfo, (const long long*)xform, (long long*)instate);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  check_kernel<<<dim3(B, CHECK_SPLIT), 256, 0, s>>>(
      (const int4*)rec, (const long long*)sym, (const long long*)instate,
      (int*)rinfo, (int*)res_off);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (F > 0) {
    final_kernel<<<(F + 127) / 128, 128, 0, s>>>(
        F, LPW, (const int*)meta, (const int*)chain, (const int4*)rec,
        (int*)rinfo, (int*)stat);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (out_size <= 0) return (int)cudaGetLastError();
  e = cudaMemsetAsync(srcs, 0xFF, (size_t)out_size * 4, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(changed, 0, (size_t)rounds * 4, s);
  if (e != cudaSuccess) return (int)e;
  expand_kernel<<<dim3(B, EXPAND_SPLIT), EXPAND_THREADS, 0, s>>>(
      (const uint32_t*)lp, LPW, (const int*)meta, (const uint8_t*)lits,
      (const int4*)rec, (const int*)res_off, (const int*)rinfo,
      (uint8_t*)out, (int*)srcs);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)pd::resolve((int*)srcs, 0, nullptr, out_size, out_size, 1,
                          (int*)changed, rounds, (uint8_t*)out, s);
}

// lits (lit_words int32) are zeroed here, and stat too where no literal
// pass runs (rows outside every chain keep zeros); scratch (the
// wrapper's): rowx (B, 4) int64; syms (tok_words) int64, a row's
// symbolic offsets at tok_prefix[r] (two words each, at most one a
// sequence)
extern "C" int zk_transcode(const void* lp, const void* sq, const void* dtabs,
                            const void* ftabs, const void* meta,
                            const void* chain, const void* ctab,
                            const void* lit_prefix, const void* tok_prefix,
                            int B, int C, int LPW, int SQW, int lit_words,
                            void* lits, void* toks, void* stat, void* rowx,
                            void* syms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t z = cudaSuccess;
  if (lit_words > 0) z = cudaMemsetAsync(lits, 0, (size_t)lit_words * 4, s);
  if (z == cudaSuccess && !lp && B > 0)
    z = cudaMemsetAsync(stat, 0, (size_t)B * 16, s);
  if (z != cudaSuccess) return (int)z;
  if (lp) {   // null: no row's literals are on the card
    const int hsm = (DT_SIZE + min(LPW, HUF_STAGE / 4)) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        huf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        HUF_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    huf_kernel<<<B, HUF_THREADS, hsm, s>>>(
        (const uint32_t*)lp, LPW, (const int*)dtabs, (const int*)meta,
        (const int*)lit_prefix, (uint8_t*)lits, (int*)stat);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (C == 0) return 0;
  // the kernel's most, set before every launch: the attribute is the
  // kernel's in the current device's context, shared by every host thread,
  // so no launch lowers it under another's and every device has it
  cudaError_t e = cudaFuncSetAttribute(
      tc_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  const int tsm = (min(SQW, TC_STAGE / 4) + 2 * lanebits::PAD) * 4;
  tc_walk_kernel<<<B, TC_THREADS, tsm, s>>>(
      lp != nullptr, (const uint32_t*)sq, SQW, (const int*)ftabs,
      (const int*)meta, (const int*)chain, C, (const int*)ctab,
      (const int*)tok_prefix, (uint32_t*)toks, (int*)stat,
      (long long*)rowx, (long long*)syms);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tc_chain_kernel<<<C, TC_THREADS, 0, s>>>(
      (const int*)meta, (const int*)chain, (const int*)tok_prefix,
      (uint32_t*)toks, (int*)stat, (long long*)rowx,
      (const long long*)syms);
  return (int)cudaGetLastError();
}
