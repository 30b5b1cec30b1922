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
// output ring from one block to the next.  Here:
//   * kernel 1 (huf_kernel), one CUDA block per row: the literal section.
//     Lanes 0-3 walk the four Huffman streams (lane 0 the single stream)
//     backward with the 12-bit peek into the row's dtab, and write the
//     literals to a 128 KiB global scratch row.  Rows are independent.
//   * kernel 2 (seq_kernel), one warp per frame chain: the rows of the
//     frame in order.  All 32 lanes walk the 3-state FSE sequence stream
//     together (the same loads, broadcast), resolve repcodes (reset at the
//     chain's start and at DMODE_FRAME_START) and execute each sequence
//     cooperatively, straight into the frame's bytes of the output.
// There is no ring: a match copy reads output already written.  So an
// offset is valid up to the bytes produced in the frame so far (the TPU's
// ring limited it to 128 KiB, MAX_OFFSET), and blocks need no word
// alignment; the port decodes blocks the reference sends to its XLA
// fallback.  A block's output offset is the running sum of the chain's
// advances (d_off in-kernel; meta[2] is not read), and meta[1] is checked
// only where it is >= 0 (a raw or RLE block's size from its header).
//
// Failure: ok = 0 in stat[row] for leftover or missing bits after a
// Huffman stream or the sequence walk (exact consumption), an offset
// outside [1, produced], literals past the section or output past the
// frame.  The rest of the chain is then skipped (stat [0, 0, 0, 0]), and
// the wrapper raises.  Every write stays inside the row's frame.
//
// Bound: the bytes moved (compressed payload in, decompressed bytes out)
// over the card's memory rate; the walks are serial chains of dependent
// loads, so this simple form is bound by their latency, one warp per
// frame, not by bandwidth.
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
//   * kernel 2 (tc_kernel), one THREAD per chain: nothing is executed, so
//     only the repcodes carry from row to row; a chain is the rows from
//     one DMODE_FRAME_START to the next (the host marks a frame's first
//     row and each chunk start, zstd_decode.py :1033-1043).
// A row's position comes from meta[2] (its offset in its frame, which
// the host predicts), not from a running sum: chunks start mid-frame and
// literal-only blocks never reach the card.  stat[row] = [advance, ok,
// 0, 0]: the advance counts the trailing literals; ok = 0 for a Huffman
// stream not consumed exactly, an offset outside [1, min(op + ll,
// 2^28 - 1)] (op frame-absolute: any offset in the frame that the
// token's 28 bits hold) or a sequence stream not consumed exactly.  As
// in the reference, a failing row still emits all its tokens and the
// chain walks on: the host checks stat before it executes anything.
// Bound: bytes (the sequence streams in, 8 bytes of token a sequence
// out); the walk is a serial chain of dependent loads per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DMODE_HUF4 = 1;
constexpr int DMODE_HUF1 = 2;
constexpr int DMODE_DIRECT = 4;
constexpr int DMODE_SEQ = 8;
constexpr int DMODE_FRAME_START = 16;
constexpr int DMODE_LIT_HOST = 64;
constexpr int MAX_TOKEN_OFFSET = 0x0FFFFFFF;   // the token's 28 bits
constexpr int HUF_PEEK = 12;
constexpr int META_W = 16;
constexpr int LIT_MAX = 1 << 17;   // literal scratch row (128 KiB)

// ctab layout (ops/decode.py CTAB): LL bits | LL base | ML bits | ML base
constexpr int N_LL = 36;
constexpr int N_ML = 53;
constexpr int C_LL_BITS = 0;
constexpr int C_LL_BASE = N_LL;
constexpr int C_ML_BITS = 2 * N_LL;
constexpr int C_ML_BASE = 2 * N_LL + N_ML;

// LE32 starting at byte b of a row of W words (indices clamped to the row)
__device__ __forceinline__ uint32_t u32_at(const uint32_t* row, int W,
                                           int b) {
  const int q = min(b >> 2, W - 1);
  const int sh = (b & 3) * 8;
  const uint32_t lo = row[q];
  const uint32_t hi = row[min(q + 1, W - 1)];
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}

// bits [a, a + nb) of the row, nb <= 16; bits below bit 0 read as zero
// (the last symbols of a valid backward stream peek past its start)
__device__ __forceinline__ int read_at(const uint32_t* row, int W, int a,
                                       int nb) {
  const uint32_t mask = (1u << nb) - 1u;
  if (a >= 0) return (int)((u32_at(row, W, a >> 3) >> (a & 7)) & mask);
  const int under = min(-a, 31);
  return (int)((u32_at(row, W, 0) << under) & mask);
}

// nb <= 32 (an offset code reaches 31): two reads of <= 16 bits
__device__ __forceinline__ uint32_t read_wide(const uint32_t* row, int W,
                                              int a, int nb) {
  const int lo_nb = min(nb, 16);
  const uint32_t lo = (uint32_t)read_at(row, W, a, lo_nb);
  const uint32_t hi = (uint32_t)read_at(row, W, a + 16, nb - lo_nb);
  return lo | (hi << 16);
}

// The FSE sequence stream of one row (RFC 8878 §3.1.1.3.2), walked
// backward from bit meta[12]: three states, one (ll, ml, off) a step.
// seq_kernel executes what it yields, tc_kernel packs it into tokens.
struct SeqStream {
  const uint32_t* row;
  int W;
  const int* ft;   // the row's LL | OF | ML tables
  int pos, s_ll, s_of, s_ml;
};

__device__ __forceinline__ SeqStream seq_open(const uint32_t* row, int W,
                                              const int* ft, const int* m) {
  const int tlp = m[14];
  const int tl_ll = tlp & 255, tl_of = (tlp >> 8) & 255,
            tl_ml = (tlp >> 16) & 255;
  SeqStream z{row, W, ft, m[12], 0, 0, 0};
  z.s_ll = read_at(row, W, z.pos - tl_ll, tl_ll);
  z.pos -= tl_ll;
  z.s_of = read_at(row, W, z.pos - tl_of, tl_of);
  z.pos -= tl_of;
  z.s_ml = read_at(row, W, z.pos - tl_ml, tl_ml);
  z.pos -= tl_ml;
  return z;
}

// Decode the next sequence, resolve its offset against the repcodes
// (RFC 8878 §3.1.1.5; rep updated in place) and, unless it is the last,
// advance the three states.  false for an offset code > 31: the walk
// stops there.  The caller checks the offset and, after the last step,
// exact consumption (z.pos == 0).
__device__ __forceinline__ bool seq_step(SeqStream& z,
                                         const int* __restrict__ ctab,
                                         bool last, long long& rep1,
                                         long long& rep2, long long& rep3,
                                         int& ll, int& ml, long long& off) {
  const int e_ll = __ldg(z.ft + z.s_ll);
  const int e_of = __ldg(z.ft + 512 + z.s_of);
  const int e_ml = __ldg(z.ft + 1024 + z.s_ml);
  const int llc = min(e_ll & 255, N_LL - 1);
  const int ofc = e_of & 255;
  const int mlc = min(e_ml & 255, N_ML - 1);
  if (ofc > 31) return false;
  const long long of_extra = read_wide(z.row, z.W, z.pos - ofc, ofc);
  z.pos -= ofc;
  const long long ofv = (1LL << min(ofc, 30)) + of_extra;
  const int mlb = __ldg(ctab + C_ML_BITS + mlc);
  ml = __ldg(ctab + C_ML_BASE + mlc) + read_at(z.row, z.W, z.pos - mlb, mlb);
  z.pos -= mlb;
  const int llb = __ldg(ctab + C_LL_BITS + llc);
  ll = __ldg(ctab + C_LL_BASE + llc) + read_at(z.row, z.W, z.pos - llb, llb);
  z.pos -= llb;
  const long long idx = ofv + (ll == 0 ? 1 : 0);
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
  if (!last) {   // state updates: LL, ML, OF
    const int nb_ll = (e_ll >> 8) & 255;
    z.s_ll = (e_ll >> 16) + read_at(z.row, z.W, z.pos - nb_ll, nb_ll);
    z.pos -= nb_ll;
    const int nb_ml = (e_ml >> 8) & 255;
    z.s_ml = (e_ml >> 16) + read_at(z.row, z.W, z.pos - nb_ml, nb_ml);
    z.pos -= nb_ml;
    const int nb_of = (e_of >> 8) & 255;
    z.s_of = (e_of >> 16) + read_at(z.row, z.W, z.pos - nb_of, nb_of);
    z.pos -= nb_of;
  }
  return true;
}

// lit_prefix null (execute mode): a Huffman row's literals go to its
// LIT_MAX scratch row.  Else (transcode mode): every row with literals on
// the card writes them at lit_prefix[r] words of the dense output, whole
// words as the reference does (a DIRECT row copies its payload words);
// DMODE_LIT_HOST rows write nothing.
__global__ void huf_kernel(const uint32_t* __restrict__ lp, int LPW,
                           const int* __restrict__ dtabs,
                           const int* __restrict__ meta,
                           const int* __restrict__ lit_prefix,
                           uint8_t* __restrict__ lits, int* stat) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int* m = meta + (size_t)r * META_W;
  const int mode = lit_prefix && (m[0] & DMODE_LIT_HOST) ? 0 : m[0];
  const int regen = m[3];
  __shared__ int ok_s;
  if (lane == 0) ok_s = 1;
  __syncthreads();
  const bool huf4 = (mode & DMODE_HUF4) != 0;
  const bool huf1 = (mode & DMODE_HUF1) != 0;
  uint8_t* row_lits = lit_prefix ? lits + 4LL * lit_prefix[r]
                                 : lits + (size_t)r * LIT_MAX;
  if ((huf4 || huf1) && regen > LIT_MAX) {
    if (lane == 0) ok_s = 0;
  } else if (lit_prefix && !huf4 && !huf1 && (mode & DMODE_DIRECT)) {
    if (regen > 4 * LPW) {
      if (lane == 0) ok_s = 0;
    } else {
      // whole words, as the reference copies them
      const uint8_t* src = (const uint8_t*)(lp + (size_t)r * LPW);
      const int nb = 4 * ((regen + 3) >> 2);
      for (int j = lane; j < nb; j += 32) row_lits[j] = src[j];
    }
  } else if ((huf4 && lane < 4) || (huf1 && lane == 0)) {
    const uint32_t* row = lp + (size_t)r * LPW;
    const int* dt = dtabs + (size_t)r * (1 << HUF_PEEK);
    uint8_t* dst = row_lits;
    int n_out = regen;
    if (huf4) {
      const int per = (regen + 3) >> 2;
      n_out = lane < 3 ? per : max(regen - 3 * per, 0);
      dst += lane * per;
    }
    int pos = m[4 + lane];
    const int base8 = m[8 + lane] * 8;
    for (int i = 0; i < n_out; ++i) {
      const int v = read_at(row, LPW, base8 + pos - HUF_PEEK, HUF_PEEK);
      const int e = __ldg(dt + v);
      pos -= e >> 8;
      dst[i] = (uint8_t)(e & 255);
    }
    if (pos != 0) atomicAnd(&ok_s, 0);
  }
  __syncthreads();
  if (lane < 4) stat[4 * r + lane] = lane == 1 ? ok_s : 0;
}

// copy n literal bytes to out (no overlap: different buffers), warp-wide
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src,
                                          int n, int lane) {
  for (int j = lane; j < n; j += 32) dst[j] = src[j];
  __threadfence_block();
  __syncwarp();
}

// match copy within the output: dst[j] = dst[j - off], repeating the last
// `off` bytes when they overlap, warp-wide.  Every source byte lies before
// dst or was written in an earlier round of 32.
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

__global__ void seq_kernel(const uint32_t* __restrict__ lp, int LPW,
                           const uint32_t* __restrict__ sq, int SQW,
                           const int* __restrict__ ftabs,
                           const int* __restrict__ meta,
                           const int* __restrict__ chain,
                           const long long* __restrict__ frame_off,
                           const int* __restrict__ ctab,
                           const uint8_t* __restrict__ lits, uint8_t* out,
                           int* stat) {
  const int f = blockIdx.x;
  const int lane = threadIdx.x;
  const int r0 = chain[f], r1 = chain[f + 1];
  uint8_t* fout = out + frame_off[f];
  const long long fsize = frame_off[f + 1] - frame_off[f];
  long long op = 0;            // bytes produced in the frame
  long long rep1 = 1, rep2 = 4, rep3 = 8;
  bool failed = false;
  for (int r = r0; r < r1; ++r) {
    int* st = stat + 4 * r;
    if (failed) {
      if (lane < 4) st[lane] = 0;
      continue;
    }
    const int* m = meta + (size_t)r * META_W;
    const int mode = m[0];
    const int regen = m[3];
    const int n_seq = m[13];
    if (mode & DMODE_FRAME_START) {
      rep1 = 1;
      rep2 = 4;
      rep3 = 8;
    }
    bool ok = st[1] != 0;   // the literal section's verdict (kernel 1)
    __syncwarp();
    const uint8_t* lit;
    if (mode & DMODE_DIRECT) {
      lit = (const uint8_t*)(lp + (size_t)r * LPW);
      if (regen > 4 * LPW) ok = false;
    } else {
      lit = lits + (size_t)r * LIT_MAX;
    }
    const long long base = op;
    int lpos = 0;
    if (ok && (mode & DMODE_SEQ) && n_seq > 0) {
      SeqStream z = seq_open(sq + (size_t)r * SQW, SQW,
                             ftabs + (size_t)r * 1536, m);
      for (int t = 0; t < n_seq; ++t) {
        int ll, ml;
        long long off;
        if (!seq_step(z, ctab, t == n_seq - 1, rep1, rep2, rep3, ll, ml,
                      off) ||
            off < 1 || off > op + ll || lpos + ll > regen ||
            op + ll + ml > fsize) {
          ok = false;
          break;
        }
        warp_copy(fout + op, lit + lpos, ll, lane);
        warp_match(fout + op + ll, (int)off, ml, lane);
        op += ll + ml;
        lpos += ll;
      }
      if (ok && z.pos != 0) ok = false;   // exact consumption
    }
    if (ok) {
      const int trail = max(regen - lpos, 0);
      if (op + trail > fsize) {
        ok = false;
      } else {
        warp_copy(fout + op, lit + lpos, trail, lane);
        op += trail;
      }
    }
    const long long adv = op - base;
    if (ok && m[1] >= 0 && adv != m[1]) ok = false;
    if (lane == 0) {
      st[0] = (int)adv;
      st[1] = ok ? 1 : 0;
      st[2] = 0;
      st[3] = 0;
    }
    failed = !ok;
  }
}

// Transcode mode: one thread walks a chain of rows (see the header).
// lits_on_card 0: huf_kernel did not run (every row's literals stay on the
// host), so a row starts from ok = 1 unless it asks for card literals.
__global__ void tc_kernel(int lits_on_card,
                          const uint32_t* __restrict__ sq, int SQW,
                          const int* __restrict__ ftabs,
                          const int* __restrict__ meta,
                          const int* __restrict__ chain, int C,
                          const int* __restrict__ ctab,
                          const int* __restrict__ tok_prefix,
                          uint32_t* __restrict__ toks, int* stat) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  long long rep1 = 1, rep2 = 4, rep3 = 8;
  for (int r = chain[c]; r < chain[c + 1]; ++r) {
    const int* m = meta + (size_t)r * META_W;
    const int mode = m[0];
    const int regen = m[3];
    const int n_seq = m[13];
    int* st = stat + 4 * r;
    if (mode & DMODE_FRAME_START) {
      rep1 = 1;
      rep2 = 4;
      rep3 = 8;
    }
    bool ok = lits_on_card
                  ? st[1] != 0   // the literal section's verdict (kernel 1)
                  : (mode & DMODE_LIT_HOST) ||
                        !(mode & (DMODE_HUF4 | DMODE_HUF1 | DMODE_DIRECT));
    const long long base = m[2];
    long long op = base, lpos = 0;
    if ((mode & DMODE_SEQ) && n_seq > 0) {
      SeqStream z = seq_open(sq + (size_t)r * SQW, SQW,
                             ftabs + (size_t)r * 1536, m);
      uint32_t* tk = toks + tok_prefix[r];
      for (int t = 0; t < n_seq; ++t) {
        int ll, ml;
        long long off;
        if (!seq_step(z, ctab, t == n_seq - 1, rep1, rep2, rep3, ll, ml,
                      off)) {
          ok = false;
          break;
        }
        if (off < 1 || off > min(op + ll, (long long)MAX_TOKEN_OFFSET))
          ok = false;
        tk[2 * t] = (uint32_t)ll | ((uint32_t)(ml & 0x3FFF) << 18);
        tk[2 * t + 1] = (uint32_t)off | ((uint32_t)(ml >> 14) << 28);
        op += ll + ml;
        lpos += ll;
      }
      if (z.pos != 0) ok = false;   // exact consumption
    }
    op += max((long long)regen - lpos, 0LL);
    st[0] = (int)(op - base);
    st[1] = ok ? 1 : 0;
    st[2] = 0;
    st[3] = 0;
  }
}

}  // namespace

extern "C" int zk_decode(const void* lp, const void* sq, const void* dtabs,
                         const void* ftabs, const void* meta,
                         const void* chain, const void* frame_off,
                         const void* ctab, int B, int F, int LPW, int SQW,
                         void* lits, void* out, void* stat, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  huf_kernel<<<B, 32, 0, s>>>((const uint32_t*)lp, LPW, (const int*)dtabs,
                              (const int*)meta, nullptr, (uint8_t*)lits,
                              (int*)stat);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  seq_kernel<<<F, 32, 0, s>>>((const uint32_t*)lp, LPW, (const uint32_t*)sq,
                              SQW, (const int*)ftabs, (const int*)meta,
                              (const int*)chain,
                              (const long long*)frame_off, (const int*)ctab,
                              (const uint8_t*)lits, (uint8_t*)out,
                              (int*)stat);
  return (int)cudaGetLastError();
}

extern "C" int zk_transcode(const void* lp, const void* sq, const void* dtabs,
                            const void* ftabs, const void* meta,
                            const void* chain, const void* ctab,
                            const void* lit_prefix, const void* tok_prefix,
                            int B, int C, int LPW, int SQW, void* lits,
                            void* toks, void* stat, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lp) {   // null: no row's literals are on the card
    huf_kernel<<<B, 32, 0, s>>>((const uint32_t*)lp, LPW, (const int*)dtabs,
                                (const int*)meta, (const int*)lit_prefix,
                                (uint8_t*)lits, (int*)stat);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (C == 0) return 0;
  tc_kernel<<<(C + 31) / 32, 32, 0, s>>>(
      lp != nullptr, (const uint32_t*)sq, SQW, (const int*)ftabs, (const int*)meta,
      (const int*)chain, C, (const int*)ctab, (const int*)tok_prefix,
      (uint32_t*)toks, (int*)stat);
  return (int)cudaGetLastError();
}
