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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DMODE_HUF4 = 1;
constexpr int DMODE_HUF1 = 2;
constexpr int DMODE_DIRECT = 4;
constexpr int DMODE_SEQ = 8;
constexpr int DMODE_FRAME_START = 16;
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

__global__ void huf_kernel(const uint32_t* __restrict__ lp, int LPW,
                           const int* __restrict__ dtabs,
                           const int* __restrict__ meta,
                           uint8_t* __restrict__ lits, int* stat) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int* m = meta + (size_t)r * META_W;
  const int mode = m[0];
  const int regen = m[3];
  __shared__ int ok_s;
  if (lane == 0) ok_s = 1;
  __syncthreads();
  const bool huf4 = (mode & DMODE_HUF4) != 0;
  const bool huf1 = (mode & DMODE_HUF1) != 0;
  if ((huf4 || huf1) && regen > LIT_MAX) {
    if (lane == 0) ok_s = 0;
  } else if ((huf4 && lane < 4) || (huf1 && lane == 0)) {
    const uint32_t* row = lp + (size_t)r * LPW;
    const int* dt = dtabs + (size_t)r * (1 << HUF_PEEK);
    uint8_t* dst = lits + (size_t)r * LIT_MAX;
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
  int rep1 = 1, rep2 = 4, rep3 = 8;
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
      const uint32_t* row = sq + (size_t)r * SQW;
      const int* ft = ftabs + (size_t)r * 1536;
      const int tlp = m[14];
      const int tl_ll = tlp & 255, tl_of = (tlp >> 8) & 255,
                tl_ml = (tlp >> 16) & 255;
      int pos = m[12];
      int s_ll = read_at(row, SQW, pos - tl_ll, tl_ll);
      pos -= tl_ll;
      int s_of = read_at(row, SQW, pos - tl_of, tl_of);
      pos -= tl_of;
      int s_ml = read_at(row, SQW, pos - tl_ml, tl_ml);
      pos -= tl_ml;
      for (int t = 0; t < n_seq; ++t) {
        const int e_ll = __ldg(ft + s_ll);
        const int e_of = __ldg(ft + 512 + s_of);
        const int e_ml = __ldg(ft + 1024 + s_ml);
        const int llc = min(e_ll & 255, N_LL - 1);
        const int ofc = e_of & 255;
        const int mlc = min(e_ml & 255, N_ML - 1);
        if (ofc > 31) {
          ok = false;
          break;
        }
        const long long of_extra = read_wide(row, SQW, pos - ofc, ofc);
        pos -= ofc;
        const long long ofv = (1LL << min(ofc, 30)) + of_extra;
        const int mlb = __ldg(ctab + C_ML_BITS + mlc);
        const int ml = __ldg(ctab + C_ML_BASE + mlc) +
                       read_at(row, SQW, pos - mlb, mlb);
        pos -= mlb;
        const int llb = __ldg(ctab + C_LL_BITS + llc);
        const int ll = __ldg(ctab + C_LL_BASE + llc) +
                       read_at(row, SQW, pos - llb, llb);
        pos -= llb;
        // repcodes (RFC 8878 §3.1.1.5)
        const long long idx = ofv + (ll == 0 ? 1 : 0);
        long long off;
        int n_r2, n_r3;
        if (ofv > 3) {
          off = ofv - 3;
          n_r3 = rep2;
          n_r2 = rep1;
        } else if (idx == 1) {
          off = rep1;
          n_r3 = rep3;
          n_r2 = rep2;
        } else if (idx == 2) {
          off = rep2;
          n_r3 = rep3;
          n_r2 = rep1;
        } else if (idx == 3) {
          off = rep3;
          n_r3 = rep2;
          n_r2 = rep1;
        } else {
          off = (long long)rep1 - 1;
          n_r3 = rep2;
          n_r2 = rep1;
        }
        if (off < 1 || off > op + ll || lpos + ll > regen ||
            op + ll + ml > fsize) {
          ok = false;
          break;
        }
        rep1 = (int)off;
        rep2 = n_r2;
        rep3 = n_r3;
        // state updates (not after the last sequence): LL, ML, OF
        if (t < n_seq - 1) {
          const int nb_ll = (e_ll >> 8) & 255;
          s_ll = (e_ll >> 16) + read_at(row, SQW, pos - nb_ll, nb_ll);
          pos -= nb_ll;
          const int nb_ml = (e_ml >> 8) & 255;
          s_ml = (e_ml >> 16) + read_at(row, SQW, pos - nb_ml, nb_ml);
          pos -= nb_ml;
          const int nb_of = (e_of >> 8) & 255;
          s_of = (e_of >> 16) + read_at(row, SQW, pos - nb_of, nb_of);
          pos -= nb_of;
        }
        warp_copy(fout + op, lit + lpos, ll, lane);
        warp_match(fout + op + ll, (int)off, ml, lane);
        op += ll + ml;
        lpos += ll;
      }
      if (ok && pos != 0) ok = false;   // exact consumption
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

}  // namespace

extern "C" int zk_decode(const void* lp, const void* sq, const void* dtabs,
                         const void* ftabs, const void* meta,
                         const void* chain, const void* frame_off,
                         const void* ctab, int B, int F, int LPW, int SQW,
                         void* lits, void* out, void* stat, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  huf_kernel<<<B, 32, 0, s>>>((const uint32_t*)lp, LPW, (const int*)dtabs,
                              (const int*)meta, (uint8_t*)lits, (int*)stat);
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
