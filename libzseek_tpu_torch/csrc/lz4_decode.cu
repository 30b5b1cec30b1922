// LZ4 frame decode on the card.
//
// Replaces the XLA decoder libzseek_tpu/ops/lz4_decode.py
// lz4_decode_frames (:110), not a Pallas kernel: there the token stream
// is a while_loop over sequences vectorised over blocks, and execution is
// a literal scatter plus pointer-doubling copy resolution (:16).
//
// What bounded the first version (one warp walked a whole frame, tokens
// and copies in order; 92 ms per 4-frame window on an H100): the walk of
// the longest frame.  Clock counters on the card gave the text frame's
// warp 214 M cycles against 3-7 M for the other three: 214,442
// sequences at ~290 cycles of header parsing (five dependent byte loads
// from global memory), ~160 of literal copies and ~430 of match copies
// (a __syncwarp after every 32 bytes) each, on 4 warps for the window.
//
// This version splits the decode into the reference's three phases:
//  1. parse_kernel: one CUDA block (one warp) per LZ4 block.  The row is
//     staged in shared memory with 16-byte loads; the warp walks its
//     tokens in lock step from shared memory (0xFF runs by ballot) and
//     lane 0 writes one record a sequence, {literal source, ll, output
//     position, offset}, all block-local, plus the block's output length
//     and a bad flag.  A window of 4 frames of 16 blocks parses on 64 SMs
//     at once instead of 4 warps.
//  2. expand_kernel: every block's base is the sum of the lengths of the
//     blocks before it in its frame (out_lens comes from the same sums).
//     Warps take a block's records in parallel: literal bytes go straight
//     to the output; each match byte gets the frame index of its source,
//     inside the match folded back before the match start
//     (dst - off + j % off), so self-overlapping copies cost no rounds.
//  3. ceil(log2 F) rounds of in-place pointer doubling over the source
//     indices, src[i] <- src[src[i]], until every index names a byte that
//     is no match byte; a round whose predecessor changed nothing returns
//     at once; then each match byte is copied from its root
//     (pd_round_kernel, pd_finish_kernel in pointer_doubling.cuh, shared
//     with K4), and lens_kernel writes out_lens and ok.
//
// Flags follow the reference exactly: a block is bad on a truncated or
// overrunning sequence, offset 0, an offset past the block start
// (independent frames), or more than max_seqs sequences; the block stops
// there (its output ends before the bad sequence) and the frame's later
// blocks still decode, so out_lens is the reference's.  A match that
// starts inside the row and before the frame start makes the frame bad
// and copies nothing.  Header loads past the padded block row are
// clamped to its last byte, as the reference's gathers are.  Nothing is
// written past F; the wrapper zero-fills the output.  Uncompressed
// blocks are one literal record.
//
// What bounds it now (4.1 ms a window): parse_kernel, 3.1 ms, the
// longest block's token walk (one chain of shared-memory loads over its
// ~13,000 sequences); then expand_kernel, 0.6 ms, and the doubling
// rounds, 0.3 ms, each a pass over 4 bytes an output byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "pointer_doubling.cuh"

namespace {

constexpr int STAGE_MAX = 96 * 1024;   // bytes of a row staged in smem
constexpr int EXPAND_SPLIT = 8;        // CUDA blocks per LZ4 block
constexpr int EXPAND_THREADS = 256;

// meta layout (int32): nrec[L], blen[L], bad[L], frame_bad[B], lim[B],
// changed[rounds]
struct Meta {
  int* nrec;
  int* blen;
  int* bad;
  int* frame_bad;
  int* lim;
  int* changed;
};

__device__ __forceinline__ Meta meta_of(int* m, int L, int B) {
  return Meta{m, m + L, m + 2 * L, m + 3 * L, m + 3 * L + B,
              m + 3 * L + 2 * B};
}

struct Row {
  const uint8_t* g;  // the block's padded row of M bytes in global memory
  const uint8_t* s;  // its first `staged` bytes in shared memory
  int staged, M;
};

__device__ __forceinline__ int at(const Row& r, int i) {
  i = i < 0 ? 0 : (i > r.M - 1 ? r.M - 1 : i);
  return i < r.staged ? r.s[i] : r.g[i];
}

// consecutive 0xFF bytes from position i (clamped) to the row end; the
// whole warp calls it with the same i
__device__ int ff_run(const Row& r, int i, int lane) {
  i = i < 0 ? 0 : (i > r.M - 1 ? r.M - 1 : i);
  int n = 0;
  for (;;) {
    const int j = i + n + lane;
    const bool stop = j >= r.M || at(r, j) != 0xFF;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, stop);
    if (m) return n + __ffs((int)m) - 1;
    n += 32;
  }
}

__global__ void parse_kernel(const uint8_t* __restrict__ comp,
                             const int* __restrict__ clens,
                             const uint8_t* __restrict__ unc, int L, int B,
                             int M, int max_seqs, int linked,
                             int4* __restrict__ rec, int* meta_p) {
  extern __shared__ uint4 stage[];
  const int blk = blockIdx.x;
  const int lane = threadIdx.x;
  const Meta meta = meta_of(meta_p, L, B);
  const int clen = clens[blk];
  int4* R = rec + (size_t)blk * max_seqs;
  if (unc[blk] || clen <= 0) {
    if (lane == 0) {
      const bool u = unc[blk] != 0;
      if (u) R[0] = make_int4(0, clen, 0, 0);
      meta.nrec[blk] = u ? 1 : 0;
      meta.blen[blk] = u ? clen : 0;
      meta.bad[blk] = 0;
    }
    return;
  }
  const uint8_t* row = comp + (size_t)blk * M;
  int staged = clen < M ? clen : M;
  staged = staged < STAGE_MAX ? staged : STAGE_MAX;
  uint8_t* sb = reinterpret_cast<uint8_t*>(stage);
  if ((M & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    for (int q = lane; q < (staged + 15) / 16; q += 32) stage[q] = src[q];
  } else {
    for (int q = lane; q < staged; q += 32) sb[q] = row[q];
  }
  __syncwarp();
  const Row r{row, sb, staged, M};
  int ip = 0, s = 0;
  long long op = 0;
  bool bad = false;
  for (;; ++s) {
    if (s == max_seqs) {
      bad = true;  // ran out of sequence budget mid-block
      break;
    }
    const int token = at(r, ip);
    int ll = token >> 4, ll_extbytes = 0;
    if (ll == 15) {
      const int ffr = ff_run(r, ip + 1, lane);
      ll_extbytes = ffr + 1;
      ll = 15 + 255 * ffr + at(r, ip + 1 + ffr);
    }
    const int src = ip + 1 + ll_extbytes;
    const int lit_end = src + ll;
    const bool is_last = lit_end >= clen;
    const int off = at(r, lit_end) | (at(r, lit_end + 1) << 8);
    int ml = (token & 15) + 4, ml_extbytes = 0;
    if ((token & 15) == 15) {
      const int ffr2 = ff_run(r, lit_end + 2, lane);
      ml_extbytes = ffr2 + 1;
      ml = 19 + 255 * ffr2 + at(r, lit_end + 2 + ffr2);
    }
    const long long match_dst = op + ll;
    bool overrun = lit_end > clen ||
                   (!is_last && (lit_end + 2 + ml_extbytes > clen ||
                                 off == 0));
    if (!linked) overrun = overrun || (!is_last && off > match_dst);
    if (overrun) {
      bad = true;
      break;
    }
    if (lane == 0) R[s] = make_int4(src, ll, (int)op, is_last ? 0 : off);
    if (is_last) {
      op += ll;
      ++s;
      break;
    }
    op = match_dst + ml;
    ip = lit_end + 2 + ml_extbytes;
  }
  if (lane == 0) {
    meta.nrec[blk] = s;
    meta.blen[blk] = (int)op;
    meta.bad[blk] = bad ? 1 : 0;
  }
}

// grid (L, EXPAND_SPLIT): the warps of a block's EXPAND_SPLIT CUDA blocks
// share its records
__global__ void expand_kernel(const uint8_t* __restrict__ comp,
                              const int4* __restrict__ rec, int L, int B,
                              int K, int M, int F, int max_seqs,
                              uint8_t* __restrict__ out,
                              int* __restrict__ srcs, int* meta_p) {
  const int blk = blockIdx.x;
  const int b = blk / K, k = blk % K;
  const Meta meta = meta_of(meta_p, L, B);
  long long base = 0;
  for (int j = 0; j < k; ++j) base += meta.blen[b * K + j];
  const int n = meta.nrec[blk];
  const int blen = meta.blen[blk];
  if (k == K - 1 && blockIdx.y == 0 && threadIdx.x == 0) {
    const long long total = base + blen;
    meta.lim[b] = (int)(total < F ? total : (long long)F);
  }
  const long long KM = (long long)K * M;
  const uint8_t* comp_f = comp + (size_t)b * KM;
  const long long kb = (long long)k * M;
  uint8_t* fo = out + (size_t)b * F;
  int* fs = srcs + (size_t)b * F;
  const int4* R = rec + (size_t)blk * max_seqs;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.y * (EXPAND_THREADS / 32);
  const int w = blockIdx.y * (EXPAND_THREADS / 32) + threadIdx.x / 32;
  bool before = false;
  for (int i = w; i < n; i += warps) {
    const int4 q = R[i];
    const int next = i + 1 < n ? R[i + 1].z : blen;
    const long long ld = base + q.z;
    const long long mdst = ld + q.y;
    const long long ml = (long long)next - q.z - q.y;
    for (long long j = lane; j < q.y; j += 32) {
      const long long d = ld + j;
      if (d >= F) break;
      const long long s = kb + q.x + j;
      fo[d] = s < KM ? comp_f[s] : 0;
      fs[d] = -1;
    }
    if (ml <= 0 || mdst >= F) continue;
    const long long cnt = F - mdst < ml ? F - mdst : ml;
    const int off = q.w;
    const bool pre = mdst - off < 0;   // the match reaches before the frame
    before = before || pre;
    for (long long j = lane; j < cnt; j += 32)
      fs[mdst + j] = pre ? -1
                         : (int)(mdst - off + (off < cnt ? j % off : j));
  }
  if (__any_sync(0xFFFFFFFFu, before) && lane == 0) meta.frame_bad[b] = 1;
}

// one thread a frame, after the copies: out_lens and ok
__global__ void lens_kernel(int L, int B, int K, int* __restrict__ out_lens,
                            uint8_t* __restrict__ ok, int* meta_p) {
  const Meta meta = meta_of(meta_p, L, B);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long total = 0;
  bool bad = meta.frame_bad[b] != 0;
  for (int k = 0; k < K; ++k) {
    total += meta.blen[b * K + k];
    bad = bad || meta.bad[b * K + k] != 0;
  }
  out_lens[b] = (int)total;
  ok[b] = bad ? 0 : 1;
}

}  // namespace

// rec: int32 (B*K, max_seqs, 4) scratch; srcs: int32 (B, F) scratch;
// meta: int32 (3*B*K + 2*B + rounds), zero-filled by the caller
extern "C" int zk_lz4_decode(const void* comp, const void* clens,
                             const void* unc, int B, int K, int M, int F,
                             int max_seqs, int linked, void* out,
                             void* out_lens, void* ok, void* rec, void* srcs,
                             void* meta, int rounds, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int L = B * K;
  int stage = M < STAGE_MAX ? M : STAGE_MAX;
  stage = (stage + 15) / 16 * 16;
  // the attribute is the kernel's, shared by every host thread: set it to
  // the most any launch asks for, so that a thread launching a smaller
  // batch never lowers it under another thread's larger launch
  cudaError_t e = cudaFuncSetAttribute(
      parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_MAX);
  if (e != cudaSuccess) return (int)e;
  parse_kernel<<<L, 32, stage, st>>>(
      (const uint8_t*)comp, (const int*)clens, (const uint8_t*)unc, L, B, M,
      max_seqs, linked, (int4*)rec, (int*)meta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  expand_kernel<<<dim3(L, EXPAND_SPLIT), EXPAND_THREADS, 0, st>>>(
      (const uint8_t*)comp, (const int4*)rec, L, B, K, M, F, max_seqs,
      (uint8_t*)out, (int*)srcs, (int*)meta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int* m = (int*)meta;
  e = pd::resolve((int*)srcs, F, m + 3 * L + B, 0, F, B, m + 3 * L + 2 * B,
                  rounds, (uint8_t*)out, st);
  if (e != cudaSuccess) return (int)e;
  lens_kernel<<<(B + 127) / 128, 128, 0, st>>>(L, B, K, (int*)out_lens,
                                               (uint8_t*)ok, m);
  return (int)cudaGetLastError();
}
