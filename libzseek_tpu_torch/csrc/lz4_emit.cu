// K5: fused LZ4 block encode (hash-probe parse with inline emission).
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_lz4.py _lz4_kernel
// (pallas_call at :390, wrapper lz4_emit_blocks_smem :355): liblz4's
// greedy parse over a window of [previous block | this block] with a
// persistent tagged hash table {tag:7, pos:24} of absolute positions, the
// quad-probe miss loop, the miss accelerator, the lazy arm of the HC
// levels, and token / length / literal / offset emission straight into
// the row's output, under liblz4's end rules.
//
// On the TPU the grid runs in order and the table lives in SMEM across
// grid steps, reset and seeded from row 0 at step 0.  Here one CUDA block
// walks one CHAIN of rows in order: a chain starts at every row whose
// min_ref fences off the previous row (a frame start), because an entry
// written before that row fails the window check exactly like an empty
// slot.  The grid has one block per row; the blocks of chain-start rows
// find themselves from min_ref (no host sync) and walk their chains in
// parallel, the rest exit.  The 2^16-entry table (256 KiB) does not fit
// a block's shared memory, so it is per-chain scratch in device memory,
// filled with -1 by the block at chain start; the chain starting at row 0
// is then seeded from row 0, as the reference's step 0 is.
//
// The TPU's workarounds are gone: bytes are read from the (B+1, N) rows
// directly (row r and r+1 are the window, contiguous in memory), not from
// int32 words of a concatenated prev || cur stream, and the quad probe
// computes its four words from byte offsets.  Loads past the window end
// repeat its last word, as the reference's clamped loads do (the walk
// never reaches them).
//
// What bounds it: a dependent scalar walk (hash, table load and store,
// byte compares) on one thread per chain, ~1,600 cycles a sequence of
// the text chain on an H100, whose loads mostly hit L1 (the table and
// the window share its 256 KB); the quad loop issues its four table
// loads together and forwards its own stores when two probes share a
// bucket.  The other threads only fill the table.  Three redesigns that
// keep the walk's decisions ran slower on the card and were not kept
// (PERF.md section 6): the table in shared memory with the quad loop
// probed by a warp, a warp whose lanes hold the next 32 positions'
// entries and confirmations, and a positions-only table with the window
// in a shared-memory ring; none shortens the chain of dependent steps,
// and a 192 KiB table in shared memory leaves the window a quarter of
// L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t PRIME = 2654435761u;
constexpr int HASH_LOG = 16;
constexpr int TAB_SIZE = 1 << HASH_LOG;
constexpr int TAGB_SH = HASH_LOG - 1;
constexpr int TAG_MASK = 0x7F << 24;

struct Row {
  const uint32_t* win;  // words of rows r and r+1
  const uint8_t* wb;    // the same window as bytes
  int WW;               // words in the window
  int blen, base, min_ref, limit, lit_limit;
  int max_offset, lazy, accel_log;
  int* table;
  uint8_t* out;
};

struct State {
  int ip, anchor, op, miss;
};

__device__ __forceinline__ uint32_t word_cl(const Row& R, int q) {
  q = q < 0 ? 0 : (q > R.WW - 1 ? R.WW - 1 : q);
  return R.win[q];
}

// the 4 bytes at window position i, little-endian (clamped loads)
__device__ __forceinline__ uint32_t w32(const Row& R, int i) {
  int q = i >> 2;
  uint32_t sh = (uint32_t)((i & 3) * 8);
  uint32_t lo = word_cl(R, q), hi = word_cl(R, q + 1);
  return sh == 0 ? lo : ((lo >> sh) | (hi << (32u - sh)));
}

__device__ __forceinline__ void hash_of(uint32_t w, int& h, int& tagb) {
  uint32_t u = w * PRIME;
  h = (int)(u >> (32 - HASH_LOG));
  tagb = ((int)(u << TAGB_SH)) & TAG_MASK;
}

__device__ __forceinline__ void insert_at(const Row& R, int p) {
  int h, tagb;
  hash_of(w32(R, p), h, tagb);
  R.table[h] = (R.base + p) | tagb;
}

// match length from ip against cand, the first 4 bytes known equal:
// words while they fit before lit_limit, then up to three bytes
__device__ int extend(const Row& R, int ip, int cand) {
  int l = 4;
  while (ip + l + 4 <= R.lit_limit && w32(R, ip + l) == w32(R, cand + l))
    l += 4;
  for (int t = 0; t < 3; ++t) {
    if (ip + l < R.lit_limit && R.wb[ip + l] == R.wb[cand + l]) ++l;
    else break;
  }
  return l;
}

__device__ __forceinline__ int emit_len_ext(const Row& R, int op, int v) {
  while (v >= 255) {
    R.out[op++] = 255;
    v -= 255;
  }
  R.out[op++] = (uint8_t)v;
  return op;
}

__device__ __forceinline__ int copy_lits(const Row& R, int op, int src,
                                         int n) {
  for (int k = 0; k < n; ++k) R.out[op + k] = R.wb[src + k];
  return op + n;
}

__device__ int emit_seq(const Row& R, int op, int anchor, int ip, int mlen,
                        int dist) {
  int litlen = ip - anchor;
  int tok = op++;
  if (litlen >= 15) op = emit_len_ext(R, op, litlen - 15);
  op = copy_lits(R, op, anchor, litlen);
  R.out[tok] = (uint8_t)((min(litlen, 15) << 4) | min(mlen - 4, 15));
  R.out[op++] = (uint8_t)(dist & 0xFF);
  R.out[op++] = (uint8_t)(dist >> 8);
  if (mlen - 4 >= 15) op = emit_len_ext(R, op, mlen - 19);
  return op;
}

__device__ __forceinline__ void miss_step(const Row& R, State& s, int ip) {
  s.ip = ip + 1 + (s.miss >> R.accel_log);
  s.miss += 1;
}

// confirm the candidate's bytes (tag collisions), extend, probe ip + 1
// for a strictly longer match `lazy` times, emit, insert the match tail
__device__ void match_at(const Row& R, State& s, int ip, int cand_abs,
                         uint32_t w) {
  int cand = cand_abs - R.base;
  if (w32(R, cand) != w) {
    miss_step(R, s, ip);
    return;
  }
  int lf = extend(R, ip, cand);
  int ipf = ip, candf = cand;
  for (int z = 0; z < R.lazy; ++z) {
    if (ipf + 1 >= R.limit) continue;
    int p2 = ipf + 1;
    uint32_t w2 = w32(R, p2);
    int h2, tb2;
    hash_of(w2, h2, tb2);
    int e2 = R.table[h2];
    int pos2 = R.base + p2;
    int wlo2 = max(R.min_ref, pos2 - R.max_offset);
    R.table[h2] = pos2 | tb2;
    if (e2 >= tb2 + wlo2 && e2 < tb2 + pos2) {
      int c2 = (e2 & 0xFFFFFF) - R.base;
      if (w32(R, c2) == w2) {
        int l2 = extend(R, p2, c2);
        if (l2 > lf) {
          ipf = p2;
          candf = c2;
          lf = l2;
        }
      }
    }
  }
  s.op = emit_seq(R, s.op, s.anchor, ipf, lf, ipf - candf);
  insert_at(R, ipf + lf - 2);
  s.ip = ipf + lf;
  s.anchor = ipf + lf;
  s.miss = 0;
}

__device__ void body1(const Row& R, State& s) {
  int ip = s.ip;
  int pos = R.base + ip;
  int wlo = max(R.min_ref, pos - R.max_offset);
  uint32_t w = w32(R, ip);
  int h, tagb;
  hash_of(w, h, tagb);
  int e = R.table[h];
  R.table[h] = pos | tagb;
  if (e >= tagb + wlo && e < tagb + pos) match_at(R, s, ip, e & 0xFFFFFF, w);
  else miss_step(R, s, ip);
}

__device__ void emit_row(const Row& R, int N, int* olen) {
  State s{N, N, 0, 0};
  const int qlim = R.blen - 16;
  while (s.ip < R.limit) {
    // realign, then probe four word-aligned positions per iteration;
    // every probe inserts, even after an earlier hit in the quad
    while (s.ip < R.limit && (s.ip & 3) != 0) body1(R, s);
    int q = s.ip >> 2, qp = q, fnd = 0, missq = s.miss;
    int es[4] = {0, 0, 0, 0};
    while (fnd == 0 && 4 * q <= qlim) {
      const int pos0 = R.base + 4 * q;
      const int wlo = max(R.min_ref, pos0 - (R.max_offset - 3));
      int hs[4], tbs[4];
      for (int k = 0; k < 4; ++k) hash_of(w32(R, 4 * q + k), hs[k], tbs[k]);
      for (int k = 0; k < 4; ++k) es[k] = R.table[hs[k]];
      for (int k = 1; k < 4; ++k)      // a bucket probed earlier in the quad
        for (int j = 0; j < k; ++j)    // holds that probe's own store
          if (hs[j] == hs[k]) es[k] = (pos0 + j) | tbs[j];
      for (int k = 0; k < 4; ++k) {
        R.table[hs[k]] = (pos0 + k) | tbs[k];
        bool good = es[k] >= tbs[k] + wlo && es[k] < tbs[k] + pos0 + k;
        fnd |= (good ? 1 : 0) << k;
      }
      qp = q;
      q = q + 1 + (missq >> (R.accel_log + 2));
      missq += 4;
    }
    s.miss = missq;
    if (fnd != 0) {
      int k = __ffs(fnd) - 1;
      int iph = 4 * qp + k;
      match_at(R, s, iph, es[k] & 0xFFFFFF, w32(R, iph));
    } else {
      s.ip = 4 * q;
      while (s.ip < R.limit) body1(R, s);
    }
  }
  // final literal run [anchor, blen)
  int litlen = R.blen - s.anchor;
  int op = s.op;
  R.out[op++] = (uint8_t)(min(litlen, 15) << 4);
  if (litlen >= 15) op = emit_len_ext(R, op, litlen - 15);
  op = copy_lits(R, op, s.anchor, litlen);
  *olen = op;
}

__global__ void lz4_emit_kernel(const uint8_t* __restrict__ x,
                                const int* __restrict__ lens,
                                const int* __restrict__ min_ref, int B,
                                int N, int cap, int max_offset, int lazy,
                                int accel_log, int* tables, uint8_t* out,
                                int* olen) {
  // row r starts a chain when min_ref fences off the previous row
  const int r0 = blockIdx.x;
  if (r0 > 0 && min_ref[r0] < (r0 + 1) * N) return;
  int* table = tables + (size_t)r0 * TAB_SIZE;
  for (int i = threadIdx.x; i < TAB_SIZE; i += blockDim.x) table[i] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;
  Row R;
  R.WW = 2 * N / 4;
  R.max_offset = max_offset;
  R.lazy = lazy;
  R.accel_log = accel_log;
  R.table = table;
  for (int r = r0; r < B && (r == r0 || min_ref[r] < (r + 1) * N); ++r) {
    R.wb = x + (size_t)r * N;
    R.win = (const uint32_t*)R.wb;
    R.blen = lens[r];
    R.base = r * N;
    // the wrapper's contract keeps min_ref >= base; clamping keeps a
    // caller that breaks it inside the window
    R.min_ref = max(min_ref[r], R.base);
    R.limit = R.blen - 12;
    R.lit_limit = R.blen - 5;
    R.out = out + (size_t)r * cap;
    if (r == 0)   // the reference's step-0 seed: row 0, base 0
      for (int p = 0; p < N - 3; ++p) insert_at(R, p);
    emit_row(R, N, olen + r);
  }
}

}  // namespace

extern "C" int zk_lz4_emit(const void* x, const void* lens,
                           const void* min_ref, int B, int N, int cap,
                           int max_offset, int lazy, int accel_log,
                           void* tables, void* out, void* olen,
                           void* stream) {
  if (B > 0)
    lz4_emit_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const int*)lens, (const int*)min_ref, B, N, cap,
        max_offset, lazy, accel_log, (int*)tables, (uint8_t*)out,
        (int*)olen);
  return (int)cudaGetLastError();
}
