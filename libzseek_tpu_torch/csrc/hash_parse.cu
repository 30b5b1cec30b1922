// K7: per-block zstd-fast hash parse.
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_match.py
// _parse_kernel_smem (pallas_call at :154, wrapper hash_parse_blocks_smem
// :122) in its zstd arm (start_ip = 0, end_margin = 0, min_ref = 0):
// zstd-fast's greedy single-probe parse of each block on its own, with a
// 2^16-entry table of positions reset for every block, the miss
// accelerator 1 + (miss >> 6), word-at-a-time extension and probing up to
// blen - 12.  Outputs per row: ll, ml, offv = offset + 3 for each
// sequence, n_seq and cover_end (the last anchor).
//
// On the TPU the grid steps run in order, one block per step, each
// starting from a cleared table.  The rows are independent, so here one
// CUDA block parses one row and every row of the batch runs at once.
//
// The table lives in shared memory: a 2^16-entry int32 table (256 KiB) does
// not fit a block's 227 KB, but positions are below 2^17, so each entry
// stores pos + 1 (0 = empty) in 17 bits, the low 16 in a uint16 array and
// the high bit in a 2^16-bit bitmap: 136 KiB, cleared by the whole block
// in 16-byte stores.
//
// The walk runs on warp 0, a round of 32 positions at a time (the first
// version probed one position a step on lane 0: ~1,650 cycles a sequence
// of a text row, 11.9 ms for the 64-row batch on an H100).  Lane k takes
// the position the walk reaches after k misses (ip + k while the round
// starts at <= DENSE_MISS misses, so every step is 1; else with the
// accelerator's steps), hashes it, reads its slot and loads its
// candidate's first three words, all lanes at once.  The serial walk
// writes the table only at the positions it probes, so the table a lane
// needs is the round's starting table plus the round's earlier probes: a
// lane whose bucket an earlier lane shares (__match_any_sync) takes that
// lane's position as its candidate.  The walk over the lanes is then
// found by pointer doubling on shuffles (lane k's next probe: k + 1 after
// a miss, k + l after a hit of length l; five steps cover 32 lanes); a
// round past DENSE_MISS misses ends at its first hit.  The round is cut
// before the first probed lane whose forwarding lane the walk skipped
// (its true candidate is older: the next round reads it from the table)
// and before a hit past cap.  A hit's length comes from the xor of its
// first unequal word (two words past the first, compared by the lane
// itself); a longer match is extended by the whole warp, 4 x 32 words a
// step.  The probed lanes then write the sequences and the table, the
// last prober of each bucket winning (the bitmap by shared-memory
// atomics, only where a bit changes).  ops/hash_parse.py parse_rounds
// mirrors these rounds in Python for the tests.
//
// What bounds it: a round is a chain of dependent steps, ~2,200 cycles
// on an H100 (clock counters): the round's words and slots with the
// bucket match (~750), the candidates' words and the ballots (~600), the
// walk over the lanes (~250), the cuts (~200) and the emission with the
// table writes (~420).  A text row takes ~2,900 rounds of ~5.6
// sequences; the batch's slowest row sets the time.  Loading the next
// round's words during the emission, or copying the row ahead of the
// walk into shared memory by the block's other warps, did not shorten it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t PRIME = 2654435761u;
constexpr int HASH_LOG = 16;
constexpr int TAB_SIZE = 1 << HASH_LOG;
constexpr int SMEM_BYTES = TAB_SIZE * 2 + TAB_SIZE / 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DENSE_MISS = 32;    // miss <= 32 + 31 lanes: every step is 1
constexpr int LONG_LEN = 12;      // a lane compares words at +4 and +8
constexpr int EXT_UNROLL = 4;     // ballots of 32 words a warp step

// the 4 bytes at position i of a row, little-endian (i <= N - 4; lastw =
// N / 4 - 1): two loads and a funnel shift, no branch, so that the
// compiler can issue a round's loads together
__device__ __forceinline__ uint32_t w32(const uint32_t* xw, int i,
                                        int lastw) {
  const int q = i >> 2;
  return __funnelshift_r(xw[q], xw[min(q + 1, lastw)], (i & 3) * 8);
}

// sum(i >> 6 for i < n): the accelerator's extra steps over n misses
__device__ __forceinline__ int miss_skip(int n) {
  const int q = n >> 6, r = n & 63;
  return 32 * q * (q - 1) + q * r;
}

// lanes 0..k (k <= 31) and lanes k.. (k <= 31)
__device__ __forceinline__ unsigned upto(int k) {
  return k >= 31 ? FULL : (2u << k) - 1u;
}
__device__ __forceinline__ unsigned from(int k) { return ~((1u << k) - 1u); }

// a match of >= LONG_LEN bytes at pos against cand, extended by the warp
// (EXT_UNROLL ballots a step, each 32 words), the first unequal word's
// xor ending it; within 4 bytes of the row's end, byte by byte
__device__ int warp_length(const uint8_t* xb, const uint32_t* xw, int lastw,
                           int blen, int pos, int cand, int lane) {
  const int R = blen - pos;
  int l = LONG_LEN;
  while (true) {
    unsigned bal[EXT_UNROLL];
    uint32_t a[EXT_UNROLL], b[EXT_UNROLL];
#pragma unroll
    for (int u = 0; u < EXT_UNROLL; ++u) {   // loads clamped into the row
      const int p = min(l + 4 * (lane + 32 * u), R - 4);
      a[u] = w32(xw, pos + p, lastw);
      b[u] = w32(xw, cand + p, lastw);
    }
#pragma unroll
    for (int u = 0; u < EXT_UNROLL; ++u) {
      const int p = l + 4 * (lane + 32 * u);
      bal[u] = __ballot_sync(FULL, p + 4 <= R && a[u] == b[u]);
    }
    int u = 0;
    while (u < EXT_UNROLL && bal[u] == FULL) ++u;
    if (u == EXT_UNROLL) {
      l += 128 * EXT_UNROLL;
      continue;
    }
    l += 128 * u + 4 * (__ffs(~bal[u]) - 1);
    break;
  }
  if (l + 4 <= R) {
    const uint32_t x = w32(xw, pos + l, lastw) ^ w32(xw, cand + l, lastw);
    return l + ((__ffs(x) - 1) >> 3);
  }
  while (l < R && xb[pos + l] == xb[cand + l]) ++l;
  return l;
}

__global__ void __launch_bounds__(256) hash_parse_kernel(
    const uint8_t* __restrict__ x, const int* __restrict__ lens, int N,
    int cap, int max_offset, int* ll, int* ml, int* offv, int* nn) {
  extern __shared__ uint4 smem4[];
  for (int i = threadIdx.x; i < SMEM_BYTES / 16; i += blockDim.x)
    smem4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  uint16_t* tlo = reinterpret_cast<uint16_t*>(smem4);
  uint32_t* thi = reinterpret_cast<uint32_t*>(smem4) + TAB_SIZE / 2;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int r = blockIdx.x;
  const uint8_t* xb = x + (size_t)r * N;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xb);
  const int lastw = N / 4 - 1;
  int* rll = ll + (size_t)r * cap;
  int* rml = ml + (size_t)r * cap;
  int* roff = offv + (size_t)r * cap;
  const int blen = lens[r];
  const int limit = blen - 12;
  int ip = 0, anchor = 0, cnt = 0, miss = 0;
  while (ip < limit) {
    // lane k: the position after k misses, its words, slot and candidate
    const int ip0 = ip, m0 = miss, s0 = miss_skip(miss);
    const bool dense = m0 <= DENSE_MISS;
    auto pos_of = [&](int k) {
      return dense ? ip0 + k : ip0 + k + miss_skip(m0 + k) - s0;
    };
    const int pos = pos_of(lane);
    const bool valid = pos < limit;
    const unsigned nv = __ballot_sync(FULL, valid);
    uint32_t w = 0, w1 = 0, w2 = 0, c0 = 0, c1 = 0, c2 = 0;
    int h = TAB_SIZE + lane;   // no valid lane's bucket
    int tval = -1;
    if (valid) {
      w = w32(xw, pos, lastw);
      w1 = w32(xw, pos + 4, lastw);
      w2 = w32(xw, pos + 8, lastw);
      h = (int)((w * PRIME) >> (32 - HASH_LOG));
      tval = (int)(tlo[h] | (((thi[h >> 5] >> (h & 31)) & 1u) << 16)) - 1;
      if (tval >= 0) {   // loaded before the buckets are compared
        c0 = w32(xw, tval, lastw);
        c1 = w32(xw, tval + 4, lastw);
        c2 = w32(xw, tval + 8, lastw);
      }
    }
    const unsigned g = __match_any_sync(FULL, h);
    const unsigned gb = g & below;
    const int jd = gb ? 31 - __clz(gb) : -1;
    {   // a forwarded candidate's words are lane jd's own
      const int src = jd >= 0 ? jd : lane;
      const uint32_t f0 = __shfl_sync(FULL, w, src),
                     f1 = __shfl_sync(FULL, w1, src),
                     f2 = __shfl_sync(FULL, w2, src);
      if (jd >= 0) {
        c0 = f0;
        c1 = f1;
        c2 = f2;
      }
    }
    const int cand = jd >= 0 ? pos_of(jd) : tval;
    const bool hit = valid && cnt < cap && cand >= 0 &&
                     pos - cand <= max_offset && c0 == w;
    const uint32_t x1 = w1 ^ c1, x2 = w2 ^ c2;
    const bool lng = hit && !x1 && !x2;
    int len = !hit ? 0
              : x1 ? 4 + ((__ffs(x1) - 1) >> 3)
              : x2 ? 8 + ((__ffs(x2) - 1) >> 3) : LONG_LEN;
    const unsigned hb = __ballot_sync(FULL, hit);
    const unsigned lb = __ballot_sync(FULL, lng);

    // the walk over the lanes: P = the lanes it probes.  Dense rounds by
    // pointer doubling over the lanes: lane k's next probe is k + 1 after
    // a miss, k + len after a hit, none after a long hit (the walk's
    // last); S = the lanes visited from k within 2^s steps
    unsigned P;
    if (!dense) {
      P = hb ? upto(__ffs(hb) - 1) : nv;
    } else {
      int J = !valid || lng ? 32 : min(lane + (hit ? len : 1), 32);
      unsigned S = valid ? 1u << lane : 0u;
#pragma unroll
      for (int st = 0; st < 5; ++st) {
        const int src = J < 32 ? J : lane;
        const unsigned Sj = __shfl_sync(FULL, S, src);
        const int Jj = __shfl_sync(FULL, J, src);
        if (J < 32) {
          S |= Sj;
          J = Jj;
        }
      }
      P = __shfl_sync(FULL, S, 0);
    }
    // cuts: before a probed lane whose forwarding lane was skipped, then
    // before a hit past cap
    int stop = -1;
    const unsigned vb = __ballot_sync(
        FULL, ((P >> lane) & 1) && jd >= 0 && !((P >> jd) & 1));
    if (vb) {
      stop = __ffs(vb) - 1;
      P &= (1u << stop) - 1u;
    }
    unsigned HP = hb & P;
    if (__popc(HP) > cap - cnt) {
      unsigned rest = HP;
      for (int i = 0; i < cap - cnt; ++i) rest &= rest - 1u;
      stop = __ffs(rest) - 1;
      P &= (1u << stop) - 1u;
      HP &= P;
    }
    const int lastp = 31 - __clz(P);   // P holds lane 0
    const bool last_hit = (HP >> lastp) & 1;
    if (last_hit && ((lb >> lastp) & 1)) {   // a long match is the last
      const int l = warp_length(xb, xw, lastw, blen, pos_of(lastp),
                                __shfl_sync(FULL, cand, lastp), lane);
      if (lane == lastp) len = l;
    }
    const int end = pos + len;

    // the walk's next position, then the sequences and the table
    const int last_end = __shfl_sync(FULL, end, lastp);
    ip = stop >= 0 ? pos_of(stop) : last_hit ? last_end : pos_of(lastp + 1);
    if (HP) {
      const unsigned hbelow = HP & below;
      const int lh = 31 - __clz(HP);
      const int prev_end =
          __shfl_sync(FULL, end, hbelow ? 31 - __clz(hbelow) : 0);
      if ((HP >> lane) & 1) {
        const int s = cnt + __popc(hbelow);
        rll[s] = pos - (hbelow ? prev_end : anchor);
        rml[s] = len;
        roff[s] = pos - cand + 3;
      }
      anchor = __shfl_sync(FULL, end, lh);
      cnt += __popc(HP);
      miss = __popc(P & ~upto(lh));
    } else {
      miss += __popc(P);
    }
    if (((P >> lane) & 1) && !(g & P & ~upto(lane))) {
      const int e = pos + 1;
      tlo[h] = (uint16_t)e;
      if ((e >> 16) != ((tval + 1) >> 16)) {   // the bit changes: rare
        const uint32_t bit = 1u << (h & 31);
        if (e >> 16)
          atomicOr(thi + (h >> 5), bit);
        else
          atomicAnd(thi + (h >> 5), ~bit);
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    nn[2 * r] = cnt;
    nn[2 * r + 1] = anchor;
  }
}

}  // namespace

extern "C" int zk_hash_parse(const void* x, const void* lens, int B, int N,
                             int cap, int max_offset, void* ll, void* ml,
                             void* offv, void* nn, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hash_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    hash_parse_kernel<<<B, 256, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const int*)lens, N, cap, max_offset, (int*)ll,
        (int*)ml, (int*)offv, (int*)nn);
  return (int)cudaGetLastError();
}
