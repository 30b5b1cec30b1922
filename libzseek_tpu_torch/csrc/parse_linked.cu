// K1: linked-block gated zstd parse, every level.
//
// Replaces the TPU kernel libzseek_tpu/ops/pallas_match.py
// _parse_linked_kernel (pallas_call at :914, wrapper
// zstd_parse_linked_smem :853): zstd-fast's greedy LZ77 parse over a
// window of [previous block | this block], with a persistent tagged hash
// table {tag:7, pos:24}, the miss accelerator and the in-kernel
// profitability gate (gated_policy "halve").  Levels <= 3 run the quad
// miss loop on one 2^16-entry table.  Levels >= 4 add the arms of
// make_arm / do_match_full (:338-678): `dual` (a 2^15-entry short half
// hashed on 5 bytes and a 2^14-entry long quarter hashed on 8 bytes,
// both probed and seeded at every position, the long candidate first;
// in strict rows a short-only candidate confirms on 4 bytes, short4),
// `lazy` 1 or 2 (after a confirmed hit, probe ip+1 in the long quarter
// and take a strictly longer match) and `rep_probe` (the previous kept
// match's distance is tried at every position and wins over the table);
// with `dual` the walk single-steps (run_single, :680).
//
// On the TPU the grid runs in order and the table lives in SMEM across
// grid steps.  Here one CUDA block walks one CHAIN of rows in order: a
// chain starts at every row whose min_abs fences off the previous row
// (a frame start), because an entry written before that row can never
// pass the window check (its position is below min_abs), exactly like an
// empty slot, in each dual sub-table too (ops/parse_linked.py proves it).
// Chains run in parallel.  The 2^16-entry table (256 KiB) does not fit a
// block's shared memory, so below level 4 it is per-chain scratch in
// device memory that the block fills with -1 at chain start.  The dual
// arms use 2^15 + 2^14 entries (192 KiB), which fit: their table lives in
// the block's dynamic shared memory.
//
// What bounds it.  A chain is one ordered walk: the table carries from
// row to row and every decision from position to position.  The first
// version walked it on one thread.  Clock counters on an H100 (level 9,
// 64 rows of 64 KiB in 4 chains) put the launch at the text chain's
// walk, 6.1e8 cycles against 0.5-0.9e8 for the other three: 782,697
// probed positions, 90 % of them misses, at ~340 cycles a probe (a
// dependent chain of window loads, hashing and table loads), plus
// ~1,800 cycles a match in its serial confirm, extend, lazy steps,
// inserts and backward extension.  The zeros chain spent its time in
// 64-byte extend gallops, 42 cycles a byte.
//
// So the walk now runs on a whole warp, still one ordered walk:
//  - the dual arms' miss run: the 32 lanes take the next 32 positions the
//    miss accelerator would visit (a prefix sum of 1 + (miss >> accel)),
//    each loads its 8 bytes, runs the repcode check and hashes both
//    sub-tables at once.  A lane reads its buckets from the table, or,
//    when an earlier lane of the run writes the same bucket, takes that
//    lane's value (__match_any_sync), which is what the table would hold
//    when the serial walk reached it.  The first lane that hits ends the
//    run; the lanes up to it seed the table, the last writer of each
//    bucket winning, and the walk moves to the hit.
//  - extend, the backward extension and the lazy steps' extends compare
//    32 words (or bytes) a step with one __ballot_sync, as K7 does;
//  - a match's table inserts hash on separate lanes, the last writer of
//    a bucket winning.
// The rest of a position's logic runs on every lane with the same
// values; lane 0 writes the outputs.  The level <= 3 quad loop runs the
// same way and shares the warp's match arm.
//
// What bounds it now (counters on the card, level 9): still the text
// chain, ~1,350 cycles a run and ~3,000 a match, most of it waiting on
// the candidate's window lines from L2 (294-508 cycles a load against
// 50 from L1; the warp operations take 22-67): a match's confirm,
// extension, lazy steps and backward extension each touch them.  L1
// prefetches of the candidate's lines at the hit hide part of that; the
// 128 KiB window does not fit beside the table in shared memory.
//
// Unwritten ll/ml/offv slots hold INT32_MIN, the value the reference's
// interpret mode leaves there, so whole outputs compare equal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t PRIME = 2654435761u;
constexpr uint32_t GOLD = 0x9E3779B1u;
constexpr int HASH_LOG = 16;
constexpr int TAB_SIZE = 1 << HASH_LOG;
constexpr int SHORT_LOG = HASH_LOG - 1;     // dual: short half
constexpr int LONG_LOG = HASH_LOG - 2;      // dual: long quarter
constexpr int LONG_OFF = 1 << SHORT_LOG;
constexpr int DUAL_SIZE = LONG_OFF + (1 << LONG_LOG);
constexpr int TAG_MASK = 0x7F << 24;
constexpr int UNWRITTEN = (int)0x80000000;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Row {
  const uint32_t* win;  // words of x2 rows b and b+1
  int WW;               // words in the window
  int N, blen, base, min_abs, h16, limit, lim;
  int cap, max_offset, gate_bits, min_match, accel_log, lazy;
  bool strict, dual, rep_probe;
  int* table;
  int* ll;
  int* ml;
  int* off;
  uint32_t* mask;
};

struct State {
  int ip, anchor, cnt, miss, rep;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned lanes_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned lanes_gt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_gt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ uint32_t word_cl(const Row& R, int q) {
  q = q < 0 ? 0 : (q > R.WW - 1 ? R.WW - 1 : q);
  return R.win[q];
}

__device__ __forceinline__ uint32_t w32(const Row& R, int i) {
  int q = i >> 2;
  uint32_t sh = (uint32_t)((i & 3) * 8);
  uint32_t lo = word_cl(R, q), hi = word_cl(R, q + 1);
  return sh == 0 ? lo : ((lo >> sh) | (hi << (32u - sh)));
}

__device__ __forceinline__ uint32_t w32c(const Row& R, int i) {
  int q = i >> 2;
  uint32_t sh = (uint32_t)((i & 3) * 8);
  uint32_t lo = R.win[q];
  uint32_t hi = R.win[min(q + 1, R.WW - 1)];
  return sh == 0 ? lo : ((lo >> sh) | (hi << (32u - sh)));
}

__device__ __forceinline__ int byte_cl(const Row& R, int i) {
  return (int)((word_cl(R, i >> 2) >> ((i & 3) * 8)) & 0xFF);
}

__device__ __forceinline__ int byte_c(const Row& R, int i) {
  return (int)((R.win[i >> 2] >> ((i & 3) * 8)) & 0xFF);
}

// start bringing the window's line at byte i (clamped) into L1
__device__ __forceinline__ void prefetch(const Row& R, int i) {
  i = i < 0 ? 0 : (i > 4 * R.WW - 1 ? 4 * R.WW - 1 : i);
  asm volatile("prefetch.global.L1 [%0];" ::"l"(
      reinterpret_cast<const char*>(R.win) + i));
}

// the word at p and the one after it.  `clamped` mirrors the reference's
// in-match inserts, whose loads past the window end repeat the last word;
// probes stay >= 12 bytes from the block end.
__device__ __forceinline__ void load_we(const Row& R, int p, bool clamped,
                                        uint32_t& w, uint32_t& ext4) {
  int q = p >> 2;
  uint32_t sh = (uint32_t)((p & 3) * 8);
  uint32_t lo = R.win[q];
  uint32_t hi, w3;
  if (clamped) {
    hi = R.win[min(q + 1, R.WW - 1)];
    w3 = R.win[min(q + 2, R.WW - 1)];
  } else {
    hi = R.win[q + 1];
    w3 = R.win[q + 2];
  }
  w = sh == 0 ? lo : ((lo >> sh) | (hi << (32u - sh)));
  ext4 = sh == 0 ? hi : ((hi >> sh) | (w3 << (32u - sh)));
}

// bucket (tlog bits, + off) and tag pre-shifted to bits 24..30
__device__ __forceinline__ void bucket_tag(uint32_t u, int tlog, int off,
                                           int& h, int& tagb) {
  h = (int)(u >> (32 - tlog)) + off;
  tagb = ((int)(u << (tlog - 1))) & TAG_MASK;
}

// the one table's hash (8 bytes in strict rows, else 5) or, with dual,
// the short half's: the reference's sig_u over ext4's low byte, in the
// row's strict or non-strict form
__device__ __forceinline__ void hash_main(const Row& R, uint32_t w,
                                          uint32_t ext4, int& h,
                                          int& tagb) {
  uint32_t ext = (R.dual || !R.strict) ? (ext4 & 0xFFu) : ext4;
  uint32_t u = R.strict ? (w ^ (ext * GOLD)) * PRIME
                        : (w ^ (ext << 13)) * PRIME;
  bucket_tag(u, R.dual ? SHORT_LOG : HASH_LOG, 0, h, tagb);
}

// the dual long quarter's hash: 8 bytes
__device__ __forceinline__ void hash_long(uint32_t w, uint32_t ext4,
                                          int& h, int& tagb) {
  bucket_tag((w ^ (ext4 * GOLD)) * PRIME, LONG_LOG, LONG_OFF, h, tagb);
}

// a probe's bucket and tag (probes stay >= 12 bytes from the block end)
__device__ __forceinline__ void hash_at(const Row& R, int p, int& h,
                                        int& tagb) {
  uint32_t w, ext4;
  load_we(R, p, false, w, ext4);
  hash_main(R, w, ext4, h, tagb);
}

// the index of the highest lane of `m` (nonzero)
__device__ __forceinline__ int top_lane(unsigned m) { return 31 - __clz(m); }

// writes of several lanes to one table in the serial walk's order: of
// the active lanes that write bucket h, the highest lane's value wins
__device__ __forceinline__ void put_last(int* T, bool act, int h, int v) {
  const unsigned am = __ballot_sync(FULL, act);
  const unsigned grp = __match_any_sync(FULL, act ? h : -1 - lane_id());
  if (act && (grp & am & lanes_gt()) == 0) T[h] = v;
}

// one insert at p, the same on every lane
__device__ __forceinline__ void insert_at(const Row& R, int p) {
  uint32_t w, ext4;
  load_we(R, p, true, w, ext4);
  int h, tagb;
  if (R.dual) {
    hash_long(w, ext4, h, tagb);
    R.table[h] = (R.base + p) | tagb;
  }
  hash_main(R, w, ext4, h, tagb);
  R.table[h] = (R.base + p) | tagb;
}

// the table inserts of one match: lane k < nins - 1 takes ip + (k+1)*stp,
// lane nins - 1 ip + le - 2 (one insert on every lane below 2), with the clamped
// loads of the reference's in-match inserts; then a barrier, so every
// lane reads what any lane wrote
__device__ __forceinline__ void insert_span(const Row& R, int ip, int le,
                                            int nins, int stp) {
  if (nins <= 1) {        // one insert (matches under 64 bytes)
    insert_at(R, ip + le - 2);
    return;
  }
  const int lane = lane_id();
  const int c = nins;
  const bool act = lane < c;
  const int p = lane < c - 1 ? ip + (lane + 1) * stp : ip + le - 2;
  int h = 0, tagb = 0, hl = 0, tl = 0;
  if (act) {
    uint32_t w, ext4;
    load_we(R, p, true, w, ext4);
    hash_main(R, w, ext4, h, tagb);
    if (R.dual) hash_long(w, ext4, hl, tl);
  }
  const int v = R.base + p;
  if (R.dual) put_last(R.table, act, hl, v | tl);
  put_last(R.table, act, h, v | tagb);
  __syncwarp();
}

// the length of the common prefix of ip.. and cand.. from byte 4 on,
// plus 4, capped at the block end: 32 words a step, one ballot
__device__ __forceinline__ int extend(const Row& R, int ip, int cand) {
  const int lim = R.N + R.blen;
  const int lane = lane_id();
  int l = 4;
  for (;;) {
    const int a = ip + l + 4 * lane;
    int k = 0;  // bytes of this lane's word that match, within lim
    if (a < lim) {
      const uint32_t x = w32c(R, a) ^ w32(R, cand + l + 4 * lane);
      k = x == 0 ? 4 : ((__ffs((int)x) - 1) >> 3);
      k = min(k, lim - a);
    }
    const unsigned part = __ballot_sync(FULL, k < 4);
    if (part == 0) {
      l += 128;
      continue;
    }
    const int f = __ffs((int)part) - 1;
    return l + 4 * f + __shfl_sync(FULL, k, f);
  }
}

// bytes before ip that equal those before cand, back to the anchor and
// above the window's low fence: 32 bytes a step
__device__ __forceinline__ int back_extend(const Row& R, int ip, int cand,
                                           int anchor, int minw) {
  const int lane = lane_id();
  for (int kb = 0;; kb += 32) {
    const int j = kb + lane;
    const bool go = ip - j > anchor && cand - j > minw &&
                    byte_c(R, ip - j - 1) == byte_cl(R, max(cand - j - 1, 0));
    const unsigned stop = __ballot_sync(FULL, !go);
    if (stop) return kb + __ffs((int)stop) - 1;
  }
}

__device__ __forceinline__ int floor_log2(int v) { return 31 - __clz(v); }

__device__ __forceinline__ void clear_mask(const Row& R, int ips, int lf) {
  int a = ips - R.N;
  int eend = a + lf;
  int wa = a >> 5, we = (eend - 1) >> 5;
  uint32_t lowm = (1u << (uint32_t)(a & 31)) - 1u;
  uint32_t eb = (uint32_t)(eend & 31);
  uint32_t highm = eb == 0 ? 0u : (0xFFFFFFFFu << eb);
  uint32_t mm = wa == we ? (lowm | highm) : lowm;
  if (lane_id() == 0) {
    R.mask[wa] &= mm;
    if (we > wa) R.mask[we] &= highm;
  }
  for (int wk = wa + 1 + lane_id(); wk < we; wk += 32) R.mask[wk] = 0u;
  __syncwarp();
}

// lazy matching: probe ip+1 (the long quarter with dual, else the one
// table) `lazy` times, seeding the slot whether or not it was good; a
// strictly longer confirmed match there moves the match, and the skipped
// byte joins the literals.  The second step probes from the updated ip.
__device__ __forceinline__ void lazy_steps(const Row& R, int& ip,
                                           int& cand_abs, int& l) {
  for (int z = 0; z < R.lazy; ++z) {
    if (ip + 1 >= R.limit) continue;
    const int p2 = ip + 1;
    int h2, tb2;
    if (R.dual) {
      uint32_t w, ext4;
      load_we(R, p2, false, w, ext4);
      hash_long(w, ext4, h2, tb2);
    } else {
      hash_at(R, p2, h2, tb2);
    }
    const int e2 = R.table[h2];
    const int pos2 = R.base + p2;
    const int wlo2 = max(R.min_abs, pos2 - R.max_offset);
    R.table[h2] = pos2 | tb2;
    if (e2 >= tb2 + wlo2 && e2 < tb2 + pos2) {
      const int c2_abs = e2 & 0xFFFFFF;
      const int c2 = c2_abs - R.base;
      prefetch(R, c2 + 96);
      if (w32(R, c2) == w32c(R, p2)) {
        const int l2 = extend(R, p2, c2);
        if (l2 > l) {
          ip = p2;
          cand_abs = c2_abs;
          l = l2;
        }
      }
    }
  }
}

// shared match arm: extend, [lazy steps], reseed the table across the
// span, backward-extend, gate, emit (slot cnt is written even when the
// match is dropped; the next survivor overwrites it)
__device__ __forceinline__ void match_full(const Row& R, State& s, int ip,
                                           int cand_abs, bool conf) {
  int l = extend(R, ip, cand_abs - R.base);
  if (conf && R.lazy > 0) lazy_steps(R, ip, cand_abs, l);
  int pos = R.base + ip;
  int dist = pos - cand_abs;
  int cand = cand_abs - R.base;
  int le = conf ? l : 2;
  int nins = min(le >> 5, 8);
  int stp = le / max(nins, 1);
  insert_span(R, ip, le, nins, stp);
  int kb = back_extend(R, ip, cand, s.anchor, R.min_abs - R.base);
  int ips = ip - kb;
  int lf = l + kb;
  int ebits = floor_log2(dist + 3);
  bool cheap = dist == s.rep && s.cnt > 0 && ips > s.anchor;
  bool keep = conf && lf >= (cheap ? 4 : R.min_match) &&
              lf * R.h16 > (cheap ? max(R.gate_bits - 6, 6)
                                  : R.gate_bits + ebits) * 16;
  if (lane_id() == 0) {
    R.ll[s.cnt] = ips - s.anchor;
    R.ml[s.cnt] = lf;
    R.off[s.cnt] = dist + 3;
  }
  if (keep) clear_mask(R, ips, lf);
  int ipn = conf ? ip + l : ip + 1 + (s.miss >> R.accel_log);
  int missn = keep ? 0 : (conf ? (s.miss >> 1) : s.miss + 1);
  s.ip = ipn;
  if (keep) {
    s.anchor = ip + l;
    s.rep = dist;
  }
  s.cnt += keep ? 1 : 0;
  s.miss = missn;
}

// confirm the candidate; the non-strict arm fast-rejects confirmed short
// matches that cannot pass the gate.  short4: the candidate came from the
// dual short half alone, and 4 confirmed bytes suffice in a strict row
__device__ __forceinline__ void match_at(const Row& R, State& s, int ip,
                                         int cand_abs, bool short4) {
  int cand = cand_abs - R.base;
  bool conf4 = w32(R, cand) == w32c(R, ip);
  if (R.strict) {
    bool conf = conf4 && w32(R, cand + 4) == w32c(R, ip + 4);
    conf = conf || (conf4 && R.base + ip - cand_abs == s.rep && s.cnt > 0);
    conf = conf || (conf4 && short4);
    match_full(R, s, ip, cand_abs, conf);
    return;
  }
  uint32_t x = w32(R, cand + 4) ^ w32c(R, ip + 4);
  int l8 = x == 0 ? 8 : 4 + ((__ffs((int)x) - 1) >> 3);
  int pos = R.base + ip;
  int dist = pos - cand_abs;
  int ebits = floor_log2(dist + 3);
  bool cheap8 = dist == s.rep && s.cnt > 0;
  bool prof8 = l8 >= (cheap8 ? 4 : R.min_match) &&
               l8 * R.h16 > (cheap8 ? max(R.gate_bits - 6, 6)
                                    : R.gate_bits + ebits) * 16;
  int minw = R.min_abs - R.base;
  bool bk0 = ip > s.anchor && cand > minw &&
             byte_c(R, ip - 1) == byte_cl(R, max(cand - 1, 0));
  if (conf4 && l8 < 8 && !prof8 && !bk0) {
    insert_at(R, ip + l8 - 2);
    s.ip = ip + l8;
    s.miss = s.miss >> 1;
    return;
  }
  match_full(R, s, ip, cand_abs, conf4);
}

__device__ __forceinline__ void body1(const Row& R, State& s) {
  int ip = s.ip;
  int pos = R.base + ip;
  int wlo = max(R.min_abs, pos - R.max_offset);
  int h, tagb;
  hash_at(R, ip, h, tagb);
  int e = R.table[h];
  bool good = e >= tagb + wlo && e < tagb + pos && s.cnt < R.cap;
  R.table[h] = pos | tagb;
  if (good) {
    match_at(R, s, ip, e & 0xFFFFFF, false);
  } else {
    s.ip = ip + 1 + (s.miss >> R.accel_log);
    s.miss += 1;
  }
}

// the dual arms, from s.ip on until the first position that finds a
// match: lane j takes the j-th position the serial walk would probe if
// all before it missed.  Each position runs the repcode probe and reads
// both sub-tables as the serial walk would (a bucket an earlier lane
// seeds reads that lane's value); a rep hit wins, then the long
// candidate, then the short.  The lanes up to the first hit seed the
// table, then the hit's match runs.
__device__ __forceinline__ void run_dual(const Row& R, State& s) {
  const int lane = lane_id();
  const int d = 1 + ((s.miss + lane) >> R.accel_log);
  int incl = d;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int p = s.ip + incl - d;
  const bool valid = p < R.limit;
  const unsigned vmask = __ballot_sync(FULL, valid);
  const int pos = R.base + p;
  const int wlo = max(R.min_abs, pos - R.max_offset);
  bool rep_hit = false;
  int hs = -1 - lane, ts = 0, hl = -1 - lane, tl = 0;
  if (valid) {
    rep_hit = R.rep_probe && s.rep > 0 && s.cnt < R.cap &&
              w32(R, max(p - s.rep, 0)) == w32c(R, p);
    uint32_t w, ext4;
    load_we(R, p, false, w, ext4);
    hash_main(R, w, ext4, hs, ts);
    hash_long(w, ext4, hl, tl);
  }
  const unsigned gs = __match_any_sync(FULL, hs);
  const unsigned gl = __match_any_sync(FULL, hl);
  const int vs = pos | ts, vl = pos | tl;
  const unsigned ps = gs & lanes_lt(), pl = gl & lanes_lt();
  const int fs = __shfl_sync(FULL, vs, ps ? top_lane(ps) : lane);
  const int fl = __shfl_sync(FULL, vl, pl ? top_lane(pl) : lane);
  int es = -1, el = -1;
  if (valid) {
    es = ps ? fs : R.table[hs];
    el = pl ? fl : R.table[hl];
  }
  const bool good_l = el >= tl + wlo && el < tl + pos;
  const bool good_s = es >= ts + wlo && es < ts + pos;
  const bool hit = valid && (rep_hit || ((good_l || good_s) && s.cnt < R.cap));
  if (hit) {   // the candidate's lines, for the confirm and the extensions
    const int cand = rep_hit ? p - s.rep
                             : ((good_l ? el : es) & 0xFFFFFF) - R.base;
    prefetch(R, cand - 32);
    prefetch(R, cand + 96);
  }
  const unsigned hits = __ballot_sync(FULL, hit);
  const int h = hits ? __ffs((int)hits) - 1 : 32;
  const unsigned done = (h < 32 ? (2u << h) - 1u : FULL) & vmask;
  if ((done >> lane) & 1u) {
    if ((gs & done & lanes_gt()) == 0) R.table[hs] = vs;
    if ((gl & done & lanes_gt()) == 0) R.table[hl] = vl;
  }
  __syncwarp();
  if (h == 32) {
    const int n = __popc(vmask);
    s.miss += n;
    s.ip = __shfl_sync(FULL, p + d, n - 1);
    return;
  }
  const int ph = __shfl_sync(FULL, p, h);
  const bool rep_h = __shfl_sync(FULL, rep_hit, h);
  const bool long_h = __shfl_sync(FULL, good_l, h);
  const int e_h = __shfl_sync(FULL, long_h ? el : es, h);
  s.miss += h;
  s.ip = ph;
  if (rep_h)
    match_at(R, s, ph, R.base + ph - s.rep, false);
  else
    match_at(R, s, ph, e_h & 0xFFFFFF, !long_h);
}

// one row on one warp; every lane holds the same state
__device__ __forceinline__ void parse_row(const Row& R, int* nn) {
  State s{R.N, R.N, 0, 0, 0};
  if (R.dual) {
    while (s.ip < R.limit) run_dual(R, s);
  } else {
    const int qlim = R.N + R.blen - 12 - 4;
    while (s.ip < R.limit) {
      // realign, then probe four word-aligned positions per iteration;
      // every probe inserts, even after an earlier hit in the quad
      while (s.ip < R.limit && (s.ip & 3) != 0) body1(R, s);
      int q = s.ip >> 2, qp = q, fnd = 0, missq = s.miss;
      int es[4] = {0, 0, 0, 0};
      while (fnd == 0 && 4 * q <= qlim) {
        int pos0 = R.base + 4 * q;
        int wlo = max(R.min_abs, pos0 - (R.max_offset - 3));
        for (int k = 0; k < 4; ++k) {
          int h, tagb;
          hash_at(R, 4 * q + k, h, tagb);
          int e = R.table[h];
          int pos_k = pos0 + k;
          bool good = e >= tagb + wlo && e < tagb + pos_k;
          R.table[h] = pos_k | tagb;
          fnd |= (good ? 1 : 0) << k;
          es[k] = e;
        }
        qp = q;
        q = q + 1 + (missq >> (R.accel_log + 2));
        missq += 4;
      }
      s.miss = missq;
      if (fnd != 0 && s.cnt < R.cap) {
        int k = __ffs(fnd) - 1;
        match_at(R, s, 4 * qp + k, es[k] & 0xFFFFFF, false);
      } else {
        s.ip = 4 * q;
        while (s.ip < R.limit) body1(R, s);
      }
    }
  }
  if (lane_id() == 0) {
    nn[0] = s.cnt;
    nn[1] = s.anchor - R.N;
  }
}

__global__ void __launch_bounds__(128) parse_linked_kernel(
    const uint32_t* __restrict__ x2w, const int* __restrict__ lens,
    const int* __restrict__ min_abs, const int* __restrict__ h16,
    const int* __restrict__ bounds, int N, int cap, int max_offset,
    int gate_bits, int min_match, int accel_log, int strict_h16_x6,
    int lazy, int dual, int rep_probe, int* tables, int* ll, int* ml,
    int* off, int* nn, uint32_t* mask) {
  extern __shared__ int dual_table[];
  const int c = blockIdx.x;
  const int r0 = bounds[c], r1 = bounds[c + 1];
  const int NW = N / 4, NWM = N / 32;
  int* table = dual ? dual_table : tables + (size_t)c * TAB_SIZE;
  const int tsize = dual ? DUAL_SIZE : TAB_SIZE;
  for (int i = threadIdx.x; i < tsize; i += blockDim.x) table[i] = -1;
  for (int r = r0; r < r1; ++r) {
    int* llr = ll + (size_t)r * cap;
    int* mlr = ml + (size_t)r * cap;
    int* offr = off + (size_t)r * cap;
    uint32_t* maskr = mask + (size_t)r * NWM;
    for (int i = threadIdx.x; i < cap; i += blockDim.x) {
      llr[i] = UNWRITTEN;
      mlr[i] = UNWRITTEN;
      offr[i] = UNWRITTEN;
    }
    for (int i = threadIdx.x; i < NWM; i += blockDim.x) maskr[i] = 0xFFFFFFFFu;
    __syncthreads();
    if (threadIdx.x < 32) {
      Row R;
      R.win = x2w + (size_t)r * NW;
      R.WW = 2 * NW;
      R.N = N;
      R.blen = lens[r];
      R.base = r * N;
      R.min_abs = min_abs[r];
      R.h16 = h16[r];
      R.limit = N + R.blen - 12;
      R.lim = N + R.blen;
      R.cap = cap;
      R.max_offset = max_offset;
      R.gate_bits = gate_bits;
      R.min_match = min_match;
      R.accel_log = accel_log;
      R.lazy = lazy;
      R.strict = 6 * R.h16 <= strict_h16_x6;
      R.dual = dual != 0;
      R.rep_probe = rep_probe != 0;
      R.table = table;
      R.ll = llr;
      R.ml = mlr;
      R.off = offr;
      R.mask = maskr;
      parse_row(R, nn + 2 * r);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int zk_parse_linked(const void* x2, const void* lens,
                               const void* min_abs, const void* h16,
                               const void* bounds, int nchains, int N,
                               int cap, int max_offset, int gate_bits,
                               int min_match, int accel_log,
                               int strict_h16_x6, int lazy, int dual,
                               int rep_probe, void* tables, void* ll,
                               void* ml, void* off, void* nn, void* mask,
                               void* stream) {
  // the dual table (192 KiB) is dynamic shared memory, above the 48 KB
  // a launch gets without opting in
  const int smem = dual ? DUAL_SIZE * (int)sizeof(int) : 0;
  if (dual) {
    cudaError_t e = cudaFuncSetAttribute(
        parse_linked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  parse_linked_kernel<<<nchains, 128, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x2, (const int*)lens, (const int*)min_abs,
      (const int*)h16, (const int*)bounds, N, cap, max_offset, gate_bits,
      min_match, accel_log, strict_h16_x6, lazy, dual, rep_probe,
      (int*)tables, (int*)ll, (int*)ml, (int*)off, (int*)nn,
      (uint32_t*)mask);
  return (int)cudaGetLastError();
}
