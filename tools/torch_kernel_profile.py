#!/usr/bin/env python3
"""Timings and clock-counter attributions of the port's K1 (linked parse),
K2 (entropy emission), K3 (literal placement), K4 (fused decode, execute
arm), K5 (LZ4 block encode), K6 (the lane route's block executor), K7
(per-block hash parse), LZ4 decoder, greedy_select, Huffman and sequence
lane decoders and K4's transcode arm on an H100, for PERF.md section 6.

    python3 tools/torch_kernel_profile.py times DIR [LEVELS] [--check] [--only=K6,K7]
    python3 tools/torch_kernel_profile.py pair PARENT_DIR DIR [LEVELS] [--only=K6,K7]
    python3 tools/torch_kernel_profile.py counters DIR [--only=K6,K7]
    python3 tools/torch_kernel_profile.py kernels DIR [--only=K2,K3]
    python3 tools/torch_kernel_profile.py archives DIR
    python3 tools/torch_kernel_profile.py writes PARENT_DIR DIR [ROUNDS]
    python3 tools/torch_kernel_profile.py micro

DIR is a directory holding libzseek_tpu_torch/ and chip_smoke.py: the
repository root, or a `git archive` of another commit unpacked under the
gitignored build/, so two versions can be timed in one run.

times: K1 at each level of LEVELS (comma-separated, optional; 3 takes
chip_smoke's 64 rows of 128 KiB, the others its 64 rows of 64 KiB in 4
chains), K5 at chip_smoke's 128-row batch (8 frames of 16 blocks of
64 KiB, two per quarter of mixed_corpus), K4's execute arm at 64 blocks
(the codec's first 8 level-3 frames of the corpus) and at the first 8
level-9 frames (128 blocks of 64 KiB), the LZ4 decoder on a 4-frame
window of the codec's own frames (one per quarter), K7 at chip_smoke's
64-row batch and at the 64 MiB hash write's batches 0, 2, 4 and 6 (8
contiguous MiB each: text, repeats, zeros, noise), and K6 at the lane
route's calls for the level-3 archive's frames 0-7 (with hints, as
chip_smoke's phase 8; without hints too), 16-23 (repeats) and 32-39
(zeros), K2 at chip_smoke's 64 rows (the main path's K2 modes), at the
64 MiB hash write's batches 0, 2, 4 and 6 (the arguments the codec's K2
arm passes, captured from ZstdCodec(parser="hash") on those 8 MiB) and
at the level-9 write's first batch of each quarter (64 rows of 64 KiB),
and K3 at chip_smoke's 64 rows and at the level-3 write's two text
batches (the arguments the codec passes to vector_literals): the whole
call and, where DIR's K3 has a separate placement kernel, that kernel
alone; each K2 and K3 input's rows are summarised (modes, literals,
sequences); CUDA events, mean of 5; --check compares each output with
the plain version first; --only keeps the entries whose names start with
one of the given prefixes.  Each output's sha256 is printed.  With
--only=greedy: greedy_select at the zstd and LZ4 sort writes' first
batches (chip_smoke's capture_greedy; 64 and 128 rows of 32,768
segments), with each batch's candidates, selections and longest run of
segments without a selection.  With --only=huf, seq or K4T (or a longer
prefix, e.g. "huf L9"): every call of the Huffman lanes, the sequence
lanes and K4's transcode arm in one sequential Reader pass over the
level-3, level-9 and log-like archives, with decoder "lanes" (groups
"huf L3 anchored", "seq L9 tagged", ...) and with decoder "auto", whose
host delivery takes the transcode route ("K4T L3 transcode host literals", "K4T L9 transcode ...", "K4T log
transcode ..."): per group its launches, work and summed bound, the
calls replayed together, and its call with the most work alone ("...
max"; --check holds only these to plain); for the transcode groups also
the wrapper's host time ("... host ms": until the calls return, the card
idle before each, apart from their device time); and for each decoder
arm, which group's largest call has the most work of all ("seq tagged
largest", ..., "K4T literals largest").

pair: `times` in fresh processes from PARENT_DIR, DIR, DIR, PARENT_DIR
(one card, in turns), then checks that both gave the same outputs.

counters: copies DIR's kernels to build/counters/, inserts clock64()
counters into K1's level >= 4 walk (the one-thread walk or the warp walk
that replaced it, whichever DIR holds), into the LZ4 decoder's first,
one-warp version (the phased decoder that replaced it is timed per
kernel by torch.profiler instead), into K5's one-thread chain walk, into
K4's first, one-warp frame walk (seq_kernel), into K7's walk (the first
version's lane-0 walk or the round walk that replaced it; per row of
each K7 batch), into K6's first, one-warp frame walk (per frame of
each K6 call) and into K2's first, two-thread version (per row of each
K2 input of `times`: thread 0's run table, and per literal its run walk,
`x` load, code load and push; its raw copy; thread 32's sequence walk;
the zeroing), into greedy_select's first, lane-0 walk (per row: its
cycles a segment, beside each row's candidates and selections), into
the lane decoders' first, one-thread walks and K4's first transcode
walk, tc_kernel (at each lane group's largest call: cycles, symbols or
sequences, lanes or chains, the slowest; the first walks also split
into their parts: the Huffman walk's stream read and table load, the
sequence walk's table loads, ctab loads, extra-bit reads and state
reads), into the redesigned lane walks (cycles, the steps read through
read_at, the lanes on unstaged tables or streams) and K4's transcode row
walk that replaced tc_kernel (cycles, sequences, rows, the slowest row,
the steps read through read_at and those with a WIDE entry, the rows
whose stream was not staged), builds that copy, and prints per chain (per
frame, per row) the cycles of each part of the walk and its counts.  For the
one-thread K1 it also times the walk with the dual table in device
memory instead of shared memory.  Kernels that DIR holds in another
design are skipped, and so are those that --only leaves out.

kernels: K4's execute arm (level 3, 64 blocks; level 9, 128 blocks), K5
(128 rows), K7 (chip_smoke's 64 rows; the text batch), K6 (the 8
frames with hints; the 8 repeats frames), K2 (64 rows; the hash write's
text batch), K3 (the first text batch, the whole call), greedy_select
(both batches) and each lane group's largest call under torch.profiler,
five calls each: the mean milliseconds and launches a call of each CUDA
kernel; --only as for `times`.

archives: the sha256 of the 64 MiB of mixed_corpus (seed 11) that DIR's
Writer writes as chip_smoke.py does (zstd at levels 3 and 9, LZ4 at
level 0, and zstd through ZstdCodec(parser="hash")), to show two
commits' archives equal.

writes: the MiB/s of the level-3, level-9 and hash-parser writes of
those 64 MiB (chip_smoke.py's write_archive and hash_write, host clock to
torch.cuda.synchronize(), no profiler), each process writing each once to
warm up and then twice; ROUNDS (default 5) rounds of a process from
PARENT_DIR and one from DIR, the first side alternating; prints each
side's runs, their medians, the parent's quartile spread and how many
change runs beat every parent run.

micro: latency in cycles of warp intrinsics and loads on the card.
"""

import ctypes
import inspect
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20

# counters: (name, [(old text, new text), ...]) for each kernel version;
# the first set whose texts all occur is applied
PROF_HEAD = "__device__ unsigned long long g_prof[64][16];\nnamespace {"
# the counters' reader, one per patched source (NAME: k1 or lz4)
PROF_READ = '''
extern "C" int zk_prof_NAME(void* dst, int reset) {
  static unsigned long long z[64][16];
  if (reset) return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)cudaMemcpyFromSymbol(dst, g_prof, sizeof(g_prof));
}
'''
K1_SHARED = [
    ("  uint32_t* mask;\n};", "  uint32_t* mask;\n  unsigned long long* P;\n};"),
    ("  extern __shared__ int dual_table[];\n",
     "  extern __shared__ int dual_table[];\n"
     "  __shared__ unsigned long long sprof[16];\n"
     "  if (threadIdx.x < 16) sprof[threadIdx.x] = 0;\n"),
    ("      R.mask = maskr;\n", "      R.mask = maskr;\n      R.P = sprof;\n"),
    ("    __syncthreads();\n  }\n}\n\n}  // namespace",
     "    __syncthreads();\n  }\n  if (threadIdx.x < 16) "
     "g_prof[c & 63][threadIdx.x] += sprof[threadIdx.x];\n}\n\n}  // namespace"),
]
K1_THREAD = ("thread", ["walk", "probe", "confirm", "extend", "lazy",
                        "inserts", "backward", "positions", "matches",
                        "extends", "ext_bytes", "lazy_ext", "rep_hits",
                        "misses", "gallop_pairs", "rows"], K1_SHARED + [
    ("__device__ int extend(const Row& R, int ip, int cand) {\n"
     "  const int lim = R.N + R.blen;\n  int l = 4;",
     "__device__ int extend_(const Row& R, int ip, int cand);\n"
     "__device__ int extend(const Row& R, int ip, int cand) {\n"
     "  long long t0 = clock64();\n  int l = extend_(R, ip, cand);\n"
     "  R.P[3] += clock64() - t0; R.P[9] += 1; R.P[10] += l;\n"
     "  return l;\n}\n__device__ int extend_(const Row& R, int ip, int cand) {\n"
     "  const int lim = R.N + R.blen;\n  int l = 4;"),
    ("      m = w32c(R, a + 4 * t) == w32c(R, b + 4 * t);\n",
     "      { m = w32c(R, a + 4 * t) == w32c(R, b + 4 * t); R.P[14] += 1; }\n"),
    ("__device__ void lazy_steps(const Row& R, int& ip, int& cand_abs, "
     "int& l) {\n  for",
     "__device__ void lazy_steps(const Row& R, int& ip, int& cand_abs, "
     "int& l) {\n  long long t0 = clock64();\n  for"),
    ("          l = l2;\n        }\n      }\n    }\n  }\n}",
     "          l = l2;\n        }\n      }\n    }\n  }\n"
     "  R.P[4] += clock64() - t0;\n}"),
    ("      if (w32(R, c2) == w32c(R, p2)) {\n",
     "      if (w32(R, c2) == w32c(R, p2)) {\n        R.P[11] += 1;\n"),
    ("  int nins = min(le >> 5, 8);",
     "  long long t1 = clock64();\n  int nins = min(le >> 5, 8);"),
    ("  insert_at(R, ip + le - 2);\n  int minw",
     "  insert_at(R, ip + le - 2);\n  long long t2 = clock64(); "
     "R.P[5] += t2 - t1;\n  int minw"),
    ("    ++kb;\n  int ips = ip - kb;",
     "    ++kb;\n  R.P[6] += clock64() - t2; R.P[8] += 1;\n"
     "  int ips = ip - kb;"),
    ("  const int ip = s.ip;\n  const int pos = R.base + ip;\n"
     "  const int wlo = max(R.min_abs, pos - R.max_offset);\n"
     "  const bool rep_hit",
     "  long long t0 = clock64();\n  const int ip = s.ip;\n"
     "  const int pos = R.base + ip;\n"
     "  const int wlo = max(R.min_abs, pos - R.max_offset);\n"
     "  const bool rep_hit"),
    ("  R.table[hl] = pos | tl;\n  if (rep_hit) {\n"
     "    match_at(R, s, ip, pos - s.rep, false);",
     "  R.table[hl] = pos | tl;\n  R.P[1] += clock64() - t0; R.P[7] += 1;\n"
     "  if (rep_hit) {\n    R.P[12] += 1;\n"
     "    match_at(R, s, ip, pos - s.rep, false);"),
    ("  } else {\n    s.ip = ip + 1 + (s.miss >> R.accel_log);\n"
     "    s.miss += 1;\n  }\n}\n\n__device__ void parse_row",
     "  } else {\n    R.P[13] += 1;\n"
     "    s.ip = ip + 1 + (s.miss >> R.accel_log);\n    s.miss += 1;\n"
     "  }\n}\n\n__device__ void parse_row"),
    ("  int cand = cand_abs - R.base;\n  bool conf4 = w32(R, cand) == "
     "w32c(R, ip);\n  if (R.strict) {\n    bool conf = conf4 && "
     "w32(R, cand + 4) == w32c(R, ip + 4);",
     "  long long t0 = clock64();\n  int cand = cand_abs - R.base;\n"
     "  bool conf4 = w32(R, cand) == w32c(R, ip);\n  if (R.strict) {\n"
     "    bool conf = conf4 && w32(R, cand + 4) == w32c(R, ip + 4);\n"
     "    R.P[2] += clock64() - t0;"),
    ("  if (conf4 && l8 < 8 && !prof8 && !bk0) {",
     "  R.P[2] += clock64() - t0;\n  if (conf4 && l8 < 8 && !prof8 && !bk0) {"),
    ("  if (R.dual) {\n    while (s.ip < R.limit) body1_dual(R, s);",
     "  if (R.dual) {\n    long long t0 = clock64();\n"
     "    while (s.ip < R.limit) body1_dual(R, s);\n"
     "    R.P[0] += clock64() - t0; R.P[15] += 1;"),
    # dual == 2: the dual table in device memory (L1 gets the whole SM)
    ("  int* table = dual ? dual_table : tables + (size_t)c * TAB_SIZE;",
     "  int* table = dual == 1 ? dual_table : "
     "tables + (size_t)c * TAB_SIZE;"),
    ("  const int smem = dual ? DUAL_SIZE * (int)sizeof(int) : 0;\n"
     "  if (dual) {",
     "  const int smem = dual == 1 ? DUAL_SIZE * (int)sizeof(int) : 0;\n"
     "  if (dual == 2) cudaFuncSetAttribute(parse_linked_kernel, "
     "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n"
     "  if (dual == 1) {"),
])
K1_WARP = ("warp", ["walk", "runs", "matches", "extend", "lazy", "inserts",
                    "backward", "gate_emit", "match_full", "nruns",
                    "run_positions", "hits"], K1_SHARED + [
    ("  int l = extend(R, ip, cand_abs - R.base);\n"
     "  if (conf && R.lazy > 0) lazy_steps(R, ip, cand_abs, l);",
     "  long long t0 = clock64();\n  int l = extend(R, ip, cand_abs - R.base);\n"
     "  long long t1 = clock64();\n"
     "  if (conf && R.lazy > 0) lazy_steps(R, ip, cand_abs, l);\n"
     "  long long t2 = clock64();"),
    ("  insert_span(R, ip, le, nins, stp);\n"
     "  int kb = back_extend(R, ip, cand, s.anchor, R.min_abs - R.base);",
     "  insert_span(R, ip, le, nins, stp);\n  long long t3 = clock64();\n"
     "  int kb = back_extend(R, ip, cand, s.anchor, R.min_abs - R.base);\n"
     "  long long t4 = clock64();"),
    ("  if (keep) clear_mask(R, ips, lf);\n",
     "  if (keep) clear_mask(R, ips, lf);\n  long long t5 = clock64();\n"
     "  if (lane_id() == 0) { R.P[3] += t1 - t0; R.P[4] += t2 - t1; "
     "R.P[5] += t3 - t2; R.P[6] += t4 - t3; R.P[7] += t5 - t4; "
     "R.P[8] += 1; }\n"),
    ("__device__ __forceinline__ void run_dual(const Row& R, State& s) {\n"
     "  const int lane = lane_id();",
     "__device__ __forceinline__ void run_dual(const Row& R, State& s) {\n"
     "  long long T0 = clock64();\n  const int lane = lane_id();"),
    ("    s.ip = __shfl_sync(FULL, p + d, n - 1);\n    return;",
     "    s.ip = __shfl_sync(FULL, p + d, n - 1);\n"
     "    if (lane == 0) { R.P[1] += clock64() - T0; R.P[9] += 1; "
     "R.P[10] += n; }\n    return;"),
    ("  s.miss += h;\n  s.ip = ph;\n  if (rep_h)",
     "  s.miss += h;\n  s.ip = ph;\n  long long T1 = clock64();\n"
     "  if (lane == 0) { R.P[1] += T1 - T0; R.P[9] += 1; R.P[10] += h + 1; "
     "R.P[11] += 1; }\n  if (rep_h)"),
    ("    match_at(R, s, ph, e_h & 0xFFFFFF, !long_h);\n}",
     "    match_at(R, s, ph, e_h & 0xFFFFFF, !long_h);\n"
     "  if (lane == 0) R.P[2] += clock64() - T1;\n}"),
    ("  if (R.dual) {\n    while (s.ip < R.limit) run_dual(R, s);",
     "  if (R.dual) {\n    long long T0 = clock64();\n"
     "    while (s.ip < R.limit) run_dual(R, s);\n"
     "    if (lane_id() == 0) { R.P[0] += clock64() - T0; R.P[15] += 1; }"),
])
LZ4_WARP_PER_FRAME = ("frame", ["walk", "header", "lits", "match", "seqs",
                                "lit_bytes", "match_bytes", "off_lt32",
                                "off_ge32_overlap"], [
    ("namespace {\n\nstruct Blk",
     "__device__ unsigned long long g_prof[64][16];\nnamespace {\n\n"
     "struct Blk"),
    ("  long long base = 0;  // the frame's bytes so far\n  bool bad = false;",
     "  long long base = 0;  // the frame's bytes so far\n"
     "  bool bad = false;\n  unsigned long long P[16] = {0};\n"
     "  long long T0 = clock64(), ta, tb;"),
    ("      const int token = g(B, ip);",
     "      ta = clock64();\n      const int token = g(B, ip);"),
    ("      if (overrun) {\n        bad = true;\n        break;\n      }\n"
     "      warp_lits(fo, base + op, comp_f, kb + src, ll, KM, F, lane);",
     "      tb = clock64(); if (lane == 0) { P[1] += tb - ta; P[4] += 1; "
     "P[5] += ll; }\n      if (overrun) {\n        bad = true;\n"
     "        break;\n      }\n"
     "      warp_lits(fo, base + op, comp_f, kb + src, ll, KM, F, lane);\n"
     "      ta = clock64(); if (lane == 0) P[2] += ta - tb;"),
    ("      else warp_match(fo, mdst, off, ml, F, lane);",
     "      else warp_match(fo, mdst, off, ml, F, lane);\n"
     "      if (lane == 0) { P[3] += clock64() - ta; P[6] += ml; "
     "P[7] += off < 32; P[8] += off >= 32 && off < ml; }"),
    ("  if (lane == 0) {\n    out_lens[b] = (int)base;",
     "  if (lane == 0) {\n    P[0] += clock64() - T0;\n"
     "    for (int i = 0; i < 16; ++i) g_prof[b & 63][i] += P[i];\n"
     "    out_lens[b] = (int)base;"),
])

# K5, the one-thread chain walk of PR 3 (chain c counted at c = r0 >> 4,
# the 16-row frames of the 128-row batch)
K5_THREAD = ("thread", ["walk", "quad_loop", "quads", "single_probe",
                        "singles", "confirm", "extend", "lazy", "emit",
                        "insert", "matches", "confirm_fail", "lit_bytes",
                        "seed", "match_bytes", "rows"], [
    ("  int* table;\n  uint8_t* out;\n};",
     "  int* table;\n  uint8_t* out;\n  unsigned long long* P;\n};"),
    ("  if (e >= tagb + wlo && e < tagb + pos) match_at(R, s, ip, "
     "e & 0xFFFFFF, w);\n  else miss_step(R, s, ip);",
     "  if (e >= tagb + wlo && e < tagb + pos) {\n"
     "    R.P[3] += clock64() - t0; R.P[4] += 1;\n"
     "    match_at(R, s, ip, e & 0xFFFFFF, w);\n  } else {\n"
     "    miss_step(R, s, ip);\n"
     "    R.P[3] += clock64() - t0; R.P[4] += 1;\n  }"),
    ("__device__ void body1(const Row& R, State& s) {\n  int ip = s.ip;",
     "__device__ void body1(const Row& R, State& s) {\n"
     "  long long t0 = clock64();\n  int ip = s.ip;"),
    ("  int cand = cand_abs - R.base;\n  if (w32(R, cand) != w) {\n"
     "    miss_step(R, s, ip);\n    return;\n  }\n"
     "  int lf = extend(R, ip, cand);\n",
     "  long long t0 = clock64();\n  int cand = cand_abs - R.base;\n"
     "  if (w32(R, cand) != w) {\n"
     "    R.P[5] += clock64() - t0; R.P[11] += 1;\n"
     "    miss_step(R, s, ip);\n    return;\n  }\n"
     "  long long t1 = clock64(); R.P[5] += t1 - t0;\n"
     "  int lf = extend(R, ip, cand);\n"
     "  long long t2 = clock64(); R.P[6] += t2 - t1;\n"),
    ("  s.op = emit_seq(R, s.op, s.anchor, ipf, lf, ipf - candf);\n"
     "  insert_at(R, ipf + lf - 2);\n",
     "  long long t3 = clock64(); R.P[7] += t3 - t2;\n"
     "  s.op = emit_seq(R, s.op, s.anchor, ipf, lf, ipf - candf);\n"
     "  long long t4 = clock64(); R.P[8] += t4 - t3; R.P[10] += 1;\n"
     "  R.P[12] += ipf - s.anchor; R.P[14] += lf;\n"
     "  insert_at(R, ipf + lf - 2);\n"
     "  R.P[9] += clock64() - t4;\n"),
    ("    while (fnd == 0 && 4 * q <= qlim) {",
     "    long long tq = clock64();\n"
     "    while (fnd == 0 && 4 * q <= qlim) {\n      R.P[2] += 1;"),
    ("    s.miss = missq;\n    if (fnd != 0) {",
     "    R.P[1] += clock64() - tq;\n    s.miss = missq;\n    if (fnd != 0) {"),
    ("  R.table = table;\n",
     "  R.table = table;\n  __shared__ unsigned long long P[16];\n"
     "  for (int i = 0; i < 16; ++i) P[i] = 0;\n  R.P = P;\n"
     "  long long T0 = clock64();\n"),
    ("    if (r == 0)   // the reference's step-0 seed: row 0, base 0\n"
     "      for (int p = 0; p < N - 3; ++p) insert_at(R, p);\n"
     "    emit_row(R, N, olen + r);\n  }\n}",
     "    long long ts = clock64();\n"
     "    if (r == 0)   // the reference's step-0 seed: row 0, base 0\n"
     "      for (int p = 0; p < N - 3; ++p) insert_at(R, p);\n"
     "    P[13] += clock64() - ts; P[15] += 1;\n"
     "    emit_row(R, N, olen + r);\n  }\n  P[0] += clock64() - T0;\n"
     "  for (int i = 0; i < 16; ++i) g_prof[(r0 >> 4) & 63][i] += P[i];\n}"),
])
# K4's execute arm, the one-warp frame walk of PR 2 (lane 0 counts; the
# repcode resolution inside seq_step is timed from the last extra-bit
# read's use to the new rep1, so it includes that read's wait; only
# decode_blocks runs here, so tc_kernel's share of seq_step adds nothing)
K4_WARP_PER_FRAME = ("frame", ["walk", "fse_step", "unused", "lit_copy",
                               "match_copy", "seqs", "lit_bytes",
                               "match_bytes", "trail_copy", "rows",
                               "off_lt32", "off_ge32_overlap", "repcode"], [
    ("  const long long idx = ofv + (ll == 0 ? 1 : 0);",
     "  long long tr0 = clock64();\n"
     "  const long long idx = ofv + (ll == 0 ? 1 : 0);"),
    ("  rep1 = off;\n  if (!last) {",
     "  rep1 = off;\n  if ((threadIdx.x & 31) == 0)\n"
     "    atomicAdd(&g_prof[blockIdx.x & 63][12],\n"
     "              (unsigned long long)(clock64() - tr0));\n"
     "  if (!last) {"),
    ("  long long op = 0;            // bytes produced in the frame\n",
     "  long long op = 0;            // bytes produced in the frame\n"
     "  unsigned long long P[16] = {0};\n  long long T0 = clock64();\n"),
    ("    bool ok = st[1] != 0;   // the literal section's verdict (kernel 1)\n"
     "    __syncwarp();",
     "    bool ok = st[1] != 0;   // the literal section's verdict (kernel 1)\n"
     "    __syncwarp();\n    P[9] += 1;"),
    ("        if (!seq_step(z, ctab, t == n_seq - 1, rep1, rep2, rep3, ll, ml,\n"
     "                      off) ||",
     "        long long ta = clock64();\n"
     "        if (!seq_step(z, ctab, t == n_seq - 1, rep1, rep2, rep3, ll, ml,\n"
     "                      off) ||"),
    ("        warp_copy(fout + op, lit + lpos, ll, lane);\n"
     "        warp_match(fout + op + ll, (int)off, ml, lane);\n",
     "        long long tb = clock64();\n"
     "        P[1] += tb - ta; P[5] += 1; P[6] += ll; P[7] += ml;\n"
     "        warp_copy(fout + op, lit + lpos, ll, lane);\n"
     "        long long tc = clock64(); P[3] += tc - tb;\n"
     "        warp_match(fout + op + ll, (int)off, ml, lane);\n"
     "        P[4] += clock64() - tc; P[10] += off < 32;\n"
     "        P[11] += off >= 32 && off < ml;\n"),
    ("        warp_copy(fout + op, lit + lpos, trail, lane);\n"
     "        op += trail;",
     "        long long td = clock64();\n"
     "        warp_copy(fout + op, lit + lpos, trail, lane);\n"
     "        P[8] += clock64() - td;\n        op += trail;"),
    ("    failed = !ok;\n  }\n}\n",
     "    failed = !ok;\n  }\n  if (lane == 0) {\n    P[0] += clock64() - T0;\n"
     "    for (int i = 0; i < 12; ++i) g_prof[f & 63][i] += P[i];\n  }\n}\n"),
])

# K7, the first version's lane-0 walk (per row; lane 0 counts): the probe (hash,
# table read and write, the candidate's broadcast), the candidate's load
# and compare (timed to the first clock after the branch that uses it),
# the extension's 32-word rounds, the tail bytes, the emission, the miss
# step, and the table clear before the walk
K7_LANE0 = ("lane0", ["walk", "probe", "cand", "extend", "tail", "emit",
                      "miss_step", "unused", "probes", "misses",
                      "ext_rounds", "tail_bytes", "seqs", "clear"], [
    ("  extern __shared__ uint32_t smem[];\n",
     "  extern __shared__ uint32_t smem[];\n  long long Tk = clock64();\n"),
    ("  int ip = 0, anchor = 0, cnt = 0, miss = 0;\n  while (ip < limit) {\n"
     "    const uint32_t w = w32(xw, ip);\n",
     "  int ip = 0, anchor = 0, cnt = 0, miss = 0;\n"
     "  unsigned long long P[16] = {0};\n  long long T0 = clock64(), ta, tb, tc;\n"
     "  P[13] = T0 - Tk;\n  while (ip < limit) {\n    ta = clock64();\n"
     "    const uint32_t w = w32(xw, ip);\n"),
    ("    cand = __shfl_sync(FULL, cand, 0);\n",
     "    cand = __shfl_sync(FULL, cand, 0);\n"
     "    tb = clock64(); P[1] += tb - ta; P[8] += 1;\n"),
    ("    if (!good) {\n      ip += 1 + (miss >> 6);\n      miss += 1;\n",
     "    if (!good) {\n      tc = clock64(); P[2] += tc - tb;\n"
     "      ip += 1 + (miss >> 6);\n      miss += 1;\n"
     "      P[6] += clock64() - tc; P[9] += 1;\n"),
    ("    const int R = blen - ip;\n    int l = 4;\n",
     "    tc = clock64(); P[2] += tc - tb;\n    const int R = blen - ip;\n"
     "    int l = 4;\n"),
    ("      const unsigned bal = __ballot_sync(FULL, ok);\n",
     "      const unsigned bal = __ballot_sync(FULL, ok);\n      P[10] += 1;\n"),
    ("    for (int t = 0; t < 3 && l < R && xb[ip + l] == xb[cand + l]; ++t) ++l;\n",
     "    long long td = clock64(); P[3] += td - tc;\n    const int l0 = l;\n"
     "    for (int t = 0; t < 3 && l < R && xb[ip + l] == xb[cand + l]; ++t) ++l;\n"
     "    long long te = clock64(); P[4] += te - td; P[11] += l - l0;\n"),
    ("    anchor = ip;\n    miss = 0;\n  }\n",
     "    anchor = ip;\n    miss = 0;\n    P[5] += clock64() - te; P[12] += 1;\n  }\n"),
    ("  if (lane == 0) {\n    nn[2 * r] = cnt;",
     "  if (lane == 0) {\n    P[0] += clock64() - T0;\n"
     "    for (int i = 0; i < 16; ++i) g_prof[r & 63][i] += P[i];\n"
     "    nn[2 * r] = cnt;"),
])
# K7, the round walk (per row; lane 0 counts): the round's
# words, slots and buckets (to __match_any_sync), the candidates' words
# and the lanes' lengths (to the ballots), the walk over the lanes, the
# cuts and the warp's extension of a long match, and the next position,
# the emission and the table writes
K7_ROUNDS = ("rounds", ["walk", "load", "cand", "scan", "cut_long", "emit",
                        "unused", "unused2", "rounds", "probes", "hits",
                        "long", "cuts", "dense", "clear"], [
    ("  extern __shared__ uint4 smem4[];\n",
     "  extern __shared__ uint4 smem4[];\n  long long Tk = clock64();\n"),
    ("  int ip = 0, anchor = 0, cnt = 0, miss = 0;\n  while (ip < limit) {\n",
     "  int ip = 0, anchor = 0, cnt = 0, miss = 0;\n"
     "  unsigned long long P_[16] = {0};\n  long long T0 = clock64(), Ta, Tb;\n"
     "  P_[14] = T0 - Tk;\n  while (ip < limit) {\n    Ta = clock64();\n"),
    ("    const unsigned g = __match_any_sync(FULL, h);\n",
     "    const unsigned g = __match_any_sync(FULL, h);\n"
     "    Tb = clock64(); P_[1] += Tb - Ta; Ta = Tb;\n"),
    ("    const unsigned lb = __ballot_sync(FULL, lng);\n",
     "    const unsigned lb = __ballot_sync(FULL, lng);\n"
     "    Tb = clock64(); P_[2] += Tb - Ta; Ta = Tb;\n"),
    ("    int stop = -1;\n",
     "    Tb = clock64(); P_[3] += Tb - Ta; Ta = Tb;\n    int stop = -1;\n"),
    ("    // the walk's next position, then the sequences and the table\n",
     "    // the walk's next position, then the sequences and the table\n"
     "    Tb = clock64(); P_[4] += Tb - Ta; Ta = Tb;\n"
     "    P_[8] += 1; P_[9] += __popc(P); P_[10] += __popc(HP);\n"
     "    P_[11] += last_hit && ((lb >> lastp) & 1); P_[12] += stop >= 0;\n"
     "    P_[13] += m0 <= DENSE_MISS;\n"),
    ("    __syncwarp();\n  }\n  if (lane == 0) {\n    nn[2 * r] = cnt;",
     "    __syncwarp();\n    P_[5] += clock64() - Ta;\n  }\n  if (lane == 0) {\n"
     "    P_[0] += clock64() - T0;\n"
     "    for (int i = 0; i < 16; ++i) g_prof[r & 63][i] += P_[i];\n"
     "    nn[2 * r] = cnt;"),
])
# K6, the first version's one-warp frame walk (per frame; lane 0 counts): the
# checks (the sequence's loads and tests), the literal copy, and the match
# copy by kind: off >= ml (no overlap), an overlap with off >= 32 (rounds
# of 32 bytes), off < 32 (the repeated pattern)
K6_WARP_PER_FRAME = ("frame", ["walk", "checks", "lit_copy", "match_ge_ml",
                               "match_ge32", "match_lt32", "unused", "seqs",
                               "lit_bytes", "n_ge_ml", "n_ge32", "n_lt32",
                               "match_bytes", "rows"], [
    # only the first version's launch (the phased version's serial arm
    # shares the walk's text)
    ("  exec_kernel<<<F, 32, 0, (cudaStream_t)stream>>>(",
     "  exec_kernel<<<F, 32, 0, (cudaStream_t)stream>>>("),
    ("  bool failed = false;\n  for (int r = chain[f];",
     "  bool failed = false;\n  unsigned long long P[16] = {0};\n"
     "  long long T0 = clock64();\n  for (int r = chain[f];"),
    ("    const int n_seq = meta[3 * r];",
     "    P[13] += 1;\n    const int n_seq = meta[3 * r];"),
    ("      const int a = ll[j], m = ml[j], o = of[j];",
     "      long long ta = clock64();\n"
     "      const int a = ll[j], m = ml[j], o = of[j];"),
    ("      warp_copy(fout + op, row + lp, a, lane);\n"
     "      warp_match(fout + op + a, o, m, lane);\n",
     "      long long tb = clock64(); P[1] += tb - ta;\n"
     "      warp_copy(fout + op, row + lp, a, lane);\n"
     "      long long tc = clock64(); P[2] += tc - tb;\n"
     "      warp_match(fout + op + a, o, m, lane);\n"
     "      const int k = m == 0 ? -1 : o >= m ? 3 : o >= 32 ? 4 : 5;\n"
     "      if (k > 0) { P[k] += clock64() - tc; P[k + 6] += 1; }\n"
     "      P[7] += 1; P[8] += a; P[12] += m;\n"),
    ("    failed = !good;\n  }\n}\n",
     "    failed = !good;\n  }\n  if (lane == 0) {\n    P[0] += clock64() - T0;\n"
     "    for (int i = 0; i < 16; ++i) g_prof[f & 63][i] += P[i];\n  }\n}\n"),
])

# K2, the first version's two threads (per row): thread 0 builds the run
# table, then per literal walks the run back, loads the byte from x, loads
# its code and pushes it (each part timed to a MOV that uses its value);
# its raw copy; thread 32's sequence walk and its tail (the state flushes
# and the rep1 pass); thread 0's zeroing (from the kernel's start to the
# barrier after it)
K2_SERIAL = ("two_threads", ["lit_walk", "run_walk", "x_load", "code_load",
                             "push", "lits", "raw_copy", "raw_bytes",
                             "seq_walk", "seqs", "zero", "run_table",
                             "run_steps", "seq_tail"], [
    ("                              int* osz, int* lanch, int LMAXA) {\n"
     "  int pos = 0, cum = 0;\n",
     "                              int* osz, int* lanch, int LMAXA) {\n"
     "  unsigned long long P[16] = {0};\n  long long Tr = clock64();\n"
     "  int pos = 0, cum = 0;\n"),
    ("  run_cum[n] = cum;\n  if (mode & MODE_HUF) {\n",
     "  run_cum[n] = cum;\n  P[11] += clock64() - Tr;\n"
     "  long long Tl = clock64();\n  if (mode & MODE_HUF) {\n"),
    ("          while (run_cum[r] > g) --r;\n"
     "          const int p = codes[x[run_pos[r] + (g - run_cum[r])]];\n"
     "          push(st, (uint32_t)(p >> 4), p & 15);\n",
     "          long long t0 = clock64();\n"
     "          while (run_cum[r] > g) { --r; P[12] += 1; }\n"
     "          int ip_ = run_pos[r] + (g - run_cum[r]);\n"
     "          asm volatile(\"mov.b32 %0, %0;\" : \"+r\"(ip_));\n"
     "          long long t1 = clock64();\n"
     "          int xb_ = x[ip_];\n"
     "          asm volatile(\"mov.b32 %0, %0;\" : \"+r\"(xb_));\n"
     "          long long t2 = clock64();\n"
     "          int p = codes[xb_];\n"
     "          asm volatile(\"mov.b32 %0, %0;\" : \"+r\"(p));\n"
     "          long long t3 = clock64();\n"
     "          push(st, (uint32_t)(p >> 4), p & 15);\n"),
    ("            lanch[s4 * LMAXA + (k >> 9) - 1] = sbits;\n        }\n",
     "            lanch[s4 * LMAXA + (k >> 9) - 1] = sbits;\n"
     "          P[1] += t1 - t0; P[2] += t2 - t1; P[3] += t3 - t2;\n"
     "          P[4] += clock64() - t3; P[5] += 1;\n        }\n"),
    ("  if (mode & MODE_RAWLIT) {\n    uint8_t* out = (uint8_t*)lit_o;\n",
     "  P[0] += clock64() - Tl;\n  long long Tw = clock64();\n"
     "  if (mode & MODE_RAWLIT) {\n    P[7] += lc;\n"
     "    uint8_t* out = (uint8_t*)lit_o;\n"),
    ("    osz[0] = lc;\n  }\n}\n",
     "    osz[0] = lc;\n  }\n  P[6] += clock64() - Tw;\n"
     "  for (int i = 0; i < 16; ++i) g_prof[blockIdx.x & 63][i] += P[i];\n"
     "}\n"),
    ("  int s_ll = 0, s_of = 0, s_ml = 0;\n  for (int t = 0; t < n; ++t) {\n",
     "  int s_ll = 0, s_of = 0, s_ml = 0;\n  long long Ts = clock64();\n"
     "  for (int t = 0; t < n; ++t) {\n"),
    ("  push(bs, rle_ml ? 0u : (uint32_t)(s_ml & ((1 << tl_ml) - 1)),\n",
     "  long long Tt = clock64();\n"
     "  g_prof[blockIdx.x & 63][8] += Tt - Ts;\n"
     "  g_prof[blockIdx.x & 63][9] += n;\n"
     "  push(bs, rle_ml ? 0u : (uint32_t)(s_ml & ((1 << tl_ml) - 1)),\n"),
    ("    if (soff[i] > 3) last = soff[i] - 3;\n  }\n}\n",
     "    if (soff[i] > 3) last = soff[i] - 3;\n  }\n"
     "  g_prof[blockIdx.x & 63][13] += clock64() - Tt;\n}\n"),
    ("  const int b = blockIdx.x;\n  const int* m = meta + 8 * b;\n",
     "  long long Tz = clock64();\n  const int b = blockIdx.x;\n"
     "  const int* m = meta + 8 * b;\n"),
    ("  if (threadIdx.x < 8) oz[threadIdx.x] = 0;\n  __syncthreads();\n",
     "  if (threadIdx.x < 8) oz[threadIdx.x] = 0;\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) g_prof[b & 63][10] += clock64() - Tz;\n"),
])

# greedy_select, the first version's lane-0 walk (per row, rows r and
# r + 64 share a slot): the walk's cycles, its segments and the rows
GREEDY_LANE0 = ("lane0", ["walk", "segments", "rows"], [
    ("    if (lane == 0) {\n      for (int i = 0; i < n; ++i) {\n",
     "    if (lane == 0) {\n      long long T0 = clock64();\n"
     "      for (int i = 0; i < n; ++i) {\n"),
    ("        c = ok ? ei : c;\n      }\n    }\n",
     "        c = ok ? ei : c;\n      }\n"
     "      atomicAdd(&g_prof[row & 63][0], "
     "(unsigned long long)(clock64() - T0));\n"
     "      atomicAdd(&g_prof[row & 63][1], (unsigned long long)n);\n"
     "    }\n"),
    ("  if (lane == 0) c_final[row] = c;",
     "  if (lane == 0) {\n    c_final[row] = c;\n"
     "    atomicAdd(&g_prof[row & 63][2], 1ull);\n  }"),
])
# the lane decoders' first, one-thread walks (lane l counts in slot
# l & 63): the walk's cycles, its symbols or sequences, the lanes, the
# slowest lane's cycles, then the walk's parts (each timed to a MOV that
# uses its value): the Huffman walk's stream read and table load; the
# sequence walk's three table loads, four ctab loads, its three extra-bit
# reads and its three state reads
_LANE_TAIL = ("  {\n    const unsigned long long dt = clock64() - T0;\n"
              "    atomicAdd(&g_prof[l & 63][0], dt);\n"
              "    atomicAdd(&g_prof[l & 63][1], (unsigned long long)cnt);\n"
              "    atomicAdd(&g_prof[l & 63][2], 1ull);\n"
              "    atomicMax(&g_prof[l & 63][3], dt);\n"
              "    for (int i_ = 0; i_ < 4; ++i_)\n"
              "      atomicAdd(&g_prof[l & 63][4 + i_], P_[i_]);\n  }\n")
_MOV = '    asm volatile("mov.b32 %0, %0;" : "+r"({}));\n'
HUF_THREAD = ("thread", ["walk", "symbols", "lanes", "max_walk", "read",
                         "table"], [
    ("  const int cnt = min(n[l], cap);\n  for (int t = 0; t < cnt; ++t) {",
     "  const int cnt = min(n[l], cap);\n  long long T0 = clock64();\n"
     "  unsigned long long P_[4] = {0, 0, 0, 0};\n"
     "  for (int t = 0; t < cnt; ++t) {"),
    ("    const int v = (int)lanebits::read_at(row, SB, pos - HUF_PEEK, "
     "HUF_PEEK);\n    long long k = tbase + v;\n"
     "    k = k < 0 ? 0 : (k > last ? last : k);\n"
     "    const int e = __ldg(dtabs + k);\n",
     "    const long long c0_ = clock64();\n"
     "    int v = (int)lanebits::read_at(row, SB, pos - HUF_PEEK, "
     "HUF_PEEK);\n" + _MOV.format("v") +
     "    const long long c1_ = clock64();\n    long long k = tbase + v;\n"
     "    k = k < 0 ? 0 : (k > last ? last : k);\n"
     "    int e = __ldg(dtabs + k);\n" + _MOV.format("e") +
     "    P_[1] += clock64() - c1_;\n    P_[0] += c1_ - c0_;\n"),
    ("  ok[l] = exact ? (pos == 0) : (pos >= 0);\n}",
     _LANE_TAIL + "  ok[l] = exact ? (pos == 0) : (pos >= 0);\n}"),
])
SEQ_THREAD = ("thread", ["walk", "sequences", "lanes", "max_walk", "tables",
                         "ctab", "extra_reads", "state_reads"], [
    ("  const int cnt = min(n[l], cap);\n  int* lo = ll_out",
     "  const int cnt = min(n[l], cap);\n  long long T0 = clock64();\n"
     "  unsigned long long P_[4] = {0, 0, 0, 0};\n  int* lo = ll_out"),
    ("    const int e_ll = entry(tabs, last, b_ll, s_ll);\n"
     "    const int e_of = entry(tabs, last, b_of, s_of);\n"
     "    const int e_ml = entry(tabs, last, b_ml, s_ml);\n"
     "    const int ofc = e_of & 255;\n"
     "    const int mlc = min(e_ml & 255, N_ML - 1);\n"
     "    const int llc = min(e_ll & 255, N_LL - 1);\n"
     "    const uint32_t of_extra = read_wide(row, SB, pos - ofc, ofc);\n"
     "    pos -= ofc;\n"
     "    const int ofv = (int)((1u << min(ofc, 30)) + of_extra);\n"
     "    const int mlb = __ldg(ctab + C_ML_BITS + mlc);\n"
     "    const int ml = __ldg(ctab + C_ML_BASE + mlc) +\n"
     "                   (int)read_at(row, SB, pos - mlb, mlb);\n"
     "    pos -= mlb;\n"
     "    const int llb = __ldg(ctab + C_LL_BITS + llc);\n"
     "    const int ll = __ldg(ctab + C_LL_BASE + llc) +\n"
     "                   (int)read_at(row, SB, pos - llb, llb);\n"
     "    pos -= llb;\n",
     "    const long long c0_ = clock64();\n"
     "    int e_ll = entry(tabs, last, b_ll, s_ll);\n"
     "    int e_of = entry(tabs, last, b_of, s_of);\n"
     "    int e_ml = entry(tabs, last, b_ml, s_ml);\n"
     + _MOV.format("e_ll") + _MOV.format("e_of") + _MOV.format("e_ml") +
     "    const long long c1_ = clock64();\n"
     "    const int ofc = e_of & 255;\n"
     "    const int mlc = min(e_ml & 255, N_ML - 1);\n"
     "    const int llc = min(e_ll & 255, N_LL - 1);\n"
     "    int mlb = __ldg(ctab + C_ML_BITS + mlc);\n"
     "    int mlbase_ = __ldg(ctab + C_ML_BASE + mlc);\n"
     "    int llb = __ldg(ctab + C_LL_BITS + llc);\n"
     "    int llbase_ = __ldg(ctab + C_LL_BASE + llc);\n"
     + _MOV.format("mlb") + _MOV.format("mlbase_") + _MOV.format("llb")
     + _MOV.format("llbase_") +
     "    const long long c2_ = clock64();\n"
     "    uint32_t of_extra = read_wide(row, SB, pos - ofc, ofc);\n"
     "    pos -= ofc;\n"
     "    int mlx_ = (int)read_at(row, SB, pos - mlb, mlb);\n"
     "    pos -= mlb;\n"
     "    int llx_ = (int)read_at(row, SB, pos - llb, llb);\n"
     "    pos -= llb;\n"
     + _MOV.format("of_extra") + _MOV.format("mlx_") + _MOV.format("llx_") +
     "    const long long c3_ = clock64();\n"
     "    P_[0] += c1_ - c0_;\n    P_[1] += c2_ - c1_;\n"
     "    P_[2] += c3_ - c2_;\n"
     "    const int ofv = (int)((1u << min(ofc, 30)) + of_extra);\n"
     "    const int ml = mlbase_ + mlx_;\n"
     "    const int ll = llbase_ + llx_;\n"),
    ("    if (t < n[l] - 1) {\n      const int nb_ll = (e_ll >> 8) & 255;\n",
     "    if (t < n[l] - 1) {\n      const long long c4_ = clock64();\n"
     "      const int nb_ll = (e_ll >> 8) & 255;\n"),
    ("      s_ll = ns_ll;\n      s_ml = ns_ml;\n      s_of = ns_of;\n    }\n",
     "      s_ll = ns_ll;\n      s_ml = ns_ml;\n      s_of = ns_of;\n"
     + _MOV.format("s_ll").replace("    asm", "      asm")
     + _MOV.format("s_ml").replace("    asm", "      asm")
     + _MOV.format("s_of").replace("    asm", "      asm") +
     "      P_[3] += clock64() - c4_;\n    }\n"),
    ("  rep_out[3 * l] = r1;\n", _LANE_TAIL + "  rep_out[3 * l] = r1;\n"),
])
# the staged, windowed lane walks (lane l counts in slot l & 63, the
# tagged arm's lane being its block): cycles, sequences or symbols,
# lanes, the slowest lane's cycles; the sequence walk's steps read through
# read_at (slow_steps), its lanes whose tables were not staged
# (global_tables) and its tagged lanes whose stream was not staged
# (global_streams); the Huffman walk's lanes that walked a symbol a step
# through read_at (not staged, or bits past the row)
_WALK_TAIL = ("    const unsigned long long dt = clock64() - T0;\n"
              "    atomicAdd(&g_prof[l_ & 63][0], dt);\n"
              "    atomicAdd(&g_prof[l_ & 63][1], "
              "(unsigned long long)(cnt > 0 ? cnt : 0));\n"
              "    atomicAdd(&g_prof[l_ & 63][2], 1ull);\n"
              "    atomicMax(&g_prof[l_ & 63][3], dt);\n")
SEQ_WINDOW = ("window", ["walk", "sequences", "lanes", "max_walk",
                         "slow_steps", "global_tables", "global_streams"], [
    ("  const int cnt = min(n_l, cap);\n",
     "  const int cnt = min(n_l, cap);\n  long long T0 = clock64();\n"
     "  unsigned long long slow_ = 0;\n"
     "  const int l_ = TAGGED ? blockIdx.x : blockIdx.x * blockDim.x + "
     "threadIdx.x;\n"),
    ("    if (!fast) {    // the exact entries (clamped indices into tabs)\n",
     "    slow_ += !fast;\n"
     "    if (!fast) {    // the exact entries (clamped indices into tabs)\n"),
    ("  rep[0] = r1;\n  rep[1] = r2;\n",
     "  {\n" + _WALK_TAIL +
     "    atomicAdd(&g_prof[l_ & 63][4], slow_);\n"
     "    if (!STAGED) atomicAdd(&g_prof[l_ & 63][5], 1ull);\n"
     "  }\n  rep[0] = r1;\n  rep[1] = r2;\n"),
    ("  if (threadIdx.x != 0) return;\n",
     "  if (threadIdx.x != 0) return;\n"
     "  if (!staged) atomicAdd(&g_prof[l & 63][6], 1ull);\n"),
])
HUF_WINDOW = ("window", ["walk", "symbols", "lanes", "max_walk",
                         "unstaged_lanes"], [
    ("  const size_t g0 = (size_t)l * cap;      // out's flat byte index\n",
     "  const size_t g0 = (size_t)l * cap;      // out's flat byte index\n"
     "  long long T0 = clock64();\n  const int l_ = l;\n"
     "  const bool ser_ = tb == nullptr || pos > 8 * SB;\n"),
    ("  ok[l] = pos >= 0;\n}\n",
     "  {\n" + _WALK_TAIL +
     "    if (ser_) atomicAdd(&g_prof[l_ & 63][4], 1ull);\n  }\n"
     "  ok[l] = pos >= 0;\n}\n"),
])

# K4's transcode arm, tc_kernel's one thread a chain (chain c counts in
# slot c & 63): cycles, sequences, chains, the slowest chain's cycles
TC_THREAD = ("chain", ["walk", "sequences", "chains", "max_walk"], [
    ("  if (c >= C) return;\n  long long rep1 = 1, rep2 = 4, rep3 = 8;\n",
     "  if (c >= C) return;\n  long long rep1 = 1, rep2 = 4, rep3 = 8;\n"
     "  long long T0 = clock64();\n  unsigned long long nseq_ = 0;\n"),
    ("    const int n_seq = m[13];\n    int* st = stat + 4 * r;\n",
     "    const int n_seq = m[13];\n    int* st = stat + 4 * r;\n"
     "    nseq_ += n_seq > 0 ? n_seq : 0;\n"),
    ("    st[3] = 0;\n  }\n}\n",
     "    st[3] = 0;\n  }\n  {\n"
     "    const unsigned long long dt = clock64() - T0;\n"
     "    atomicAdd(&g_prof[c & 63][0], dt);\n"
     "    atomicAdd(&g_prof[c & 63][1], nseq_);\n"
     "    atomicAdd(&g_prof[c & 63][2], 1ull);\n"
     "    atomicMax(&g_prof[c & 63][3], dt);\n  }\n}\n"),
])

# K4's transcode arm redesigned: tc_walk_kernel's row walk (row r counts
# in slot r & 63): cycles, sequences walked, rows, the slowest row's
# cycles, the steps read through read_at (slow_steps: WIDE entries,
# states outside [0, 512), a position past the row), those with a WIDE
# entry, and the rows whose stream was not staged
TC_ROW = ("row", ["walk", "sequences", "rows", "max_walk", "slow_steps",
                  "wide_steps", "unstaged_rows"], [
    ("  lanebits::window(src, pos, X, Y);\n  int t = 0;\n",
     "  lanebits::window(src, pos, X, Y);\n  int t = 0;\n"
     "  long long T0 = clock64();\n"
     "  unsigned long long slow_ = 0, wide_ = 0;\n"),
    ("      c = tc_entry(ftg, ct, 2, s_ml);\n",
     "      c = tc_entry(ftg, ct, 2, s_ml);\n      ++slow_;\n"
     "      wide_ += ((a.y | b.y | c.y) & lanebits::WIDE) != 0;\n"),
    ("  // stopped (the row's later tokens zero",
     "  {\n    const unsigned long long dt = clock64() - T0;\n"
     "    const int s_ = blockIdx.x & 63;\n"
     "    atomicAdd(&g_prof[s_][0], dt);\n"
     "    atomicAdd(&g_prof[s_][1], (unsigned long long)t);\n"
     "    atomicAdd(&g_prof[s_][2], 1ull);\n"
     "    atomicMax(&g_prof[s_][3], dt);\n"
     "    atomicAdd(&g_prof[s_][4], slow_);\n"
     "    atomicAdd(&g_prof[s_][5], wide_);\n  }\n"
     "  // stopped (the row's later tokens zero"),
    ("    w = staged\n",
     "    if (!staged) atomicAdd(&g_prof[r & 63][6], 1ull);\n"
     "    w = staged\n"),
])

MICRO = r'''
#include <cstdio>
#include <cuda_runtime.h>
__global__ void k(int* out, long long* cyc, const int* g, int n) {
  __shared__ int s[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) s[i] = (i * 7 + 1) & 1023;
  __syncwarp();
  int x = threadIdx.x;
  long long t[7];
  t[0] = clock64();
  for (int i = 0; i < n; ++i) x = __match_any_sync(0xFFFFFFFFu, x & 7) & 31;
  t[1] = clock64();
  for (int i = 0; i < n; ++i)
    x = (int)__ballot_sync(0xFFFFFFFFu, x & 1) & 31 ^ threadIdx.x;
  t[2] = clock64();
  for (int i = 0; i < n; ++i) x = __shfl_sync(0xFFFFFFFFu, x, (x + 1) & 31);
  t[3] = clock64();
  for (int i = 0; i < n; ++i) x = s[x & 1023];
  t[4] = clock64();
  for (int i = 0; i < n; ++i) x = g[x & 4095];
  t[5] = clock64();
  for (int i = 0; i < n; ++i)
    x = g[(x * 2654435761u) & ((1 << 24) - 1)] + i;
  t[6] = clock64();
  out[threadIdx.x] = x;
  if (threadIdx.x == 0)
    for (int j = 0; j < 6; ++j) cyc[j] = (t[j + 1] - t[j]) / n;
}
int main() {
  int *out, *g;
  long long* cyc;
  cudaMalloc(&out, 128);
  cudaMalloc(&cyc, 64);
  cudaMalloc(&g, (1 << 24) * 4);
  cudaMemset(g, 0, (1 << 24) * 4);
  for (int rep = 0; rep < 2; ++rep) {
    k<<<1, 32>>>(out, cyc, g, 2000);
    long long h[6];
    cudaMemcpy(h, cyc, 48, cudaMemcpyDeviceToHost);
    printf("cycles per op: match_any %lld ballot %lld shfl %lld smem %lld "
           "L1 %lld L2/HBM (64 MiB random) %lld\n", h[0], h[1], h[2], h[3],
           h[4], h[5]);
  }
  return 0;
}
'''


def _load(pkg_dir):
    sys.path.insert(0, os.path.abspath(pkg_dir))
    import numpy as np
    import chip_smoke as cs
    from libzseek_tpu_torch.testing.corpus import mixed_corpus
    data = mixed_corpus(np.random.default_rng(11), 64 * MIB).tobytes()
    return cs, data


def _k1_args(cs, data, level):
    import torch
    from libzseek_tpu_torch.ops.zstd_encode import (GATE_FIXED_BITS,
                                                    block_entropy_h16,
                                                    level_search_params)
    if level == 3:
        x2, lens, ma = cs.batch_layout(data, cs.BATCH_ROWS, 8)
        t = lambda a: torch.from_numpy(a).cuda()
        args = [t(x2), t(lens), t(ma)]
        args.append(block_entropy_h16(args[0][1:], args[1])[0])
        return args, {}
    return (cs.k1_level_args(data, cs.K1H_BATCH, 16, cs.BLOCK_HIGH),
            {"gate_bits": GATE_FIXED_BITS, **level_search_params(level)})


def _lz4_window(cs, data):
    from libzseek_tpu_torch import LZ4Codec
    frames = LZ4Codec(device="cuda").compress_frames(
        [data[16 * q * MIB: (16 * q + 1) * MIB] for q in range(4)])
    return cs.lz4_rows(frames)


def _k5_args(cs, data):
    """K5 at chip_smoke's batch: 128 rows, 8 frames of 16 blocks."""
    import torch
    from libzseek_tpu_torch.ops import lz4_emit
    offs = [f + j * cs.LZ4_BLOCK for f in cs.LZ4_FRAMES for j in range(16)]
    args = [torch.from_numpy(a).cuda() for a in cs.k5_layout(data, offs, 16)]
    return args, lz4_emit.out_cap()


def _k4_args(data, level):
    """K4's execute-arm inputs for the codec's first 8 frames of the
    corpus at `level` (64 blocks at level 3, 128 at level 9)."""
    import torch
    from libzseek_tpu_torch import ZstdCodec
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.ops.zstd_decode import k4_inputs
    frames = ZstdCodec(level=level, device="cuda").compress_frames(
        [data[i * MIB: (i + 1) * MIB] for i in range(8)])
    args, n, rows = k4_inputs(frames, [MIB] * 8, torch.device("cuda"))
    # the record scratch's size, for a decode_blocks that takes it
    takes = "n_seqs" in inspect.signature(D.decode_blocks).parameters
    return args, n, {"n_seqs": D.seq_total(rows["meta"])} if takes else {}


# K7's batches: chip_smoke's 64 rows (16 from each quarter), then the 64 MiB
# hash write's batches 0, 2, 4 and 6 (8 contiguous MiB: one per quarter)
K7_BATCHES = (("64 rows", None), ("text", 0), ("repeats", 16),
              ("zeros", 32), ("noise", 48))
# K6's windows: the level-3 archive's frames from these indices, 8 each
K6_WINDOWS = (("8 frames", 0), ("repeats 8 frames", 16),
              ("zeros 8 frames", 32))


def _k7_args(cs, data, start):
    """K7's (x, lengths) on the card: chip_smoke's BATCH_ROWS (start
    None) or the 64 blocks of 128 KiB from `start` MiB on."""
    import torch
    rows = cs.BATCH_ROWS if start is None else \
        [start * MIB + j * cs.N for j in range(64)]
    return [torch.from_numpy(a).cuda() for a in cs.hash_rows(data, rows)]


def _k6_calls(cs, data):
    """K6's recorded calls (fn, args, kwargs) on the lane route for each
    K6_WINDOWS window of the level-3 archive (with its hints; the first
    window also without): {name: [calls]}."""
    from libzseek_tpu_torch import Reader
    from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
    archive, _ = cs.write_archive(data, "cuda")
    table = parse_seek_table_bytes(archive)
    r = Reader(archive, device="cuda", decoder="lanes")
    out = {}
    for name, i0 in K6_WINDOWS:
        idx = range(i0, i0 + 8)
        frames = [cs.frame_bytes(archive, table, i) for i in idx]
        for tag, hints in (("", [r._frame_hints(i) for i in idx]),
                           (" no hints", None)):
            if tag and i0:
                continue
            _, calls = cs.lane_calls(frames, [MIB] * 8, hints)
            out[name + tag] = [c[:3] for c in calls["execute_blocks"]]
    r.close()
    return out


# the 64 MiB corpus's quarters (MiB offsets): the hash write's batches 0,
# 2, 4 and 6, and the level-9 write's first batch of each quarter
QUARTERS = (("text", 0), ("repeats", 16), ("zeros", 32), ("noise", 48))


def _clone(v):
    import torch
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(a) for a in v)
    if isinstance(v, dict):
        return {k: _clone(a) for k, a in v.items()}
    return v


def _capture(module, name, codec, frames):
    """The arguments (args, kwargs) of the codec's first call to
    module.name while it compresses `frames` (the call itself runs); the
    tool's own copy of testing/capture.first_call, which DIR's package
    may not have."""
    real = getattr(module, name)
    got = []

    def spy(*a, **kw):
        if not got:
            got.append((_clone(a), _clone(kw)))
        return real(*a, **kw)
    setattr(module, name, spy)
    try:
        codec.compress_frames(frames)
    finally:
        setattr(module, name, real)
    return got[0]


def _k2_calls(cs, data):
    """K2's inputs {name: (args, kwargs)}: chip_smoke's 64 rows with the
    main path's K2 modes, the hash write's batches 0, 2, 4, 6 and the
    level-9 write's first batch of each quarter."""
    import torch
    from libzseek_tpu_torch import ZstdCodec
    from libzseek_tpu_torch.ops import entropy as E
    cuda = torch.device("cuda")
    S = 8192
    xb, seqs, _m, kmeta, codes, ctabs, _l, _v = cs.chain_inputs(
        *cs.batch_layout(data, cs.BATCH_ROWS, 8), cuda)
    out = {"64 rows": ((xb, seqs["ll"], seqs["ml"], seqs["offv"], kmeta,
                        codes, S, (cs.N + 64 + 127) // 128 * 128,
                        (9 * S + 64 + 127) // 128 * 128), {"ctabs": ctabs})}
    for name, start in QUARTERS:
        out[f"hash {name}"] = _capture(
            E, "entropy_emit", ZstdCodec(device="cuda", parser="hash"),
            [data[(start + i) * MIB: (start + i + 1) * MIB]
             for i in range(8)])
    for name, start in QUARTERS:
        out[f"L9 {name}"] = _capture(
            E, "entropy_emit", ZstdCodec(level=9, device="cuda"),
            [data[(start + i) * MIB: (start + i + 1) * MIB]
             for i in range(4)])
    return out


def _k3_calls(cs, data):
    """K3's inputs {name: vector_literals args}: chip_smoke's 64 rows (the
    main path's K3 rows) and the level-3 write's two text batches."""
    import torch
    from libzseek_tpu_torch import ZstdCodec
    from libzseek_tpu_torch.ops import vector_entropy as VE
    cuda = torch.device("cuda")
    xb, seqs, _m, _k, codes, _c, lens, vec = cs.chain_inputs(
        *cs.batch_layout(data, cs.BATCH_ROWS, 8), cuda)
    out = {"64 rows": (xb, seqs["lit_mask"], codes, lens, vec,
                       (cs.N + 64 + 127) // 128 * 128)}
    for k in range(2):
        out[f"text {k}"] = _capture(
            VE, "vector_literals", ZstdCodec(device="cuda"),
            [data[(8 * k + i) * MIB: (8 * k + i + 1) * MIB]
             for i in range(8)])[0]
    return out


def _k2_rows(meta):
    """A K2 input's rows: counts of each literal mode, literals and
    sequences."""
    from libzseek_tpu_torch.ops import entropy as E
    m = meta.cpu().numpy()
    mode, lc, n = m[:, 3], m[:, 1], m[:, 2]
    huf = (mode & E.MODE_HUF) != 0
    one = (mode & E.MODE_HUF1) != 0
    raw = (mode & E.MODE_RAWLIT) != 0
    seq = ((mode & E.MODE_SEQ) != 0) & (n > 0)
    return {"huf4": int((huf & ~one).sum()), "huf1": int((huf & one).sum()),
            "raw": int(raw.sum()), "no_literals": int((~huf & ~raw).sum()),
            "huf_literals": int(lc[huf].sum()),
            "raw_literals": int(lc[raw].sum()), "seq_rows": int(seq.sum()),
            "sequences": int(n[seq].sum()),
            "n_max": int(n[seq].max()) if seq.any() else 0}


def _k3_rows(args):
    """A K3 input's rows: the rows it takes and their literals."""
    import numpy as np
    x, mask, _codes, lens, vec = (a.cpu().numpy() for a in args[:5])
    bits = np.unpackbits(mask.view(np.uint8), axis=1, bitorder="little")
    live = np.arange(x.shape[1])[None, :] < lens[:, None]
    lits = (bits.astype(bool) & live)[vec.astype(bool)].sum()
    return {"rows": int(vec.sum()), "literals": int(lits)}


def _greedy_calls(cs, data):
    """greedy_select's inputs {name: (args, kwargs)}: the zstd and LZ4
    sort writes' first batches, captured from the codecs as chip_smoke's
    phase 11 does (64 and 128 rows of 32,768 segments)."""
    from libzseek_tpu_torch import LZ4Codec, ZstdCodec
    frames = [data[f * 8 * MIB: f * 8 * MIB + MIB] for f in range(8)]
    return {"zstd 64 rows": cs.capture_greedy(ZstdCodec(parser="sort"),
                                              frames),
            "LZ4 128 rows": cs.capture_greedy(LZ4Codec(parser="sort"),
                                              frames)}


def _greedy_rows(args, out):
    """Per row of a greedy_select call: the segments with a candidate,
    the selections, and the longest run of segments with no selection."""
    import numpy as np
    has = args[3].cpu().numpy()
    sel = out[0].cpu().numpy()
    rows = []
    for h, s in zip(has, sel):
        idx = np.flatnonzero(s)
        gaps = np.diff(np.concatenate([[-1], idx, [s.size]])) - 1
        rows.append({"candidates": int(h.sum()), "selections": int(s.sum()),
                     "longest_gap": int(gaps.max())})
    return rows


def _rows_summary(rows):
    tot = lambda k: sum(r[k] for r in rows)
    return {"rows": len(rows), "candidates": tot("candidates"),
            "selections": tot("selections"),
            "max_selections": max(r["selections"] for r in rows),
            "max_longest_gap": max(r["longest_gap"] for r in rows)}


# the reads whose lane-decoder and transcode calls the lane groups
# record: (name, archive, decoder); the archives as chip_smoke writes
# them (level 3, level 9, the hash parser's log-like 8 MiB of phase 7)
LANE_READS = (("L3", "level 3", "lanes"), ("L9", "level 9", "lanes"),
              ("log", "log-like", "lanes"),
              ("L3 transcode", "level 3", "auto"),
              ("L9 transcode", "level 9", "auto"),
              ("log transcode", "log-like", "auto"))
LANE_WRAPPERS = (("huf", "huf_lanes"), ("seq", "seq_lanes"),
                 ("K4T", "transcode_blocks"))


def _arm(short, a, kw):
    if short == "huf":
        return "plain" if kw["exact"] else "anchored"
    if short == "seq":
        return "tagged" if kw["tagged"] else "anchored"
    return "host literals" if a[0] is None else "device literals"


def _lane_reads(cs, data):
    """Every call of the Huffman lanes, the sequence lanes and K4's
    transcode arm in one sequential Reader pass over each LANE_READS
    archive (the read checked against its input): {"huf L9 plain":
    [(fn, args, kwargs, out)], ...}, grouped by read and arm."""
    import numpy as np
    from libzseek_tpu_torch import Reader
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.ops import lanes
    from libzseek_tpu_torch.testing.corpus import log_corpus
    logs = log_corpus(np.random.default_rng(13), 8 * MIB).tobytes()
    archives = {"level 3": (cs.write_archive(data, "cuda")[0], data),
                "level 9": (cs.write_archive(data, "cuda", "zstd", 9)[0],
                            data),
                "log-like": (cs.hash_write(logs, "cuda")[0], logs)}
    mods = {"huf_lanes": lanes, "seq_lanes": lanes, "transcode_blocks": D}
    groups = {}
    for read, arch, decoder in LANE_READS:
        archive, raw = archives[arch]
        calls = []
        saved = [(fname, getattr(mods[fname], fname))
                 for _, fname in LANE_WRAPPERS]
        for short, fname in LANE_WRAPPERS:
            real = getattr(mods[fname], fname)

            def spy(*a, _real=real, _short=short, **kw):
                out = _real(*a, **kw)
                calls.append((_short, (_real, a, kw, out)))
                return out
            setattr(mods[fname], fname, spy)
        try:
            with Reader(archive, device="cuda", decoder=decoder) as r:
                got = cs.read_all(r)
        finally:
            for fname, real in saved:
                setattr(mods[fname], fname, real)
        if got != raw:
            sys.exit(f"the {read} read differs from its input")
        for short, call in calls:
            arm = _arm(short, call[1], call[2])
            groups.setdefault(f"{short} {read} {arm}", []).append(call)
    return groups


def _lane_work(cs, name, call):
    """(bytes, operations, symbols or sequences) of one recorded call."""
    fn, a, kw, out = call
    if name.startswith("K4T"):
        nb, ops = cs.transcode_work([(a, out)])
        return nb, ops, ops
    fname = "huf_lanes" if name.startswith("huf") else "seq_lanes"
    nb, ops = cs.lane_work(fname, call)
    return nb, ops, int(kw["n"].sum())


def _lane_summary(cs, name, calls):
    """A group's launches, bound (summed over its calls) and work, and
    the index of its call with the most work."""
    work = [_lane_work(cs, name, c) for c in calls]
    return {"launches": len(calls),
            "bound_ms": sum(cs.bound(nb, ops)[0] for nb, ops, _ in work),
            "work": sum(w for _, _, w in work)}, \
        max(range(len(work)), key=lambda i: work[i][2])


def _lanes_wanted(only):
    """Whether --only asks for any lane-read group."""
    return not only or any(o.startswith(p) or p.startswith(o) for o in only
                           for p in ("huf", "seq", "K4T"))


def _keep(name, only):
    return not only or any(name.startswith(p) for p in only)


def _host_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds until fn() returns, the card idle before
    each call: the wrapper's own time (allocations, copies, launches),
    apart from the kernels' device time."""
    import time
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def _digest(ts) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def times(pkg_dir, levels, check, only=()):
    import torch
    cs, data = _load(pkg_dir)
    from libzseek_tpu_torch.ops import decode, exec_blocks, hash_parse
    from libzseek_tpu_torch.ops import lz4_decode, lz4_emit, parse_linked
    res = {}

    def run(name, fn, plain):
        if not _keep(name, only):
            return
        got = fn()
        torch.cuda.synchronize()
        res[f"{name} sha256"] = _digest(got)
        if check and plain is not None:
            res[f"{name} equal"] = all(
                torch.equal(a.cpu(), b) for a, b in zip(got, plain()))
        res[f"{name} ms"] = cs.time_cuda(fn)

    for level in levels:
        if not _keep(f"K1 L{level}", only):
            continue
        args, prm = _k1_args(cs, data, level)
        run(f"K1 L{level}", lambda: parse_linked.parse_linked(*args, **prm),
            lambda: parse_linked.parse_linked(*[a.cpu() for a in args],
                                              **prm))
    if _keep("K5", only):
        k5, cap = _k5_args(cs, data)
        run("K5 128 rows", lambda: lz4_emit.lz4_emit(*k5, cap),
            lambda: lz4_emit.lz4_emit(*[a.cpu() for a in k5], cap))
    for level in (3, 9) if _keep("K4", only) else ():
        k4, n, ns = _k4_args(data, level)
        run(f"K4 L{level} {k4[4].shape[0]} blocks",
            lambda: decode.decode_blocks(*k4, n, **ns),
            lambda: decode.decode_blocks(*[a.cpu() for a in k4], n))
    if _keep("LZ4", only):
        (comp, clens, unc), F, linked = _lz4_window(cs, data)
        d = [a.cuda() for a in (comp, clens, unc)]
        run("LZ4 decode", lambda: lz4_decode.lz4_decode_frames(
            *d, F, linked=linked), lambda: lz4_decode.lz4_decode_frames(
            comp, clens, unc, F, linked=linked))
    for name, start in K7_BATCHES if _keep("K7", only) else ():
        k7 = _k7_args(cs, data, start)
        run(f"K7 {name}", lambda: hash_parse.hash_parse(*k7),
            lambda: hash_parse.hash_parse(*[a.cpu() for a in k7]))
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
    if _keep("K6", only):
        for name, calls in _k6_calls(cs, data).items():
            run(f"K6 {name}",
                lambda: [t for fn, a, kw in calls for t in fn(*a, **kw)],
                lambda: [t for fn, a, kw in calls for t in fn(
                    *map(cpu, a), **{k: cpu(v) for k, v in kw.items()})])
    if _keep("K2", only):
        from libzseek_tpu_torch.ops import entropy as E
        for name, (a, kw) in _k2_calls(cs, data).items():
            res[f"K2 {name} rows"] = _k2_rows(a[4])
            run(f"K2 {name}", lambda: E.entropy_emit(*a, **kw),
                lambda: E.entropy_emit(*map(cpu, a),
                                       **{k: cpu(v) for k, v in kw.items()}))
    if _keep("K3", only):
        from libzseek_tpu_torch.ops import vector_entropy as VE
        for name, a in _k3_calls(cs, data).items():
            res[f"K3 {name} rows"] = _k3_rows(a)
            run(f"K3 {name} call", lambda: VE.vector_literals(*a),
                lambda: VE.vector_literals(*map(cpu, a)))
            if hasattr(VE, "place_literals"):
                # the parent's placement kernel alone, on its prep's output
                prep = VE.vector_prep(*a[:5])[:3]
                run(f"K3 {name} kernel",
                    lambda: [VE.place_literals(*prep, a[5] // 4)],
                    lambda: [VE.place_literals(*map(cpu, prep), a[5] // 4)])
    if _keep("greedy", only):
        from libzseek_tpu_torch.ops import match
        outs = lambda o: [o[0], o[1], o[4], o[5]]   # e, off pass through
        for name, (a, kw) in _greedy_calls(cs, data).items():
            fn = lambda: outs(match.greedy_select(*a, **kw))
            res[f"greedy {name} rows"] = _rows_summary(_greedy_rows(a, fn()))
            run(f"greedy {name}", fn, lambda: outs(match.greedy_select(
                *map(cpu, a), **kw)))
    if _lanes_wanted(only):
        for name, calls in _lane_reads(cs, data).items():
            if not _keep(name, only):
                continue
            summ, imax = _lane_summary(cs, name, calls)
            res[f"{name} calls"] = summ
            run(name, lambda: [t for fn, a, kw, _ in calls
                               for t in fn(*a, **kw)], None)
            fn, a, kw, _ = calls[imax]
            nb, ops, w = _lane_work(cs, name, calls[imax])
            res[f"{name} max call"] = {"work": w,
                                       "bound_ms": cs.bound(nb, ops)[0]}
            run(f"{name} max", lambda: list(fn(*a, **kw)),
                lambda: list(fn(*map(cpu, a),
                                **{k: cpu(v) for k, v in kw.items()})))
            if name.startswith("K4T") and _keep(f"{name} max", only):
                res[f"{name} max host ms"] = _host_ms(lambda: fn(*a, **kw))
                res[f"{name} host ms"] = _host_ms(
                    lambda: [fn(*a, **kw) for fn, a, kw, _ in calls])
        # each decoder arm's call with the most work over the reads
        for arm in ("huf plain", "huf anchored", "seq tagged",
                    "seq anchored", "K4T literals"):
            short, kind = arm.split()
            groups = [k[: -len(" max call")] for k in res
                      if k.startswith(short) and k.endswith(
                          f" {kind} max call")]
            if groups:
                g = max(groups, key=lambda k: res[f"{k} max call"]["work"])
                res[f"{arm} largest"] = {"group": g,
                                         **res[f"{g} max call"],
                                         "ms": res.get(f"{g} max ms")}
    print(json.dumps({os.path.abspath(pkg_dir): res}), flush=True)
    return res


def pair(parent, change, levels, only=()):
    """times from parent, change, change, parent, each in its own process
    (the two trees hold packages of one name)."""
    runs = []
    for d in (parent, change, change, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "times", d,
             ",".join(map(str, levels)), "--check",
             "--only=" + ",".join(only)],
            capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"pair: times {d} failed:\n{proc.stderr}")
        out = proc.stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
        print(out.strip().splitlines()[-1], flush=True)
    res = [next(iter(r.values())) for r in runs]
    same = {k: res[0][k] == res[1][k] for k in res[0]
            if k.endswith("sha256") and k in res[1]}
    # a kernel held in another form on one side has its times on that side
    summary = {}
    for k in dict.fromkeys([*res[0], *res[1]]):
        if k.endswith(" ms"):
            summary[k[:-3]] = {
                side: (res[a][k] + res[b][k]) / 2
                for side, a, b in (("parent", 0, 3), ("change", 1, 2))
                if k in res[a]}
    largest = {k: {side: res[a][k] for side, a in (("parent", 0),
                                                   ("change", 1))
                   if k in res[a]}
               for k in res[0] if k.endswith(" largest")}
    print(json.dumps({"outputs equal": same, "mean ms": summary,
                      "largest calls": largest}), flush=True)
    if not all(same.values()):
        sys.exit("pair: the parent's and the change's outputs differ")


def kernels(pkg_dir, only=()):
    """K4's execute arm (level 3, 64 blocks; level 9, 128 blocks), K5
    (128 rows), K7 (64 rows; the text batch), K6 (8 frames with hints; 8
    repeats frames), K2 (64 rows; the hash text batch) and K3 (the first
    text batch), five calls each under torch.profiler: the mean time of
    each CUDA kernel a call launches."""
    import torch
    cs, data = _load(pkg_dir)
    from libzseek_tpu_torch.ops import decode, hash_parse, lz4_emit
    runs = []
    for level in (3, 9) if _keep("K4", only) else ():
        k4, n, ns = _k4_args(data, level)
        runs.append((f"K4 L{level} {k4[4].shape[0]} blocks",
                     lambda k4=k4, n=n, ns=ns: decode.decode_blocks(
                         *k4, n, **ns)))
    if _keep("K5", only):
        k5, cap = _k5_args(cs, data)
        runs.append(("K5 128 rows", lambda: lz4_emit.lz4_emit(*k5, cap)))
    for name, start in K7_BATCHES[:2] if _keep("K7", only) else ():
        k7 = _k7_args(cs, data, start)
        runs.append((f"K7 {name}",
                     lambda k7=k7: hash_parse.hash_parse(*k7)))
    if _keep("K6", only):
        k6 = _k6_calls(cs, data)
        for name in ("8 frames", "repeats 8 frames"):
            runs.append((f"K6 {name}", lambda calls=k6[name]: [
                fn(*a, **kw) for fn, a, kw in calls]))
    if _keep("K2", only):
        from libzseek_tpu_torch.ops import entropy as E
        k2 = _k2_calls(cs, data)
        for name in ("64 rows", "hash text"):
            a, kw = k2[name]
            runs.append((f"K2 {name}", lambda a=a, kw=kw: E.entropy_emit(
                *a, **kw)))
    if _keep("K3", only):
        from libzseek_tpu_torch.ops import vector_entropy as VE
        a = _k3_calls(cs, data)["text 0"]
        runs.append(("K3 text 0 call", lambda: VE.vector_literals(*a)))
    if _keep("greedy", only):
        from libzseek_tpu_torch.ops import match
        for name, (a, kw) in _greedy_calls(cs, data).items():
            runs.append((f"greedy {name}", lambda a=a, kw=kw:
                         match.greedy_select(*a, **kw)))
    if _lanes_wanted(only):
        for name, calls in _lane_reads(cs, data).items():
            fn, a, kw, _ = calls[_lane_summary(cs, name, calls)[1]]
            runs.append((f"{name} max", lambda fn=fn, a=a, kw=kw:
                         fn(*a, **kw)))
    act = [torch.profiler.ProfilerActivity.CUDA]
    for name, fn in runs:
        if not _keep(name, only):
            continue
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        per = {e.key: [round(e.device_time_total / 5 / 1e3, 4),
                       e.count // 5]
               for e in prof.key_averages() if e.device_time_total > 0}
        print(json.dumps({name: per}), flush=True)


def archives(pkg_dir):
    """sha256 of the 64 MiB of mixed_corpus written by DIR's Writer as
    chip_smoke.py writes it: zstd at levels 3 and 9, LZ4 at level 0, zstd
    through the hash parser."""
    import hashlib
    cs, data = _load(pkg_dir)
    res = {}
    for codec, level in (("zstd", 3), ("zstd", 9), ("lz4", 0)):
        archive, _ = cs.write_archive(data, "cuda", codec, level)
        res[f"{codec} level {level}"] = hashlib.sha256(archive).hexdigest()
    archive, _, _ = cs.hash_write(data, "cuda")
    res["zstd hash parser"] = hashlib.sha256(archive).hexdigest()
    print(json.dumps({os.path.abspath(pkg_dir): res}), flush=True)


WRITES = ("zstd level 3", "zstd level 9", "zstd hash parser")


def write_rates(pkg_dir):
    """MiB/s of DIR's writes (WRITES), a warm-up each, then two each."""
    cs, data = _load(pkg_dir)
    run = {"zstd level 3": lambda: cs.write_archive(data, "cuda")[1],
           "zstd level 9": lambda: cs.write_archive(data, "cuda", "zstd",
                                                    9)[1],
           "zstd hash parser": lambda: cs.hash_write(data, "cuda")[1]}
    for name in WRITES:
        run[name]()
    res = {name: [] for name in WRITES}
    for _ in range(2):
        for name in WRITES:
            res[name].append(len(data) / MIB / run[name]())
    print(json.dumps({os.path.abspath(pkg_dir): res}), flush=True)


def writes(parent, change, rounds):
    """write_rates in fresh processes, a round parent and change, the
    first side alternating."""
    import numpy as np
    got = {"parent": {n: [] for n in WRITES},
           "change": {n: [] for n in WRITES}}
    for r in range(rounds):
        order = (("parent", parent), ("change", change))
        for side, d in order if r % 2 == 0 else order[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "write_rates",
                 d], capture_output=True, text=True)
            if proc.returncode:
                sys.exit(f"writes: {d} failed:\n{proc.stderr}")
            line = proc.stdout.strip().splitlines()[-1]
            print(side, line, flush=True)
            for n, v in next(iter(json.loads(line).values())).items():
                got[side][n] += v
    out = {}
    for n in WRITES:
        p, c = np.array(got["parent"][n]), np.array(got["change"][n])
        q1, q3 = np.percentile(p, [25, 75])
        out[n] = {"parent": got["parent"][n], "change": got["change"][n],
                  "median parent": float(np.median(p)),
                  "median change": float(np.median(c)),
                  "parent quartile spread": float(q3 - q1),
                  "change runs above every parent run":
                      f"{int((c > p.max()).sum())} of {c.size}",
                  "change runs below every parent run":
                      f"{int((c < p.min()).sum())} of {c.size}"}
    print(json.dumps(out), flush=True)


def _patch(path, variants, tag):
    with open(path) as f:
        src = f.read()
    for name, fields, edits in variants:
        if all(old in src for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            if "g_prof[64][16];" not in src:
                src = src.replace("namespace {", PROF_HEAD, 1)
            src = src.replace("g_prof", f"g_prof_{tag}")
            with open(path, "w") as f:
                f.write(src + PROF_READ.replace("NAME", tag)
                        .replace("g_prof", f"g_prof_{tag}"))
            return name, fields
    return None, None


def counters(pkg_dir, only=()):
    import numpy as np
    import torch
    dst = os.path.join(ROOT, "build", "counters")
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(os.path.join(pkg_dir, "libzseek_tpu_torch"),
                    os.path.join(dst, "libzseek_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(pkg_dir, "chip_smoke.py"), dst)
    csrc = os.path.join(dst, "libzseek_tpu_torch", "csrc")
    k1, k1_fields = _patch(os.path.join(csrc, "parse_linked.cu"),
                           [K1_THREAD, K1_WARP], "k1")
    lz, lz_fields = _patch(os.path.join(csrc, "lz4_decode.cu"),
                           [LZ4_WARP_PER_FRAME], "lz4")
    k5v, k5_fields = _patch(os.path.join(csrc, "lz4_emit.cu"), [K5_THREAD],
                            "k5")
    k4v, k4_fields = _patch(os.path.join(csrc, "decode.cu"),
                            [K4_WARP_PER_FRAME], "k4")
    k7v, k7_fields = _patch(os.path.join(csrc, "hash_parse.cu"),
                            [K7_LANE0, K7_ROUNDS], "k7")
    k6v, k6_fields = _patch(os.path.join(csrc, "exec_blocks.cu"),
                            [K6_WARP_PER_FRAME], "k6")
    k2v, k2_fields = _patch(os.path.join(csrc, "entropy.cu"), [K2_SERIAL],
                            "k2")
    grv, gr_fields = _patch(os.path.join(csrc, "greedy_select.cu"),
                            [GREEDY_LANE0], "greedy")
    hufv, huf_fields = _patch(os.path.join(csrc, "huf_lanes.cu"),
                              [HUF_THREAD, HUF_WINDOW], "huf")
    seqv, seq_fields = _patch(os.path.join(csrc, "fse_lanes.cu"),
                              [SEQ_THREAD, SEQ_WINDOW], "seq")
    tcv, tc_fields = _patch(os.path.join(csrc, "decode.cu"),
                            [TC_THREAD, TC_ROW], "tc")
    cs, data = _load(dst)
    from libzseek_tpu_torch import kernels
    from libzseek_tpu_torch.ops import decode, hash_parse, lz4_decode, lz4_emit
    from libzseek_tpu_torch.ops import parse_linked as PL
    lib = kernels.library()
    prof = np.zeros((64, 16), np.uint64)

    def run(fn, fields, n, tag):
        read = getattr(lib, f"zk_prof_{tag}")
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn()
        torch.cuda.synchronize()
        read(None, 1)
        fn()
        torch.cuda.synchronize()
        read(prof.ctypes.data, 0)
        return [dict(zip(fields, prof[c][: len(fields)].tolist()))
                for c in range(n)]

    print(json.dumps({"k1_version": k1, "lz4_version": lz, "k5_version": k5v,
                      "k4_version": k4v, "k7_version": k7v,
                      "k6_version": k6v, "k2_version": k2v,
                      "greedy_version": grv, "huf_version": hufv,
                      "seq_version": seqv, "tc_version": tcv}), flush=True)
    if grv and _keep("greedy", only):
        from libzseek_tpu_torch.ops import match
        for name, (a, kw) in _greedy_calls(cs, data).items():
            fn = lambda: match.greedy_select(*a, **kw)
            slots = run(fn, gr_fields, 64, "greedy")
            rows = _greedy_rows(a, fn())
            for i, r in enumerate(rows):   # rows i and i + 64 share slot i
                sl = slots[i & 63]
                r["cycles_per_segment"] = round(sl["walk"] / sl["segments"],
                                                2)
            print(json.dumps({f"greedy {name}": {
                "ms": cs.time_cuda(fn, reps=3),
                "summary": _rows_summary(rows), "per_row": rows}}),
                flush=True)
    lane_v = {"huf": hufv, "seq": seqv, "K4T": tcv}
    if _lanes_wanted(only) and any(lane_v.values()):
        for name, calls in _lane_reads(cs, data).items():
            short = name.split()[0]
            if not lane_v[short] or not _keep(name, only):
                continue
            fn, a, kw, _ = calls[_lane_summary(cs, name, calls)[1]]
            go = lambda: fn(*a, **kw)
            fields = {"huf": huf_fields, "seq": seq_fields,
                      "K4T": tc_fields}[short]
            slots = run(go, fields, 64,
                        {"huf": "huf", "seq": "seq", "K4T": "tc"}[short])
            tot = {k: sum(sl[k] for sl in slots) for k in slots[0]}
            work = tot[fields[1]]
            print(json.dumps({f"{name} max": {
                "ms": cs.time_cuda(go, reps=3), **tot,
                "cycles_per_item": round(tot["walk"] / work, 2)
                if work else None,
                **{f"{k}_per_item": round(tot[k] / work, 2)
                   for k in fields[4:] if work},
                "max_walk": max(sl["max_walk"] for sl in slots)}}),
                flush=True)
    if k2v and _keep("K2", only):
        from libzseek_tpu_torch.ops import entropy as E
        for name, (a, kw) in _k2_calls(cs, data).items():
            fn = lambda: E.entropy_emit(*a, **kw)
            rows = run(fn, k2_fields, 64, "k2")
            print(json.dumps({f"K2 {name}": {
                "ms": cs.time_cuda(fn, reps=3), "rows": _k2_rows(a[4]),
                "summary": _k2_summary(rows), "per_row": rows}}),
                flush=True)
    if k7v and _keep("K7", only):
        for name, start in K7_BATCHES:
            k7 = _k7_args(cs, data, start)
            fn = lambda: hash_parse.hash_parse(*k7)
            print(json.dumps({f"K7 {name}": {
                "ms": cs.time_cuda(fn, reps=3),
                "rows": run(fn, k7_fields, 64, "k7")}}), flush=True)
    if k6v and _keep("K6", only):
        for name, calls in _k6_calls(cs, data).items():
            fn = lambda: [f(*a, **kw) for f, a, kw in calls]
            print(json.dumps({f"K6 {name}": {
                "ms": cs.time_cuda(fn, reps=3),
                "frames": run(fn, k6_fields, 8, "k6")}}), flush=True)
    if k5v and _keep("K5", only):
        k5, cap = _k5_args(cs, data)
        fn = lambda: lz4_emit.lz4_emit(*k5, cap)
        print(json.dumps({"K5 128 rows": {
            "ms": cs.time_cuda(fn, reps=3),
            "chains": run(fn, k5_fields, 8, "k5")}}), flush=True)
    if k4v and _keep("K4", only):
        for level in (3, 9):
            k4, n, ns = _k4_args(data, level)
            fn = lambda: decode.decode_blocks(*k4, n, **ns)
            print(json.dumps({f"K4 L{level}": {
                "ms": cs.time_cuda(fn, reps=3),
                "frames": run(fn, k4_fields, 8, "k4")}}), flush=True)
    if k1 and _keep("K1", only):
        for level in (9, 4, 16):
            args, prm = _k1_args(cs, data, level)
            fn = lambda: PL.parse_linked(*args, **prm)
            out = {"ms": cs.time_cuda(fn, reps=3),
                   "chains": run(fn, k1_fields, 4, "k1")}
            if k1 == "thread" and level == 9:
                out["ms_table_in_device_memory"] = _global_table(
                    lib, cs, PL, args, prm)
            print(json.dumps({f"K1 L{level}": out}), flush=True)
    if lz and _keep("LZ4", only):
        (comp, clens, unc), F, linked = _lz4_window(cs, data)
        d = [a.cuda() for a in (comp, clens, unc)]
        fn = lambda: lz4_decode.lz4_decode_frames(*d, F, linked=linked)
        print(json.dumps({"LZ4 decode": {
            "ms": cs.time_cuda(fn, reps=3),
            "frames": run(fn, lz_fields, 4, "lz4")}}), flush=True)


def _k2_summary(rows):
    """Cycles a literal of each part of thread 0's walk (over all rows),
    a raw byte, a sequence; the slowest row's thread-0 and thread-32
    cycles; the mean zeroing cycles."""
    tot = {k: sum(r[k] for r in rows) for k in rows[0]}
    per = lambda k, n: round(tot[k] / tot[n], 2) if tot[n] else None
    out = {f"{k}_per_literal": per(k, "lits")
           for k in ("lit_walk", "run_walk", "x_load", "code_load", "push")}
    out["raw_copy_per_byte"] = per("raw_copy", "raw_bytes")
    out["seq_walk_per_sequence"] = per("seq_walk", "seqs")
    out["max_thread0"] = max(r["run_table"] + r["lit_walk"] + r["raw_copy"]
                             for r in rows)
    out["max_thread32"] = max(r["seq_walk"] + r["seq_tail"] for r in rows)
    out["zero_mean"] = round(tot["zero"] / len(rows), 1)
    return out


def _global_table(lib, cs, PL, args, prm):
    """The one-thread walk with dual = 2: its table in device memory."""
    import torch
    x2, lengths, min_abs, h16 = args
    B, N = x2.shape[0] - 1, x2.shape[1]
    bounds = torch.from_numpy(
        PL.chain_bounds(min_abs.cpu().numpy(), N)).cuda()
    nch = bounds.numel() - 1
    tables = torch.empty((nch, PL.TAB_SIZE), dtype=torch.int32,
                         device="cuda")
    ll = torch.empty((B, PL.CAP), dtype=torch.int32, device="cuda")
    ml, off = torch.empty_like(ll), torch.empty_like(ll)
    nn = torch.empty((B, 2), dtype=torch.int32, device="cuda")
    mask = torch.empty((B, N // 32), dtype=torch.int32, device="cuda")

    def go():
        kernels_err = lib.zk_parse_linked(
            x2.data_ptr(), lengths.data_ptr(), min_abs.data_ptr(),
            h16.data_ptr(), bounds.data_ptr(), nch, N, PL.CAP,
            PL.MAX_OFFSET, prm["gate_bits"], prm["min_match"],
            prm["accel_log"], PL.STRICT_H16_X6, prm["lazy"], 2,
            int(prm["rep_probe"]), tables.data_ptr(), ll.data_ptr(),
            ml.data_ptr(), off.data_ptr(), nn.data_ptr(), mask.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if kernels_err:
            raise RuntimeError(f"zk_parse_linked: CUDA error {kernels_err}")
    return cs.time_cuda(go, reps=3)


def micro():
    out = os.path.join(ROOT, "build", "micro")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "micro.cu"), "w") as f:
        f.write(MICRO)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", os.path.join(out, "micro"),
                    os.path.join(out, "micro.cu")], check=True)
    subprocess.run([os.path.join(out, "micro")], check=True)


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    levels = lambda i: [int(x) for x in sys.argv[i].split(",") if x] \
        if len(sys.argv) > i and not sys.argv[i].startswith("-") else []
    only = [p for a in sys.argv if a.startswith("--only=")
            for p in a[len("--only="):].split(",") if p]
    if cmd == "times":
        times(sys.argv[2], levels(3), "--check" in sys.argv, only)
    elif cmd == "pair":
        pair(sys.argv[2], sys.argv[3], levels(4), only)
    elif cmd == "archives":
        archives(sys.argv[2])
    elif cmd == "write_rates":
        write_rates(sys.argv[2])
    elif cmd == "writes":
        writes(sys.argv[2], sys.argv[3],
               int(sys.argv[4]) if len(sys.argv) > 4 else 5)
    elif cmd == "kernels":
        kernels(sys.argv[2], only)
    elif cmd == "counters":
        counters(sys.argv[2], only)
    elif cmd == "micro":
        micro()
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
