#!/usr/bin/env python3
"""Timings and clock-counter attributions of the port's K1 (linked parse)
and LZ4 decoder on an H100, for PERF.md section 6.

    python3 tools/torch_kernel_profile.py times DIR LEVELS [--check]
    python3 tools/torch_kernel_profile.py counters DIR
    python3 tools/torch_kernel_profile.py micro

DIR is a directory holding libzseek_tpu_torch/ and chip_smoke.py: the
repository root, or a `git archive` of another commit unpacked under the
gitignored build/, so two versions can be timed in one run.

times: K1 at each level of LEVELS (comma-separated; 3 takes chip_smoke's
64 rows of 128 KiB, the others its 64 rows of 64 KiB in 4 chains) and the
LZ4 decoder on a 4-frame window of the codec's own frames (one per
quarter of mixed_corpus), CUDA events, mean of 5; --check compares each
output with the plain version first.

counters: copies DIR's kernels to build/counters/, inserts clock64()
counters into K1's level >= 4 walk (the one-thread walk of PR 6 or the
warp walk that replaced it, whichever DIR holds) and into the one-warp
LZ4 decoder of PR 3 (the phased decoder that replaced it is timed per
kernel by torch.profiler instead), builds that copy, and prints per chain
(per frame) the cycles of each part of the walk and its counts.
For the one-thread K1 it also times the walk with the dual table in
device memory instead of shared memory.

micro: latency in cycles of warp intrinsics and loads on the card.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20

# counters: (name, [(old text, new text), ...]) for each kernel version;
# the first set whose texts all occur is applied
PROF_HEAD = ("namespace {\n\nconstexpr uint32_t PRIME",
             "__device__ unsigned long long g_prof[64][16];\n"
             "namespace {\n\nconstexpr uint32_t PRIME")
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


def times(pkg_dir, levels, check):
    import torch
    cs, data = _load(pkg_dir)
    from libzseek_tpu_torch.ops import lz4_decode, parse_linked
    res = {}
    for level in levels:
        args, prm = _k1_args(cs, data, level)
        fn = lambda: parse_linked.parse_linked(*args, **prm)
        if check:
            got = fn()
            ref = parse_linked.parse_linked(*[a.cpu() for a in args], **prm)
            res[f"K1 L{level} equal"] = all(
                torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        res[f"K1 L{level} ms"] = cs.time_cuda(fn)
    (comp, clens, unc), F, linked = _lz4_window(cs, data)
    d = [a.cuda() for a in (comp, clens, unc)]
    dec = lambda: lz4_decode.lz4_decode_frames(*d, F, linked=linked)
    if check:
        got = dec()
        ref = lz4_decode.lz4_decode_frames(comp, clens, unc, F,
                                           linked=linked)
        res["LZ4 decode equal"] = all(
            torch.equal(a.cpu(), b) for a, b in zip(got, ref))
    res["LZ4 decode ms"] = cs.time_cuda(dec)
    print(json.dumps({os.path.abspath(pkg_dir): res}), flush=True)


def _patch(path, variants, tag):
    with open(path) as f:
        src = f.read()
    for name, fields, edits in variants:
        if all(old in src for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            if "g_prof[64][16];" not in src:
                src = src.replace(*PROF_HEAD)
            src = src.replace("g_prof", f"g_prof_{tag}")
            with open(path, "w") as f:
                f.write(src + PROF_READ.replace("NAME", tag)
                        .replace("g_prof", f"g_prof_{tag}"))
            return name, fields
    return None, None


def counters(pkg_dir):
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
    cs, data = _load(dst)
    from libzseek_tpu_torch import kernels
    from libzseek_tpu_torch.ops import lz4_decode, parse_linked as PL
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

    print(json.dumps({"k1_version": k1, "lz4_version": lz}), flush=True)
    if k1:
        for level in (9, 4, 16):
            args, prm = _k1_args(cs, data, level)
            fn = lambda: PL.parse_linked(*args, **prm)
            out = {"ms": cs.time_cuda(fn, reps=3),
                   "chains": run(fn, k1_fields, 4, "k1")}
            if k1 == "thread" and level == 9:
                out["ms_table_in_device_memory"] = _global_table(
                    lib, cs, PL, args, prm)
            print(json.dumps({f"K1 L{level}": out}), flush=True)
    if lz:
        (comp, clens, unc), F, linked = _lz4_window(cs, data)
        d = [a.cuda() for a in (comp, clens, unc)]
        fn = lambda: lz4_decode.lz4_decode_frames(*d, F, linked=linked)
        print(json.dumps({"LZ4 decode": {
            "ms": cs.time_cuda(fn, reps=3),
            "frames": run(fn, lz_fields, 4, "lz4")}}), flush=True)


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
    if cmd == "times":
        times(sys.argv[2], [int(x) for x in sys.argv[3].split(",")],
              "--check" in sys.argv)
    elif cmd == "counters":
        counters(sys.argv[2])
    elif cmd == "micro":
        micro()
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
