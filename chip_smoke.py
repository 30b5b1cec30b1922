#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (libzseek_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit, torch and CUDA versions; builds the
     port's native host library (c++) and the CUDA kernels (one nvcc per
     source, in parallel), timed;
  2. each kernel on the card against its plain PyTorch version on the
     CPU, same inputs, exact equality: K1 parse, K2 entropy and K3
     literal placement (the fused vector_literals call) on small inputs
     from mixed_corpus(seed 11) and at the main path's 64-block batch (8
     frames of 8 blocks; K2 with the main path's modes, K3 on the rows
     the main path gives it); K2 also at the hash write's first batch
     (64 literal-heavy text rows, as its K2 arm passes them) and at the
     level-9 write's first batch (64 rows of 64 KiB), K3 at the level-3
     write's first batch (64 text rows), each timed; K4 decode
     on small frames (the cases of tests/test_decode_smem.py, seed 91,
     written by the port's codec and by stock libzstd at levels 1, 3 and
     19, and a long-window frame) and on damaged copies (rows with a bit
     of a sequence stream flipped, frames with a bit flipped near a
     compressed block's end: the same stat and bytes as plain, some rows
     failing mid-block), and after phase 3 on the archive's first 8
     frames (64 blocks, equal to the input and to the plain version);
     the plan kernel (csrc/plan.cu) on the 8 rows and at the 64-block
     batch, its eleven arrays equal to the torch plans' on the CPU and on
     the card, the torch plans on the card timed beside it;
     kernel times with CUDA events, plain times on the CPU at
     the same 64-block shapes, each kernel's bound (bytes over 3.35 TB/s
     against 32-bit integer operations over 16.7 T/s);
  3. the write path: the port's Writer writes 64 MiB of mixed_corpus
     (seed 11) at level 3 with 1 MiB frames, batch_frames=16 and 1 MiB
     writes (one warm-up run, then the measured run); K1-K3 and the plan
     kernel must have launched during the measured run, the plan kernel
     once for each K2 launch (one each a device batch); stock libzstd
     decodes the archive
     (its sha256 is printed, to compare commits), the seek table lists 64
     frames, and 16 random 4 KiB reads decode through their covering
     frames;
  4. the first 1 MiB frame written once more with device="cpu" (the plain
     versions) is byte-identical to the card's;
  5. the read path: the port's Reader(device="cuda", decoder="fused")
     (K4's execute arm) reads the archive
     sequentially in 1 MiB reads (one warm-up pass, then the measured
     pass, during which K4 must launch), makes 1,000 uniform random 4 KiB
     preads (seed 7), and with device_cache=True 16 preads whose cached
     frames are CUDA tensors; every byte equals the input;
  6. the LZ4 path: K5 (LZ4 block encode) and the LZ4 decoder against
     their plain versions, exact, on small inputs (linked 4 KiB rows, a
     seeded batch, the four level arms, hand-written frames with every
     kind of copy and bad block, damaged frames) and at the path's
     shapes (K5 on 128 rows = 8 frames x 16 blocks of 64 KiB; the decoder
     on one archive frame of each quarter, the shape of the device-cache
     read's one-frame calls, timed and reported, and on a 4-frame
     window, timed and printed); then the port's Writer(codec="lz4",
     level=0) writes the same 64 MiB with 1 MiB frames (warm-up, then the
     measured run, during which K5 must launch); stock liblz4 decodes it
     (its sha256 printed), the seek table lists 64 frames, the first
     frame equals the plain
     versions', a level-9 write of 8 MiB decodes through liblz4; the
     Reader reads it as in phase 5 with device_cache=True (frames
     delivered to the host take the native host route; the decoder must
     launch), and the codec's host route (native block decoder, host
     delivery's) and the card route (to_device=True, then one copy of
     the window to the host) decode the 64 frames in 4-frame windows,
     timed;
  7. the per-block hash-parser path: K7 (hash parse) against its plain
     version, exact, on four 16 KiB rows (text, repeats, zeros, noise),
     at the path's 64-row batch of 128 KiB blocks (8 frames of 8
     blocks, two per quarter of the corpus) and at the hash write's
     first batch (64 text rows); then the port's
     Writer(sink, ZstdCodec(parser="hash")) writes the same 64 MiB with
     1 MiB frames and batch_frames=16 (warm-up, then the measured run,
     during which K7 and K2 must launch and every batch must take the K2
     arm); stock libzstd decodes it, the seek table lists 64 frames, the
     first frame equals the plain versions', and the port's Reader reads
     it back sequentially (the archive's sha256 printed, to compare
     commits); 8 MiB of log-like lines (seed 13) written the
     same way must take the XLA entropy arm in every batch and decode
     through libzstd;
  8. the lane decode route (ZstdCodec(decoder="lanes")): every call the
     route makes to the Huffman lane decoder, the sequence lane decoder
     and K6 (the block executor) is replayed on the CPU's plain versions,
     exact, on the small frames of phase 2 and on the archive's first 8
     frames (64 blocks) with and without its decode hints; K6 also on
     the calls the route makes for damaged frames (testing/damage.py)
     and on damaged copies of the 8 frames' rows, some of which must fail
     and some overlap the row before (their frames must take K6's serial
     arm); then Reader(decoder="lanes") reads the 64 MiB archive as in
     phase 5 (anchored lanes and K6 must run; K6's serial frames
     counted; the decoders' launches counted by arm) and the log-like
     archive of phase 7; each decoder arm's recorded call with the most
     symbols or sequences (over the 8 frames, the 64 MiB read and the
     log-like read) is held against its plain version and timed, with
     its bound from that call, and the decoder's line gives the arm with
     the most; K6 is timed at the 8 frames; the long-window frame
     decodes through the pointer-doubling executor; each route's frame
     and batch counts are printed;
  9. levels >= 4 (64 KiB blocks, K1's dual table, lazy matching and
     repcode probe): K1 against its plain version, exact, at levels 4, 9
     and 16 on four 16 KiB rows (one per quarter: the text quarter takes
     the strict arm and short4, the period-337 quarter the repcode probe),
     on rows that drive the walk's decisions (a lazy step's later match,
     short4, a repcode hit, CAP sequences, a fence inside a chain, short
     last rows) and at the path's 64-row batch (4 frames of 16 blocks, one per
     quarter), timed there; then the port's Writer(sink, level=9) writes
     the 64 MiB with 1 MiB frames and batch_frames=16 (warm-up, then the
     measured run, during which K1 and K2 must launch and K3 must not);
     stock libzstd decodes it (its sha256 printed), the seek table lists
     64 frames, 16 random 4 KiB reads decode, and its first frame equals
     the plain versions';
     levels 4 and 16, and ZstdCodec(level=9, parser="hash"), each write
     8 MiB (2 MiB of each quarter) that libzstd decodes, K1 (K7) launching;
     the level-9 archive is read back through Reader(device="cuda")
     (fused, K4 launching) and Reader(decoder="lanes"), with the lane
     route's counts;
 10. the transcode decode route (host delivery under ZstdCodec(), whose
     decoder "auto" is the default): every
     call the route makes to K4's transcode arm is replayed on its plain
     version, exact (tokens, literals, stat), with the Huffman literals
     on the host and on the device, on the small frames of phase 2 and
     on the archive's first 8 frames with their hints, where the route
     must equal libzstd's output and the arm is timed; then
     Reader(decoder="auto") reads the 64 MiB archive as in phase 5
     (the arm must launch, no batch may leave the route), the
     long-window frame and the level-9 archive go through it without a
     fallback, and the log-like archive of phase 7; every call of the
     level-9 and log-like reads is replayed on plain, each read's
     launches are timed and its call with the most sequences timed
     alone, and variants of the level-9 read's largest call (damaged
     streams, a walk stopped mid-row, a row at its frame's start, a
     stream above the row walk's stage) equal plain; the fused, lane and
     transcode reads of the 64 MiB run in turn, three rounds, each
     read's MiB/s printed;
 11. the sort parser and the public API: greedy_select (the kernel of
     the sort parser, csrc/greedy_select.cu) against its plain version,
     exact, on small cases (one 16 KiB row per quarter, seg_size 4 and
     8, and the LZ4 context arm) and at the path's batches, the
     arguments captured from the codecs on 8 frames (two per quarter):
     64 zstd rows of 128 KiB and 128 LZ4 rows of 64 KiB window plus 64
     KiB block, timed; Writer(sink, ZstdCodec(parser="sort")) writes the
     64 MiB after an 8 MiB warm-up (greedy_select must launch; libzstd
     decodes it, 64 frames, the first frame equals the CPU-plain write's,
     Reader(device="cuda", decoder="fused") reads it back with K4
     launching and 16 random 4 KiB preads equal), then
     Writer(codec=LZ4Codec(parser="sort")) the same with liblz4 and the
     LZ4 decoder (device_cache=True); level 1 zstd and LZ4 level -1
     (seg_size 8) write 8 MiB each, decoded by the stock libraries; the
     zseek_* shims write 8 MiB (CompressionParams("zstd",
     ZstdParams(3))), read it back with 64 zseek_preads and one
     Reader.prefetch of 8 offsets (one decode call), and print the
     reader's stats;
 12. `workers` and parallel/: Writer(workers=2) writes the 64 MiB as
     phase 3 does, with one visible card the codec keeps every batch on
     it (_devices None, _rr 0), the archive's sha256 phase 3's; with
     utils/device._visible_devices listing cuda:0 four times,
     ZstdCodec(workers=4) and LZ4Codec(workers=4) write it (each
     dispatched batch takes the next device, _rr = the batches; K1, K2
     and K3, or K5, must launch), the archives equal to phases 3 and 6's
     by sha256, decoded by stock libzstd / liblz4 and read back by
     Reader(device="cuda"), MiB/s beside workers=1's in turns; two
     processes of libzseek_tpu_torch.testing.dist_worker on cuda:0 over
     gloo on localhost write the 64 MiB in uneven shards (24 and 40
     frames) through parallel.distributed.write_archive, rank 0's
     archive decoded by libzstd and equal by sha256 to this process's
     write_archive of the same 64 frames at world size 1, the MiB/s
     printed; the dry run (parallel/dryrun.py) at
     n = torch.cuda.device_count();
 13. the default decode routes (decoder="auto", the JAX package's):
     Reader(device="cuda") with no decoder reads the level-3 archive of
     phase 3, the level-9 archive of phase 9, 8 MiB in 1 MiB frames of
     stock libzstd (level 3, no hints) and the LZ4 archive of phase 6,
     each equal to its input; each zstd read's transcode counts
     (zstd_decode.routes) and K4 launches by arm are printed, and the
     LZ4 read must launch no decoder (the native host route); then
     paired rounds in turns (AB, BA, AB): the level-3 archive through
     "auto" and "fused", and the LZ4 archive through the host route and
     the card route (device_cache=True, the decoder launching; the host
     route's rounds must launch none), each round timed_read's
     sequential read (MiB/s) and uniform random 4 KiB pread_fulls (seed
     7; 1,000 for zstd, 300 for LZ4: p50, p99);
     the example CLI (libzseek_tpu_torch.example, --zstd and --lz4) on
     the 8 MiB sample in a temporary directory prints SUCCESS, K1 or K5
     launching.

Prints JSON lines for the write path, the read path, the LZ4 path, the
hash path, the lane route, the level >= 4 path, the transcode route, the
sort path, the workers path, the default routes and the kernels, the
card's name and power limit, then as its last line {"ok": true,
"device": {...}}.  Exits non-zero without a result when no CUDA device is
visible or the port is not beside it.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 131072
MIB = 1 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(fn, reps: int = 5) -> float:
    """Mean milliseconds of fn() on the card (CUDA events), after warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def max_abs_err(a, b) -> int:
    """Largest absolute difference over matching tensors (0 = equal)."""
    import torch
    err = 0
    for x, y in zip(a, b):
        x = x.cpu().to(torch.int64)
        y = y.cpu().to(torch.int64)
        check(x.shape == y.shape,
              f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x - y).abs().max()))
    return err


def batch_layout(data, offsets, frame_blocks: int, n: int = N):
    """The codec's host layout for full blocks of n bytes of `data` at
    byte offsets `offsets`, in frames of `frame_blocks` blocks: x2
    (B+1, n), lens, min_abs."""
    import numpy as np
    B = len(offsets)
    x2 = np.zeros((B + 1, n), np.uint8)
    for r, off in enumerate(offsets):
        x2[r + 1] = np.frombuffer(data, np.uint8, n, off)
    i = np.arange(B)
    min_abs = np.where(i % frame_blocks == 0, (i + 1) * n, i * n)
    return x2, np.full(B, n, np.int32), min_abs.astype(np.int32)


# block offsets into the 64 MiB mixed corpus, whose quarters are
# text-like, period-337 repeats, zeros and noise.  Small checks: K1 on two
# 2-block frames (text, repeats); K2 and K3 on 8 rows across all regimes,
# two of them straddling a regime change.  Full checks at the main path's
# batch shape: 64 rows = 8 whole 1 MiB frames of 8 blocks, two frames from
# each quarter.
K1_ROWS = [0, N, 16 * MIB, 16 * MIB + N]
K2_ROWS = [0, 8 * MIB, 16 * MIB, 24 * MIB, 32 * MIB - N // 2, 40 * MIB,
           48 * MIB - N // 2, 56 * MIB]
BATCH_ROWS = [f * 8 * MIB + j * N for f in range(8) for j in range(8)]


def chain_inputs(x2, lens, min_abs, dev):
    """Run the encode chain up to the entropy stage as the codec does.

    Returns x rows, seqs, meta (all plan modes), kmeta (the main path's
    K2 modes: MODE_HUF cleared on the rows K3 takes), codes, ctabs, lens
    and the K3 row mask."""
    import torch
    from libzseek_tpu_torch.ops import entropy as E
    from libzseek_tpu_torch.ops import fse_plan as fpl
    from libzseek_tpu_torch.ops import huffman_plan as hp
    from libzseek_tpu_torch.ops import vector_entropy as VE
    from libzseek_tpu_torch.ops.zstd_encode import zstd_sequences_linked
    t = lambda a: torch.from_numpy(a).to(dev)
    X2 = t(x2)
    lens_t = t(lens)
    seqs = zstd_sequences_linked(X2, lens_t, t(min_abs), level=3)
    _m, mb, codes, _w, _r, sizes4 = hp.plan_blocks(
        seqs["hist"], seqs["lit_count"], seqs["n_seq"], seqs["const"],
        lens_t, mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
        mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ,
        hist_q=seqs["hist_q"])
    sflags, ctabs, _n, _s, _g = fpl.plan_seq_tables(
        seqs["ll"], seqs["ml"], seqs["offv"], seqs["n_seq"])
    mb = mb | torch.where((mb & E.MODE_SEQ) != 0, sflags,
                          torch.zeros_like(sflags))
    vec = ((mb & E.MODE_HUF) != 0) & ((mb & E.MODE_HUF1) == 0) & \
        (seqs["lit_count"] >= VE.VEC_MIN_LC)
    kmode = torch.where(vec, mb & ~E.MODE_HUF, mb)
    head = [lens_t, seqs["lit_count"], seqs["n_seq"]]
    meta = torch.cat([torch.stack(head + [mb], 1), sizes4], 1)
    kmeta = torch.cat([torch.stack(head + [kmode], 1), sizes4], 1)
    return X2[1:], seqs, meta, kmeta, codes, ctabs, lens_t, vec


def against_plain(name, fn, args_gpu):
    """Run fn on the card and on CPU copies of the same inputs (its plain
    version): (max_abs_err, plain ms).  Fails unless the two are equal."""
    import torch
    out_gpu = fn(*args_gpu)
    torch.cuda.synchronize()
    args_cpu = [a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args_gpu]
    plain_ms, out_cpu = time_host(lambda: fn(*args_cpu))
    if isinstance(out_gpu, torch.Tensor):
        out_gpu, out_cpu = [out_gpu], [out_cpu]
    err = max_abs_err(out_gpu, out_cpu)
    check(err == 0, f"{name} differs from its plain version (max err {err})")
    return err, plain_ms


# bound: the larger of the bytes moved over the card's memory rate and
# the 32-bit integer operations over its int32 issue rate.  H100 SXM:
# 3.35 TB/s (data sheet); the data sheet gives no int32 rate, so it is
# 132 SMs x 64 INT32 lanes per clock (Hopper architecture whitepaper)
# x 1.98 GHz boost clock = 16.7 T/s
HBM_BYTES_S = 3.35e12
OPS_S = 132 * 64 * 1.98e9


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    """Bytes of every tensor in ts (nested tuples and lists too)."""
    import torch
    n = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            n += nbytes(*t)
    return n


def k2_work(x, sll, sml, soff, meta, codes, S, lit_cap, seq_cap,
            ctabs=None) -> tuple[int, int]:
    """(bytes, operations) that K2 must move and do on these inputs: each
    output written once (every word is zeroed or written); the meta rows
    and the constant tables once; on a literal row (MODE_HUF or
    MODE_RAWLIT) its lc literal bytes, the ll and ml of its n sequences
    (the run table) and, with MODE_HUF, its 256 codes; on a sequence row
    its n offsets (and ll, ml) and its sequence tables (the predefined
    table once, where every row shares it).  Operations: a literal or a
    sequence each."""
    import numpy as np
    from libzseek_tpu_torch.ops import entropy as E
    B, N = x.shape
    m = meta.cpu().numpy().astype(np.int64)
    lc, n, mode = m[:, 1], m[:, 2], m[:, 3]
    lit = (mode & (E.MODE_HUF | E.MODE_RAWLIT)) != 0
    seq = ((mode & E.MODE_SEQ) != 0) & (n > 0)
    huf = (mode & E.MODE_HUF) != 0
    LMAXA, SMAXA = E.anchor_slots(N, S)
    out = 4 * B * (lit_cap // 4 + seq_cap // 4 + 8 + 4 * LMAXA + 5 * SMAXA)
    tables = 4 * E.CTAB_WIDTH * (int(seq.sum()) if ctabs is not None
                                 else int(seq.any()))
    read = (4 * 8 * B + 4 * len(E.TABS) + int(lc[lit].sum())
            + 4 * 256 * int((lit & huf).sum())
            + 4 * int((n * (2 * (lit | seq) + seq)).sum()) + tables)
    return out + read, int(lc[lit].sum() + n[seq].sum())


def k3_work(x, lit_mask_words, codes, lens, vec_row,
            lit_cap) -> tuple[int, int]:
    """(bytes, operations) that K3 must move and do on these inputs: each
    output written once (the words, sizes and anchors); lens and vec_row;
    on a row K3 takes, its mask words up to its length, its literal bytes
    and its 256 codes (a row it does not take gets its sentinels from
    nothing else).  Operations: a literal each."""
    import numpy as np
    from libzseek_tpu_torch.ops import entropy as E
    B, N = x.shape
    vec = vec_row.cpu().numpy().astype(bool)
    ln = lens.cpu().numpy().astype(np.int64)
    mask = np.ascontiguousarray(lit_mask_words.cpu().numpy())
    bits = np.unpackbits(mask.view(np.uint8), axis=1,
                         bitorder="little")[:, :N]
    bits &= np.arange(N)[None, :] < ln[:, None]
    lits = int(bits[vec].sum())
    LMAXA, _ = E.anchor_slots(N, 1)
    out = 4 * B * (lit_cap // 4 + 4 + 4 * LMAXA)
    read = (5 * B + lits + 4 * int((-(-ln[vec] // 32)).sum())
            + 4 * 256 * int(vec.sum()))
    return out + read, lits


def plan_work(ll, n_seq) -> tuple[int, int]:
    """(bytes, operations) the plans must move and do: the histograms,
    the six per-row scalars and each row's n_seq sequences read once,
    the plan kernel's constant table once, the eleven outputs written
    once; operations: three codes a sequence and the Kraft bisection's
    compares (8 rounds of 24 steps over 256 symbols a row)."""
    B, S = ll.shape
    n = int(n_seq.clamp(0, S).sum())
    out = 4 * B * (1 + 1 + 256 + 32 + 1 + 4 + 1 + 1516 + 118 + 3 + 1)
    read = 4 * (B * (256 + 4 * 256 + 6) + 3 * n + 2694)
    return out + read, 3 * n + B * 256 * 8 * 24


def plan_args(seqs, lens):
    """The plans' inputs as _dispatch_chain passes them: hist, lit_count,
    n_seq, const, lens, hist_q, ll, ml, offv."""
    return ([seqs[k] for k in ("hist", "lit_count", "n_seq", "const")]
            + [lens] + [seqs[k] for k in ("hist_q", "ll", "ml", "offv")])


def plans(kernel, hist, lit_count, n_seq, const, lens, hist_q, ll, ml,
          offv):
    """The eleven plan arrays on the tensors' device: one launch of
    csrc/plan.cu (kernel) or the torch plan_blocks and plan_seq_tables."""
    from libzseek_tpu_torch.ops import entropy as E
    from libzseek_tpu_torch.ops import fse_plan as fpl
    from libzseek_tpu_torch.ops import huffman_plan as hp
    head = (hist, lit_count, n_seq, const, lens)
    kw = dict(mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
              mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ, hist_q=hist_q)
    if kernel:
        lit, seq = hp.plan_all_cuda(*head, **kw, ll=ll, ml=ml, offv=offv)
        return list(lit + seq)
    return list(hp.plan_blocks(*head, **kw)) + list(
        fpl.plan_seq_tables(ll, ml, offv, n_seq))


def by_device(*args):
    """The plans as the chain picks them: the kernel on a CUDA device."""
    return plans(args[0].is_cuda, *args)


def entry(report, name, source, replaces, errs, ms, plain_ms, nb, ops,
          note):
    """One kernel's line of the report: `nb` bytes read and written once,
    `ops` operations, at the timed shape."""
    bms, by = bound(nb, ops)
    print(f"{name}: equal to plain ({note}); card {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms on the CPU, bound {bms:.4f} ms ({by})",
          flush=True)
    report.append(dict(name=name, route="cuda", source=source,
                       replaces=replaces, max_abs_err=max(errs), ms=ms,
                       card_ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=None, note=note))


def phase_kernels(data, report):
    """Phase 2: K1-K3 against their plain versions, on small inputs and at
    the main path's 64-block batch; times at the 64-block batch."""
    import torch
    from libzseek_tpu_torch.ops import entropy as E
    from libzseek_tpu_torch.ops import vector_entropy as VE
    from libzseek_tpu_torch.ops.parse_linked import parse_linked
    from libzseek_tpu_torch.ops.zstd_encode import block_entropy_h16
    cuda = torch.device("cuda")
    S = 8192
    lit_cap = (N + 64 + 127) // 128 * 128
    seq_cap = (9 * S + 64 + 127) // 128 * 128

    # K1: 2 frames x 2 blocks, then 8 frames x 8 blocks
    def k1_args(rows, fb):
        x2, lens, ma = batch_layout(data, rows, fb)
        t = lambda a: torch.from_numpy(a).to(cuda)
        h16, _ = block_entropy_h16(t(x2[1:]), t(lens))
        return t(x2), t(lens), t(ma), h16
    e_small, _ = against_plain("K1 (4 blocks)", parse_linked,
                               k1_args(K1_ROWS, 2))
    big = k1_args(BATCH_ROWS, 8)
    e_big, plain_ms = against_plain("K1 (64 blocks)", parse_linked, big)
    entry(report, "K1 parse_linked", "libzseek_tpu_torch/csrc/parse_linked.cu",
          "libzseek_tpu/ops/pallas_match.py:194", [e_small, e_big],
          time_cuda(lambda: parse_linked(*big)), plain_ms,
          nbytes(big, parse_linked(*big)), big[0][1:].numel(),
          "4 blocks in 2 frames; 64 blocks in 8 chains of 8")

    # K2 and K3: 8 rows in 2-block frames with every plan mode (K3 on all
    # 8 rows); then 64 rows with the main path's modes and K3 rows; K2
    # also at the hash write's first batch (64 literal-heavy text rows on
    # its K2 arm) and at the level-9 write's first batch (64 rows of 64 KiB),
    # K3 also at the level-3 write's first batch (64 text rows), each with
    # the arguments the codec passes
    from libzseek_tpu_torch import ZstdCodec

    def k2(x, ll, ml, offv, meta, codes, ctabs):
        return E.entropy_emit(x, ll, ml, offv, meta, codes, S, lit_cap,
                              seq_cap, ctabs=ctabs)

    def k3(x, mask, codes, lens, vec):
        return VE.vector_literals(x, mask, codes, lens, vec, lit_cap)

    x, seqs, meta, _k, codes, ctabs, lens_t, _v = chain_inputs(
        *batch_layout(data, K2_ROWS, 2), cuda)
    e2_small, _ = against_plain("K2 (8 rows)", k2, (
        x, seqs["ll"], seqs["ml"], seqs["offv"], meta, codes, ctabs))
    modes = meta[:, 3].cpu().tolist()
    e3_small, _ = against_plain("K3 (8 rows)", k3, (
        x, seqs["lit_mask"], codes, lens_t,
        torch.ones(8, dtype=torch.bool, device=cuda)))

    xb, seqsb, _m, kmetab, codesb, ctabsb, lensb, vecb = chain_inputs(
        *batch_layout(data, BATCH_ROWS, 8), cuda)
    k2b = (xb, seqsb["ll"], seqsb["ml"], seqsb["offv"], kmetab, codesb,
           ctabsb)
    e2_big, plain_ms = against_plain("K2 (64 rows)", k2, k2b)
    text = [data[i * MIB: (i + 1) * MIB] for i in range(8)]
    k2h = codec_batch(E, "entropy_emit", ZstdCodec(device="cuda",
                                                   parser="hash"), text)
    e2_hash, hash_plain_ms = against_plain("K2 (hash text batch)",
                                           E.entropy_emit, k2h)
    k2l9 = codec_batch(E, "entropy_emit", ZstdCodec(level=9, device="cuda"),
                       text[:4])
    k2_full = (*k2b[:6], S, lit_cap, seq_cap, k2b[6])
    e2_l9, l9_plain_ms = against_plain("K2 (level-9 text batch)",
                                       E.entropy_emit, k2l9)
    hash_ms = time_cuda(lambda: E.entropy_emit(*k2h))
    l9_ms = time_cuda(lambda: E.entropy_emit(*k2l9))
    entry(report, "K2 entropy_emit", "libzseek_tpu_torch/csrc/entropy.cu",
          "libzseek_tpu/ops/pallas_entropy.py:144",
          [e2_small, e2_big, e2_hash, e2_l9], time_cuda(lambda: k2(*k2b)),
          plain_ms, *k2_work(*k2_full),
          f"8 rows, modes {modes}; 64 rows, main-path modes; the hash "
          f"write's text batch card {hash_ms:.3f} ms (plain "
          f"{hash_plain_ms:.1f}), the level-9 write's text batch card "
          f"{l9_ms:.3f} ms (plain {l9_plain_ms:.1f})")
    report[-1].update(
        cuda_kernels=K2_KERNELS, hash_batch_ms=hash_ms,
        hash_batch_bound_ms=bound(*k2_work(*k2h))[0], level9_batch_ms=l9_ms,
        level9_batch_bound_ms=bound(*k2_work(*k2l9))[0])
    n_vec = int(vecb.sum())
    check(n_vec > 0, "no row of the 64-block batch goes to K3")
    vb = (xb, seqsb["lit_mask"], codesb, lensb, vecb)
    e3_big, plain_ms = against_plain("K3 (64 rows)", k3, vb)
    k3t = codec_batch(VE, "vector_literals", ZstdCodec(device="cuda"), text)
    e3_text, text_plain_ms = against_plain("K3 (level-3 text batch)",
                                           VE.vector_literals, k3t)
    text_ms = time_cuda(lambda: VE.vector_literals(*k3t))
    entry(report, "K3 vector_literals",
          "libzseek_tpu_torch/csrc/place_literals.cu",
          "libzseek_tpu/ops/vector_entropy.py:60",
          [e3_small, e3_big, e3_text], time_cuda(lambda: k3(*vb)), plain_ms,
          *k3_work(*vb, lit_cap),
          f"the fused call; 8 rows; 64 rows, {n_vec} of them K3's on the "
          f"main path; the level-3 write's text batch card {text_ms:.3f} ms "
          f"(plain {text_plain_ms:.1f})")
    report[-1].update(cuda_kernels=K3_KERNELS, text_batch_ms=text_ms,
                      text_batch_bound_ms=bound(*k3_work(*k3t))[0])

    # the plans: csrc/plan.cu on the 8 rows and the 64-row batch, its
    # eleven arrays equal to the torch plans' on the CPU (its plain
    # version) and on the card; timed beside the torch plans on the card
    small = plan_args(seqs, lens_t)
    ep_small, _ = against_plain("plan (8 rows)", by_device, small)
    big = plan_args(seqsb, lensb)
    ep_big, plain_ms = against_plain("plan (64 rows)", by_device, big)
    ep_card = max_abs_err(plans(True, *big), plans(False, *big))
    check(ep_card == 0, "the plan kernel differs from the torch plans on the "
          f"card (max err {ep_card})")
    torch_ms = time_cuda(lambda: plans(False, *big))
    entry(report, "plan zk_plan", "libzseek_tpu_torch/csrc/plan.cu",
          "libzseek_tpu/ops/huffman_plan.py:250, fse_plan.py:157",
          [ep_small, ep_big, ep_card], time_cuda(lambda: plans(True, *big)),
          plain_ms, *plan_work(big[6], big[2]),
          f"eleven arrays; 8 rows; 64 rows, also equal to the torch plans "
          f"on the card, {torch_ms:.3f} ms there")
    report[-1].update(cuda_kernels=PLAN_KERNELS, torch_card_ms=torch_ms)


def by_name(report, name):
    return next(r for r in report if r["name"] == name)


def codec_batch(module, name, codec, frames):
    """The positional arguments of the codec's first call to module.name
    (keywords in the function's order) while it compresses `frames`."""
    from libzseek_tpu_torch.testing.capture import first_call
    return tuple(first_call(module, name, codec, frames).arguments.values())


def k4_against_plain(name, frames, raws):
    """K4 on the card and its plain version on the CPU, same packed rows:
    (max_abs_err, plain ms, card args, out size, rows).  Fails unless the
    two agree, every block is ok and the bytes equal the input."""
    import torch
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    args, n, rows = ZD.k4_inputs(frames, [len(r) for r in raws],
                                 torch.device("cuda"))
    ns = D.seq_total(rows["meta"])
    out, stat = D.decode_blocks(*args, n, n_seqs=ns)
    torch.cuda.synchronize()
    cpu = [a.cpu() for a in args]
    plain_ms, (p_out, p_stat) = time_host(lambda: D.decode_blocks(*cpu, n))
    err = max_abs_err([out, stat], [p_out, p_stat])
    check(err == 0, f"{name} differs from its plain version (max err {err})")
    check(bool((stat[:, 1] == 1).all()), f"{name}: a block failed")
    check(out.cpu().numpy().tobytes() == b"".join(raws),
          f"{name}: bytes differ from the input")
    return err, plain_ms, args, n, rows


# the CUDA kernels behind each wrapper whose kernel this slice redesigned
K2_KERNELS = ["tables_kernel", "emit_kernel", "fixup_kernel"]
K3_KERNELS = ["vec_tables_kernel", "vec_place_kernel", "vec_fixup_kernel"]
K4_KERNELS = ["huf_kernel", "rec_kernel", "frame_kernel", "check_kernel",
              "final_kernel", "expand_kernel", "pd_round_kernel",
              "pd_finish_kernel"]
K4T_KERNELS = ["huf_kernel", "tc_walk_kernel", "tc_chain_kernel"]
K5_KERNELS = ["lz4_emit_kernel"]
K7_KERNELS = ["hash_parse_kernel"]
PLAN_KERNELS = ["plan_kernel"]
K6_KERNELS = ["row_kernel", "frame_kernel", "scatter_kernel",
              "pd_round_kernel", "pd_finish_kernel", "exec_kernel"]


def k4_small_frames():
    """The small frames: the test_decode_smem.py cases (seed 91) by the
    port's codec on the card and by stock libzstd at levels 1, 3, 19,
    and a long-window frame with a match ~400 KiB back: (frames, raws)."""
    import numpy as np
    from libzseek_tpu_torch import ZstdCodec
    from libzseek_tpu_torch.testing import golden
    from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
    rng = np.random.default_rng(91)
    n = 24 * 1024
    cases = [text_corpus(rng, n).tobytes(),
             (rng.integers(0, 256, 337, np.uint8).tobytes()
              * (n // 337 + 1))[:n],
             bytes(n), rng.integers(0, 256, n, np.uint8).tobytes(),
             b"abcabcabcabc", b"x", b""]
    raw = mixed_corpus(rng, 300 * 1024).tobytes()
    raws = cases + [(raw[:150 * 1024] + raw[:100 * 1024]
                     + raw[150 * 1024:])[:300 * 1024]]
    frames = ZstdCodec(device="cuda").compress_frames(raws)
    for level in (1, 3, 19):
        frames += [golden.zstd_compress(v, level=level) for v in cases if v]
        raws += [v for v in cases if v]
    blk = rng.integers(0, 256, 400 * 1024, np.uint8).tobytes()
    raws.append(blk + bytes(16) + blk)
    frames.append(golden.zstd_compress(raws[-1], level=19, strategy=None))
    return frames, raws


def k4_damaged(frames, raws) -> tuple[int, int]:
    """K4 on damaged inputs against its plain version, stat and bytes
    equal: the small frames' rows with one bit of a sequence stream
    flipped (24 copies) and frames with one bit flipped near a compressed
    block's end (24, those the host parse accepts).  Fails unless some
    row fails mid-block.  Returns (max_abs_err, copies compared)."""
    import numpy as np
    import torch
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    from libzseek_tpu_torch.testing.damage import damaged_frames, damaged_rows
    cpu, cuda = torch.device("cpu"), torch.device("cuda")

    def both(args, n, ns):
        got = D.decode_blocks(*[a.to(cuda) for a in args], n, n_seqs=ns)
        ref = D.decode_blocks(*args, n)
        return max_abs_err(got, ref), ref[1].numpy()

    args, n, rows = ZD.k4_inputs(frames, [len(r) for r in raws], cpu)
    ns = D.seq_total(rows["meta"])
    err, mid, count = 0, 0, 0
    for a in damaged_rows(args, 11, 24):
        e, st = both(a, n, ns)
        bad = np.nonzero(st[:, 1] == 0)[0]
        mid += bool(len(bad)) and st[bad[0], 0] > 0
        err, count = max(err, e), count + 1
    for i, fr in damaged_frames(frames, 13, 24):
        try:
            a, m, r2 = ZD.k4_inputs([fr], [len(raws[i])], cpu)
        except Exception:
            continue    # the host parse rejects it: no kernel runs
        e, _ = both(a, m, D.seq_total(r2["meta"]))
        err, count = max(err, e), count + 1
    check(err == 0, f"K4 on damaged rows differs from plain (max err {err})")
    check(mid > 0, "no damaged row failed mid-block")
    return err, count


def k4_small():
    """K4 on the small frames, then on damaged copies of them."""
    frames, raws = k4_small_frames()
    err, _, _, _, rows = k4_against_plain("K4 (small frames)", frames, raws)
    e_dmg, n_dmg = k4_damaged(frames, raws)
    return max(err, e_dmg), (f"{len(frames)} small frames, "
                             f"{len(rows['meta'])} blocks; {n_dmg} damaged "
                             f"copies")


def k4_ops(rows, out_size: int) -> int:
    """32-bit operations K4 does at least: one per byte written, one per
    Huffman symbol, ten per sequence (three table reads, three state
    updates, three extra-bit reads, the repcode)."""
    from libzseek_tpu_torch.ops import decode as D
    meta = rows["meta"]
    huf = (meta[:, 0] & (D.DMODE_HUF4 | D.DMODE_HUF1)) != 0
    return out_size + int(meta[huf, 3].sum()) + 10 * int(meta[:, 13].sum())


def k4_full(report, archive, table, data, err_small, note_small):
    """K4 on the first 8 frames of the phase-3 archive (64 blocks): equal
    to the input and to the plain version, whose time is kept; card times
    at 32 blocks (the reader's window) and 64 blocks."""
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.ops.zstd_decode import k4_inputs
    frames = [frame_bytes(archive, table, i) for i in range(8)]
    raws = [data[i * MIB: (i + 1) * MIB] for i in range(8)]
    err_big, plain_ms, args, n, rows = k4_against_plain("K4 (64 blocks)",
                                                        frames, raws)
    args32, n32, rows32 = k4_inputs(frames[:4], [MIB] * 4, args[0].device)
    s32, s64 = D.seq_total(rows32["meta"]), D.seq_total(rows["meta"])
    ms32 = time_cuda(lambda: D.decode_blocks(*args32, n32, n_seqs=s32))
    ms = time_cuda(lambda: D.decode_blocks(*args, n, n_seqs=s64))
    tables = sum(nbytes(a) for a in args[2:])   # dtabs, ftabs, meta, chain
    nb = rows["payload_bytes"] + tables + n + 16 * len(rows["meta"])
    print(f"K4 at 32 blocks: {ms32:.3f} ms", flush=True)
    entry(report, "K4 decode", "libzseek_tpu_torch/csrc/decode.cu",
          "libzseek_tpu/ops/pallas_decode.py:94", [err_small, err_big],
          ms, plain_ms, nb, k4_ops(rows, n),
          f"{note_small}; 64 blocks (8 archive frames) equal to the input "
          f"and to plain; card {ms32:.3f} ms at 32 blocks")
    report[-1]["ms_32_blocks"] = ms32
    report[-1]["cuda_kernels"] = K4_KERNELS


def read_all(r) -> bytes:
    parts = []
    while True:
        b = r.read(MIB)
        if not b:
            return b"".join(parts)
        parts.append(b)


def timed_read(archive: bytes, data: bytes, n_preads: int = 1000,
               counted=None, **kw) -> dict:
    """The read phases' timing: a fresh Reader(device="cuda", **kw) reads
    the archive sequentially in 1 MiB reads (MiB/s, host clock to a
    synchronize; the counters of `counted`, {name: (module, attribute)},
    set to 0 just before that pass and read just after), then a fresh one
    makes n_preads uniform random 4 KiB pread_fulls (seed 7): p50 and p99
    in microseconds and the cache hits; every byte equal to the input."""
    import numpy as np
    import torch
    from libzseek_tpu_torch import Reader
    counted = counted or {}
    r = Reader(archive, device="cuda", **kw)
    for mod, attr in counted.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    got = read_all(r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: getattr(mod, attr) for k, (mod, attr) in counted.items()}
    r.close()
    check(got == data, f"the sequential read ({kw}) differs from the input")
    offs = np.random.default_rng(7).integers(0, len(data) - 4096, n_preads)
    lat = []
    with Reader(archive, device="cuda", **kw) as r:
        for off in offs.tolist():
            t = time.perf_counter()
            b = r.pread_full(4096, off)
            lat.append((time.perf_counter() - t) * 1e6)
            check(b == data[off: off + 4096], f"{kw} pread at {off} differs")
        hits = r.stats().cache_hits
    return {"read_mib_s": len(data) / MIB / dt, "seconds": dt,
            "pread_p50_us": float(np.percentile(lat, 50)),
            "pread_p99_us": float(np.percentile(lat, 99)),
            "cache_hits": hits, "counts": counts}


def phase_read(archive: bytes, data: bytes, card: str, D=None,
               name: str = "K4", decoder: str = "fused",
               counted=None, attr: str = "launches",
               device_cache: bool = False) -> dict:
    """Phase 5 (and the LZ4, lane and transcode routes' reads): the read
    path through the port's Reader on the card, after a warm-up read,
    timed by timed_read; `D` is the decoder's module, whose launch count
    `attr` the measured sequential pass must raise, and `counted` maps
    more names to (module, counter attribute) to count in that pass.
    device_cache keeps the frames of both passes on the card (the LZ4
    decoder serves only device-resident frames); 16 preads through a
    device-cache reader must leave CUDA tensors in its cache."""
    import numpy as np
    import torch
    from libzseek_tpu_torch import Reader
    if D is None:
        from libzseek_tpu_torch.ops import decode as D
    counted = dict(counted or {}, **{name: (D, attr)})
    kw = dict(decoder=decoder, device_cache=device_cache)
    with Reader(archive, device="cuda", **kw) as r:  # warm-up
        check(read_all(r) == data, "warm-up read differs from the input")
    t = timed_read(archive, data, counted=counted, **kw)
    counts = t["counts"]
    launches = counts[name]
    check(launches > 0, f"{name} never launched on the read path")
    rd = Reader(archive, device="cuda", device_cache=True, decoder=decoder)
    offs = np.random.default_rng(7).integers(0, len(data) - 4096, 16)
    for off in offs.tolist():
        check(rd.pread_full(4096, off) == data[off: off + 4096],
              f"device-cache pread at {off} differs")
    cached = list(rd._cache._map.values())
    check(cached and all(isinstance(c, torch.Tensor) and c.is_cuda
                         for c in cached),
          "device_cache frames are not CUDA tensors")
    rd.close()
    where = ", device_cache" if device_cache else ""
    print(f"read path ({decoder}{where}): 64 MiB sequential in "
          f"{t['seconds']:.3f} s = {t['read_mib_s']:.2f} MiB/s (launches "
          f"{counts}); 1000 random 4 KiB preads p50 {t['pread_p50_us']:.1f} "
          f"us, p99 {t['pread_p99_us']:.1f} us ({t['cache_hits']} cache "
          f"hits); 16 device-cache preads equal, {len(cached)} frames on the "
          f"card", flush=True)
    return {"card": card, "read_mib_s": t["read_mib_s"],
            "pread_p50_us": t["pread_p50_us"],
            "pread_p99_us": t["pread_p99_us"], "launches": launches,
            "counts": counts}


class Sink:
    def __init__(self):
        self.parts = []

    def write(self, b):
        self.parts.append(bytes(b))

    def value(self) -> bytes:
        return b"".join(self.parts)


def write_archive(data: bytes, device: str, codec="zstd",
                  level: int = 3) -> tuple[bytes, float]:
    """`data` through Writer(sink, codec) (a name at `level`, or a codec
    object), 1 MiB frames and writes, batch_frames=16: (archive,
    seconds)."""
    import torch
    from libzseek_tpu_torch import Writer
    sink = Sink()
    w = Writer(sink, codec, level=level, device=device, min_frame_size=MIB,
               batch_frames=16)
    t0 = time.perf_counter()
    for pos in range(0, len(data), MIB):
        w.write(data[pos: pos + MIB])
    w.close()
    if device == "cuda":
        torch.cuda.synchronize()
    return sink.value(), time.perf_counter() - t0


def frame_bytes(archive: bytes, table, i: int) -> bytes:
    off = table.frame_c_offset(i)
    return archive[off: off + table.frame_c_size(i)]


def random_reads(archive: bytes, table, data: bytes) -> None:
    """16 random 4 KiB reads (seed 7), each through stock libzstd on the
    frames that cover it, must equal the input."""
    import numpy as np
    from libzseek_tpu_torch.testing import golden
    rng = np.random.default_rng(7)
    for off in rng.integers(0, len(data) - 4096, 16).tolist():
        got = b""
        pos = off
        while len(got) < 4096:
            i = table.frame_for_offset(pos)
            d0 = table.frame_d_offset(i)
            frame = golden.zstd_frame_decompress(
                frame_bytes(archive, table, i), table.frame_d_size(i))
            got += frame[pos - d0: pos - d0 + 4096 - len(got)]
            pos = off + len(got)
        check(got == data[off: off + 4096], f"random read at {off} differs")


# ---------------------------------------------------------------------------
# phase 6: the LZ4 path

LZ4_BLOCK = 1 << 16
# K5 at the path's batch: 128 rows = 8 whole 1 MiB frames of 16 blocks,
# two frames from each quarter of the corpus
LZ4_FRAMES = [f * 8 * MIB for f in range(8)]


def k5_layout(data, offsets, frame_blocks):
    """The LZ4 codec's host layout for full 64 KiB blocks of `data` at
    `offsets`, in frames of `frame_blocks` blocks: (D, lens, min_ref)."""
    import numpy as np
    B = len(offsets)
    D = np.zeros((B + 1, LZ4_BLOCK), np.uint8)
    for r, off in enumerate(offsets):
        D[r + 1] = np.frombuffer(data, np.uint8, LZ4_BLOCK, off)
    i = np.arange(B)
    min_ref = np.where(i % frame_blocks == 0, (i + 1) * LZ4_BLOCK,
                       i * LZ4_BLOCK).astype(np.int32)
    return D, np.full(B, 2 * LZ4_BLOCK, np.int32), min_ref


def k5_small_cases(data):
    """(D, lens, min_ref, level): three linked 4 KiB rows with
    cross-block matches; a seeded batch (row 0 is the previous block of
    its first row's frame, min_ref 0) with a short block; four 64 KiB
    rows, one per quarter, at each level arm."""
    import numpy as np
    BK = 4096
    D = np.zeros((4, BK), np.uint8)
    for r in range(3):
        D[r + 1] = np.frombuffer(data, np.uint8, BK, r * BK)
    D[2, 100:400] = D[1, 50:350]
    cases = [(D, np.full(3, 2 * BK, np.int32),
              np.array([BK, BK, 2 * BK], np.int32), 0)]
    Ds = np.zeros((4, LZ4_BLOCK), np.uint8)
    Ds[0] = np.frombuffer(data, np.uint8, LZ4_BLOCK, 0)
    Ds[1, :LZ4_BLOCK - 7] = Ds[0, 7:]
    Ds[2] = np.frombuffer(data, np.uint8, LZ4_BLOCK, 16 * MIB)
    cases.append((Ds, np.array([2 * LZ4_BLOCK - 7, 2 * LZ4_BLOCK,
                                2 * LZ4_BLOCK], np.int32),
                  np.array([0, 2 * LZ4_BLOCK, 2 * LZ4_BLOCK], np.int32), 0))
    Dm, lens, mr = k5_layout(data, [q * 16 * MIB for q in range(4)], 2)
    for level in (-1, 0, 3, 9):
        cases.append((Dm, lens, mr, level))
    return cases


def lz4_small_frames():
    """(frames, raws, independent): frames of the port's LZ4 codec on the
    card and of stock liblz4, linked and independent, over text, every
    mixed regime, noise (stored raw) and a tiny frame."""
    import numpy as np
    from libzseek_tpu_torch import LZ4Codec
    from libzseek_tpu_torch.testing import golden
    from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
    rng = np.random.default_rng(5)
    raws = [text_corpus(rng, 2 * LZ4_BLOCK + 5000).tobytes(),
            mixed_corpus(rng, 4 * LZ4_BLOCK).tobytes(),
            rng.integers(0, 256, LZ4_BLOCK + 99, np.uint8).tobytes(),
            b"abcabcabcabc"]
    out = []
    for independent in (False, True):
        frames = LZ4Codec(device="cuda", block_independent=independent) \
            .compress_frames(raws)
        frames += [golden.lz4f_compress(r, block_independent=independent)
                   for r in raws]
        out.append((frames, raws + raws, independent))
    return out


def lz4_rows(frames, damaged: int = 0, seed: int = 5):
    """The codec's padded decoder inputs for `frames` (comp, clens, unc
    as tensors, F, linked), plus `damaged` copies of the first frame with
    random bytes of its second block changed."""
    import numpy as np
    import torch
    from libzseek_tpu_torch.format import lz4f
    parsed = []
    for f in frames:
        info = lz4f.parse_frame_header(f)
        parsed.append((info, lz4f.parse_blocks(f, info, info.header_size)[0]))
    K = max(max(1, len(b)) for _, b in parsed)
    K = 1 << (K - 1).bit_length()
    M = max(max((x.size for x in b), default=1) for _, b in parsed)
    M = (M + 4095) // 4096 * 4096
    n = len(frames) + damaged
    comp = np.zeros((n, K, M), np.uint8)
    clens = np.zeros((n, K), np.int32)
    unc = np.zeros((n, K), bool)
    for r, (f, (_, blocks)) in enumerate(zip(frames, parsed)):
        for k, b in enumerate(blocks):
            comp[r, k, : b.size] = np.frombuffer(f, np.uint8, b.size,
                                                 b.offset)
            clens[r, k] = b.size
            unc[r, k] = b.uncompressed
    rng = np.random.default_rng(seed)
    for j in range(damaged):
        r = len(frames) + j
        comp[r], clens[r], unc[r] = comp[0], clens[0], unc[0]
        for p in rng.integers(0, int(clens[r, 1]), 1 + j % 3).tolist():
            comp[r, 1, p] = int(rng.integers(0, 256))
    sizes = [(int(info.content_size or 0)) for info, _ in parsed]
    F = (max(sizes + [1]) + LZ4_BLOCK - 1) // LZ4_BLOCK * LZ4_BLOCK
    t = torch.from_numpy
    return (t(comp), t(clens), t(unc)), F, \
        not parsed[0][0].block_independent


def lz4_seq_block(seqs, tail=b""):
    """A raw LZ4 block from (literals, offset, match length) sequences and
    the last literals."""
    def ext(n):
        n -= 15
        return bytes([255] * (n // 255) + [n % 255])
    out = bytearray()
    for lit, off, ml in seqs:
        out.append(min(len(lit), 15) << 4 | min(ml - 4, 15))
        out += (ext(len(lit)) if len(lit) >= 15 else b"") + lit
        out += off.to_bytes(2, "little")
        out += ext(ml - 4) if ml - 4 >= 15 else b""
    out.append(min(len(tail), 15) << 4)
    return bytes(out + (ext(len(tail)) if len(tail) >= 15 else b"") + tail)


def lz4_crafted_rows():
    """Decoder inputs (comp, clens, unc tensors) of hand-written frames:
    a frame of a block whose copies overlap themselves (offsets 1, 2, 7,
    31, 40), reach 500 back, take literal and match lengths with
    extension bytes, and a block copying 100 bytes back into it, then an
    uncompressed block; a frame of the same first block and a block
    that stays inside itself; then the bad cases: a match before the
    frame, one past its block's start, offset 0, a truncated block, 10
    sequences (bad under a budget of 7).  F = 12 KiB."""
    import numpy as np
    import torch
    b0 = lz4_seq_block([(b"ab", 2, 61), (b"XYZ", 1, 300),
                        (bytes(range(40)), 40, 200), (b"", 500, 20),
                        (b"q" * 300, 7, 100), (b"k", 31, 64)], b"END0")
    frames = [
        [(b0, False), (lz4_seq_block([(b"hello world", 6, 40)], b"t"),
                       False)],
        [(b0, False), (lz4_seq_block([(b"", 100, 150)], b"E1"), False),
         (b"RAW" * 50, True)],
        [(lz4_seq_block([(b"ab", 10, 8)], b"t"), False)],
        [(b0, False), (lz4_seq_block([(b"", 50, 9)]), False)],
        [(lz4_seq_block([(b"a", 0, 5)], b"t"), False)],
        [(b0[:-3], False), (b0, False)],
        [(lz4_seq_block([(b"ab", 2, 6)] * 10, b"!"), False), (b0, False)],
    ]
    comp = np.zeros((len(frames), 3, 4096), np.uint8)
    clens = np.zeros((len(frames), 3), np.int32)
    unc = np.zeros((len(frames), 3), bool)
    for r, f in enumerate(frames):
        for k, (blk, u) in enumerate(f):
            comp[r, k, : len(blk)] = np.frombuffer(blk, np.uint8)
            clens[r, k], unc[r, k] = len(blk), u
    return [torch.from_numpy(a) for a in (comp, clens, unc)]


def decoder_against_plain(name, args, F, linked, n_valid, max_seqs=None):
    """The LZ4 decoder on the card and its plain version on the CPU, same
    rows: equal ok and out_lens everywhere, equal out where ok; the first
    n_valid frames must be ok.  Returns (max_abs_err, plain ms)."""
    import torch
    from libzseek_tpu_torch.ops.lz4_decode import lz4_decode_frames
    cuda = torch.device("cuda")
    got = lz4_decode_frames(*[a.to(cuda) for a in args], F,
                            max_seqs=max_seqs, linked=linked)
    torch.cuda.synchronize()
    plain_ms, ref = time_host(lambda: lz4_decode_frames(
        *args, F, max_seqs=max_seqs, linked=linked))
    ok = ref[2]
    err = max_abs_err([got[1], got[2], got[0][ok.to(cuda)]],
                      [ref[1], ref[2], ref[0][ok]])
    check(err == 0, f"{name} differs from its plain version (max err {err})")
    check(bool(ok[:n_valid].all()), f"{name}: a valid frame failed")
    return err, plain_ms, got


def phase_lz4(data, card, report, keep: dict) -> dict:
    """Phase 6: K5 and the LZ4 decoder against their plain versions, then
    the LZ4 write and read paths (the archive goes to `keep` for phase
    13)."""
    import torch
    from libzseek_tpu_torch import LZ4Codec
    from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
    from libzseek_tpu_torch.ops import lz4_decode, lz4_emit
    from libzseek_tpu_torch.testing import golden
    cuda = torch.device("cuda")
    t = lambda a: torch.from_numpy(a)

    # K5: small cases, then the path's 128-row batch
    errs = []
    for D, lens, mr, level in k5_small_cases(data):
        kw = LZ4Codec._level_params(level)
        cap = lz4_emit.out_cap(D.shape[1])
        e, _ = against_plain(f"K5 (level {level}, {len(lens)} rows)",
                             lambda *a: lz4_emit.lz4_emit(*a, cap, **kw),
                             [t(D).to(cuda), t(lens).to(cuda),
                              t(mr).to(cuda)])
        errs.append(e)
    offs = [f + j * LZ4_BLOCK for f in LZ4_FRAMES for j in range(16)]
    D, lens, mr = k5_layout(data, offs, 16)
    cap = lz4_emit.out_cap()
    big = [t(D).to(cuda), t(lens).to(cuda), t(mr).to(cuda)]
    k5 = lambda *a: lz4_emit.lz4_emit(*a, cap)
    e_big, plain_ms = against_plain("K5 (128 rows)", k5, big)
    out, olen = k5(*big)
    nb = nbytes(big) + int(olen.sum()) + olen.numel() * 4
    entry(report, "K5 lz4_emit", "libzseek_tpu_torch/csrc/lz4_emit.cu",
          "libzseek_tpu/ops/pallas_lz4.py:41", errs + [e_big],
          time_cuda(lambda: k5(*big)), plain_ms, nb, big[0][1:].numel(),
          "linked 4 KiB rows, a seeded batch, levels -1/0/3/9 on 4 rows; "
          "128 rows in 8 chains of 16 (level 0)")
    report[-1]["cuda_kernels"] = K5_KERNELS

    # the decoder: hand-written frames, small frames and damaged copies
    derrs = []
    crafted = lz4_crafted_rows()
    for linked in (True, False):
        for max_seqs in (None, 7):
            e, _, _ = decoder_against_plain(
                f"LZ4 decoder (hand-written, linked {linked}, budget "
                f"{max_seqs})", crafted, 3 * 4096, linked,
                2 if linked else 1, max_seqs)
            derrs.append(e)
    for frames, raws, independent in lz4_small_frames():
        args, F, linked = lz4_rows(frames, damaged=12)
        e, _, got = decoder_against_plain(
            f"LZ4 decoder ({'independent' if independent else 'linked'})",
            args, F, linked, len(frames))
        out_h = got[0].cpu().numpy()
        for r, raw in enumerate(raws):
            check(out_h[r, : len(raw)].tobytes() == raw,
                  "LZ4 decoder: bytes differ from the input")
        derrs.append(e)

    # the write path
    write_archive(data, "cuda", "lz4", 0)            # warm-up
    lz4_emit.launches = 0
    archive, dt = write_archive(data, "cuda", "lz4", 0)
    k5_launches = lz4_emit.launches
    check(k5_launches > 0, "K5 never launched on the LZ4 write path")
    report[-1]["launches"] = k5_launches
    ratio = len(archive) / len(data)
    print(f"LZ4 write path: 64 MiB in {dt:.3f} s = {64 / dt:.2f} MiB/s, "
          f"ratio {ratio:.5f} ({len(archive)} bytes); K5 launches "
          f"{k5_launches}", flush=True)
    check(golden.lz4f_decompress(archive) == data,
          "stock liblz4 does not reproduce the input")
    print(f"LZ4 archive sha256 {hashlib.sha256(archive).hexdigest()}",
          flush=True)
    keep["lz4_archive"] = archive
    table = parse_seek_table_bytes(archive)
    check(table.num_frames == 64, f"seek table has {table.num_frames} frames")
    cpu_archive, cpu_dt = write_archive(data[:MIB], "cpu", "lz4", 0)
    cpu_table = parse_seek_table_bytes(cpu_archive)
    check(frame_bytes(cpu_archive, cpu_table, 0) ==
          frame_bytes(archive, table, 0),
          "first LZ4 frame differs between the card and the plain versions")
    hc, hc_dt = write_archive(data[:8 * MIB], "cuda", "lz4", 9)
    check(golden.lz4f_decompress(hc) == data[:8 * MIB],
          "stock liblz4 does not reproduce the level-9 archive")
    print(f"LZ4 archive: liblz4 decode equal, 64 frames; first frame equal "
          f"to plain (CPU, {cpu_dt:.1f} s); level 9, 8 MiB: ratio "
          f"{len(hc) / (8 * MIB):.5f}, liblz4 decode equal", flush=True)

    # the decoder on archive frames: one frame of each quarter alone (the
    # device-cache read decodes one frame a call; timed, the mean over the
    # quarters), then the four together (a 4-frame window)
    frames = [frame_bytes(archive, table, i) for i in range(64)]
    timed = {}
    for win in [[frames[16 * q]] for q in range(4)] + \
            [[frames[16 * q] for q in range(4)]]:
        args, F, linked = lz4_rows(win)
        n = len(win)
        e, p_ms, got = decoder_against_plain(
            f"LZ4 decoder ({n} archive frame{'s' if n > 1 else ''})",
            args, F, linked, n)
        derrs.append(e)
        q0 = [16 * q for q in range(4)] if n > 1 else [frames.index(win[0])]
        check(all(got[0][r, :MIB].cpu().numpy().tobytes() ==
                  data[i * MIB: (i + 1) * MIB] for r, i in enumerate(q0)),
              "LZ4 decoder: archive frames differ from the input")
        dargs = [a.to(cuda) for a in args]
        ms = time_cuda(lambda: lz4_decode.lz4_decode_frames(
            *dargs, F, linked=linked))
        timed.setdefault(n, []).append(
            (ms, p_ms, sum(len(f) for f in win) + n * MIB, n * MIB))
    mean = lambda rows, k: sum(r[k] for r in rows) / len(rows)
    one, four = timed[1], timed[4][0]
    entry(report, "LZ4 decode", "libzseek_tpu_torch/csrc/lz4_decode.cu",
          "libzseek_tpu/ops/lz4_decode.py:110 (XLA lz4_decode_frames)",
          derrs, mean(one, 0), mean(one, 1), round(mean(one, 2)), MIB,
          "hand-written frames (self-overlapping, cross-block and bad "
          "copies); linked and independent frames of the codec and of "
          "liblz4 with 12 damaged copies each; one archive frame of each "
          "quarter (the device-cache read's calls; times the mean of the "
          "four) and the four together")
    bms4, _ = bound(four[2], four[3])
    report[-1].update(window4_ms=four[0], window4_plain_ms=four[1],
                      window4_bound_ms=bms4)
    print(f"LZ4 decoder, 4 archive frames together: card {four[0]:.3f} ms, "
          f"plain {four[1]:.1f} ms on the CPU, bound {bms4:.4f} ms; one "
          f"frame: card " + ", ".join(f"{r[0]:.3f}" for r in one) + " ms",
          flush=True)

    # the read path: frames kept on the card go through the decoder
    read = phase_read(archive, data, card, lz4_decode, "LZ4 decoder",
                      decoder="auto", device_cache=True)
    report[-1]["launches"] = read["launches"]

    # the two decode routes over the 64 frames, 4-frame windows: the
    # card's decoder with each window copied to the host at once, and the
    # native host route that host delivery takes
    codec = LZ4Codec(device="cuda")
    sizes = [MIB] * 64
    routes = {}
    card_route = lambda d, s: [torch.cat(codec.decompress_frames(
        d, s, to_device=True)).cpu().numpy().tobytes()]
    for name, fn in (("card", card_route),
                     ("host", codec.decompress_frames)):
        fn(frames[:4], sizes[:4])                        # warm-up
        t0 = time.perf_counter()
        got = []
        for i in range(0, 64, 4):
            got += fn(frames[i: i + 4], sizes[i: i + 4])
        torch.cuda.synchronize()
        routes[name] = 64 / (time.perf_counter() - t0)
        check(b"".join(got) == data, f"{name} route differs from the input")
    print(f"LZ4 decode routes, 64 frames in 4-frame windows: card "
          f"{routes['card']:.2f} MiB/s, host (native) {routes['host']:.2f} "
          f"MiB/s", flush=True)
    return {"card": card, "write_mib_s": 64 / dt, "ratio": ratio,
            "sha256": hashlib.sha256(archive).hexdigest(),
            "read_mib_s": read["read_mib_s"],
            "pread_p50_us": read["pread_p50_us"],
            "pread_p99_us": read["pread_p99_us"],
            "card_route_mib_s": routes["card"],
            "host_route_mib_s": routes["host"],
            "k5_launches": k5_launches,
            "decoder_launches": read["launches"]}


# ---------------------------------------------------------------------------
# phase 7: the per-block hash-parser path

# K7's small check: one 16 KiB row from each quarter of the corpus
K7_ROWS = [q * 16 * MIB for q in range(4)]


def hash_rows(data, offsets, n=N):
    """(x (B, n) uint8, lens) rows of `data` at `offsets`, as the hash
    path lays them out (no context row)."""
    import numpy as np
    x = np.stack([np.frombuffer(data, np.uint8, n, off) for off in offsets])
    return x, np.full(len(offsets), n, np.int32)


def hash_write(data: bytes, device: str):
    """`data` through Writer(sink, ZstdCodec(parser="hash")), 1 MiB frames
    and writes, batch_frames=16: (archive, seconds, codec), the codec's
    two entropy arms counted per batch in codec.arms."""
    import torch
    from libzseek_tpu_torch import Writer, ZstdCodec
    codec = ZstdCodec(device=device, parser="hash")
    codec.arms = {"smem": 0, "xla": 0}
    for arm in codec.arms:
        def counted(*a, _arm=arm, _fn=getattr(codec, f"_entropy_{arm}")):
            codec.arms[_arm] += 1
            return _fn(*a)
        setattr(codec, f"_entropy_{arm}", counted)
    sink = Sink()
    w = Writer(sink, codec, min_frame_size=MIB, batch_frames=16)
    t0 = time.perf_counter()
    for pos in range(0, len(data), MIB):
        w.write(data[pos: pos + MIB])
    w.close()
    if device == "cuda":
        torch.cuda.synchronize()
    return sink.value(), time.perf_counter() - t0, codec


def phase_hash(data, card, report, keep: dict) -> dict:
    """Phase 7: K7 against its plain version, then the hash-parser write
    of the 64 MiB corpus and of 8 MiB of log-like lines (kept in `keep`
    for phase 8, with the input)."""
    import numpy as np
    import torch
    from libzseek_tpu_torch import Reader
    from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
    from libzseek_tpu_torch.ops import entropy, hash_parse
    from libzseek_tpu_torch.testing import golden
    from libzseek_tpu_torch.testing.corpus import log_corpus
    cuda = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(cuda)

    small = [t(a) for a in hash_rows(data, K7_ROWS, 16384)]
    e_small, _ = against_plain("K7 (4 rows)", hash_parse.hash_parse, small)
    big = [t(a) for a in hash_rows(data, BATCH_ROWS)]
    e_big, plain_ms = against_plain("K7 (64 rows)", hash_parse.hash_parse,
                                    big)
    # the hash write's first batch: 64 rows of the text quarter
    text = [t(a) for a in hash_rows(data, [j * N for j in range(64)])]
    e_text, text_plain_ms = against_plain("K7 (64 text rows)",
                                          hash_parse.hash_parse, text)
    text_ms = time_cuda(lambda: hash_parse.hash_parse(*text))
    n_seq = hash_parse.hash_parse(*big)[3]
    # bytes: each row's bytes and length read, its n_seq sequences (three
    # int32 each), n_seq and cover_end written; operations: at least one
    # per input byte (the walk hashes or compares every byte)
    nb = int(big[1].sum()) + nbytes(big[1]) + 12 * int(n_seq.sum()) + \
        8 * len(BATCH_ROWS)
    entry(report, "K7 hash_parse", "libzseek_tpu_torch/csrc/hash_parse.cu",
          "libzseek_tpu/ops/pallas_match.py:37", [e_small, e_big, e_text],
          time_cuda(lambda: hash_parse.hash_parse(*big)), plain_ms, nb,
          int(big[1].sum()),
          f"4 rows of 16 KiB, one per quarter; 64 rows of 128 KiB (8 "
          f"frames x 8 blocks, two per quarter), {int(n_seq.sum())} "
          f"sequences; 64 text rows (the write's first batch) card "
          f"{text_ms:.3f} ms, plain {text_plain_ms:.1f} ms")
    k7 = report[-1]
    k7["cuda_kernels"] = K7_KERNELS
    k7["text_batch_ms"] = text_ms

    # the 64 MiB write
    hash_write(data, "cuda")                        # warm-up
    hash_parse.launches = entropy.launches = 0
    archive, dt, codec = hash_write(data, "cuda")
    k7["launches"] = hash_parse.launches
    k2_launches = entropy.launches
    by_name(report, "K2 entropy_emit")["launches_hash"] = k2_launches
    check(hash_parse.launches > 0, "K7 never launched on the hash write")
    check(k2_launches > 0, "K2 never launched on the hash write")
    check(codec.arms["xla"] == 0, "a batch of the corpus took the XLA arm")
    ratio = len(archive) / len(data)
    print(f"hash write path: 64 MiB in {dt:.3f} s = {64 / dt:.2f} MiB/s, "
          f"ratio {ratio:.5f} ({len(archive)} bytes); K7 launches "
          f"{k7['launches']}, K2 launches {k2_launches}, arms "
          f"{codec.arms}", flush=True)
    check(golden.zstd_decompress(archive) == data,
          "stock libzstd does not reproduce the hash archive")
    print(f"hash archive sha256 {hashlib.sha256(archive).hexdigest()}",
          flush=True)
    table = parse_seek_table_bytes(archive)
    check(table.num_frames == 64, f"seek table has {table.num_frames} frames")
    cpu_archive, cpu_dt, _ = hash_write(data[:MIB], "cpu")
    check(frame_bytes(cpu_archive, parse_seek_table_bytes(cpu_archive), 0)
          == frame_bytes(archive, table, 0),
          "first hash frame differs between the card and the plain versions")
    t0 = time.perf_counter()
    with Reader(archive, device="cuda") as r:
        got = read_all(r)
    read_s = time.perf_counter() - t0
    check(got == data, "the Reader's read of the hash archive differs")
    print(f"hash archive: libzstd decode equal, 64 frames, first frame equal "
          f"to plain (CPU, {cpu_dt:.1f} s), sequential Reader read equal "
          f"({64 / read_s:.2f} MiB/s)", flush=True)

    # 8 MiB of log-like lines: every batch keeps > 4096 sequences a block
    logs = log_corpus(np.random.default_rng(13), 8 * MIB).tobytes()
    hash_write(logs[:2 * MIB], "cuda")               # warm-up
    log_archive, log_dt, log_codec = hash_write(logs, "cuda")
    check(log_codec.arms["xla"] > 0 and log_codec.arms["smem"] == 0,
          f"the log-like write took arms {log_codec.arms}")
    check(golden.zstd_decompress(log_archive) == logs,
          "stock libzstd does not reproduce the log-like archive")
    keep.update(log_archive=log_archive, logs=logs)
    log_ratio = len(log_archive) / len(logs)
    print(f"hash write, log-like 8 MiB: {log_dt:.3f} s = {8 / log_dt:.2f} "
          f"MiB/s, ratio {log_ratio:.5f}, arms {log_codec.arms}; libzstd "
          f"decode equal", flush=True)
    return {"card": card, "write_mib_s": 64 / dt, "ratio": ratio,
            "read_mib_s": 64 / read_s, "k7_launches": k7["launches"],
            "k2_launches": k2_launches, "arms": codec.arms,
            "log_write_mib_s": 8 / log_dt, "log_ratio": log_ratio,
            "log_arms": log_codec.arms}


# ---------------------------------------------------------------------------
# phase 8: the lane decode route

LANE_KERNELS = (("huf_lanes", "Huffman lanes", "huf_launches",
                 "libzseek_tpu_torch/csrc/huf_lanes.cu",
                 "libzseek_tpu/ops/zstd_decode.py:401,578 (XLA "
                 "huf_decode_lanes, huf_decode_anchored)"),
                ("seq_lanes", "sequence lanes", "seq_launches",
                 "libzseek_tpu_torch/csrc/fse_lanes.cu",
                 "libzseek_tpu/ops/zstd_decode.py:443,620 (XLA "
                 "fse_decode_seq_lanes, fse_decode_anchored)"),
                ("execute_blocks", "K6 exec_blocks", "launches",
                 "libzseek_tpu_torch/csrc/exec_blocks.cu",
                 "libzseek_tpu/ops/pallas_match.py:954"))


def lane_calls(frames, sizes, hints, calls=None):
    """The lane route on the card with every call of its three kernel
    wrappers recorded: (its result, {wrapper: [(fn, args, kwargs, out)]});
    `calls`, where given, collects them also when the route raises."""
    from libzseek_tpu_torch.ops import exec_blocks, lanes
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    calls = {} if calls is None else calls
    saved = []
    for mod, fname in ((lanes, "huf_lanes"), (lanes, "seq_lanes"),
                       (exec_blocks, "execute_blocks")):
        real = getattr(mod, fname)
        saved.append((mod, fname, real))

        def spy(*a, _real=real, _name=fname, **kw):
            out = _real(*a, **kw)
            calls.setdefault(_name, []).append((_real, a, kw, out))
            return out
        setattr(mod, fname, spy)
    try:
        res = ZD.decode_frames_lanes(frames, sizes, hints, device="cuda")
    finally:
        for mod, fname, real in saved:
            setattr(mod, fname, real)
    return res, calls


def replay_plain(name, calls):
    """Each recorded card call again on CPU copies of its inputs (the
    plain version): (max_abs_err, plain ms summed).  Fails unless equal."""
    import torch
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
    err, ms = 0, 0.0
    for fn, a, kw, out in calls:
        t, ref = time_host(lambda: fn(*[cpu(v) for v in a],
                                      **{k: cpu(v) for k, v in kw.items()}))
        ms += t
        err = max(err, max_abs_err(list(out), list(ref)))
    check(err == 0, f"{name} differs from its plain version (max err {err})")
    return err, ms


def k6_damaged(frames, sizes, k6_call) -> tuple[int, str]:
    """K6 against its plain version on damaged inputs: every K6 call the
    lane route makes on damaged copies of `frames` (testing/damage.py;
    copies the host parse or the lane decoders reject never reach K6),
    then damaged copies of one recorded call's rows: a length or offset
    changed (a failing row), n_seq cut (a row that stops short of its
    content), d_off moved back over the row before (frames that do not
    tile in order, which must take the serial arm).  Returns (max_abs_err,
    a note)."""
    import torch
    from libzseek_tpu_torch.errors import FormatError
    from libzseek_tpu_torch.ops import exec_blocks
    from libzseek_tpu_torch.testing.damage import (damaged_exec_rows,
                                                   damaged_frames)
    err, routed = 0, 0
    for i, fr in damaged_frames(frames, 17, 16):
        calls = {}
        try:
            lane_calls([fr], [sizes[i]], None, calls)
        except FormatError:
            pass        # the route's verdict on a damaged frame
        if calls.get("execute_blocks"):
            e, _ = replay_plain("K6 (damaged frames)",
                                calls["execute_blocks"])
            err, routed = max(err, e), routed + len(calls["execute_blocks"])
    fn, a, kw, _ = k6_call
    cpu = [t.cpu() for t in a[:7]]
    before = exec_blocks.serial_frames()
    failed = mid = 0
    copies = damaged_exec_rows(cpu, 19, 40)
    for d in copies:
        got = fn(*[t.cuda() for t in d], *a[7:], **kw)
        ref = fn(*d, *a[7:], **kw)
        err = max(err, max_abs_err(list(got), list(ref)))
        bad = ref[1] == 0
        failed += int(bad.any())
    serial = exec_blocks.serial_frames() - before
    check(err == 0, f"K6 on damaged inputs differs from plain (max err {err})")
    check(failed > 0, "no damaged K6 row failed")
    check(serial > 0, "no damaged K6 frame took the serial arm")
    return err, (f"{routed} K6 calls on 16 damaged frames, {len(copies)} "
                 f"damaged copies of the 8 frames' rows ({failed} with a "
                 f"failing row, {serial} frames on the serial arm)")


def lane_work(fname, call):
    """(bytes read and written once, operations) of one recorded call:
    every tensor in and out; operations one per symbol (Huffman), ten per
    sequence (sequences: three table reads, three extra-bit reads, three
    state updates, the repcode) or one per output byte (K6)."""
    fn, a, kw, out = call
    nb = nbytes(list(a), list(kw.values()), list(out))
    if fname == "execute_blocks":
        return nb, out[0].numel()
    n = int(kw["n"].sum())
    return nb, n if fname == "huf_lanes" else 10 * n


# the lane decoders' arms, and the launch counters of the lane reads
LANE_ARMS = {"huf_lanes": ("plain", "anchored"),
             "seq_lanes": ("tagged", "anchored")}


def lane_counts() -> dict:
    """phase_read's counters of a lane read: each decoder's launches, in
    all and by arm."""
    from libzseek_tpu_torch.ops import lanes
    return {"Huffman lanes": (lanes, "huf_launches"),
            "Huffman lanes plain": (lanes, "huf_plain_launches"),
            "Huffman lanes anchored": (lanes, "huf_anchored_launches"),
            "sequence lanes": (lanes, "seq_launches"),
            "sequence lanes tagged": (lanes, "seq_tagged_launches"),
            "sequence lanes anchored": (lanes, "seq_anchored_launches")}


def lane_arm(fname, call) -> str:
    kw = call[2]
    if fname == "huf_lanes":
        return "plain" if kw["exact"] else "anchored"
    return "tagged" if kw["tagged"] else "anchored"


def call_work(call) -> int:
    """A lane-decoder call's symbols or sequences."""
    return int(call[2]["n"].sum())


def max_calls(calls) -> dict:
    """{arm: the call of that arm with the most symbols or sequences}."""
    out = {}
    for c in calls:
        fname = c[0].__name__
        a = lane_arm(fname, c)
        if a not in out or call_work(c) > call_work(out[a]):
            out[a] = c
    return out


def lane_variant_errs(pools, log_calls) -> tuple[dict, str]:
    """Every arm of both lane decoders against its plain version on the
    variants (testing/damage.py lane_variants: damaged streams, shuffled
    lanes, mixed tables, rows longer than the tagged arm's stage) of each
    recorded call in `pools` and of the log-like read's largest tagged
    call, its lanes cut to 2,000 sequences: ({wrapper: max_abs_err}, a
    note).  Fails unless every arm met a damaged and a shuffled call and
    all were equal."""
    import torch
    from libzseek_tpu_torch.testing.damage import lane_variants
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
    calls = [c for pool in pools for f in ("huf_lanes", "seq_lanes")
             for c in pool.get(f, [])]
    big = max(log_calls.get("seq_lanes", []), key=call_work, default=None)
    if big is not None:
        calls.append((big[0], big[1], dict(big[2], n=big[2]["n"].clamp(
            max=2000)), None))
    errs = {"huf_lanes": 0, "seq_lanes": 0}
    seen = set()
    for i, (fn, a, kw, _) in enumerate(calls):
        fname = fn.__name__
        arm = lane_arm(fname, (fn, a, kw, None))
        for name, v in lane_variants({k: cpu(x) for k, x in kw.items()},
                                     100 + i).items():
            got = fn(*a, **{k: (x.cuda() if isinstance(x, torch.Tensor)
                                else x) for k, x in v.items()})
            ref = fn(*a, **v)
            errs[fname] = max(errs[fname], max_abs_err(list(got), list(ref)))
            seen.add((fname, arm, name))
    check(not any(errs.values()),
          f"a lane decoder differs from plain on variants of its calls "
          f"({errs})")
    for fname, arms in LANE_ARMS.items():
        for arm in arms:
            for name in ("damaged", "shuffled"):
                check((fname, arm, name) in seen,
                      f"{fname} {arm} arm met no {name} call")
    kinds = sorted({n for _, _, n in seen})
    return errs, (f"{len(calls)} calls' variants ({', '.join(kinds)}) "
                  f"equal to plain, every arm")


@contextlib.contextmanager
def record_lane_calls():
    """Every call of the lane decoders' wrappers inside the block:
    {wrapper: [(fn, args, kwargs, out)]}."""
    from libzseek_tpu_torch.ops import lanes
    calls = {}
    saved = [(f, getattr(lanes, f)) for f in ("huf_lanes", "seq_lanes")]
    for fname, real in saved:
        def spy(*a, _real=real, _name=fname, **kw):
            out = _real(*a, **kw)
            calls.setdefault(_name, []).append((_real, a, kw, out))
            return out
        setattr(lanes, fname, spy)
    try:
        yield calls
    finally:
        for fname, real in saved:
            setattr(lanes, fname, real)


def phase_lanes(archive, table, data, kept, card, report) -> dict:
    """Phase 8: the lane decoders and K6 against their plain versions on
    small frames and on the phase-3 archive's first 8 frames (with and
    without its hints), then the lane route through the Reader on the
    64 MiB archive, the log-like archive of phase 7 and a long-window
    libzstd frame."""
    import numpy as np
    import torch
    from libzseek_tpu_torch import Reader
    from libzseek_tpu_torch.ops import exec_blocks
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    errs = {k[0]: [] for k in LANE_KERNELS}
    plain_lanes = {}

    def run(tag, frames, sizes, hints, raws):
        res, calls = lane_calls(frames, sizes, hints)
        check(b"".join(res) == b"".join(raws),
              f"lane route ({tag}) differs from the input")
        for fname, (err, ms) in ((f, replay_plain(f"{f} ({tag})", c))
                                 for f, c in calls.items()):
            errs[fname].append(err)
            plain_lanes[f"{fname} ({tag})"] = ms
        return calls

    small, raws = k4_small_frames()    # the long-window frame comes last
    small_calls = run("small frames", small[:-1],
                      [len(r) for r in raws[:-1]], None, raws[:-1])
    r = Reader(archive, device="cuda", decoder="lanes")
    hints8 = [r._frame_hints(i) for i in range(8)]
    r.close()
    frames = [frame_bytes(archive, table, i) for i in range(8)]
    raws8 = [data[i * MIB: (i + 1) * MIB] for i in range(8)]
    bare = run("8 frames, no hints", frames, [MIB] * 8, None, raws8)
    full = run("8 frames", frames, [MIB] * 8, hints8, raws8)
    e_dmg, dmg_note = k6_damaged(frames, [MIB] * 8, full["execute_blocks"][0])
    errs["execute_blocks"].append(e_dmg)
    print(f"K6 on damaged inputs: equal to plain ({dmg_note})", flush=True)

    # the main path: Reader(decoder="lanes") over the 64 MiB archive
    for k in ZD.routes:
        ZD.routes[k] = 0
    serial0 = exec_blocks.serial_frames()
    with record_lane_calls() as main_calls:
        read = phase_read(archive, data, card, exec_blocks,
                          "K6 exec_blocks", "lanes", lane_counts())
    main_routes = dict(ZD.routes)
    main_routes["k6_serial_frames"] = exec_blocks.serial_frames() - serial0
    check(main_routes["anchored_frames"] > 0,
          "no frame took the anchored lanes on the lane read")
    for k in ("Huffman lanes", "sequence lanes"):
        check(read["counts"][k] > 0, f"{k} never launched on the lane read")

    # the log-like archive of phase 7 (the plain arms, > 8,190 sequences
    # a block); its calls join the timing pool
    for k in ZD.routes:
        ZD.routes[k] = 0
    with record_lane_calls() as log_calls, \
            Reader(kept["log_archive"], device="cuda", decoder="lanes") as r:
        check(read_all(r) == kept["logs"],
              "the lane read of the log-like archive differs")
    log_routes = dict(ZD.routes)

    pool = {f: [c for calls in (small_calls, bare, full, main_calls,
                                log_calls) for c in calls.get(f, [])]
            for f in ("huf_lanes", "seq_lanes")}
    var_errs, var_note = lane_variant_errs((small_calls, bare, full),
                                           log_calls)
    for fname, e in var_errs.items():
        errs[fname].append(e)
    print(f"lane decoders on variants: {var_note}", flush=True)
    for fname, name, attr, source, replaces in LANE_KERNELS:
        if fname == "execute_blocks":
            cl = full[fname]
            nb, ops = map(sum, zip(*(lane_work(fname, c) for c in cl)))
            ms = time_cuda(lambda: [c[0](*c[1], **c[2]) for c in cl])
            ms_bare = time_cuda(lambda: [c[0](*c[1], **c[2])
                                         for c in bare.get(fname, [])])
            entry(report, name, source, replaces, errs[fname], ms,
                  plain_lanes[f"{fname} (8 frames)"], nb, ops,
                  f"small frames and the archive's first 8 frames (64 "
                  f"blocks) with and without hints equal to plain; timed "
                  f"at the 8 frames with hints (one chain per frame, "
                  f"{len(cl)} call(s)); without hints card {ms_bare:.3f} "
                  f"ms, plain "
                  f"{plain_lanes.get(f'{fname} (8 frames, no hints)', 0):.1f}"
                  f" ms; {dmg_note}")
            report[-1].update(launches=read["counts"][name],
                              ms_without_hints=ms_bare,
                              cuda_kernels=K6_KERNELS)
            continue
        # each arm at its recorded call with the most work; the entry at
        # the call with the most work of all
        arms = {}
        for arm, c in max_calls(pool[fname]).items():
            nb, ops = lane_work(fname, c)
            t_plain, ref = time_host(lambda: c[0](
                *c[1], **{k: v.cpu() if hasattr(v, "cpu") else v
                          for k, v in c[2].items()}))
            err = max_abs_err(list(c[3]), list(ref))
            check(err == 0, f"{name}: the {arm} arm's largest call differs "
                  f"from its plain version (max err {err})")
            errs[fname].append(err)
            arms[arm] = dict(ms=time_cuda(lambda: c[0](*c[1], **c[2])),
                             plain_ms=t_plain, bound_ms=bound(nb, ops)[0],
                             work=call_work(c), nb=nb, ops=ops)
        top = max(arms, key=lambda a: arms[a]["work"])
        unit = "symbols" if fname == "huf_lanes" else "sequences"
        entry(report, name, source, replaces, errs[fname], arms[top]["ms"],
              arms[top]["plain_ms"], arms[top]["nb"], arms[top]["ops"],
              f"small frames, the archive's first 8 frames (64 blocks) "
              f"with and without hints, the 64 MiB read's calls and the "
              f"log-like read's largest equal to plain; {var_note}; timed "
              f"at the call "
              f"with the most {unit} ({top} arm, {arms[top]['work']}); "
              + "; ".join(f"{a} arm's largest call {v['work']} {unit}: card "
                          f"{v['ms']:.3f} ms, plain {v['plain_ms']:.1f} ms, "
                          f"bound {v['bound_ms']:.6f} ms"
                          for a, v in arms.items()))
        report[-1].update(
            launches=read["counts"][name],
            launches_by_arm={a: read["counts"][f"{name} {a}"]
                             for a in LANE_ARMS[fname]},
            arms={a: {k: v[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "work")}
                  for a, v in arms.items()})

    # a long-window libzstd frame
    for k in ZD.routes:
        ZD.routes[k] = 0
    run("long-window frame", small[-1:], [len(raws[-1])], None, raws[-1:])
    lw_routes = dict(ZD.routes)
    check(lw_routes["pointer_doubling_batches"] == 1,
          f"the long-window frame took {lw_routes}")
    torch.cuda.synchronize()
    print(f"lane routes: 64 MiB read {main_routes}; log-like 8 MiB "
          f"{log_routes}; long-window frame {lw_routes}", flush=True)
    print("lane launches by arm, 64 MiB level-3 read: "
          + ", ".join(f"{k} {v}" for k, v in read["counts"].items()),
          flush=True)
    return {"card": card, "read_mib_s": read["read_mib_s"],
            "pread_p50_us": read["pread_p50_us"],
            "pread_p99_us": read["pread_p99_us"],
            "launches": read["counts"], "routes_main": main_routes,
            "routes_log": log_routes, "routes_long_window": lw_routes,
            "plain_ms": plain_lanes}


# ---------------------------------------------------------------------------
# phase 9: levels >= 4

BLOCK_HIGH = 1 << 16
HIGH_LEVELS = (4, 9, 16)
# K1's small check: one 16 KiB row per quarter of the corpus, each its own
# frame; the path's batch: 64 rows of 64 KiB = 4 whole 1 MiB frames of 16
# blocks, one per quarter
K1H_ROWS = [q * 16 * MIB for q in range(4)]
K1H_BATCH = [q * 16 * MIB + j * BLOCK_HIGH for q in range(4)
             for j in range(16)]


def k1_level_args(data, offsets, frame_blocks, n):
    """x2, lens, min_abs, h16 on the card for K1 at block size n."""
    import torch
    from libzseek_tpu_torch.ops.zstd_encode import block_entropy_h16
    x2, lens, ma = batch_layout(data, offsets, frame_blocks, n)
    t = lambda a: torch.from_numpy(a).to("cuda")
    h16, _ = block_entropy_h16(t(x2[1:]), t(lens))
    return t(x2), t(lens), t(ma), h16


def k1_edge_rows():
    """K1's decision rows as (x2, lens, min_abs): four fenced 16 KiB rows
    crafted as tests/test_torch_cuda_inputs.arms_rows crafts them (a lazy
    step's later match, a strict row of small-vocabulary text for short4,
    a repcode pattern the tables miss, period-337 repeats); then seven
    64 KiB rows: 5-byte
    words from 64 random ones (past CAP sequences), text, text fenced
    30,000 bytes into its previous block, a frame's 20,000-byte last
    row, a new frame and its 100-byte last row, a frame of one 10-byte
    row."""
    import numpy as np
    from libzseek_tpu_torch.testing.corpus import mixed_corpus
    n, rng = 16384, np.random.default_rng(4242)
    a = np.zeros((5, n), np.uint8)
    a[1] = rng.integers(0, 256, n, np.uint8)
    alpha = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", np.uint8)
    a[1, 20:25], a[1, 60:71] = alpha[:5], alpha[1:12]
    a[1, 100: 100 + len(alpha) - 2], a[1, 200: 200 + len(alpha)] = \
        alpha[2:], alpha
    a[1, [19, 59, 99]] = ord("#")
    a[2] = rng.choice(np.frombuffer(b"abcdefgh ", np.uint8), n)
    a[3] = rng.integers(0, 256, n, np.uint8)
    W, V = rng.integers(0, 256, 16, np.uint8), rng.integers(0, 256, 64,
                                                             np.uint8)
    a[3, 280:296], a[3, 380:396] = W, W
    a[3, 300:364], a[3, 400:464], a[3, 366:378] = V, V, V[:12]
    a[3, [299, 399, 279, 379, 365, 378]] = [1, 2, 3, 4, 5, 6]
    a[4] = np.tile(rng.integers(0, 256, 337, np.uint8), n // 337 + 1)[:n]
    arms = (a, np.full(4, n, np.int32),
            (np.arange(4, dtype=np.int32) + 1) * n)
    N = BLOCK_HIGH
    x2 = np.zeros((8, N), np.uint8)
    words = rng.integers(0, 256, (64, 5), np.uint8)
    x2[1] = words[rng.integers(0, 64, N // 5 + 1)].reshape(-1)[:N]
    x2[2:6] = mixed_corpus(np.random.default_rng(89), 4 * N) \
        .reshape(4, N)[[0, 0, 0, 1]]
    x2[3, : N // 2] = x2[2, N // 4: 3 * N // 4]
    x2[6:8] = mixed_corpus(np.random.default_rng(97), 2 * N).reshape(2, N)
    i = np.arange(7)
    min_abs = (i * N).astype(np.int32)
    min_abs[[0, 4, 6]] = (i[[0, 4, 6]] + 1) * N
    min_abs[2] = 2 * N + 30000
    return [arms, (x2, np.array([N, N, N, 20000, N, 100, 10], np.int32),
                   min_abs)]


def sample_8mib(data: bytes) -> bytes:
    """2 MiB from the start of each quarter of the corpus."""
    return b"".join(data[q * 16 * MIB: q * 16 * MIB + 2 * MIB]
                    for q in range(4))


def phase_levels(data, card, report, keep: dict) -> dict:
    """Phase 9: K1's level >= 4 arms against their plain versions, then
    the level-9 write of the 64 MiB, levels 4 and 16 and the hash parser
    at level 9 on 8 MiB, and the level-9 archive's read through both
    decode routes (the archive goes to `keep` for phase 10)."""
    import numpy as np
    import torch
    from libzseek_tpu_torch import ZstdCodec
    from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
    from libzseek_tpu_torch.ops import (entropy, exec_blocks, hash_parse,
                                        parse_linked, vector_entropy)
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    from libzseek_tpu_torch.ops.zstd_encode import (GATE_FIXED_BITS,
                                                    block_entropy_h16,
                                                    level_search_params)
    from libzseek_tpu_torch.testing import golden

    small = k1_level_args(data, K1H_ROWS, 1, 16384)
    big = k1_level_args(data, K1H_BATCH, 16, BLOCK_HIGH)
    edges = []
    for x2, lens, ma in k1_edge_rows():
        t = lambda a: torch.from_numpy(a).to("cuda")
        edges.append([t(x2), t(lens), t(ma),
                      block_entropy_h16(t(x2[1:]), t(lens))[0]])
    k1 = {}
    for level in HIGH_LEVELS:
        prm = {"gate_bits": GATE_FIXED_BITS, **level_search_params(level)}
        fn = lambda *a, _p=prm: parse_linked.parse_linked(*a, **_p)
        e_small, _ = against_plain(f"K1 level {level} (4 rows)", fn, small)
        e_edges = [against_plain(f"K1 level {level} (decision rows)", fn,
                                 e)[0] for e in edges]
        e_big, plain_ms = against_plain(f"K1 level {level} (64 rows)", fn,
                                        big)
        out = fn(*big)
        entry(report, f"K1 parse_linked (level {level})",
              "libzseek_tpu_torch/csrc/parse_linked.cu",
              "libzseek_tpu/ops/pallas_match.py:194",
              [e_small, e_big] + e_edges,
              time_cuda(lambda: fn(*big)), plain_ms, nbytes(big, out),
              big[0][1:].numel(),
              f"lazy {prm['lazy']}, accel_log {prm['accel_log']}, dual, "
              f"rep_probe; 4 rows of 16 KiB, one per quarter; the decision "
              f"rows (lazy win, short4, rep hit, CAP, a fence, short last "
              f"rows); 64 rows of 64 KiB in 4 chains of 16, "
              f"{int(out[3].sum())} sequences")
        k1[level] = report[-1]

    # the main path at level 9
    mods = {"K1": parse_linked, "K2": entropy, "K3": vector_entropy}
    write_archive(data, "cuda", level=9)             # warm-up
    for m in mods.values():
        m.launches = 0
    archive, dt = write_archive(data, "cuda", level=9)
    counts = {k: m.launches for k, m in mods.items()}
    k1[9]["launches"] = counts["K1"]
    by_name(report, "K2 entropy_emit")["launches_level9"] = counts["K2"]
    by_name(report, "K3 vector_literals")["launches_level9"] = counts["K3"]
    ratio = len(archive) / len(data)
    print(f"level-9 write path: 64 MiB in {dt:.3f} s = {64 / dt:.2f} MiB/s, "
          f"ratio {ratio:.5f} ({len(archive)} bytes); launches {counts}",
          flush=True)
    check(counts["K1"] > 0 and counts["K2"] > 0,
          "K1 or K2 never launched on the level-9 write")
    check(counts["K3"] == 0, "K3 launched on 64 KiB blocks")
    check(golden.zstd_decompress(archive) == data,
          "stock libzstd does not reproduce the level-9 archive")
    print(f"level-9 archive sha256 {hashlib.sha256(archive).hexdigest()}",
          flush=True)
    keep["level9_archive"] = archive
    table = parse_seek_table_bytes(archive)
    check(table.num_frames == 64, f"seek table has {table.num_frames} frames")
    random_reads(archive, table, data)
    cpu_archive, cpu_dt = write_archive(data[:MIB], "cpu", level=9)
    check(frame_bytes(cpu_archive, parse_seek_table_bytes(cpu_archive), 0)
          == frame_bytes(archive, table, 0),
          "first level-9 frame differs between the card and the plain "
          "versions")
    print(f"level-9 archive: libzstd decode equal, 64 frames, 16 random "
          f"4 KiB reads equal, first frame equal to plain (CPU, "
          f"{cpu_dt:.1f} s)", flush=True)

    # levels 4 and 16, and the hash parser at level 9, on 8 MiB
    sample = sample_8mib(data)
    others = {}
    for name, level, codec, mod in (
            ("level 4", 4, "zstd", parse_linked),
            ("level 16", 16, "zstd", parse_linked),
            ("hash level 9", 9, ZstdCodec(level=9, device="cuda",
                                          parser="hash"), hash_parse)):
        mod.launches = 0
        arc, sdt = write_archive(sample, "cuda", codec, level)
        n = mod.launches
        check(n > 0, f"{name}: its parse kernel never launched")
        check(golden.zstd_decompress(arc) == sample,
              f"stock libzstd does not reproduce the {name} archive")
        others[name] = {"write_mib_s": 8 / sdt,
                        "ratio": len(arc) / len(sample), "launches": n}
        if level in k1 and codec == "zstd":
            k1[level]["launches"] = n
        print(f"{name}, 8 MiB: {sdt:.3f} s = {8 / sdt:.2f} MiB/s, ratio "
              f"{len(arc) / len(sample):.5f}, parse launches {n}; libzstd "
              f"decode equal", flush=True)

    # the level-9 archive read back through both decode routes
    fused = phase_read(archive, data, card)
    for k in ZD.routes:
        ZD.routes[k] = 0
    lane = phase_read(archive, data, card, exec_blocks, "K6 exec_blocks",
                      "lanes", lane_counts())
    routes = dict(ZD.routes)
    print(f"level-9 lane routes: {routes}; launches by arm: "
          + ", ".join(f"{k} {v}" for k, v in lane["counts"].items()),
          flush=True)
    for name, f in (("Huffman lanes", "huf_lanes"),
                    ("sequence lanes", "seq_lanes")):
        by_name(report, name)["launches_by_arm_level9"] = {
            a: lane["counts"][f"{name} {a}"] for a in LANE_ARMS[f]}
    return {"card": card, "write_mib_s": 64 / dt, "ratio": ratio,
            "launches": counts, "others_8mib": others,
            "read_fused": fused, "read_lanes": lane, "lane_routes": routes,
            "k1_ms": {lv: k1[lv]["ms"] for lv in HIGH_LEVELS}}


# ---------------------------------------------------------------------------
# phase 10: the transcode decode route

@contextlib.contextmanager
def record_transcode():
    """Every call of K4's transcode wrapper while the block runs (the
    Reader's threads too): [(args, outputs)]."""
    from libzseek_tpu_torch.ops import decode as D
    calls = []
    real = D.transcode_blocks

    def spy(*a):
        out = real(*a)
        calls.append((a, out))
        return out
    D.transcode_blocks = spy
    try:
        yield calls
    finally:
        D.transcode_blocks = real


def transcode_calls(frames, sizes, hints, host_literals: bool):
    """decode_frames_transcode on the card with every call of K4's
    transcode wrapper recorded: (its result, [(args, outputs)])."""
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    with record_transcode() as calls:
        res = ZD.decode_frames_transcode(frames, sizes, hints,
                                         device="cuda",
                                         host_literals=host_literals)
    return res, calls


def transcode_replay(calls) -> tuple[int, list]:
    """Recorded transcode calls replayed on the plain version: (max_abs_err
    over their tokens, literal words and stat, each call's plain ms)."""
    import torch
    from libzseek_tpu_torch.ops import decode as D
    ms, err = [], 0
    for a, out in calls:
        t, ref = time_host(lambda: D.transcode_blocks(
            *[v.cpu() if isinstance(v, torch.Tensor) else v for v in a]))
        ms.append(t)
        err = max(err, max_abs_err(list(out), list(ref)))
    return err, ms


def transcode_variant_errs(a) -> tuple[int, str]:
    """K4's transcode arm on variants of one recorded call
    (testing/damage.transcode_variants: damaged streams, a walk stopped
    mid-row, a WIDE entry, a row at its frame's start, a stream above the
    row walk's stage) against its plain version: (max_abs_err, note)."""
    import torch
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.testing.damage import transcode_variants
    cpu = [v.cpu() if isinstance(v, torch.Tensor) else v for v in a]
    err, failed = 0, 0
    variants = transcode_variants(cpu, 17, n_damaged=2)
    for v in variants.values():
        got = D.transcode_blocks(*[x.cuda() if isinstance(x, torch.Tensor)
                                   else x for x in v])
        ref = D.transcode_blocks(*v)
        err = max(err, max_abs_err(list(got), list(ref)))
        failed += not bool(ref[2][:, 1].all())
    return err, (f"{len(variants)} variants ({', '.join(variants)}), "
                 f"{failed} with a failing row")


def transcode_sum(calls, plain_ms) -> dict:
    """A read's recorded transcode calls (and each one's plain ms):
    launches, card ms (each call timed alone), plain and bound ms summed,
    and the call with the most sequences: its index, sequences, rows,
    card, plain and bound ms."""
    import numpy as np
    from libzseek_tpu_torch.ops import decode as D
    per = []
    for (a, out), p_ms in zip(calls, plain_ms):
        m = a[4].cpu().numpy()
        per.append((int(np.maximum(m[:, 13], 0).sum()), len(m),
                    time_cuda(lambda: D.transcode_blocks(*a)), p_ms,
                    bound(*transcode_work([(a, out)]))[0]))
    i = max(range(len(per)), key=lambda k: per[k][0])
    return {"launches": len(calls), "ms_sum": sum(p[2] for p in per),
            "plain_ms_sum": sum(p[3] for p in per),
            "bound_ms_sum": sum(p[4] for p in per),
            "largest": dict(zip(("sequences", "rows", "ms", "plain_ms",
                                 "bound_ms"), per[i]), index=i)}


def transcode_work(calls) -> tuple[int, int]:
    """(bytes, operations) that recorded transcode calls need, counting
    only what the arm reads and writes: per row its meta and token
    prefix; per row with sequences its sequence stream (meta[12] bits)
    and, of each FSE table, the entries its walk can reach (2^tl, at
    most n_seq); per row whose literals the kernel emits, its literal
    prefix and either its Huffman streams (meta[4:8] bits) and at most
    regen of its 4096 peek-table entries, or its regen DIRECT bytes; the
    chain and the constant table once a call; out, the literal and token
    words and the stat.  Nothing of a DMODE_LIT_HOST row's literals.
    Operations one per Huffman symbol and ten per sequence."""
    import numpy as np
    from libzseek_tpu_torch.ops import decode as D
    nb = ops = 0
    for a, out in calls:
        m = a[4].cpu().numpy().astype(np.int64)
        mode, regen, n_seq = m[:, 0], m[:, 3], m[:, 13]
        host = (mode & D.DMODE_LIT_HOST) != 0
        huf = ((mode & (D.DMODE_HUF4 | D.DMODE_HUF1)) != 0) & ~host
        direct = ((mode & D.DMODE_DIRECT) != 0) & ~huf & ~host
        seq = ((mode & D.DMODE_SEQ) != 0) & (n_seq > 0)
        tab = sum(np.minimum(1 << ((m[:, 14] >> sh) & 255), n_seq)
                  for sh in (0, 8, 16))
        streams = np.where(mode & D.DMODE_HUF4, m[:, 4:8].sum(1), m[:, 4])
        nb += m.shape[0] * (4 * D.META_W + 4)
        nb += int(((m[seq, 12] + 7) // 8).sum() + 4 * tab[seq].sum())
        nb += int(4 * (huf | direct).sum() + ((streams[huf] + 7) // 8).sum()
                  + 4 * np.minimum(regen[huf], 1 << D.HUF_PEEK).sum()
                  + regen[direct].sum())
        nb += nbytes(a[5], list(out)) + D.CTAB.nbytes
        ops += int(regen[huf].sum()) + 10 * int(n_seq[seq].sum())
    return nb, ops


def phase_transcode(archive, table, data, kept, card, report) -> dict:
    """Phase 10: K4's transcode arm against its plain version (host and
    device literals) on the small frames of phase 2 and on the phase-3
    archive's first 8 frames, the route against libzstd there, the arm
    timed, then Reader(decoder="auto") over the 64 MiB archive, the
    long-window frame, the level-9 archive, and the fused, lane and
    transcode reads of the 64 MiB timed in alternation."""
    import torch
    from libzseek_tpu_torch import Reader
    from libzseek_tpu_torch.ops import decode as D
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    from libzseek_tpu_torch.testing import golden
    errs, plain, card_ms, recorded = [], {}, {}, {}

    def replay(tag, calls):
        err, ms = transcode_replay(calls)
        check(err == 0, f"K4 transcode ({tag}) differs from its plain "
              f"version (max err {err})")
        errs.append(err)
        plain[tag] = sum(ms)
        recorded[tag] = calls
        return ms

    def run(tag, frames, sizes, hints, host_literals):
        res, calls = transcode_calls(frames, sizes, hints, host_literals)
        want = [golden.zstd_frame_decompress(f, n)
                for f, n in zip(frames, sizes)]
        check(res == want, f"transcode route ({tag}) differs from libzstd")
        replay(tag, calls)
        return res

    small, raws = k4_small_frames()    # the long-window frame comes last
    r = Reader(archive, device="cuda", decoder="auto")
    hints8 = [r._frame_hints(i) for i in range(8)]
    r.close()
    frames8 = [frame_bytes(archive, table, i) for i in range(8)]
    for hl in (True, False):
        arm = "host literals" if hl else "device literals"
        run(f"small frames, {arm}", small, [len(x) for x in raws], None, hl)
        res = run(f"8 frames, {arm}", frames8, [MIB] * 8, hints8, hl)
        check(b"".join(res) == data[: 8 * MIB],
              "the 8 frames' transcode differs from the input")
        cl = recorded[f"8 frames, {arm}"]
        card_ms[arm] = time_cuda(lambda: [D.transcode_blocks(*a)
                                          for a, _ in cl])
    nb, ops = transcode_work(recorded["8 frames, host literals"])
    nb_d, ops_d = transcode_work(recorded["8 frames, device literals"])
    rows = sum(len(a[4]) for a, _ in recorded["8 frames, host literals"])

    # the main path: Reader(decoder="auto") over the 64 MiB archive, whose
    # host delivery takes the transcode route
    for k in ZD.routes:
        ZD.routes[k] = 0
    read = phase_read(archive, data, card, D, "K4 transcode", "auto",
                      attr="transcode_launches")
    main_routes = dict(ZD.routes)
    check(main_routes["transcode_fallback_batches"] == 0
          and main_routes["transcode_rule_batches"] == 0,
          f"the transcode read left its route: {main_routes}")
    entry(report, "K4 transcode", "libzseek_tpu_torch/csrc/decode.cu",
          "libzseek_tpu/ops/pallas_decode.py:94 (DMODE_TRANSCODE, "
          "DMODE_LIT_HOST)", errs, card_ms["host literals"],
          plain["8 frames, host literals"], nb, ops,
          f"both arms on the small frames and the archive's first 8 frames "
          f"({rows} rows) equal to plain, tokens, literals and stat; timed "
          f"there on the host-literal arm (the codec's); device-literal arm "
          f"card {card_ms['device literals']:.3f} ms, plain "
          f"{plain['8 frames, device literals']:.1f} ms")
    report[-1].update(launches=read["launches"],
                      ms_device_literals=card_ms["device literals"],
                      plain_ms_device_literals=plain[
                          "8 frames, device literals"],
                      bound_ms_device_literals=bound(nb_d, ops_d)[0],
                      cuda_kernels=K4T_KERNELS)

    # the long-window frame and the level-9 archive (64 KiB blocks)
    for k in ZD.routes:
        ZD.routes[k] = 0
    run("long-window frame", small[-1:], [len(raws[-1])], None, True)
    lw_routes = dict(ZD.routes)
    check(lw_routes["transcode_batches"] == 1 and
          lw_routes["transcode_fallback_batches"] == 0,
          f"the long-window frame took {lw_routes}")
    for k in ZD.routes:
        ZD.routes[k] = 0
    with record_transcode() as l9_calls, \
            Reader(kept["level9_archive"], device="cuda",
                   decoder="auto") as r:
        check(read_all(r) == data, "the level-9 transcode read differs")
    l9_routes = dict(ZD.routes)
    check(l9_routes["transcode_fallback_batches"] == 0
          and l9_routes["transcode_rule_batches"] == 0,
          f"the level-9 transcode read left its route: {l9_routes}")
    # the log-like archive of phase 7, where the route takes it
    for k in ZD.routes:
        ZD.routes[k] = 0
    with record_transcode() as log_calls, \
            Reader(kept["log_archive"], device="cuda",
                   decoder="auto") as r:
        check(read_all(r) == kept["logs"],
              "the log-like transcode read differs")
    log_routes = dict(ZD.routes)
    # every call of both reads against plain, each read's launches summed
    # and its call with the most sequences timed alone; variants of the
    # level-9 read's largest call
    reads = {}
    for tag, calls in (("level-9 read", l9_calls),
                       ("log-like read", log_calls)):
        if calls:
            reads[tag] = transcode_sum(calls, replay(tag, calls))
    check("level-9 read" in reads, "the level-9 read made no transcode call")
    l9_big = l9_calls[reads["level-9 read"]["largest"]["index"]][0]
    e_var, var_note = transcode_variant_errs(l9_big)
    check(e_var == 0, f"K4 transcode on variants differs from plain "
          f"(max err {e_var})")
    errs.append(e_var)
    for tag, v in reads.items():
        big = v["largest"]
        print(f"K4 transcode, {tag}: {v['launches']} launches, card "
              f"{v['ms_sum']:.3f} ms summed (bound {v['bound_ms_sum']:.6f}); "
              f"largest call ({big['sequences']} sequences, {big['rows']} "
              f"rows) card {big['ms']:.3f} ms, plain {big['plain_ms']:.1f} "
              f"ms, bound {big['bound_ms']:.6f} ms", flush=True)
    print(f"K4 transcode on variants of the level-9 read's largest call: "
          f"equal to plain ({var_note})", flush=True)

    # the three zstd decode routes, read in turn, three rounds
    paired = {"fused": [], "lanes": [], "transcode": []}
    for _ in range(3):
        for dec in paired:
            r = Reader(archive, device="cuda",
                       decoder="auto" if dec == "transcode" else dec)
            t0 = time.perf_counter()
            got = read_all(r)
            torch.cuda.synchronize()
            paired[dec].append(len(data) / MIB / (time.perf_counter() - t0))
            r.close()
            check(got == data, f"the {dec} read differs from the input")
    by_name(report, "K4 transcode").update(
        reads=reads, variants=var_note, max_abs_err=max(errs))
    print(f"transcode routes: 64 MiB read {main_routes}; long-window frame "
          f"{lw_routes}; level-9 archive {l9_routes}; log-like archive "
          f"{log_routes}", flush=True)
    print("paired 64 MiB reads, MiB/s in turn (fused, lanes, transcode) x 3: "
          + "; ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in vs)
                      for k, vs in paired.items()), flush=True)
    return {"card": card, "read_mib_s": read["read_mib_s"],
            "pread_p50_us": read["pread_p50_us"],
            "pread_p99_us": read["pread_p99_us"],
            "launches": read["counts"], "routes_main": main_routes,
            "routes_long_window": lw_routes, "routes_level9": l9_routes,
            "routes_log": log_routes, "transcode_reads": reads,
            "paired_read_mib_s": paired, "plain_ms": plain,
            "card_ms": card_ms}


# ---------------------------------------------------------------------------
# phase 11: the sort parser and the public API

GREEDY_KERNELS = ["greedy_kernel"]


def capture_greedy(codec, frames) -> tuple[list, dict]:
    """compress_frames(frames) with ops.match.greedy_select wrapped: the
    arguments of its first call (tensors cloned) and its keywords."""
    from libzseek_tpu_torch.ops import match
    orig = match.greedy_select
    got = []

    def spy(*a, **kw):
        if not got:
            got.append(([t.clone() if hasattr(t, "clone") else t
                         for t in a], kw))
        return orig(*a, **kw)
    match.greedy_select = spy
    try:
        codec.compress_frames(frames)
    finally:
        match.greedy_select = orig
    return got[0]


def greedy_small(data):
    """greedy_select's small cases: one 16 KiB row per quarter through
    the zstd candidates (seg_size 4 and 8, min_tail 4) and the LZ4
    context arm (8 KiB window, 8 KiB block, seg_size 4, c0 = 8192,
    min_tail 12): (name, args on the card, keywords)."""
    import numpy as np
    import torch
    from libzseek_tpu_torch.ops import match
    cuda = torch.device("cuda")
    rows = np.stack([np.frombuffer(data, np.uint8, 16384, q * 16 * MIB)
                     for q in range(4)])
    X = torch.from_numpy(rows).to(cuda)
    lens = torch.tensor([16384, 16384, 16000, 11], dtype=torch.int32,
                        device=cuda)
    out = []
    for seg in (4, 8):
        p, off, e, has = match.find_segment_matches(
            X, lens, seg_size=seg, max_len=48, min_tail=4, end_margin=0,
            max_offset=(1 << 17) - 1, window=8)
        out.append((f"zstd seg_size {seg}", [p, off, e, has, lens],
                    dict(min_tail=4)))
    lens_c = torch.tensor([16384, 16384, 12000, 8192], dtype=torch.int32,
                          device=cuda)
    min_ref = torch.tensor([0, 8192, 100, 0], dtype=torch.int32,
                           device=cuda)
    p, off, e, has = match.find_segment_matches(
        X, lens_c, seg_size=4, max_len=48, max_back=4, dual=True,
        ctx_len=8192, min_ref=min_ref)
    out.append(("LZ4 context", [p, off, e, has, lens_c],
                dict(min_tail=12, c0=8192)))
    return out


def greedy_work(args) -> tuple[int, int]:
    """(bytes, operations) greedy_select must move and do: p, e, has and
    lengths read once, sel, start, lit_from and c_final written once;
    about 4 integer operations a segment (a max, two compares, a
    select)."""
    p = args[0]
    B, nseg = p.shape
    return (nbytes(args[0], args[2], args[3], args[4])
            + B * nseg * (1 + 4 + 4) + 4 * B), 4 * B * nseg


def sort_read(archive: bytes, data: bytes, D, name: str, **kw) -> float:
    """timed_read of the archive with 16 preads (kw picks the route that
    runs D: decoder="fused" for K4, device_cache=True for the LZ4
    decoder): the decoder module D must launch on the sequential pass;
    returns its MiB/s."""
    t = timed_read(archive, data, 16, {name: (D, "launches")}, **kw)
    check(t["counts"][name] > 0, f"{name} never launched on the sort read")
    return t["read_mib_s"]


def phase_sort(data, card, report) -> dict:
    """Phase 11: greedy_select against its plain version, the zstd and
    LZ4 sort writes and their reads, levels 1 / -1, the public API."""
    import numpy as np
    import torch
    from libzseek_tpu_torch import LZ4Codec, ZstdCodec, api
    from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
    from libzseek_tpu_torch.ops import decode, lz4_decode, match
    from libzseek_tpu_torch.testing import golden

    # greedy_select: small cases, then the path's batches
    errs = []
    for name, args, kw in greedy_small(data):
        e, _ = against_plain(f"greedy_select ({name})",
                             lambda *a, kw=kw: match.greedy_select(*a, **kw),
                             args)
        errs.append(e)
    frames = [data[f * 8 * MIB: f * 8 * MIB + MIB] for f in range(8)]
    zargs, zkw = capture_greedy(ZstdCodec(parser="sort"), frames)
    largs, lkw = capture_greedy(LZ4Codec(parser="sort"), frames)
    check(tuple(zargs[0].shape) == (64, N // 4) and
          tuple(largs[0].shape) == (128, N // 4),
          f"greedy_select batches {tuple(zargs[0].shape)}, "
          f"{tuple(largs[0].shape)}")
    zfn = lambda *a: match.greedy_select(*a, **zkw)
    lfn = lambda *a: match.greedy_select(*a, **lkw)
    e_z, plain_ms = against_plain("greedy_select (64 zstd rows)", zfn, zargs)
    e_l, lz4_plain_ms = against_plain("greedy_select (128 LZ4 rows)", lfn,
                                      largs)
    ms = time_cuda(lambda: zfn(*zargs))
    lz4_ms = time_cuda(lambda: lfn(*largs))
    lz4_bound, _ = bound(*greedy_work(largs))
    has_z = int(zargs[3].sum())
    has_l = int(largs[3].sum())
    per_row = {"zstd": zfn(*zargs)[0].sum(1).cpu().numpy(),   # selections
               "LZ4": lfn(*largs)[0].sum(1).cpu().numpy()}
    sel_note = "; ".join(
        f"{k} selections a row min {int(v.min())}, median "
        f"{int(np.median(v))}, max {int(v.max())}, total {int(v.sum())}"
        for k, v in per_row.items())
    entry(report, "greedy_select", "libzseek_tpu_torch/csrc/greedy_select.cu",
          "libzseek_tpu/ops/match.py:213", errs + [e_z, e_l], ms, plain_ms,
          *greedy_work(zargs),
          f"not a TPU kernel (a lax.scan); one 16 KiB row per quarter, "
          f"seg_size 4/8 and the LZ4 context arm; 64 zstd rows x 32768 "
          f"segments ({has_z} with a candidate after the gate); 128 LZ4 "
          f"rows x 32768 segments ({has_l} with a candidate) card "
          f"{lz4_ms:.3f} ms, plain {lz4_plain_ms:.1f} ms, bound "
          f"{lz4_bound:.4f} ms; {sel_note}")
    g = report[-1]
    g.update(cuda_kernels=GREEDY_KERNELS, lz4_batch_ms=lz4_ms,
             lz4_plain_ms=lz4_plain_ms, lz4_bound_ms=lz4_bound)

    # the zstd sort write: an 8 MiB warm-up, then the 64 MiB
    write_archive(data[:8 * MIB], "cuda", ZstdCodec(parser="sort"))
    match.launches = 0
    archive, dt = write_archive(data, "cuda", ZstdCodec(parser="sort"))
    g["launches"] = match.launches
    check(match.launches > 0, "greedy_select never launched on the zstd "
          "sort write")
    ratio = len(archive) / len(data)
    print(f"zstd sort write: 64 MiB in {dt:.3f} s = {64 / dt:.2f} MiB/s, "
          f"ratio {ratio:.5f} ({len(archive)} bytes); greedy_select "
          f"launches {match.launches}", flush=True)
    check(golden.zstd_decompress(archive) == data,
          "stock libzstd does not reproduce the zstd sort archive")
    print(f"zstd sort archive sha256 {hashlib.sha256(archive).hexdigest()}",
          flush=True)
    table = parse_seek_table_bytes(archive)
    check(table.num_frames == 64, f"seek table has {table.num_frames} frames")
    cpu_archive, cpu_dt = write_archive(data[:MIB], "cpu",
                                        ZstdCodec(device="cpu", parser="sort"))
    check(frame_bytes(cpu_archive, parse_seek_table_bytes(cpu_archive), 0)
          == frame_bytes(archive, table, 0),
          "first zstd sort frame differs between the card and plain")
    read_mib_s = sort_read(archive, data, decode, "K4", decoder="fused")
    print(f"zstd sort archive: libzstd decode equal, 64 frames, first frame "
          f"equal to plain (CPU, {cpu_dt:.1f} s), Reader read equal "
          f"({read_mib_s:.2f} MiB/s, K4 launching), 16 preads equal",
          flush=True)

    # the LZ4 sort write
    write_archive(data[:8 * MIB], "cuda", LZ4Codec(parser="sort"))
    match.launches = 0
    l_archive, l_dt = write_archive(data, "cuda", LZ4Codec(parser="sort"))
    g["launches_lz4"] = match.launches
    check(match.launches > 0, "greedy_select never launched on the LZ4 "
          "sort write")
    l_ratio = len(l_archive) / len(data)
    print(f"LZ4 sort write: 64 MiB in {l_dt:.3f} s = {64 / l_dt:.2f} MiB/s, "
          f"ratio {l_ratio:.5f} ({len(l_archive)} bytes); greedy_select "
          f"launches {match.launches}", flush=True)
    check(golden.lz4f_decompress(l_archive) == data,
          "stock liblz4 does not reproduce the LZ4 sort archive")
    print(f"LZ4 sort archive sha256 "
          f"{hashlib.sha256(l_archive).hexdigest()}", flush=True)
    l_table = parse_seek_table_bytes(l_archive)
    check(l_table.num_frames == 64,
          f"seek table has {l_table.num_frames} frames")
    cpu_l, cpu_l_dt = write_archive(data[:MIB], "cpu",
                                    LZ4Codec(device="cpu", parser="sort"))
    check(frame_bytes(cpu_l, parse_seek_table_bytes(cpu_l), 0)
          == frame_bytes(l_archive, l_table, 0),
          "first LZ4 sort frame differs between the card and plain")
    l_read = sort_read(l_archive, data, lz4_decode, "LZ4 decoder",
                       device_cache=True)
    print(f"LZ4 sort archive: liblz4 decode equal, 64 frames, first frame "
          f"equal to plain (CPU, {cpu_l_dt:.1f} s), Reader read equal "
          f"({l_read:.2f} MiB/s, the LZ4 decoder launching), 16 preads "
          f"equal", flush=True)

    # level 1 zstd and LZ4 level -1 (seg_size 8), 8 MiB of each quarter's
    # first 2 MiB
    small = sample_8mib(data)
    z1, z1_dt = write_archive(small, "cuda",
                              ZstdCodec(level=1, parser="sort"))
    check(golden.zstd_decompress(z1) == small,
          "stock libzstd does not reproduce the level-1 sort archive")
    l1, l1_dt = write_archive(small, "cuda",
                              LZ4Codec(level=-1, parser="sort"))
    check(golden.lz4f_decompress(l1) == small,
          "stock liblz4 does not reproduce the level -1 sort archive")
    print(f"sort, 8 MiB: zstd level 1 {8 / z1_dt:.2f} MiB/s ratio "
          f"{len(z1) / len(small):.5f}, LZ4 level -1 {8 / l1_dt:.2f} MiB/s "
          f"ratio {len(l1) / len(small):.5f}; stock decodes equal",
          flush=True)

    # the public API: the zseek_* shims on the card
    sink = Sink()
    t0 = time.perf_counter()
    w = api.zseek_writer_open_full(sink, api.CompressionParams(
        "zstd", api.ZstdParams(3)), min_frame_size=MIB)
    for pos in range(0, len(small), MIB):
        check(api.zseek_write(w, small[pos: pos + MIB]), "zseek_write")
    wst = api.zseek_writer_close(w)
    torch.cuda.synchronize()
    api_dt = time.perf_counter() - t0
    check(wst.frames == 8, f"zseek_writer_close: {wst.frames} frames")
    r = api.zseek_reader_open(sink.value())
    calls = []
    orig = r._codec.decompress_frames
    r._codec.decompress_frames = lambda *a, **kw: (
        calls.append(len(a[0])), orig(*a, **kw))[1]
    r.prefetch([i * MIB + 5 for i in range(8)])
    check(calls == [8], f"prefetch made decode calls {calls}")
    offs = np.random.default_rng(17).integers(0, len(small) - 4096, 64)
    for off in offs.tolist():
        check(api.zseek_pread(r, 4096, off) == small[off: off + 4096],
              f"zseek_pread at {off} differs")
    check(api.zseek_read(r, 4096) == small[:4096], "zseek_read differs")
    check(len(calls) == 1, f"the preads after prefetch decoded {calls}")
    rst = api.zseek_reader_stats(r)
    api.zseek_reader_close(r)
    print(f"zseek_* API: 8 MiB written in {api_dt:.3f} s ({wst}), 64 "
          f"zseek_preads equal, prefetch of 8 offsets in one decode call "
          f"({calls[0]} frames), {rst}", flush=True)
    return {"card": card, "write_mib_s": 64 / dt, "ratio": ratio,
            "read_mib_s": read_mib_s, "lz4_write_mib_s": 64 / l_dt,
            "lz4_ratio": l_ratio, "lz4_read_mib_s": l_read,
            "level1_write_mib_s": 8 / z1_dt,
            "level1_ratio": len(z1) / len(small),
            "lz4_level_m1_write_mib_s": 8 / l1_dt,
            "lz4_level_m1_ratio": len(l1) / len(small),
            "greedy_launches": g["launches"],
            "greedy_launches_lz4": g["launches_lz4"],
            "api_write_s": api_dt, "prefetch_frames": calls[0]}


# ---------------------------------------------------------------------------
# phase 12: workers across devices, and parallel/

def dist_write(mib: int, timeout: int = 400) -> tuple[str, float, int]:
    """Two processes of testing.dist_worker on cuda:0 over gloo: (rank 0's
    archive sha256, its MiB/s, frames)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "libzseek_tpu_torch.testing.dist_worker",
         str(rank), "2", str(port), "cuda:0", str(mib)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                fail(f"dist_worker did not finish in {timeout} s")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (rc, out, err) in enumerate(outs):
        check(rc == 0, f"dist_worker rank {rank} exited {rc}: {err[-1500:]}")
    check("DIST-OK" in outs[0][1], "the ordered gather did not pass")
    m = re.search(r"DIST-WRITE-OK frames=(\d+) bytes=\d+ sha256=(\w+) "
                  r"mib_s=([\d.]+)", outs[0][1])
    check(m is not None, f"no DIST-WRITE-OK: {outs[0][1][-500:]}")
    return m.group(2), float(m.group(3)), int(m.group(1))


def phase_workers(data, card, zstd_sha, lz4_sha) -> dict:
    """Phase 12: the codecs' round-robin and the zstd worker pipelines on
    one card, the two-process write and the dry run."""
    import torch
    from libzseek_tpu_torch import LZ4Codec, Reader, Writer, ZstdCodec
    from libzseek_tpu_torch.ops import (entropy, lz4_emit, parse_linked,
                                        vector_entropy)
    from libzseek_tpu_torch.parallel import distributed as dist
    from libzseek_tpu_torch.parallel.dryrun import dryrun
    from libzseek_tpu_torch.testing import dist_worker, golden
    from libzseek_tpu_torch.utils import device as udev
    sha = lambda b: hashlib.sha256(b).hexdigest()

    # (a) workers=2 with one visible card: two zstd worker pipelines, both
    # on that card
    sink = Sink()
    w = Writer(sink, "zstd", level=3, device="cuda", workers=2,
               min_frame_size=MIB, batch_frames=16)
    for pos in range(0, len(data), MIB):
        w.write(data[pos: pos + MIB])
    w.close()
    cuda0 = torch.device("cuda", torch.cuda.current_device())
    check(w._codec._devices == [cuda0] * 2
          and w._stream.worker_batches == [w._codec._rr // 2] * 2,
          "workers=2 on one card did not run two pipelines on it")
    check(sha(sink.value()) == zstd_sha,
          "the workers=2 archive differs from phase 3's")
    print(f"workers=2, one card: two pipelines on it, "
          f"{w._stream.worker_batches} batches, sha256 equal to phase 3's",
          flush=True)

    # (b) the round-robin over cuda:0 listed four times
    out = {"card": card}
    real = udev._visible_devices
    udev._visible_devices = lambda dev: [torch.device("cuda", 0)] * 4
    try:
        for name, make, want, decode, mods in (
                ("zstd", lambda n: ZstdCodec(level=3, device="cuda",
                                             workers=n),
                 zstd_sha, golden.zstd_decompress,
                 (parse_linked, entropy, vector_entropy)),
                ("lz4", lambda n: LZ4Codec(level=0, device="cuda",
                                           workers=n),
                 lz4_sha, golden.lz4f_decompress, (lz4_emit,))):
            rates = {1: [], 4: []}
            for n in (1, 4, 4, 1):
                codec = make(n)
                dispatch = "_dispatch_parse" if name == "zstd" \
                    else "_dispatch_batch"
                batches = []
                real_dispatch = getattr(codec, dispatch)
                setattr(codec, dispatch, lambda *a, _f=real_dispatch, **k:
                        batches.append(1) or _f(*a, **k))
                for m in mods:
                    m.launches = 0
                archive, dt = write_archive(data, "cuda", codec)
                counts = [m.launches for m in mods]
                rates[n].append(64 / dt)
                check(sha(archive) == want,
                      f"{name} workers={n} archive differs")
                if n == 4:
                    check(codec._devices is not None
                          and len(codec._devices) == 4,
                          f"{name} workers=4 has no four devices")
                    check(codec._rr == len(batches) > 1,
                          f"{name} _rr {codec._rr} != {len(batches)} batches")
                    check(all(c > 0 for c in counts),
                          f"{name} workers=4: a kernel never launched "
                          f"{counts}")
                    four = {"batches": len(batches), "rr": codec._rr,
                            "launches": counts}
                    four_archive = archive
            check(decode(four_archive) == data,
                  f"stock library does not reproduce the {name} archive")
            with Reader(four_archive, device="cuda") as r:
                check(read_all(r) == data,
                      f"the {name} workers=4 archive reads back wrong")
            out[name] = dict(four, workers1_mib_s=rates[1],
                             workers4_mib_s=rates[4])
            print(f"{name} workers=4 on cuda:0 x4: {four['batches']} "
                  f"batches, _rr {four['rr']}, launches {four['launches']}, "
                  f"sha256 equal to workers=1's, stock decode and Reader "
                  f"equal; MiB/s workers=1 {rates[1]}, workers=4 "
                  f"{rates[4]} ({card})", flush=True)
    finally:
        udev._visible_devices = real

    # (c) two processes over gloo on cuda:0, uneven shards
    got_sha, mib_s, nframes = dist_write(64)
    shards = dist_worker.frames(2, 64)
    check([len(x) for x in shards] == [24, 40], "shards are not 24 and 40")
    whole = [f for x in shards for f in x]
    sink = Sink()
    check(dist.write_archive(sink, whole, codec=ZstdCodec(
        device="cuda", collect_hints=False)) == 64 == nframes,
          "write_archive at world size 1 wrote the wrong frame count")
    one = sink.value()
    check(golden.zstd_decompress(one) == data,
          "stock libzstd does not reproduce the world-size-1 archive")
    check(sha(one) == got_sha,
          "the two-process archive differs from the world-size-1 one")
    out["distributed"] = {"mib_s": mib_s, "frames": nframes,
                          "sha256": got_sha}
    print(f"two-process gloo write on cuda:0 (24 + 40 frames): {mib_s:.2f} "
          f"MiB/s, libzstd decode equal, sha256 equal to world size 1 "
          f"({card})", flush=True)

    # (d) the dry run
    n = torch.cuda.device_count()
    dryrun(n)
    print(f"dry run at n = {n}: lengths positive, workers={n} archive "
          f"read back equal", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the default decode routes

def golden_archive(data: bytes) -> bytes:
    """`data` in 1 MiB frames of stock libzstd (level 3, no hints
    sidecar) behind the port's seek table."""
    from libzseek_tpu_torch.format.seek_table import FrameLog
    from libzseek_tpu_torch.testing import golden
    log = FrameLog()
    frames = []
    for pos in range(0, len(data), MIB):
        raw = data[pos: pos + MIB]
        frames.append(golden.zstd_compress(raw, level=3))
        log.log_frame(len(frames[-1]), len(raw))
    return b"".join(frames) + log.serialize()


def phase_routes(archive, data, kept, card) -> dict:
    """Phase 13: Reader(device="cuda") with no decoder on the level-3,
    level-9, stock libzstd and LZ4 archives (bytes, the routes taken),
    paired rounds of the zstd routes and of the LZ4 routes, and the
    example CLI on the card."""
    import io
    import tempfile
    from libzseek_tpu_torch import Reader, example
    from libzseek_tpu_torch.ops import decode, lz4_decode, lz4_emit
    from libzseek_tpu_torch.ops import parse_linked
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    t_phase = time.perf_counter()
    sample = sample_8mib(data)
    out = {"card": card, "default_reads": {}}
    for name, arc, raw in (("level 3", archive, data),
                           ("level 9", kept["level9_archive"], data),
                           ("libzstd level 3", golden_archive(sample),
                            sample)):
        for k in ZD.routes:
            ZD.routes[k] = 0
        decode.launches = decode.transcode_launches = 0
        t0 = time.perf_counter()
        with Reader(arc, device="cuda") as r:
            check(r._codec.decoder == "auto", "the default is not 'auto'")
            hinted = r._hints is not None
            got = read_all(r)
        dt = time.perf_counter() - t0
        check(got == raw, f"the default read of the {name} archive differs")
        routes = {k: v for k, v in ZD.routes.items()
                  if k.startswith("transcode")}
        check(routes["transcode_batches"] + routes["transcode_rule_batches"]
              > 0, f"the default {name} read never tried transcode")
        out["default_reads"][name] = dict(
            mib_s=len(raw) / MIB / dt, hints=hinted, routes=routes,
            k4_launches=decode.launches,
            k4_transcode_launches=decode.transcode_launches)
        print(f"default read, {name}: {len(raw) // MIB} MiB at "
              f"{len(raw) / MIB / dt:.2f} MiB/s, hints {hinted}, routes "
              f"{routes}, K4 launches execute {decode.launches} / "
              f"transcode {decode.transcode_launches}", flush=True)
    lz4_archive = kept["lz4_archive"]
    lz4_decode.launches = 0
    t0 = time.perf_counter()
    with Reader(lz4_archive, device="cuda") as r:
        got = read_all(r)
    dt = time.perf_counter() - t0
    check(got == data, "the default read of the LZ4 archive differs")
    check(lz4_decode.launches == 0,
          f"the LZ4 host-delivery read launched the decoder "
          f"{lz4_decode.launches} times")
    out["default_reads"]["lz4"] = {"mib_s": len(data) / MIB / dt,
                                   "decoder_launches": 0}
    print(f"default read, LZ4: {len(data) // MIB} MiB at "
          f"{len(data) / MIB / dt:.2f} MiB/s, LZ4 decoder launches 0 (the "
          f"native host route)", flush=True)

    parts = {"default reads": time.perf_counter() - t_phase}

    # paired rounds in turns: AB, BA, AB (timed_read); the LZ4 card
    # route must launch the decoder in each of its rounds, the host
    # route never
    sets = (("level 3, 1000 preads", archive, 1000,
             {d: {"decoder": d} for d in ("auto", "fused")}),
            ("LZ4, 300 preads", lz4_archive, 300,
             {"host": {}, "card": {"device_cache": True}}))
    counted = {"LZ4 decoder": (lz4_decode, "launches")}
    rounds = []
    for what, arc, n, kws in sets:
        got = {k: [] for k in kws}
        for rnd in range(3):
            for k in (list(kws)[::-1] if rnd == 1 else list(kws)):
                t = timed_read(arc, data, n, counted, **kws[k])
                launched = t.pop("counts")["LZ4 decoder"] > 0
                check(arc is archive or launched == (k == "card"),
                      f"the LZ4 {k} route: decoder launched {launched}")
                got[k].append(t)
        for k, rs in got.items():
            fmt = lambda key, f: " / ".join(format(x[key], f) for x in rs)
            print(f"paired rounds ({what}), {k}: MiB/s "
                  f"{fmt('read_mib_s', '.2f')}; pread p50 "
                  f"{fmt('pread_p50_us', '.1f')} us, p99 "
                  f"{fmt('pread_p99_us', '.1f')} us ({card})", flush=True)
        rounds.append(got)
    zstd, lz4 = rounds
    out.update(zstd_rounds=zstd, lz4_rounds=lz4)
    parts["rounds"] = time.perf_counter() - t_phase - sum(parts.values())

    # the example CLI on the card, 8 MiB, in a temporary directory
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sample.bin")
        with open(path, "wb") as f:
            f.write(sample)
        for flag, mod in (("--zstd", parse_linked), ("--lz4", lz4_emit)):
            mod.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = example.main([flag, path])
            lines = buf.getvalue().strip().splitlines()
            check(rc == 0 and lines and lines[-1] == "SUCCESS",
                  f"example {flag}: {lines[-3:]}")
            check(mod.launches > 0, f"example {flag} wrote off the card")
            check(os.listdir(tmp) == ["sample.bin"],
                  f"example {flag} left {os.listdir(tmp)}")
            cli[flag[2:]] = lines[-2]
            print(f"example {flag} on the card, 8 MiB: {lines[-2]}; "
                  f"{lines[-1]}", flush=True)
    out["example"] = cli
    out["seconds"] = time.perf_counter() - t_phase
    parts["example CLI"] = out["seconds"] - sum(parts.values())
    out["parts_s"] = parts
    print(f"phase 13 in {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")",
          flush=True)
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "libzseek_tpu_torch")):
        fail("libzseek_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device visible")

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, "nvidia-smi gave no card")
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.time()
    from libzseek_tpu_torch import kernels, native
    from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
    from libzseek_tpu_torch.testing import golden
    from libzseek_tpu_torch.testing.corpus import mixed_corpus
    built = {}
    th = threading.Thread(target=lambda: built.update(
        native=(native.library(), time.time() - t0)))
    th.start()
    kernels.library()
    t_cuda = time.time() - t0
    th.join()
    check("native" in built, "native host library did not build")
    check(golden.have_zstd(), "stock libzstd not found")
    check(golden.have_lz4(), "stock liblz4 not found")
    print(f"build: native {built['native'][1]:.1f} s, CUDA kernels "
          f"{t_cuda:.1f} s (in parallel)", flush=True)
    data = mixed_corpus(np.random.default_rng(11), 64 * MIB).tobytes()

    # phase 2
    report = []
    phase_kernels(data, report)
    k4_err, k4_note = k4_small()
    print(f"K4 decode: equal to plain and to the input ({k4_note})",
          flush=True)

    # phase 3
    from libzseek_tpu_torch.ops import entropy, parse_linked, vector_entropy
    from libzseek_tpu_torch.ops import huffman_plan
    mods = {"K1 parse_linked": parse_linked, "K2 entropy_emit": entropy,
            "K3 vector_literals": vector_entropy,
            "plan zk_plan": huffman_plan}
    write_archive(data, "cuda")          # warm-up
    for m in mods.values():
        m.launches = 0
    archive, dt = write_archive(data, "cuda")
    counts = {k: m.launches for k, m in mods.items()}
    print(f"write path: 64 MiB in {dt:.3f} s = {64 / dt:.2f} MiB/s, ratio "
          f"{len(archive) / len(data):.5f} ({len(archive)} bytes); "
          f"launches {counts}", flush=True)
    for k, c in counts.items():
        check(c > 0, f"{k} never launched on the write path")
    check(counts["plan zk_plan"] == counts["K2 entropy_emit"],
          "the write path did not plan each device batch in one launch")
    for r in report:
        r["launches"] = counts[r["name"]]
    check(golden.zstd_decompress(archive) == data,
          "stock libzstd does not reproduce the input")
    print(f"level-3 archive sha256 {hashlib.sha256(archive).hexdigest()}",
          flush=True)
    table = parse_seek_table_bytes(archive)
    check(table.num_frames == 64, f"seek table has {table.num_frames} frames")
    random_reads(archive, table, data)
    print("archive: libzstd decode equal, 64 frames, 16 random 4 KiB reads "
          "equal", flush=True)

    # phase 2, K4 at full size: the archive's first 8 frames
    k4_full(report, archive, table, data, k4_err, k4_note)

    # phase 4
    cpu_archive, cpu_dt = write_archive(data[:MIB], "cpu")
    cpu_table = parse_seek_table_bytes(cpu_archive)
    check(frame_bytes(cpu_archive, cpu_table, 0) ==
          frame_bytes(archive, table, 0),
          "first frame differs between the card and the plain versions")
    print(f"first frame: card and plain (CPU, {cpu_dt:.1f} s) identical, "
          f"{table.frame_c_size(0)} bytes", flush=True)

    # phase 5
    read = phase_read(archive, data, card)
    report[-1]["launches"] = read["launches"]

    # phase 6
    kept = {}
    lz4_path = phase_lz4(data, card, report, kept)

    # phase 7
    hash_path = phase_hash(data, card, report, kept)

    # phase 8
    lane_path = phase_lanes(archive, table, data, kept, card, report)

    # phase 9
    levels_path = phase_levels(data, card, report, kept)

    # phase 10
    transcode_path = phase_transcode(archive, table, data, kept, card,
                                     report)

    # phase 11
    sort_path = phase_sort(data, card, report)

    # phase 12
    workers_path = phase_workers(data, card,
                                 hashlib.sha256(archive).hexdigest(),
                                 lz4_path["sha256"])

    # phase 13
    routes_path = phase_routes(archive, data, kept, card)

    print(json.dumps({"main_path": {"card": card, "write_mib_s": 64 / dt,
                                    "ratio": len(archive) / len(data)}}),
          flush=True)
    print(json.dumps({"read_path": read}), flush=True)
    print(json.dumps({"lz4_path": lz4_path}), flush=True)
    print(json.dumps({"hash_path": hash_path}), flush=True)
    print(json.dumps({"lane_path": lane_path}), flush=True)
    print(json.dumps({"levels_path": levels_path}), flush=True)
    print(json.dumps({"transcode_path": transcode_path}), flush=True)
    print(json.dumps({"sort_path": sort_path}), flush=True)
    print(json.dumps({"workers_path": workers_path}), flush=True)
    print(json.dumps({"routes_path": routes_path}), flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
