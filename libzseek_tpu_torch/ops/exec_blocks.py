"""K6: the block executor of the lane decode route.

Counterpart of libzseek_tpu/ops/pallas_match.py execute_blocks_smem
(:1066), which runs the Pallas kernel _exec_kernel_smem (:954, the
pallas_call at :1090).  The CUDA kernel is csrc/exec_blocks.cu; the plain
version below runs only for tensors on the CPU.

Each block's decoded sequences are executed in order: ll literal bytes
from the block's row of the literal plane, then ml bytes copied from off
bytes back (overlapping copies repeat the last off bytes); a trailing
literals-only pseudo-sequence (ml 0) carries the block's tail.  Inputs
keep the reference's row contract: lit (BL, LW) uint8 (the reference's
int32 literal words viewed as bytes), ll / ml / off (BL, S) int32 (raw
distances) and meta (BL, 3) int32 = (n_seq, content, d_off), the block's
byte offset in its frame; plus the chain layout of K4 (ops/decode.py):
chain (F + 1,) int32, frame f owning rows [chain[f], chain[f + 1]) in
order, and frame_off (F + 1,) int64, its bytes in one flat uint8 output.

The TPU runs its grid in order and carries a 256 KiB ring of the frame's
recent output from block to block.  Here every byte lands at its place
in one flat output, frame_off[f] + d_off: no ring, and a block's row of
the reference's (BL, 32768) output words is the flat output's
[frame_off[f] + d_off, + content).  A match that reaches before its
frame's first byte, or a sequence that leaves the block's literal row or
its content, sets ok = 0 (the reference would read stale ring bytes);
the rest of that frame's chain is skipped.  The CUDA kernel runs in
phases (csrc/exec_blocks.cu): per-row checks on prefix sums, the chain's
verdicts a thread a frame, a scatter of literal bytes and match sources,
pointer doubling; a frame whose rows do not tile it in order goes to the
one-warp serial walk, and `serial_frames()` counts them.  row_checks,
frame_verdicts and exec_mirror below are numpy mirrors of those phases,
used only by tests.

Returns (out (frame_off[-1],) uint8, ok (BL,) int32).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError

launches = 0
_count = threading.Lock()     # the Reader decodes from two threads
_serial = {}                  # device -> int32 count of serial-arm frames
RI_W = 8                      # int32 a row of the kernel's row summary
NO_FAIL = 0x7FFFFFFF


def match_bound(ml, chain) -> int:
    """The most sequences with ml > 0 in one frame, from host arrays (ml
    (BL, S), chain (F + 1,)).  A match byte's source lies before its
    sequence's match (folded back where off < ml), so a chain of sources
    steps through at most this many matches of its frame: it bounds the
    pointer-doubling rounds."""
    per_row = np.concatenate([[0], np.cumsum((np.asarray(ml) > 0).sum(1))])
    ch = np.asarray(chain)
    return int((per_row[ch[1:]] - per_row[ch[:-1]]).max()) if len(ch) > 1 \
        else 0


def execute_blocks(lit, ll, ml, off, meta, chain, frame_off, out_size: int,
                   max_matches: int | None = None):
    """Execute BL blocks of sequences in F frame chains; see the module
    docstring.  `out_size` is frame_off[-1] and `max_matches`, where the
    caller holds the rows on the host, is match_bound(ml, chain): both
    known without a sync.  The CUDA kernel runs ceil(log2) of it doubling
    rounds (of out_size where it is None; none where it is 0); the plain
    version ignores it."""
    BL, LW = lit.shape
    S = ll.shape[1]
    F = chain.shape[0] - 1
    dev = lit.device
    for name, t, dt, shape in (
            ("ll", ll, torch.int32, (BL, S)),
            ("ml", ml, torch.int32, (BL, S)),
            ("off", off, torch.int32, (BL, S)),
            ("meta", meta, torch.int32, (BL, 3)),
            ("chain", chain, torch.int32, (F + 1,)),
            ("frame_off", frame_off, torch.int64, (F + 1,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ParameterError(f"K6: {name} must be a contiguous {dt} "
                                 f"{shape} tensor on {dev}")
    if lit.dtype != torch.uint8 or not lit.is_contiguous():
        raise ParameterError("K6: lit must be contiguous uint8")
    if dev.type == "cpu":
        return _exec_plain(lit, ll, ml, off, meta, chain, frame_off,
                           out_size)
    if dev.type != "cuda":
        raise ParameterError(f"K6 runs on cuda or cpu tensors, not {dev}")
    return _exec_cuda(lit, ll, ml, off, meta, chain, frame_off, out_size,
                      out_size if max_matches is None else max_matches)


def _serial_counter(dev):
    """The device's running count of frames sent to the serial arm."""
    with _count:
        t = _serial.get(dev)
        if t is None:
            t = _serial[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
        return t


def serial_frames() -> int:
    """Frames the CUDA kernel has run on its serial arm (rows that do not
    tile their frame), summed over devices; reading it synchronises."""
    with _count:
        return sum(int(t.item()) for t in _serial.values())


def _exec_cuda(lit, ll, ml, off, meta, chain, frame_off, out_size, bound):
    """The phased kernels of csrc/exec_blocks.cu on the rows' device."""
    global launches
    from libzseek_tpu_torch import kernels
    BL, LW = lit.shape
    S = ll.shape[1]
    F = chain.shape[0] - 1
    dev = lit.device
    if out_size >= 1 << 31:
        raise ParameterError("K6: the output must stay below 2^31 bytes")
    rounds = int(bound).bit_length()
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    ok = torch.zeros(BL, dtype=torch.int32, device=dev)
    if F:
        # one int32 scratch: cum, lpos (BL, S), rinfo (BL, RI_W), serial
        # (F), changed (rounds); srcs (out_size) only if any match
        sizes = [BL * S, BL * S, BL * RI_W, F, rounds]
        scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
        ptr = [scratch.data_ptr() + 4 * int(v)
               for v in np.cumsum([0] + sizes[:-1])]
        srcs = torch.empty(out_size if rounds else 0, dtype=torch.int32,
                           device=dev)
        kernels.launch(
            "zk_exec_blocks", dev, lit.data_ptr(), ll.data_ptr(),
            ml.data_ptr(), off.data_ptr(), meta.data_ptr(), chain.data_ptr(),
            frame_off.data_ptr(), LW, S, F, BL, out_size, rounds,
            out.data_ptr(), ok.data_ptr(), *ptr[:4],
            srcs.data_ptr() if rounds else None, ptr[4],
            _serial_counter(dev).data_ptr())
        with _count:
            launches += 1
    return out, ok


def _exec_plain(lit, ll, ml, off, meta, chain, frame_off, out_size):
    lit_np = lit.numpy()
    lla, mla, offa = ll.numpy(), ml.numpy(), off.numpy()
    mt = meta.numpy()
    ch = chain.numpy()
    fo = frame_off.numpy()
    LW = lit_np.shape[1]
    S = lla.shape[1]
    out = np.zeros(out_size, np.uint8)
    ok = np.zeros(mt.shape[0], np.int32)
    for f in range(len(ch) - 1):
        fout = out[int(fo[f]): int(fo[f + 1])]
        for r in range(int(ch[f]), int(ch[f + 1])):
            n_seq, content, d_off = (int(v) for v in mt[r])
            end = d_off + content
            good = 0 <= n_seq <= S and d_off >= 0 and content >= 0 and \
                end <= len(fout)
            op, lp = d_off, 0
            row = lit_np[r]
            for j in range(n_seq if good else 0):
                a, m, o = int(lla[r, j]), int(mla[r, j]), int(offa[r, j])
                if a < 0 or m < 0 or lp + a > LW or op + a + m > end or \
                        (m > 0 and not 1 <= o <= op + a):
                    good = False
                    break
                fout[op: op + a] = row[lp: lp + a]
                d = op + a
                if o >= m:
                    fout[d: d + m] = fout[d - o: d - o + m]
                elif m:
                    fout[d: d + m] = np.resize(fout[d - o: d], m)
                op, lp = d + m, lp + a
            if good and op != end:
                good = False
            ok[r] = int(good)
            if not good:
                break
    return torch.from_numpy(out), torch.from_numpy(ok)


# --------------------------------------------------------------------
# the CUDA kernel's phases, mirrored in numpy (used only by tests)


def row_checks(lit_w: int, ll, ml, off, meta):
    """Phase 1 for every row: (hdr, fail, sum_ok, cum, lpos) lists.  hdr:
    n_seq, content and d_off in range; fail: the first sequence the
    serial walk rejects (NO_FAIL if none), from the prefix sums alone;
    sum_ok: the sequences' bytes add up to content; cum[j]: the output
    bytes of sequences 0..j, lpos[j]: the literals before j (row-relative,
    exact up to the first failure)."""
    S = ll.shape[1]
    res = []
    for r in range(meta.shape[0]):
        n_seq, content, d_off = (int(v) for v in meta[r])
        if not (0 <= n_seq <= S and d_off >= 0 and content >= 0):
            res.append((False, 0, False, None, None))
            continue
        a = ll[r, :n_seq].astype(np.int64)
        m = ml[r, :n_seq].astype(np.int64)
        o = off[r, :n_seq].astype(np.int64)
        cum = np.cumsum(a + m)
        lpos = np.cumsum(a) - a
        op = d_off + cum - a - m
        bad = (a < 0) | (m < 0) | (lpos + a > lit_w) | \
            (op + a + m > d_off + content) | \
            ((m > 0) & ((o < 1) | (o > op + a)))
        fail = int(np.argmax(bad)) if bad.any() else NO_FAIL
        total = int(cum[-1]) if n_seq else 0
        res.append((True, fail, total == content, cum, lpos))
    return res


def frame_verdicts(meta, chain, frame_off, rows):
    """Phase 2, a frame at a time in chain order: (ok (BL,) int32,
    {row: sequences executed}, frames that do not tile in order).  The
    failing row executes its sequences before the failure, later rows
    nothing; a frame tiles when every executed row starts at or after the
    end (d_off + content) of the one before."""
    ok = np.zeros(meta.shape[0], np.int32)
    nexec, serial = {}, []
    for f in range(len(chain) - 1):
        fsize = int(frame_off[f + 1]) - int(frame_off[f])
        dead, tiles, prev_end, mine = False, True, 0, {}
        for r in range(int(chain[f]), int(chain[f + 1])):
            if dead:
                continue
            n_seq, content, d_off = (int(v) for v in meta[r])
            hdr, fail, sum_ok, _, _ = rows[r]
            if not hdr or d_off + content > fsize:
                dead = True
                continue
            tiles &= d_off >= prev_end
            prev_end = d_off + content
            mine[r] = n_seq if fail == NO_FAIL else fail
            ok[r] = int(fail == NO_FAIL and sum_ok)
            dead = not ok[r]
        if tiles:
            nexec.update(mine)
        else:
            serial.append(f)
    return ok, nexec, serial


def exec_mirror(lit, ll, ml, off, meta, chain, frame_off, out_size):
    """The CUDA kernel's phases on CPU tensors: the checks, the verdicts,
    the scatter (literal bytes; each match byte's source, folded back
    before the match start where off < ml), pointer doubling to a fixed
    point, and the serial walk for frames that do not tile.  Returns
    (out, ok, number of serial frames)."""
    lit_np, lla, mla, offa = lit.numpy(), ll.numpy(), ml.numpy(), off.numpy()
    mt, ch, fo = meta.numpy(), chain.numpy(), frame_off.numpy()
    rows = row_checks(lit_np.shape[1], lla, mla, offa, mt)
    ok, nexec, serial = frame_verdicts(mt, ch, fo, rows)
    out = np.zeros(out_size, np.uint8)
    srcs = np.full(out_size, -1, np.int64)
    frame_of = {r: f for f in range(len(ch) - 1)
                for r in range(int(ch[f]), int(ch[f + 1]))}
    for r, nx in nexec.items():
        _, _, _, cum, lpos = rows[r]
        base = int(fo[frame_of[r]]) + int(mt[r, 2])
        for j in range(nx):
            a, m, o = int(lla[r, j]), int(mla[r, j]), int(offa[r, j])
            d = base + int(cum[j]) - a - m
            lp = int(lpos[j])
            out[d: d + a] = lit_np[r, lp: lp + a]
            k = np.arange(m)
            srcs[d + a: d + a + m] = d + a - o + (k % o if o < m else k)
    while True:                 # pointer doubling to a fixed point
        idx = np.nonzero(srcs >= 0)[0]
        up = srcs[srcs[idx]] >= 0
        if not up.any():
            break
        srcs[idx[up]] = srcs[srcs[idx[up]]]
    cp = srcs >= 0
    out[cp] = out[srcs[cp]]
    for f in serial:            # the serial walk, a frame at a time
        a, b = int(fo[f]), int(fo[f + 1])
        sub, _ = _exec_plain(
            lit, ll, ml, off, meta,
            torch.from_numpy(ch[f: f + 2].astype(np.int32)),
            torch.from_numpy(np.array([0, b - a], np.int64)), b - a)
        out[a: b] = sub.numpy()
    return torch.from_numpy(out), torch.from_numpy(ok), len(serial)
