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
recent output from block to block.  Here one warp walks each frame's
blocks in order and writes straight into the output at frame_off[f] +
d_off, reading match sources from the output already written: no ring,
and a block's row of the reference's (BL, 32768) output words is the
flat output's [frame_off[f] + d_off, + content).  A match that reaches
before its frame's first byte, or a sequence that leaves the block's
literal row or its content, sets ok = 0 (the reference would read stale
ring bytes); the rest of that frame's chain is skipped.

Returns (out (frame_off[-1],) uint8, ok (BL,) int32).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.errors import ParameterError

launches = 0
_count = threading.Lock()     # the Reader decodes from two threads


def execute_blocks(lit, ll, ml, off, meta, chain, frame_off, out_size: int):
    """Execute BL blocks of sequences in F frame chains; see the module
    docstring.  `out_size` is frame_off[-1] (known without a sync)."""
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
    global launches
    from libzseek_tpu_torch import kernels
    lib = kernels.library()
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    ok = torch.zeros(BL, dtype=torch.int32, device=dev)
    if F:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zk_exec_blocks(lit.data_ptr(), ll.data_ptr(), ml.data_ptr(),
                                 off.data_ptr(), meta.data_ptr(),
                                 chain.data_ptr(), frame_off.data_ptr(), LW,
                                 S, F, out.data_ptr(), ok.data_ptr(), stream)
        kernels.check(err, "zk_exec_blocks")
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
