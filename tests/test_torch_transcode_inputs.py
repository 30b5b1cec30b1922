"""Shared inputs of the transcode-route parity tests
(tests/test_torch_transcode_*.py).  It holds no tests.

`capture_transcode` runs the JAX package's decode_frames with its fused
decode forced (interpret mode) and its transcode route on
(ZN_DECODE_TRANSCODE=auto, ZN_HOSTLIT on or off), and records every array
_try_decode_transcode hands to pallas_decode.decode_blocks_smem, with the
kernel's outputs.  That route returns None without the JAX native runtime
and the reference then decodes through its execute arm, so it builds the
runtime first and asserts that every captured row carries
DMODE_TRANSCODE (unless asked to let the reference leave the route, as
it does for a batch it refuses).  Frames come from the port's codec (on
the CPU), the JAX codec (its hints too) and stock libzstd, all made with
numpy seeds."""

import numpy as np
import torch

from libzseek_tpu import native as jax_native
from libzseek_tpu.format import hints as jax_hints
from libzseek_tpu.ops import pallas_decode as jpd
from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JaxZstdCodec
from libzseek_tpu_torch.format import hints as port_hints
from libzseek_tpu_torch.ops import decode as D
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch.format import zstd_frame as zf
from test_torch_cuda_inputs import (cases, multiblock,  # noqa: F401
                                   repeated_text)
from test_torch_inputs import build_native_runtime
from test_torch_lanes_inputs import own_frames, stock_frames  # noqa: F401

KIB = 1024


def capture_transcode(monkeypatch, frames, sizes, hints=None,
                      host_literals=True, chunk=None, fallback=False):
    """JAX decode_frames down its transcode route: (its per-frame results,
    [(args, (out, stat)) per decode_blocks_smem call] as numpy).  With
    fallback=True the reference may leave the route for its fused
    decode (the calls then hold its execute-arm rows too, in order)."""
    build_native_runtime()
    assert jax_native.have_native(), "the JAX native runtime did not build"
    monkeypatch.setenv("ZN_DECODE_SMEM", "force")
    monkeypatch.setenv("ZN_DECODE_TRANSCODE", "auto")
    monkeypatch.setenv("ZN_HOSTLIT", "on" if host_literals else "off")
    if chunk is None:
        monkeypatch.delenv("ZN_DECODE_CHUNK", raising=False)
    else:
        monkeypatch.setenv("ZN_DECODE_CHUNK", str(chunk))
    calls = []
    real = jpd.decode_blocks_smem

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(([np.asarray(a) for a in args],
                      tuple(np.asarray(o) for o in out)))
        return out

    monkeypatch.setattr(jpd, "decode_blocks_smem", spy)
    res = JZ.decode_frames(frames, sizes, hints)
    for args, _ in calls:
        assert fallback or (args[4][:, 0] & jpd.DMODE_TRANSCODE).all(), \
            "the reference decoded through its execute arm"
    return res, calls


def _dev_lit(meta) -> np.ndarray:
    """Rows whose literals the kernel emits."""
    mode = meta[:, 0]
    return ((mode & (D.DMODE_HUF4 | D.DMODE_HUF1)) != 0) | (
        ((mode & D.DMODE_DIRECT) != 0) & ((mode & D.DMODE_LIT_HOST) == 0))


def _prefix(w) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(w)]).astype(np.int32)


def port_args(args):
    """The reference's rows as the port's transcode arm takes them:
    unchanged, chains split at DMODE_FRAME_START, and without the literal
    payload and peek tables when no row's literals are on the device, as
    the route sends them.  Returns transcode_blocks' positional
    arguments (CPU tensors)."""
    lp, sq, dtabs, ftabs, meta = (np.array(a, np.int32) for a in args)
    B = len(meta)
    litw = np.where(_dev_lit(meta), (meta[:, 3] + 3) >> 2, 0)
    lpre, tpre = _prefix(litw), _prefix(2 * meta[:, 13])
    chain = np.append(np.nonzero(meta[:, 0] & D.DMODE_FRAME_START)[0],
                      B).astype(np.int32)
    t = torch.from_numpy
    lp, dtabs = (t(lp), t(dtabs)) if _dev_lit(meta).any() else (None, None)
    return (lp, t(sq), dtabs, t(ftabs), t(meta), t(chain), t(lpre),
            t(tpre), int(lpre[-1]), int(tpre[-1]))


def port_on_rows(args, transcode=D.transcode_blocks):
    """`transcode` (the port's plain transcode arm, or its mirror) on the
    reference's rows (port_args): (lits, toks, stat, literal word prefix,
    token word prefix, literal words per row)."""
    a = port_args(args)
    meta = a[4].numpy()
    litw = np.where(_dev_lit(meta), (meta[:, 3] + 3) >> 2, 0)
    lits, toks, stat = transcode(*a)
    return (lits.numpy(), toks.numpy(), stat.numpy(), a[6].numpy(),
            a[7].numpy(), litw)


def check_rows(calls, transcode=D.transcode_blocks) -> int:
    """`transcode` (plain by default) on each captured call: stat, every
    token word and every literal word equal to the reference's row output
    (tolerance: none), but for the bytes past regen in a Huffman row's
    last literal word, which no reader of the literals touches (the
    reference leaves there its int32-minimum fill in interpret mode for a
    1-stream row and compaction leftovers for a 4-stream row; the port
    zeros).  Returns the rows compared."""
    rows = 0
    for args, (out_w, stat) in calls:
        meta = args[4]
        lits, toks, pstat, lpre, tpre, litw = port_on_rows(args, transcode)
        np.testing.assert_array_equal(pstat, stat)
        for r in range(len(meta)):
            lw, nt = int(litw[r]), 2 * int(meta[r, 13])
            np.testing.assert_array_equal(
                toks[tpre[r]: tpre[r] + nt], out_w[r, lw: lw + nt],
                err_msg=f"tokens of row {r}")
            ours = lits[lpre[r]: lpre[r] + lw].copy()
            theirs = out_w[r, :lw].copy()
            spare = 4 * lw - int(meta[r, 3])
            if meta[r, 0] & (D.DMODE_HUF1 | D.DMODE_HUF4) and spare:
                keep = np.int32((1 << (32 - 8 * spare)) - 1)
                ours[-1] &= keep
                theirs[-1] &= keep
            np.testing.assert_array_equal(ours, theirs,
                                          err_msg=f"literal words of row {r}")
            rows += 1
    return rows


def port_rows(frames, sizes, hints=None, host_literals=True):
    """The port's parse and transcode row builder on `frames`: (rows,
    the Huffman tables' device-built peek tables indexed by row)."""
    hufreg, fsereg = ZD._HufReg(), ZD._FseReg()
    plans = [ZD._parse_frame_impl(f, hufreg, fsereg, s)
             for f, s in zip(frames, sizes)]
    rows = ZD.transcode_rows(plans, hints or [None] * len(plans), fsereg,
                             host_literals)
    W, TLS = hufreg.weights_arr()
    dtabs = ZD.build_dtabs(torch.from_numpy(W), torch.from_numpy(TLS))
    return rows, dtabs.numpy()[rows["wtid"]]


def transcode_args(frames, sizes, hints=None, host_literals=True):
    """The positional arguments of ops/decode.transcode_blocks (CPU
    tensors) for `frames` as the port's transcode route builds them."""
    rows, dtabs = port_rows(frames, sizes, hints, host_literals)
    t = torch.from_numpy
    dev = np.array([d for _, d in rows["blocks"]], bool)
    lp, dt = ((t(rows["lp"]), t(np.ascontiguousarray(dtabs)))
              if dev.any() else (None, None))
    return (lp, t(rows["sq"]), dt, t(rows["ftabs"]), t(rows["meta"]),
            t(rows["chain"]), t(rows["lit_prefix"]), t(rows["tok_prefix"]),
            int(rows["lit_prefix"][-1]), int(rows["tok_prefix"][-1]))


def check_builder(calls, rows, dtabs) -> None:
    """The port's rows equal the reference's, concatenated over its
    chunks: meta, FSE tables, the payload words (each side zero past its
    own width) and, for rows whose literals go to the device, the peek
    tables."""
    ref = [np.concatenate([np.asarray(a[k], np.int32) for a, _ in calls])
           if k in (2, 3, 4) else None for k in range(5)]
    np.testing.assert_array_equal(rows["meta"], ref[4])
    np.testing.assert_array_equal(rows["ftabs"], ref[3])
    dev = _dev_lit(ref[4])
    np.testing.assert_array_equal(dtabs[dev], ref[2][dev])
    for k, name in ((0, "lp"), (1, "sq")):
        width = max(rows[name].shape[1], max(a[k].shape[1] for a, _ in calls))
        ours = np.zeros((len(ref[4]), width), np.int32)
        ours[:, : rows[name].shape[1]] = rows[name]
        theirs = np.concatenate([
            np.pad(np.asarray(a[k], np.int32),
                   ((0, 0), (0, width - a[k].shape[1]))) for a, _ in calls])
        np.testing.assert_array_equal(ours, theirs, err_msg=name)


def jax_frames(raws):
    """(frames, JAX hints per frame, the same hints parsed by the port)
    from the JAX codec on the CPU (its default parser)."""
    frames, fh = JaxZstdCodec().compress_frames(raws, return_hints=True)
    ph = port_hints.parse(jax_hints.serialize(fh), 0)
    assert ph is not None and len(ph) == len(frames)
    return frames, fh, ph


def large_frame():
    """768 KiB of mixed_corpus (seed 91) in one frame of six 128 KiB
    blocks (test_decode_smem.py:101)."""
    return mixed_corpus(np.random.default_rng(91), 768 * KIB).tobytes()


def chain_frames(rng):
    """(frames, raws): repeated_text by the JAX codec and by stock libzstd
    at levels 3 and 19, three frames of three blocks."""
    raw = repeated_text(rng)
    frames, _, _ = jax_frames([raw])
    frames += [golden.zstd_compress(raw, level=lv) for lv in (3, 19)]
    return frames, [raw] * 3


def golden_batch(rng):
    """Two multi-block texts for stock libzstd (test_decode_smem.py:77)."""
    return [(text_corpus(rng, 150 * KIB).tobytes() + bytes(100 * KIB)
             + rng.integers(0, 256, 80 * KIB, np.uint8).tobytes()),
            text_corpus(rng, 200 * KIB).tobytes()]


def far_offset_frame():
    """A frame written by hand: one compressed block of 10 RLE literals
    ("q") and one sequence with RLE tables (LL code 10, OF code 29, ML
    code 17), whose offset 2^29 - 3 the token's 28 bits cannot hold (and
    which reaches far before the frame): 30 bytes declared."""
    lits = bytes([(10 << 3) | zf.LIT_RLE]) + b"q"
    # one sequence; LL, OF, ML all RLE; their symbols; then the stream:
    # 29 zero offset bits and the sentinel above them
    seqs = bytes([1, 0b01010100, 10, 29, 17]) + (1 << 29).to_bytes(4, "little")
    body = lits + seqs
    return (zf.build_frame_header(30)
            + zf.build_block_header(zf.BLOCK_COMPRESSED, len(body), True)
            + body)
