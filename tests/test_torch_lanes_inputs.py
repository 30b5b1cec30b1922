"""Shared inputs of the lane-route parity tests (tests/test_torch_lanes_*.py,
tests/test_torch_exec_*.py).  It holds no tests.

Every input is made with numpy from a fixed seed: archives of the port's
Writer (on the CPU) with their decode-hints sidecar, frames of stock
libzstd at levels 1 and 19 (every sequence-table mode) and Huffman
streams with hand-made 12-bit tables.  `capture_k6` runs the JAX
package's decode_frames down its lane route with the block executor
forced on (ZN_DECODE_SMEM=off, _exec_backend_is_tpu patched to True) and
records every array it hands to pallas_match.execute_blocks_smem, which
runs in interpret mode, with the kernel's output."""

import io

import numpy as np
import torch

from libzseek_tpu.ops import pallas_match as jpm
from libzseek_tpu.ops import zstd_decode as JZ
import libzseek_tpu_torch as port
from libzseek_tpu_torch.ops import exec_blocks as X
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from test_torch_cuda_inputs import (cases, damage,  # noqa: F401
                                   huffman_stream, kraft_weights,
                                   rle_frame, stock_frames)
from test_torch_decode_inputs import section_modes  # noqa: F401
from test_torch_inputs import words

KIB = 1024
# zstd_decode.routes' transcode counts, which the lane route leaves as
# they are
NO_TRANSCODE = {"transcode_batches": 0, "transcode_rule_batches": 0,
                "transcode_fallback_batches": 0}


def own_frames():
    """(frames, raws) from the port's codec on the CPU: the cases of
    tests/test_decode_smem.py (seed 91) and a text frame with 1-stream
    Huffman literals, and the hand-written RLE frame (the read-path
    tests' own_frames without its 300 KiB frame, whose plain encode takes
    half a minute)."""
    rng = np.random.default_rng(91)
    raws = list(cases(rng).values()) + [text_corpus(rng, 200).tobytes()]
    fr, raw = rle_frame()
    return (port.ZstdCodec(device="cpu").compress_frames(raws) + [fr],
            raws + [raw])


def port_archive(data: bytes, frame: int) -> bytes:
    """`data` through the port's Writer on the CPU in `frame`-byte frames
    and writes: the archive with its seek table and hints sidecar."""
    sink = io.BytesIO()
    w = port.Writer(sink, device="cpu", min_frame_size=frame)
    for pos in range(0, len(data), frame):
        w.write(data[pos: pos + frame])
    w.close()
    return sink.getvalue()


def archive_parts(archive: bytes):
    """(frames, decompressed sizes, port hints per frame) of an archive."""
    r = port.Reader(archive, device="cpu", decoder="lanes")
    n = r.seek_table.num_frames
    frames = [r._read_frame_bytes(i) for i in range(n)]
    sizes = [r.seek_table.frame_d_size(i) for i in range(n)]
    hints = r._hints or [None] * n
    r.close()
    return frames, sizes, hints


def mixed_archive():
    """(archive, data): 1 MiB of mixed_corpus (seed 11) in 256 KiB frames
    of two blocks, one frame per regime of the corpus."""
    data = mixed_corpus(np.random.default_rng(11), 1 << 20).tobytes()
    return port_archive(data, 256 * KIB), data


def words_archive():
    """(archive, data): 32 KiB of vocabulary text (seed 5) in 16 KiB
    frames of one block and ~1,200 sequences each, with compressed
    sequence tables.  Frame 0 publishes every anchor; frame 1's block uses
    rep2 or rep3, so it publishes no sequence anchors and takes the plain
    lanes.  (The plain encode walks sequences one by one: larger inputs
    take minutes on a busy CPU.)"""
    data = words(np.random.default_rng(5), 32 * KIB).tobytes()
    return port_archive(data, 16 * KIB), data


def zstd_level_frames():
    """(frames, raws): stock libzstd at levels 1 and 19 with their own
    strategies and windows, on multi-block text and mixed data, so the
    sequence sections use predefined, RLE, compressed and repeat tables."""
    rng = np.random.default_rng(17)
    raws = [text_corpus(rng, 160 * KIB).tobytes(),
            mixed_corpus(rng, 192 * KIB).tobytes(),
            (b"ab" * 3000 + text_corpus(rng, 5000).tobytes()) * 3]
    frames = [golden.zstd_compress(r, level=lv, strategy=None)
              for lv in (1, 19) for r in raws]
    return frames, raws + raws


def parse(frames, sizes=None):
    """The port's parse of `frames`: (plans, _HufReg, _FseReg)."""
    huf, fse = ZD._HufReg(), ZD._FseReg()
    sizes = sizes or [None] * len(frames)
    return [ZD._parse_frame_impl(f, huf, fse, s)
            for f, s in zip(frames, sizes)], huf, fse


def jax_huf_tables(hufreg) -> np.ndarray:
    """The reference's host peek tables (_HufReg.packed) for the port
    registry's weights, in its table order."""
    jr = JZ._HufReg()
    for w in hufreg.weights:
        jr.add(w)
    return jr.packed()


def blocks_per_frame(frames, sizes):
    plans, _, _ = parse(frames, sizes)
    return [len(p.blocks) for p in plans]


def capture_k6(monkeypatch, frames, sizes, hints=None):
    """The JAX decode_frames down its lane route with K6 forced: (its
    per-frame results, [(args, out) per execute_blocks_smem call] as
    numpy)."""
    monkeypatch.setenv("ZN_DECODE_SMEM", "off")
    monkeypatch.setattr(JZ, "_exec_backend_is_tpu", lambda: True)
    calls = []
    real = jpm.execute_blocks_smem

    def spy(*args, **kw):
        out = real(*args, **dict(kw, interpret=True))
        calls.append(([np.asarray(a) for a in args], np.asarray(out)))
        return out

    monkeypatch.setattr(jpm, "execute_blocks_smem", spy)
    return JZ.decode_frames(frames, sizes, hints), calls


def port_k6_on_rows(args, per_frame, sizes):
    """The port's plain K6 fed the reference's rows (its padding rows cut
    off) with the chain of `per_frame` blocks a frame: (out, ok,
    frame_off)."""
    lit_words, ll, ml, off, meta = args
    BL = sum(per_frame)
    chain = np.concatenate([[0], np.cumsum(per_frame)]).astype(np.int32)
    frame_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out, ok = X.execute_blocks(
        t(lit_words[:BL].astype("<i4").view(np.uint8)), t(ll[:BL]),
        t(ml[:BL]), t(off[:BL]), t(meta[:BL]), t(chain), t(frame_off),
        int(frame_off[-1]))
    return out.numpy(), ok.numpy(), frame_off


def check_rows(args, ref_out, per_frame, sizes) -> int:
    """Plain K6 on the reference's rows: ok everywhere, and each block's
    first `content` bytes equal to the Pallas kernel's row.  Returns the
    number of blocks compared."""
    out, ok, frame_off = port_k6_on_rows(args, per_frame, sizes)
    meta = args[4]
    assert ok.all(), np.nonzero(ok == 0)
    r = 0
    for f, nb in enumerate(per_frame):
        for _ in range(nb):
            n_seq, content, d_off = (int(v) for v in meta[r])
            a = int(frame_off[f]) + d_off
            want = ref_out[r].astype("<i4").tobytes()[:content]
            assert out[a: a + content].tobytes() == want, (f, r)
            r += 1
    return r
