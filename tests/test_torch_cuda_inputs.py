"""Inputs of the port's on-card kernel tests (tests/test_torch_cuda*.py),
and the frames of the read-path tests (tests/test_torch_decode*.py).  It
holds no tests.

Imports no jax: those tests run on the GPU machine with --noconftest."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import fse_plan as fpl
from libzseek_tpu_torch.ops import huffman_plan as hp
from libzseek_tpu_torch.ops import vector_entropy as VE
from libzseek_tpu_torch.ops.zstd_encode import zstd_sequences_linked

N = VE.N_BLOCK
S = 8192
LIT_CAP = (N + 64 + 127) // 128 * 128
SEQ_CAP = (9 * S + 64 + 127) // 128 * 128


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def mixed_batch():
    """8 blocks, one from every 1 MiB of a 8 MiB mixed corpus (all four
    regimes), in frames of two blocks; the chain up to the entropy
    stage, run with the plain versions."""
    data = mixed_corpus(np.random.default_rng(4), 8 << 20)
    B = 8
    x2 = np.zeros((B + 1, N), np.uint8)
    for i in range(B):
        x2[i + 1] = data[i << 20: (i << 20) + N]
    lens = np.full(B, N, np.int32)
    i = np.arange(B)
    min_abs = np.where(i % 2 == 0, (i + 1) * N, i * N).astype(np.int32)
    t = torch.from_numpy
    seqs = zstd_sequences_linked(t(x2), t(lens), t(min_abs))
    _m, mb, codes, _w, _r, sizes4 = hp.plan_blocks(
        seqs["hist"], seqs["lit_count"], seqs["n_seq"], seqs["const"],
        t(lens), mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
        mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ,
        hist_q=seqs["hist_q"])
    sflags, ctabs, *_ = fpl.plan_seq_tables(seqs["ll"], seqs["ml"],
                                            seqs["offv"], seqs["n_seq"])
    mb = mb | torch.where((mb & E.MODE_SEQ) != 0, sflags,
                          torch.zeros_like(sflags))
    meta = torch.cat([torch.stack([t(lens), seqs["lit_count"],
                                   seqs["n_seq"], mb], 1), sizes4], 1)
    return x2, lens, min_abs, seqs, meta, codes, ctabs


def same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


def cases(rng, n=24 * 1024):
    return {
        "text": text_corpus(rng, n).tobytes(),
        "periodic": (rng.integers(0, 256, 337, np.uint8).tobytes()
                     * (n // 337 + 1))[:n],
        "zeros": bytes(n),
        "noise": rng.integers(0, 256, n, np.uint8).tobytes(),
        "tiny": b"abcabcabcabc",
        "one": b"x",
        "empty": b"",
    }


def multiblock(rng):
    """300 KiB in one frame, three blocks with cross-block matches and
    repcodes (test_decode_smem.py:55-64)."""
    raw = mixed_corpus(rng, 300 * 1024).tobytes()
    return (raw[:150 * 1024] + raw[:100 * 1024] + raw[150 * 1024:])[:300 * 1024]


def rle_frame():
    """A frame written by hand: one compressed block of RLE literals
    ("q" x 100) and ten sequences with RLE tables (LL code 10, OF code 0 =
    repcode 1, ML code 17), whose stream holds the sentinel bit alone;
    300 bytes of "q"."""
    n_lit = 100
    lits = bytes([((n_lit & 0xF) << 4) | (0b01 << 2) | zf.LIT_RLE,
                  n_lit >> 4]) + b"q"
    seqs = bytes([10, 0b01010100, 10, 0, 17, 0x01])
    body = lits + seqs
    return (zf.build_frame_header(300)
            + zf.build_block_header(zf.BLOCK_COMPRESSED, len(body), True)
            + body), b"q" * 300


def own_frames(device="cpu"):
    """(frames, raws) from the port's codec on `device`: the seven cases,
    a text frame with 1-stream Huffman literals and the 3-block frame;
    and the hand-written RLE frame."""
    rng = np.random.default_rng(91)
    raws = list(cases(rng).values())
    raws.append(text_corpus(rng, 200).tobytes())
    raws.append(multiblock(rng))
    frames = ZstdCodec(device=device).compress_frames(raws)
    fr, raw = rle_frame()
    return frames + [fr], raws + [raw]


def stock_frames():
    """(frames, raws) from stock libzstd at levels 1, 3 and 19, plus a
    long-window level-19 frame with a match ~400 KiB back
    (test_decode_smem.py:116-123)."""
    rng = np.random.default_rng(91)
    vals = [v for v in cases(rng).values() if v]
    frames, raws = [], []
    for level in (1, 3, 19):
        frames += [golden.zstd_compress(v, level=level) for v in vals]
        raws += vals
    blk = rng.integers(0, 256, 400 * 1024, np.uint8).tobytes()
    raws.append(blk + bytes(16) + blk)
    frames.append(golden.zstd_compress(raws[-1], level=19, strategy=None))
    return frames, raws


def leftover_bits_frame():
    """rle_frame with one zero byte below its sequence stream: the walk
    ends 8 bits above the stream's start."""
    fr, raw = rle_frame()
    hs = zf.parse_frame_header(fr, 0).header_size
    _, bsize, _ = zf.parse_block_header(fr, hs)
    body = fr[hs + 3:]
    body = body[:-1] + b"\x00" + body[-1:]
    return (fr[:hs] + zf.build_block_header(zf.BLOCK_COMPRESSED, bsize + 1,
                                            True) + body), raw


def record_lane_calls(monkeypatch, frames, sizes, hints, device):
    """The lane route (decode_frames_lanes) on `device` with every call of
    its three kernel wrappers recorded: (its result, [(wrapper, args,
    kwargs, outputs)])."""
    from libzseek_tpu_torch.ops import exec_blocks, lanes
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    calls = []
    for mod, name in ((lanes, "huf_lanes"), (lanes, "seq_lanes"),
                      (exec_blocks, "execute_blocks")):
        real = getattr(mod, name)

        def spy(*a, _real=real, **kw):
            out = _real(*a, **kw)
            calls.append((_real, a, kw, out))
            return out
        monkeypatch.setattr(mod, name, spy)
    res = ZD.decode_frames_lanes(frames, sizes, hints, device=device)
    monkeypatch.undo()
    return res, calls


def replay_on_cpu(calls):
    """Each recorded call again with its tensors on the CPU (the plain
    versions); asserts equal outputs and returns the number of calls."""
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
    for fn, a, kw, out in calls:
        ref = fn(*[cpu(v) for v in a], **{k: cpu(v) for k, v in kw.items()})
        for x, y in zip(out, ref):
            np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    return len(calls)


def words(rng, n):
    """Vocabulary text: hundreds of short matches per 16 KiB."""
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), np.uint8))
             for _ in range(300)]
    out = b" ".join(vocab[int(i)] for i in rng.zipf(1.3, n // 3) % 300)
    return np.frombuffer(out[:n], np.uint8)


# crafted rows of arms_rows: where the lazy probe's match starts (level
# 4: one step; levels >= 9: two) and where the rep probe must win
LAZY_AT = {1: (201, 141, 11), 2: (202, 102, 34)}   # start, dist, min len
REP_AT = (400, 100, 64)


def arms_rows():
    """Four fenced 16 KiB rows, (x2, lens, min_abs), that each take one
    of K1's level >= 4 arms:
    row 0 (noise, non-strict): "ABCDE..." at 200 has a 5-byte short-table
    match at 20, a longer one from 201 at 60 ("BCDEFGHIJKL") and a longer
    one still from 202 at 100, so lazy step 1, then step 2, wins;
    row 1 (vocabulary text, strict): 5-7-byte matches that only the dual
    short half with 4-byte confirmation (short4) keeps;
    row 2 (noise): V at 300 and again at 400 with the repcode distance 100
    (set by W at 280 and 380), while the tables' newest entries for V's
    first bytes are a 12-byte copy at 366: only the rep probe finds the
    64-byte match, even with the lazy steps;
    row 3: period-337 repeats with a changed byte every ~50 bytes."""
    N, B = 16384, 4
    rng = np.random.default_rng(4242)
    x2 = np.zeros((B + 1, N), np.uint8)
    x2[1] = rng.integers(0, 256, N, np.uint8)
    alpha = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", np.uint8)
    row = x2[1]
    row[20: 25] = alpha[:5]
    row[60: 71] = alpha[1:12]
    row[100: 100 + len(alpha) - 2] = alpha[2:]
    row[200: 200 + len(alpha)] = alpha
    # bytes before each source differ from the byte before its copy, so
    # the backward extension does not move the starts
    row[59], row[99], row[19] = ord("#"), ord("#"), ord("#")
    x2[2] = words(rng, N)
    row = x2[3]
    row[:] = rng.integers(0, 256, N, np.uint8)
    W = rng.integers(0, 256, 16, np.uint8)
    V = rng.integers(0, 256, 64, np.uint8)
    row[280: 296], row[380: 396] = W, W
    row[300: 364], row[400: 464] = V, V
    row[366: 378] = V[:12]
    row[299], row[399] = 1, 2
    row[279], row[379] = 3, 4
    row[365], row[378] = 5, 6
    per = rng.integers(0, 256, 337, np.uint8)
    x2[4] = np.tile(per, N // 337 + 1)[:N]
    for p in range(400, N, 50):
        x2[4, p + int(rng.integers(0, 50)) - 25] ^= 0x55
    lens = np.full(B, N, np.int32)
    min_abs = ((np.arange(B) + 1) * N).astype(np.int32)
    return x2, lens, min_abs


def _ext(n):
    """LZ4 length extension bytes for a length field value n >= 15."""
    n -= 15
    return bytes([255] * (n // 255) + [n % 255])


def seq_block(seqs, tail: bytes = b"") -> bytes:
    """A raw LZ4 block from (literals, offset, match length) sequences
    and the last literals, written as liblz4 writes them."""
    out = bytearray()
    for lit, off, ml in seqs:
        ll, m = len(lit), ml - 4
        out.append(min(ll, 15) << 4 | min(m, 15))
        if ll >= 15:
            out += _ext(ll)
        out += lit + off.to_bytes(2, "little")
        if m >= 15:
            out += _ext(m)
    out.append(min(len(tail), 15) << 4)
    if len(tail) >= 15:
        out += _ext(len(tail))
    return bytes(out + tail)


def rows_of_blocks(frames, M=4096):
    """[[(block bytes, uncompressed)]] per frame -> padded (comp (B, K,
    M), clens, unc) with K the most blocks in a frame."""
    K = max(len(f) for f in frames)
    comp = np.zeros((len(frames), K, M), np.uint8)
    clens = np.zeros((len(frames), K), np.int32)
    unc = np.zeros((len(frames), K), bool)
    for r, f in enumerate(frames):
        for k, (blk, u) in enumerate(f):
            comp[r, k, : len(blk)] = np.frombuffer(blk, np.uint8)
            clens[r, k], unc[r, k] = len(blk), u
    return comp, clens, unc

