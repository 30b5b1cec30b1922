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


def repeated_text(rng):
    """320 KiB in three 128 KiB blocks: 40 KiB of text, then copies of it
    with a byte changed every ~500, so most sequences reuse the previous
    offset (repcodes carrying from block to block) and every block's
    literals stay few enough for the reference's device-literal window
    (lw + 2 * n_seq <= 2^15 words)."""
    base = text_corpus(rng, 40 * 1024)
    x = np.tile(base, 8)
    hit = rng.integers(40 * 1024, len(x), len(x) // 500)
    x[hit] = rng.integers(97, 123, len(hit), np.uint8)
    return x.tobytes()


def chain_stock_frames():
    """(frames, raws): repeated_text (seed 91) by stock libzstd at levels 3
    and 19, two frames of three blocks whose repcodes carry from block to
    block."""
    raw = repeated_text(np.random.default_rng(91))
    return [golden.zstd_compress(raw, level=lv) for lv in (3, 19)], [raw] * 2


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



# --- K6: random frames of block rows, damaged copies, rows that overlap


def _k6_frame(rng, n_blocks, S, LW, blk):
    """One frame's valid block rows: ([(ll, ml, off) ...], content,
    d_off) each, and the frame's size."""
    rows, d_off = [], 0
    for _ in range(n_blocks):
        content = int(rng.integers(0, blk))
        seqs, lp, op, left = [], 0, d_off, content
        while left > 0 and len(seqs) < S - 1 and lp < LW:
            a = min(int(rng.integers(0, min(left, 40) + 1)), LW - lp)
            m = min(int(rng.integers(0, left - a + 1)), 80) \
                if rng.random() < 0.7 and op + a > 0 else 0
            o = 1
            if m:   # near (overlapping) or anywhere back in the frame
                o = int(rng.integers(1, min(40, op + a) + 1)) \
                    if rng.random() < 0.5 else int(rng.integers(1, op + a + 1))
            seqs.append((a, m, o))
            lp, op, left = lp + a, op + a + m, left - a - m
        tail = content - (op - d_off)
        if tail > 0 and (lp + tail > LW or len(seqs) >= S):
            content -= tail
        elif tail > 0:
            seqs.append((tail, 0, 1))     # the trailing-literals sequence
        rows.append((seqs, content, d_off))
        d_off += content
    return rows, d_off


def k6_batch(rng, F, S=32, LW=256, blocks=(1, 5), blk=600):
    """K6's inputs (lit, ll, ml, off, meta, chain, frame_off) as numpy for
    F random valid frames (some followed by a few unused bytes), and the
    output size."""
    rows, chain, fo = [], [0], [0]
    for _ in range(F):
        fr, size = _k6_frame(rng, int(rng.integers(blocks[0], blocks[1] + 1)),
                             S, LW, blk)
        rows += fr
        chain.append(len(rows))
        fo.append(fo[-1] + size + 7 * int(rng.integers(0, 3)))
    BL = len(rows)
    ll = np.zeros((BL, S), np.int32)
    ml = np.zeros((BL, S), np.int32)
    off = np.ones((BL, S), np.int32)
    meta = np.zeros((BL, 3), np.int32)
    for i, (seqs, content, d_off) in enumerate(rows):
        for j, s in enumerate(seqs):
            ll[i, j], ml[i, j], off[i, j] = s
        meta[i] = (len(seqs), content, d_off)
    lit = rng.integers(0, 256, (BL, LW), dtype=np.uint8)
    return [lit, ll, ml, off, meta, np.array(chain, np.int32),
            np.array(fo, np.int64)], int(fo[-1])


def k6_far_offset():
    """Two 128 KiB blocks of one frame whose second block's match reaches
    131071 bytes back (the reference K6's largest offset), then its
    overlapping copies (offsets 1, 7, 32, 33): K6's inputs and size."""
    rng = np.random.default_rng(29)
    n = 1 << 17
    S, LW = 8, n
    lit = rng.integers(0, 256, (2, LW), dtype=np.uint8)
    ll = np.zeros((2, S), np.int32)
    ml = np.zeros((2, S), np.int32)
    off = np.ones((2, S), np.int32)
    ll[0, 0] = n
    seqs = [(1, 500, n - 1), (3, 40, 1), (5, 90, 7), (2, 70, 32),
            (4, 100, 33), (n - 815, 0, 1)]
    for j, s in enumerate(seqs):
        ll[1, j], ml[1, j], off[1, j] = s
    meta = np.array([[1, n, 0], [len(seqs), n, n]], np.int32)
    return [lit, ll, ml, off, meta, np.array([0, 2], np.int32),
            np.array([0, 2 * n], np.int64)], 2 * n


def k6_cases(seed=7, n=40):
    """n random batches of 1-4 frames, each followed by a damaged copy
    (testing/damage.damaged_exec_rows: every kind in turn), then
    k6_far_offset(): [(args, out_size)]."""
    from libzseek_tpu_torch.testing.damage import damaged_exec_rows
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        args, size = k6_batch(rng, int(rng.integers(1, 5)))
        bad = damaged_exec_rows([torch.from_numpy(a) for a in args],
                                seed + i, 1 + i % 7)[-1]
        out += [(args, size), ([t.numpy() for t in bad], size)]
    return out + [k6_far_offset()]


# --- K7: rows that drive each arm of the round walk


def k7_edge_rows():
    """(X, lengths) of 9 rows of 2^17 bytes (seed 31), most of them used
    to 32 KiB: short repeats of 1-39 bytes over a 4-letter alphabet
    (lanes that share a bucket inside a round; forwarding lanes the walk
    skips), 3 letters over the whole row (it reaches cap = N / 8), text,
    noise (rounds past 32 misses), zeros (one long match), noise whose
    last 13 bytes repeat its first 13, after 512 bytes that repeat bytes
    100-611 (the walk lands on byte 131059: an offset of 131059, the
    largest a row of 2^17 bytes reaches, since probing stops 12 bytes
    before its end), and short rows (lengths 13, 12 and 20)."""
    rng = np.random.default_rng(31)
    n = 32768
    big = 1 << 17
    a = bytearray()
    while len(a) < n:
        k = int(rng.integers(1, 40))
        a += rng.integers(0, 4, k).astype(np.uint8).tobytes() * \
            int(rng.integers(1, 6))
    X = np.zeros((9, big), np.uint8)
    X[0, :n] = np.frombuffer(bytes(a[:n]), np.uint8)
    X[1] = rng.integers(97, 100, big)
    X[2, :n] = text_corpus(rng, n)
    X[3, :n] = rng.integers(0, 256, n)
    X[5] = rng.integers(0, 256, big)
    X[5, big - 525: big - 13] = X[5, 100: 612]
    X[5, big - 13:] = X[5, :13]
    X[5, 612] = X[5, 0] ^ 1
    X[6, :n] = text_corpus(rng, n)
    X[7, :n] = text_corpus(rng, n)
    X[8, :n] = mixed_corpus(rng, n)
    lens = np.array([n, big, n - 5, n, n, big, 13, 12, 20], np.int32)
    return X, lens


# --- K2 and K3: crafted rows for the edges of the chunked placement


def k2_edge_rows(N: int = 16384, S: int = 300, seed: int = 53):
    """K2 inputs of crafted rows (random bytes, random codes (value << 4) |
    length of 1-11 bits, random sequences; predefined tables): 4-stream
    Huffman with lc = 1003 (not a multiple of 4; streams of 251, under the
    anchor interval), a 4-stream row of no literal (lc = 0: every byte in
    a match), 1-stream with no sequence (n = 0, all literals in the
    tail), raw literals with n = S, 4-stream with n = S and lc past
    4,096 (chunks of two threads' edges), a sequence-only row with lc =
    0 and RLE ll and ml, an empty row.  (x, ll, ml, off, meta, codes,
    S)."""
    rng = np.random.default_rng(seed)
    specs = [  # (literal mode, literals in sequences, n, tail literals)
        (E.MODE_HUF, 803, 40, 200),
        (E.MODE_HUF, 0, 25, 0),
        (E.MODE_HUF | E.MODE_HUF1, 0, 0, 777),
        (E.MODE_RAWLIT, 4000, S, 1001),
        (E.MODE_HUF, 6000, S, 1234),
        (E.MODE_LL_RLE | E.MODE_ML_RLE, 0, 60, 0),
        (0, 0, 0, 0)]
    B = len(specs)
    x = rng.integers(0, 256, (B, N), np.uint8)
    ll = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    off = np.zeros((B, S), np.int32)
    meta = np.zeros((B, 8), np.int32)
    for b, (mode, lits, n, tail) in enumerate(specs):
        if n:
            cut = np.sort(rng.choice(lits + n - 1, n - 1, replace=False))
            ll[b, :n] = np.diff(np.concatenate([[-1], cut,
                                                [lits + n - 1]])) - 1
            budget = N - lits - tail
            ml[b, :n] = 3 + rng.integers(0, max(1, budget // n - 3), n)
            off[b, :n] = rng.integers(1, 1 << 16, n)
            off[b, :n][rng.random(n) < 0.2] = rng.integers(1, 4)
        blen = int(ll[b].sum() + ml[b].sum()) + tail
        mode |= E.MODE_SEQ if n else 0
        meta[b, :4] = (blen, int(ll[b].sum()) + tail, n, mode)
    nbits = rng.integers(1, 12, (B, 256))
    vals = rng.integers(0, 1 << 11, (B, 256)) & ((1 << nbits) - 1)
    codes = ((vals << 4) | nbits).astype(np.int32)
    t = torch.from_numpy
    return t(x), t(ll), t(ml), t(off), t(meta), t(codes), S


def k3_edge_rows(seed: int = 59):
    """K3 inputs of crafted 128 KiB rows: coverage masks of random
    density (every byte a literal, 3/4, 1/2, a row cut to 100,003 bytes
    inside a word, a row of 1,500 literals whose streams hold no anchor,
    a row K3 does not take), random bytes and codes.  (x, mask words,
    codes, lens, vec_row)."""
    rng = np.random.default_rng(seed)
    n = VE.N_BLOCK
    dens = [1.0, 0.75, 0.5, 0.9, 1500 / n, 0.5]
    B = len(dens)
    bits = rng.random((B, n)) < np.array(dens)[:, None]
    mask = np.packbits(bits, axis=1, bitorder="little").view("<i4")
    lens = np.full(B, n, np.int32)
    lens[3] = 100003
    vec = np.ones(B, bool)
    vec[5] = False
    x = rng.integers(0, 256, (B, n), np.uint8)
    nbits = rng.integers(1, 12, (B, 256))
    vals = rng.integers(0, 1 << 11, (B, 256)) & ((1 << nbits) - 1)
    codes = ((vals << 4) | nbits).astype(np.int32)
    t = torch.from_numpy
    return t(x), t(np.ascontiguousarray(mask)), t(codes), t(lens), t(vec)


def damage(stream: bytes, rng, flips: int = 3) -> bytes:
    """`stream` with `flips` random bits flipped below its last byte (which
    keeps its sentinel)."""
    b = bytearray(stream)
    if len(b) > 1:
        for p in rng.integers(0, 8 * (len(b) - 1), flips).tolist():
            b[p >> 3] ^= 1 << (p & 7)
    return bytes(b)


def kraft_weights(rng, tl: int) -> np.ndarray:
    """(256,) zstd Huffman weights of a random complete prefix code whose
    longest code is `tl` bits: leaves split at random until some leaf
    reaches tl, symbols shuffled."""
    lengths = [0]
    while max(lengths) < tl or len(lengths) < 2:
        cand = [i for i, l in enumerate(lengths) if l < tl]
        if len(lengths) >= 255:
            cand = [max(cand, key=lambda i: lengths[i])]
        i = cand[int(rng.integers(0, len(cand)))]
        lengths[i] += 1
        lengths.append(lengths[i])
    syms = rng.permutation(256)[: len(lengths)]
    w = np.zeros(256, np.int32)
    w[syms] = tl + 1 - np.array(lengths)
    return w


def huffman_stream(syms: np.ndarray, table: np.ndarray) -> bytes:
    """Encode `syms` with the code of a packed 12-bit peek table (nb << 8 |
    sym) as a zstd backward stream: the first symbol ends up on top."""
    code = {}
    for v in range(len(table) - 1, -1, -1):
        nb, s = int(table[v]) >> 8, int(table[v]) & 255
        code[s] = (v >> (12 - nb), nb)
    acc, nbits = 0, 0
    for s in syms[::-1].tolist():
        c, nb = code[s]
        acc |= c << nbits
        nbits += nb
    acc |= 1 << nbits
    return acc.to_bytes(nbits // 8 + 1, "little")


def huf_plain_edges(rng, n_syms: int = 8000):
    """Pass A inputs for csrc/huf_lanes.cu's pieces: streams of n_syms
    random symbols of hand-made 12-, 11- and 9-bit tables (every piece's
    guessed start but the first mid-code), each also damaged and cut
    short (n - 7), and over-long (n + 300: the tail below bit 0); a lane
    at bit 0 and one below it, n = 0, n past its stream by 9,000
    symbols, and a table with code lengths 0 (the serial walk).  Returns
    (huf_lanes keyword arguments but dtabs, as numpy; dtabs (T, 4096)
    int32 on the CPU)."""
    from libzseek_tpu_torch.ops import zstd_decode as ZD
    huf = ZD._HufReg()
    for tl in (12, 11, 9):
        huf.add(kraft_weights(rng, tl))
    W, TLS = huf.weights_arr()
    dtabs = ZD.build_dtabs(torch.from_numpy(W), torch.from_numpy(TLS))
    tab = dtabs.numpy()
    lanes = [ZD._HufLane(huffman_stream(
        tab[t][rng.integers(0, 4096, n_syms)] & 255, tab[t]), n_syms, t)
        for t in range(3)]
    lanes += [ZD._HufLane(damage(l.stream, rng, 5), l.n_out - 7, l.tid)
              for l in lanes[:3]]
    lanes += [ZD._HufLane(l.stream, l.n_out + 300, l.tid)
              for l in lanes[:3]]
    holes = tab[0].copy()
    holes[::7] &= 255                     # code length 0
    dtabs = torch.cat([dtabs, torch.from_numpy(holes)[None]])
    # (lane whose stream it reads, bits or None for its sentinel, n, tid)
    extra = [(0, None, n_syms, 3), (1, 0, 20, 1), (1, -9, 20, 2),
             (2, None, 0, 2), (1, None, n_syms + 9000, 1)]
    inp, _ = ZD.huf_lane_inputs(lanes + [lanes[e[0]] for e in extra])
    L0 = len(lanes)
    for i, (_, b, n, t) in enumerate(extra):
        if b is not None:
            inp["bits"][L0 + i] = b
        inp["n"][L0 + i] = n
        inp["tid"][L0 + i] = t
    inp["cap"] = int(inp["n"].max())
    return inp, dtabs


# --- the plan kernel (csrc/plan.cu): rows for each branch of the plans


def _seqs(rng, n, S, big=False):
    """n random sequences in rows of S: heavy-tailed literal and match
    lengths, a third repcodes; `big` reaches the codes past each table."""
    n = min(n, S)
    ll = np.zeros(S, np.int64)
    ml = np.zeros(S, np.int64)
    off = np.zeros(S, np.int64)
    top = 1 << 17 if big else 1 << 12
    ll[:n] = np.minimum(rng.pareto(1.1, n) * 3, top - 1)
    ml[:n] = 3 + np.minimum(rng.pareto(1.0, n) * 4, top)
    off[:n] = np.where(rng.random(n) < 0.3, rng.integers(1, 4, n),
                       rng.integers(4, 1 << (24 if big else 17), n))
    return ll, ml, off


def plan_random_rows(rng, B: int = 16, S: int = 512):
    """Plan inputs of B random rows: literal histograms from uniform,
    heavy-tailed, near-flat and exponential counts over a random symbol
    set, random sequences (numpy int32 arrays by name)."""
    rows = []
    for r in range(B):
        h = np.zeros(256, np.int64)
        nsym = int(rng.integers(1, 257))
        syms = rng.choice(256, nsym, replace=False)
        h[syms] = [rng.integers(0, 200, nsym),
                   (rng.pareto(1.0, nsym) * 20).astype(np.int64),
                   rng.integers(0, 3, nsym),
                   rng.exponential(200, nsym).astype(np.int64)][r % 4]
        n = int(rng.integers(0, S + 1))
        rows.append((h, n, -1, None, _seqs(rng, n, S, big=r % 5 == 0)))
    return _plan_batch(rng, rows, S)


def plan_edge_rows(S: int = 1024, seed: int = 61):
    """Plan inputs of crafted rows, one or more for each branch of the
    Huffman and sequence-table plans (numpy int32 arrays by name): an
    empty row; no literals; one literal symbol; an RLE block; two
    symbols; 150 equal counts (64 moves fall short: the balanced
    fallback); flat codes over 128 and 256 symbols (the flat fix); 192
    equal counts (exactly 64 moves); a budget over 2^11 (shrinking
    moves); a spiky row whose shrinking runs out of candidates (the
    least budget grows, then the fallback); under 256 literals (one
    stream); a noise-like and a skewed row; two symbols under 64
    literals.  Sequences: none, fewer than MIN_SEQ_FSE, one repeated
    sequence (RLE in all three streams), S sequences of heavy-tailed
    lengths (the largest log's tables), ~100 of few codes (the
    predefined log's), codes past each table, and n_seq above S."""
    rng = np.random.default_rng(seed)
    eq = lambda n, c: np.concatenate([np.full(n, c), np.zeros(256 - n)])
    geo = np.zeros(256, np.int64)
    geo[:10] = 1 << np.arange(16, 6, -1)    # scaled to 1024, 512, .. 2
    geo[10:138] = 1                          # 128 more budgets of 1
    spiky = np.zeros(256, np.int64)
    srng = np.random.default_rng(9)
    n = int(srng.integers(200, 257))
    idx = srng.choice(256, n, replace=False)
    spiky[idx] = srng.integers(1, 3, n) * \
        (1 + (srng.random(n) < 0.05) * 10000)
    one = np.zeros(256, np.int64)
    one[65] = 5000
    two = np.zeros(256, np.int64)
    two[[3, 9]] = [1, 100000]
    text = np.zeros(256, np.int64)
    text[97:123] = rng.integers(1, 15, 26)
    small2 = np.zeros(256, np.int64)
    small2[[40, 41]] = [20, 30]
    skew = (rng.pareto(1.2, 256) * 10).astype(np.int64)
    noise = rng.integers(400, 600, 256)
    z = np.zeros(256, np.int64)
    rep = (np.full(S, 3), np.full(S, 9), np.full(S, 1))
    few = (rng.choice([0, 1, 2], S), rng.choice([3, 4, 5], S),
           rng.choice([1, 2, 3], S))
    # (literal histogram, n_seq, const, block length, sequences)
    rows = [(z, 0, -1, 0, None),
            (z, 50, -1, None, _seqs(rng, 50, S)),
            (one, 20, -1, None, _seqs(rng, 20, S)),
            (eq(1, 100)[::-1].copy(), 40, 7, 1 << 17, rep),
            (two, S, -1, None, _seqs(rng, S, S)),
            (eq(150, 100), 100, -1, None, few),
            (eq(128, 50), S, -1, None, _seqs(rng, S, S, big=True)),
            (eq(256, 7), S + 5, -1, None, _seqs(rng, S, S)),
            (eq(192, 100), 31, -1, None, _seqs(rng, 31, S)),
            (geo, 32, -1, None, _seqs(rng, 32, S)),
            (spiky, S, -1, None, _seqs(rng, S, S)),
            (text, 300, -1, None, _seqs(rng, 300, S)),
            (noise, 5, -1, None, _seqs(rng, 5, S)),
            (skew, S, -1, None, _seqs(rng, S, S)),
            (small2, 1, -1, None, _seqs(rng, 1, S))]
    return _plan_batch(rng, rows, S)


def _plan_batch(rng, rows, S):
    B = len(rows)
    out = {k: np.zeros(sh, np.int32) for k, sh in (
        ("hist", (B, 256)), ("hist_q", (B, 4, 256)), ("lit_count", (B,)),
        ("n_seq", (B,)), ("const", (B,)), ("lens", (B,)), ("ll", (B, S)),
        ("ml", (B, S)), ("offv", (B, S)))}
    for b, (h, n, const, blen, seqs) in enumerate(rows):
        h = np.asarray(h, np.int64)
        hq = rng.multinomial(h, [0.25] * 4).T
        out["hist_q"][b] = hq
        out["hist"][b] = hq.sum(0)
        out["lit_count"][b] = h.sum()
        out["n_seq"][b] = n
        out["const"][b] = const
        if seqs is not None:
            m = min(n, S)
            for k, v in zip(("ll", "ml", "offv"), seqs):
                out[k][b, :m] = v[:m]
        out["lens"][b] = h.sum() + out["ml"][b].sum() if blen is None \
            else blen
    return out
