"""Shared inputs of the port's LZ4 parity tests (tests/test_torch_lz4_*.py).
It holds no tests.

Every input is made with numpy from a fixed seed.  The reference side is
the JAX package: K5 through lz4_emit_blocks_smem in interpret mode, the
XLA decoder lz4_decode_frames, and LZ4Codec(parser="hash"), whose fused
arm is K5 (its default parser on the CPU is "sort")."""

import io

import numpy as np
import torch

import jax.numpy as jnp

from libzseek_tpu.ops.lz4_decode import lz4_decode_frames as jax_decode
from libzseek_tpu.ops.pallas_lz4 import lz4_emit_blocks_smem
from libzseek_tpu.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch.ops.lz4_decode import lz4_decode_frames
from libzseek_tpu_torch.ops.lz4_emit import lz4_emit, out_cap

BK = 4096          # small blocks keep interpret mode fast
BLOCK = 1 << 16    # the codec's block


def vocab_stream(seed=23, n=3 * BK):
    """Text over a small vocabulary with planted cross-block references
    (tests/test_lz4_fused.py's stream)."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.frombuffer(b"a modest shared vocabulary ", np.uint8),
                   n).astype(np.uint8)
    s[BK + 100: BK + 400] = s[50: 350]
    s[2 * BK + 10: 2 * BK + 200] = s[2 * BK - 150: 2 * BK + 40]
    return s


def rows_of(stream, N):
    """(B+1, N) rows: row 0 zero, row i+1 = block i of the stream."""
    B = len(stream) // N
    D = np.zeros((B + 1, N), np.uint8)
    D[1:] = stream[: B * N].reshape(B, N)
    return D


def mixed_rows(seed, nblocks):
    """nblocks 64 KiB blocks of the mixed corpus (text-like, period-337
    repeats, zeros, noise), in that order."""
    return mixed_corpus(np.random.default_rng(seed), nblocks * BLOCK)


def level_rows(seed):
    """Four linked blocks, one per regime (text, repeats, zeros, noise)
    with a frame boundary before the noise."""
    x = mixed_rows(seed, 4)
    D = np.zeros((5, BLOCK), np.uint8)
    D[1:] = x.reshape(4, BLOCK)
    lens = np.full(4, 2 * BLOCK, np.int32)
    min_ref = np.array([BLOCK, BLOCK, 2 * BLOCK, 4 * BLOCK], np.int32)
    return D, lens, min_ref


def both_k5(D, lens, min_ref, lazy=0, accel_log=6):
    """K5 through the Pallas kernel (interpret mode) and the port's plain
    version on the same rows; returns ([payload bytes], [payload bytes])
    per row."""
    N = D.shape[1]
    cap = out_cap(N)
    out, olen = lz4_emit_blocks_smem(
        jnp.asarray(D), jnp.asarray(lens), jnp.asarray(min_ref), cap,
        block_bytes=N, lazy=lazy, accel_log=accel_log, interpret=True)
    out = np.asarray(out).view(np.uint8).reshape(len(lens), -1)
    olen = np.asarray(olen)
    po, pl = lz4_emit(torch.from_numpy(D), torch.from_numpy(lens),
                      torch.from_numpy(min_ref), cap, lazy=lazy,
                      accel_log=accel_log)
    po, pl = po.numpy(), pl.numpy()
    for i in range(len(pl)):      # the plain output is zero past olen
        assert not po[i, pl[i]:].any()
    ref = [out[i, : olen[i]].tobytes() for i in range(len(olen))]
    got = [po[i, : pl[i]].tobytes() for i in range(len(pl))]
    return ref, got


def both_decode(comp, clens, unc, F, linked, max_seqs=None):
    """The XLA decoder and the port's plain decoder on the same padded
    blocks: ((out, out_lens, ok) reference, (out, out_lens, ok) port)."""
    ref = jax_decode(jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(unc),
                     F, max_seqs=max_seqs, linked=linked)
    got = lz4_decode_frames(torch.from_numpy(comp), torch.from_numpy(clens),
                            torch.from_numpy(unc), F, max_seqs=max_seqs,
                            linked=linked)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def pad_frames(frames):
    """Parsed LZ4F frames -> (comp (B, K, M), clens, unc, linked) as the
    codec packs them (K a power of two, M a multiple of 4 KiB)."""
    from libzseek_tpu_torch.format import lz4f
    parsed = []
    for data in frames:
        info = lz4f.parse_frame_header(data)
        blocks, _ = lz4f.parse_blocks(data, info, info.header_size)
        parsed.append((info, blocks))
    K = max(max(1, len(b)) for _, b in parsed)
    K = 1 << (K - 1).bit_length()
    M = max(max((x.size for x in b), default=1) for _, b in parsed)
    M = (M + 4095) // 4096 * 4096
    comp = np.zeros((len(frames), K, M), np.uint8)
    clens = np.zeros((len(frames), K), np.int32)
    unc = np.zeros((len(frames), K), bool)
    for r, (data, (_, blocks)) in enumerate(zip(frames, parsed)):
        for k, blk in enumerate(blocks):
            comp[r, k, : blk.size] = np.frombuffer(data, np.uint8, blk.size,
                                                   blk.offset)
            clens[r, k] = blk.size
            unc[r, k] = blk.uncompressed
    return comp, clens, unc, not parsed[0][0].block_independent


def codec_frames(seed=7):
    """Frames of the codec tests: 3 blocks of text with a short last
    block, an incompressible block stored raw, an empty frame, a tiny
    frame, and one 64 KiB block of each mixed regime."""
    rng = np.random.default_rng(seed)
    text = text_corpus(rng, 2 * BLOCK + 5000).tobytes()
    noise = rng.integers(0, 256, 70000, np.uint8).tobytes()
    m = mixed_corpus(rng, 4 * BLOCK).tobytes()
    return [text, noise, b"", b"abcabcabcabc", m]


class Sink:
    def __init__(self):
        self.buf = io.BytesIO()

    def write(self, b):
        self.buf.write(b)

    def value(self):
        return self.buf.getvalue()


def write_all(writer, data, chunk):
    for pos in range(0, len(data), chunk):
        writer.write(data[pos: pos + chunk])
    writer.close()


def phases(comp, clens, unc, F, linked, max_seqs=None):
    """The CUDA decoder's phases as numpy mirrors (ops/lz4_decode
    parse_records then resolve_records): (out, out_lens, ok)."""
    from libzseek_tpu_torch.ops.lz4_decode import (parse_records,
                                                   resolve_records)
    B, K, M = comp.shape
    if max_seqs is None:
        max_seqs = min(M // 3 + 2, F // 4 + 2)
    rec = parse_records(comp.reshape(B * K, M), clens.reshape(-1),
                        unc.reshape(-1), max_seqs, linked)
    return resolve_records(comp, *rec, F)


def lz4_raws(seed):
    """Inputs whose blocks liblz4 compresses into thousands of sequences
    (small-vocabulary text, three blocks with a short last one), every
    mixed regime, noise it stores raw, and a tiny frame."""
    rng = np.random.default_rng(seed)
    voc = np.frombuffer(b"a modest shared vocabulary ", np.uint8)
    text = rng.choice(voc, 2 * BLOCK + 5000).astype(np.uint8).tobytes()
    return [text, mixed_corpus(rng, 4 * BLOCK).tobytes(),
            rng.integers(0, 256, 70000, np.uint8).tobytes(), b"abcabcabcabc"]
