"""The pointer-doubling executor (execute_sequences) as torch ops against
the JAX function, on random sequence lists of three frames, with one
offset before its frame's start (tolerance: none, bytes and flags)."""

import numpy as np
import torch

import jax.numpy as jnp
from libzseek_tpu.ops.zstd_decode import execute_sequences as jax_exec
from libzseek_tpu_torch.ops.zstd_decode import execute_sequences


def _frame(rng, n_seq):
    """One frame's pool and sequence arrays as decode_frames builds them
    (a trailing literals-only sequence), and its size."""
    ll = rng.integers(0, 20, n_seq)
    ml = rng.integers(3, 60, n_seq)
    ll[0] = max(ll[0], 1)
    out = np.cumsum(ll + ml)
    start = out - ml               # each match's destination
    off = np.minimum(rng.integers(1, 400, n_seq), start)
    trail = int(rng.integers(1, 9))
    lsrc = np.concatenate([np.cumsum(ll) - ll, [ll.sum()]])
    lens = np.concatenate([ll, [trail]])
    ldst = np.concatenate([out - ml - ll, [out[-1]]])
    moff = np.concatenate([off, [1]])
    mlen = np.concatenate([ml, [0]])
    mdst = np.concatenate([start, [out[-1] + trail]])
    pool = rng.integers(0, 256, int(ll.sum()) + trail, np.uint8)
    return pool, [lsrc, lens, ldst, moff, mlen, mdst], int(out[-1]) + trail


def _run(frames):
    B = len(frames)
    P = 1 << max(len(f[0]) for f in frames).bit_length()
    S = 1 << max(len(f[1][0]) for f in frames).bit_length()
    F = 1 << max(f[2] for f in frames).bit_length()
    pool = np.zeros((B, P), np.uint8)
    arrs = [np.zeros((B, S), np.int32) for _ in range(6)]
    for i, (p, seqs, _) in enumerate(frames):
        pool[i, : len(p)] = p
        for k in range(6):
            arrs[k][i, : len(seqs[k])] = seqs[k]
    out, ok = execute_sequences(torch.from_numpy(pool),
                                *[torch.from_numpy(a) for a in arrs], F)
    j_out, j_ok = jax_exec(jnp.asarray(pool),
                           *[jnp.asarray(a) for a in arrs], F)
    return out.numpy(), ok.numpy(), np.asarray(j_out), np.asarray(j_ok)


def test_execute_sequences_matches_jax():
    rng = np.random.default_rng(31)
    frames = [_frame(rng, n) for n in (40, 300, 7)]
    out, ok, j_out, j_ok = _run(frames)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(ok, j_ok)
    assert ok.all()


def test_execute_sequences_offset_before_frame_start():
    rng = np.random.default_rng(37)
    frames = [_frame(rng, n) for n in (50, 60, 70)]
    pool, seqs, size = frames[1]
    seqs[3] = seqs[3].copy()
    seqs[3][5] = seqs[5][5] + 1     # one byte before the frame's start
    out, ok, j_out, j_ok = _run(frames)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(ok, j_ok)
    assert ok.tolist() == [True, False, True]
