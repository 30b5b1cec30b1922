"""The port's native transcode executor and host Huffman decoder
(libzseek_tpu_torch/native: zir_execute, huf_decode_batch) against the
JAX package's natives (libzseek_tpu/native zn_zir_execute,
zn_huf_decode_batch) on the same inputs, made with numpy (seed 29):
token streams with long, short and overlapping offsets, a block placed
after earlier frame bytes, and tokens out of bounds (the reference
returns -1, the port raises FormatError); Huffman lanes of random
complete codes from 1 to 12 bits, streams shorter and longer than the
bit reader's 8-byte container (bytes; tolerance: none)."""

import numpy as np
import torch

from libzseek_tpu import native as jax_native
from libzseek_tpu_torch import native
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_inputs import build_native_runtime
from test_torch_lanes_inputs import huffman_stream, kraft_weights


def _tokens(seqs) -> np.ndarray:
    """(ll, ml, off) triples packed as K4's transcode arm packs them."""
    t = np.zeros(2 * len(seqs), np.uint32)
    for i, (ll, ml, off) in enumerate(seqs):
        t[2 * i] = ll | (ml & 0x3FFF) << 18
        t[2 * i + 1] = off | (ml >> 14) << 28
    return t


def _both(lits, toks, out_size, base, prefix):
    """Both executors on copies of one frame buffer whose first `base`
    bytes are `prefix`: (port result or None on FormatError, reference
    result, port buffer, reference buffer)."""
    bufs = [np.zeros(out_size, np.uint8) for _ in range(2)]
    for b in bufs:
        b[:base] = prefix[:base]
    try:
        got = native.zir_execute(lits, toks, bufs[0], base)
    except FormatError:
        got = None
    ref = jax_native.zir_execute(lits, len(lits), toks, len(toks) // 2,
                                 bufs[1], base)
    return got, ref, bufs[0], bufs[1]


def test_zir_execute_matches_reference():
    build_native_runtime()
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, 256, 300000, np.uint8)
    for base in (0, 1000, 200003):
        seqs, op, n_lit = [], base, 0
        for _ in range(400):
            ll = int(rng.integers(0, 300))
            ml = int(rng.choice([3, 4, 7, 40, 300, 20000, 131074]))
            off = int(rng.choice([1, 2, 3, 5, 31, int(rng.integers(1, op + ll + 1))])) \
                if op + ll else 1
            off = max(1, min(off, op + ll))
            seqs.append((ll, ml, off))
            op += ll + ml
            n_lit += ll
        lits = rng.integers(0, 256, n_lit + 77, np.uint8)   # 77 trailing
        size = op + 77
        got, ref, a, b = _both(lits, _tokens(seqs), size + 5, base, prefix)
        assert got == ref == size - base
        assert a.tobytes() == b.tobytes()
    lits = rng.integers(0, 256, 64, np.uint8)
    for seqs, cap in (([(10, 20, 11)], 100),      # offset past the frame
                      ([(10, 20, 0)], 100),       # offset 0
                      ([(70, 4, 1)], 200),        # more literals than given
                      ([(10, 200, 5)], 100)):     # past the buffer
        got, ref, _, _ = _both(lits, _tokens(seqs), cap, 0, prefix)
        assert got is None and ref == -1, seqs


def test_huf_decode_batch_matches_reference():
    build_native_runtime()
    rng = np.random.default_rng(29)
    weights, streams, meta, syms_all, out_off = [], [], [], [], []
    spos = opos = 0
    for tid, tl in enumerate((1, 2, 5, 8, 11, 12)):
        w = kraft_weights(rng, tl)
        weights.append(w)
        tls = np.array([tl], np.int32)
        table = ZD.build_dtabs(torch.from_numpy(w[None]),
                               torch.from_numpy(tls))[0].numpy()
        present = np.nonzero(w)[0]
        for n in (1, 3, 40, 2000):
            syms = rng.choice(present, n).astype(np.uint8)
            st = huffman_stream(syms, table)
            streams.append(st)
            meta.append((spos, len(st), n, tid))
            out_off.append(opos)
            syms_all.append(syms)
            spos += len(st)
            opos += n
    W = np.stack(weights).astype(np.int32)
    args = (b"".join(streams), np.array(meta, np.int64), W, opos,
            np.array(out_off, np.int64))
    assert min(len(s) for s in streams) < 8 < max(len(s) for s in streams)
    got = native.huf_decode_batch(*args)
    ref = jax_native.huf_decode_batch(*args)
    assert ref is not None and got.tobytes() == ref[:opos].tobytes()
    assert got.tobytes() == np.concatenate(syms_all).tobytes()
