"""The port's host Huffman decoder (native huf_decode_batch) repairs the
reference's zn_huf_decode_batch (ADVICE.md r5): a damaged lane raises
FormatError where the reference peeks with its bit count at 64 (a shift
by the type's width) or returns bytes; a single-symbol weight set (code
length 0) raises FormatError where the reference "decodes" it to zero
bytes without reading a bit.  Inputs from numpy (seed 31)."""

import numpy as np
import pytest
import torch

from libzseek_tpu import native as jax_native
from libzseek_tpu_torch import native
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_inputs import build_native_runtime
from test_torch_lanes_inputs import huffman_stream, kraft_weights


def _lane(rng, n, tl=8):
    w = kraft_weights(rng, tl)
    table = ZD.build_dtabs(torch.from_numpy(w[None]),
                           torch.from_numpy(np.array([tl], np.int32)))[0]
    syms = rng.choice(np.nonzero(w)[0], n).astype(np.uint8)
    return huffman_stream(syms, table.numpy()), syms, w[None]


def _decode(stream, n_out, W):
    return native.huf_decode_batch(stream, np.array([[0, len(stream), n_out,
                                                      0]], np.int64),
                                   W, n_out, np.zeros(1, np.int64))


def test_damaged_huffman_lane_raises():
    build_native_runtime()
    rng = np.random.default_rng(31)
    stream, syms, W = _lane(rng, 3000)
    assert _decode(stream, len(syms), W).tobytes() == syms.tobytes()
    # asked for one symbol more than the stream holds: the stream runs dry
    # exactly when the reference's next peek shifts by 64
    with pytest.raises(FormatError):
        _decode(stream, len(syms) + 1, W)
    # its low bytes cut off, and one symbol fewer than it holds: not
    # consumed exactly
    with pytest.raises(FormatError):
        _decode(stream[3:], len(syms), W)
    with pytest.raises(FormatError):
        _decode(stream, len(syms) - 1, W)
    # a zero last byte (no sentinel) and an empty lane, as the reference
    with pytest.raises(FormatError):
        _decode(stream[:-1] + b"\x00", len(syms), W)
    assert jax_native.huf_decode_batch(
        stream[:-1] + b"\x00", np.array([[0, len(stream), len(syms), 0]],
                                        np.int64),
        W, len(syms), np.zeros(1, np.int64)) is None


def test_single_symbol_weights_raise():
    build_native_runtime()
    W = np.zeros((1, 256), np.int32)
    W[0, 97] = 2        # one symbol: total 2, code length 2 - 1 + 1 - 2 = 0
    stream = b"\x5a\x01"
    meta = np.array([[0, 2, 16, 0]], np.int64)
    ref = jax_native.huf_decode_batch(stream, meta, W, 16,
                                      np.zeros(1, np.int64))
    assert ref is not None and not ref[:16].any()
    with pytest.raises(FormatError):
        native.huf_decode_batch(stream, meta, W, 16, np.zeros(1, np.int64))
