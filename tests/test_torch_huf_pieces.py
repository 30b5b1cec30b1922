"""The Huffman lanes' plain arm as csrc/huf_lanes.cu walks it (one block a
stream, pieces at guessed bit offsets that self-synchronise; numpy
mirror libzseek_tpu_torch/testing/huf_mirror.py) against the port's plain
version (ops/lanes.huf_lanes on CPU tensors) and the reference's XLA
huf_decode_lanes (libzseek_tpu/ops/zstd_decode.py:401).  Same streams,
lanes and tables; symbols and ok flags equal (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import huf_mirror as HM
from test_torch_lanes_inputs import (damage, huffman_stream, jax_huf_tables,
                                     kraft_weights, own_frames, parse,
                                     stock_frames)


def _three(inp, tables):
    """(mirror, port plain, reference) (syms, ok) on one lane input; the
    mirror's per-lane stats."""
    dt = torch.from_numpy(tables)
    got = L.huf_lanes(dtabs=dt, **ZD._upload(inp, "cpu"))
    stats = []
    mir = HM.huf_plain_mirror(inp["bank"], inp["sid"], inp["bits"],
                              inp["n"], inp["tid"], tables, inp["cap"],
                              stats)
    ref = JZ.huf_decode_lanes(
        jnp.asarray(JZ._win32(inp["bank"])), jnp.asarray(inp["bits"]),
        jnp.asarray(inp["n"]), jnp.asarray(inp["tid"]), jnp.asarray(tables),
        inp["cap"])
    for a, b, c in zip(mir, got, ref):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, np.asarray(c))
    return mir, stats


def _long_lanes(rng, hufreg, n_syms):
    """Lanes of 12- and 11-bit hand-made tables, `n_syms` random symbols
    each: every piece's guessed start but the first falls mid-code."""
    lanes = []
    for tl in (12, 11, 9):
        tid = hufreg.add(kraft_weights(rng, tl))
        table = jax_huf_tables(hufreg)[tid]
        syms = table[rng.integers(0, 4096, n_syms)] & 255
        lanes.append(ZD._HufLane(huffman_stream(syms, table), n_syms, tid))
    return lanes


def test_piece_walk_matches_plain_and_reference():
    """The port's and libzstd's literal streams (1 and 4 streams a block),
    and 8,000-symbol streams of hand-made tables (up to 59 pieces), each
    also damaged (bits flipped) and cut short (n - 7: the walk stops
    above bit 0), and over-long (n + 300: the walk runs below bit 0, the
    tail)."""
    rng = np.random.default_rng(61)
    frames, _ = own_frames()
    plans, hufreg, _ = parse(frames + stock_frames()[0])
    framed = [l for p in plans for bp in p.blocks
              for l in bp.huf_lanes or () if l.n_out <= 6144]
    for lanes, min_pieces in ((framed, 2), (_long_lanes(rng, hufreg, 8000),
                                            50)):
        k = len(lanes)
        lanes = lanes + [
            ZD._HufLane(damage(l.stream, rng, 5), l.n_out - 7, l.tid)
            for l in lanes] + [ZD._HufLane(l.stream, l.n_out + 300, l.tid)
                               for l in lanes]
        inp, _ = ZD.huf_lane_inputs(lanes)
        (syms, ok), stats = _three(inp, jax_huf_tables(hufreg))
        assert ok[:k].all() and not ok[2 * k:].any()
        assert max(s["pieces"] for s in stats) > min_pieces
        assert sum(s["resyncs"] for s in stats) > k


def test_piece_walk_edges():
    """A table with code lengths 0 (the serial walk), a lane at bit 0 and
    one below it (only the tail), n = 0, a lane whose n exceeds its
    stream by thousands of symbols (the tail past the last piece), and
    out-of-range table ids (clamped)."""
    rng = np.random.default_rng(62)
    _, hufreg, _ = parse([])
    lanes = _long_lanes(rng, hufreg, 3000)
    tables = jax_huf_tables(hufreg)
    holes = tables[0].copy()
    holes[::7] &= 255                     # code length 0
    tables = np.concatenate([tables, holes[None]]).astype(np.int32)
    L0 = len(lanes)
    # (lane whose stream it reads, bits or None for its sentinel, n, tid)
    extra = [(0, None, 3000, len(tables) - 1), (1, 0, 20, 1),
             (1, -9, 20, 2), (2, None, 0, 2), (1, None, 9000, 1),
             (0, None, 3000, 9), (2, None, 3000, -2)]
    inp, _ = ZD.huf_lane_inputs(lanes + [lanes[e[0]] for e in extra])
    for i, (_, b, n, t) in enumerate(extra):
        if b is not None:
            inp["bits"][L0 + i] = b
        inp["n"][L0 + i] = n
        inp["tid"][L0 + i] = t
    inp["cap"] = 9000
    (syms, ok), stats = _three(inp, tables)
    assert ok[:L0].all() and not ok[L0 + 1:].any()
    assert stats[L0]["serial"] and not stats[0]["serial"]
    assert stats[L0 + 4]["pieces"] > 1 and stats[L0 + 2]["pieces"] == 0
