"""The Huffman lanes' anchored arm as csrc/huf_lanes.cu walks it (a thread
a chunk lane, the tables of a block's first and last lanes staged as
uint16, a 64-bit register window; numpy mirror
libzseek_tpu_torch/testing/huf_mirror.py huf_anchored_mirror) against
the port's plain version (ops/lanes.huf_lanes on CPU tensors) and the
reference's XLA huf_decode_anchored (libzseek_tpu/ops/zstd_decode.py:578).
Symbols and ok flags are equal (tolerance: none)."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import huf_mirror as HM
from test_torch_lanes_inputs import (archive_parts, damage, jax_huf_tables,
                                     mixed_archive, parse)

LANE_KEYS = ("sid", "bits", "n", "tid")


def _three(inp, tables, ref=True):
    """(mirror, plain) equal, and the reference where ref; the mirror's
    output and stats."""
    stats = {}
    mir = HM.huf_anchored_mirror(inp["bank"], inp["sid"], inp["bits"],
                                 inp["n"], inp["tid"], tables, inp["cap"],
                                 stats)
    got = L.huf_lanes(dtabs=torch.from_numpy(tables), **ZD._upload(inp, "cpu"))
    for a, b in zip(mir, got):
        np.testing.assert_array_equal(a, b.numpy())
    if ref:
        r = JZ.huf_decode_anchored(
            jnp.asarray(JZ._win32(inp["bank"]).reshape(-1)),
            inp["bank"].shape[1], jnp.asarray(inp["sid"]),
            jnp.asarray(inp["bits"]), jnp.asarray(inp["n"]),
            jnp.asarray(inp["tid"]), jnp.asarray(tables), inp["cap"])
        for a, b in zip(mir, r):
            np.testing.assert_array_equal(a, np.asarray(b))
    return mir, stats


@functools.lru_cache(maxsize=1)
def _chunk_lanes():
    """The chunk lanes of an archive of the port's Writer at its sidecar's
    anchors, and of damaged copies of every fifth stream: (inputs, tables,
    lanes of clean streams)."""
    frames, sizes, hints = archive_parts(mixed_archive()[0])
    plans, hufreg, _ = parse(frames, sizes)
    lanes, anchors = [], []
    for p, fh in zip(plans, hints):
        for bp, bh in zip(p.blocks, fh):
            for s, lane in enumerate(bp.huf_lanes or ()):
                lanes.append(lane)
                anchors.append((bh.lit, s))
    rng = np.random.default_rng(83)
    n_clean = len(lanes)
    for j in range(0, n_clean, 5):
        lanes.append(ZD._HufLane(damage(lanes[j].stream, rng, 40),
                                 lanes[j].n_out, lanes[j].tid))
        anchors.append(anchors[j])
    inp, _ = ZD.huf_lane_inputs(lanes, anchors)
    return inp, jax_huf_tables(hufreg), inp["sid"] < n_clean


def test_anchored_window_matches_plain_and_reference():
    """The archive's chunk lanes and damaged copies; shuffled, with a
    quarter of them on other tables (mostly read from dtabs); and over rows
    longer than any stream (the same outputs)."""
    inp, tables, clean = _chunk_lanes()
    (syms, ok), st = _three(inp, tables)
    assert ok[clean].all()
    assert st["staged_lanes"] == st["lanes"] > 4 * HM.ANCHOR_THREADS
    rng = np.random.default_rng(84)
    perm = rng.permutation(len(inp["sid"]))
    mixed = {k: (v[perm].copy() if k in LANE_KEYS else v)
             for k, v in inp.items()}
    # three more tables: the first one's entries rolled
    more = np.concatenate([tables] + [np.roll(tables[:1], 97 * i, axis=1)
                                      for i in (1, 2, 3)])
    k = len(perm) // 4
    mixed["tid"][:k] = rng.integers(0, len(more), k)
    _, st = _three(mixed, more)
    assert 0 < st["staged_lanes"] < st["lanes"]
    wide = np.zeros((inp["bank"].shape[0], 4 * inp["bank"].shape[1]),
                    np.uint8)
    wide[:, : inp["bank"].shape[1]] = inp["bank"]
    got = HM.huf_anchored_mirror(wide, inp["sid"], inp["bits"], inp["n"],
                                 inp["tid"], tables, inp["cap"])
    for a, b in zip(got, (syms, ok)):
        np.testing.assert_array_equal(a, b)


def test_anchored_window_edges():
    """A table with an nb past uint16's byte (the lanes on it walk from
    dtabs) and one with code lengths 0, table ids out of range (clamped),
    bits past the row's end, at 0 and below it, n = 0, n past cap; a
    block whose first and last lanes stage two tables, and one whose last
    lane's table cannot be staged; rows of 510 bytes (mirror and plain)."""
    inp, tables, _ = _chunk_lanes()
    T = len(tables)
    big = tables[0].copy()
    big[::9] = (300 << 8) | (big[::9] & 255)
    holes = tables[0].copy()
    holes[::7] &= 255
    tables = np.concatenate([tables, big[None], holes[None]]).astype(np.int32)
    SB = inp["bank"].shape[1]
    edits = [("tid", T), ("tid", T + 1), ("tid", T + 5), ("tid", -3),
             ("bits", 8 * SB + 64), ("bits", 0), ("bits", -20), ("n", 0),
             ("n", inp["cap"] + 9)]
    c = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in inp.items()}
    for i, (key, v) in enumerate(edits):
        c[key][3 + 40 * i] = v
    # block 0's last lane and ten others on the table with holes (a
    # second staged table), block 1's last lane on the one past uint16
    c["tid"][HM.ANCHOR_THREADS - 11: HM.ANCHOR_THREADS] = T + 1
    c["tid"][2 * HM.ANCHOR_THREADS - 1] = T
    (_, _), st = _three(c, tables)
    assert st["staged_lanes"] < st["lanes"]
    # rows of 510 bytes: words shared by two rows, stored byte by byte
    (_, _), st = _three(dict(c, cap=510), tables, ref=False)
    assert st["staged_lanes"] > 0
