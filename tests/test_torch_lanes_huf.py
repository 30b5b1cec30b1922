"""The Huffman lane decoder's plain version against the reference's XLA
lanes: huf_decode_lanes (one lane per stream, pass A) and
huf_decode_anchored (one lane per 512-symbol chunk from the Writer's
anchors, pass A').  Same streams, lanes and table ids; the reference gets
its host tables (_HufReg.packed), the port its device-built ones
(build_dtabs).  Symbols and ok flags are equal (tolerance: none)."""

import numpy as np
import torch

import jax.numpy as jnp
from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_lanes_inputs import (archive_parts, damage, huffman_stream,
                                     jax_huf_tables, kraft_weights,
                                     mixed_archive, own_frames, parse,
                                     stock_frames)


def _port(inp, hufreg):
    W, TLS = hufreg.weights_arr()
    dtabs = ZD.build_dtabs(torch.from_numpy(W), torch.from_numpy(TLS))
    syms, ok = L.huf_lanes(dtabs=dtabs, **ZD._upload(inp, "cpu"))
    return syms.numpy(), ok.numpy()


def test_huf_lanes_match_reference_plain():
    """1- and 4-stream lanes of the port's and libzstd's frames (streams
    of up to 6,144 symbols: the plain walk steps once a symbol), lanes of
    hand-made 12-bit tables (1 and 4 streams), and damaged copies."""
    frames, _ = own_frames()
    sf, _ = stock_frames()
    plans, hufreg, _ = parse(frames + sf)
    lanes = [l for p in plans for bp in p.blocks for l in bp.huf_lanes or ()
             if l.n_out <= 6144]
    assert {len(bp.huf_lanes) for p in plans for bp in p.blocks
            if bp.huf_lanes} == {1, 4}
    rng = np.random.default_rng(41)
    for streams in (1, 4):        # 12-bit tables
        w = kraft_weights(rng, 12)
        tid = hufreg.add(w)
        table = jax_huf_tables(hufreg)[tid]
        for _ in range(streams):
            syms = table[rng.integers(0, 4096, 700)] & 255
            lanes.append(ZD._HufLane(huffman_stream(syms, table), 700, tid))
    assert max(hufreg.tls) == 12
    lanes += [ZD._HufLane(damage(l.stream, rng), l.n_out, l.tid)
              for l in lanes[::3]]
    inp, _ = ZD.huf_lane_inputs(lanes)
    syms, ok = _port(inp, hufreg)
    j_syms, j_ok = JZ.huf_decode_lanes(
        jnp.asarray(JZ._win32(inp["bank"])), jnp.asarray(inp["bits"]),
        jnp.asarray(inp["n"]), jnp.asarray(inp["tid"]),
        jnp.asarray(jax_huf_tables(hufreg)), inp["cap"])
    np.testing.assert_array_equal(syms, np.asarray(j_syms))
    np.testing.assert_array_equal(ok, np.asarray(j_ok))
    n_good = len(lanes) - len(lanes[::3][:len(lanes) // 4])
    assert ok[:n_good].all() and not ok.all()


def test_huf_lanes_match_reference_anchored():
    """The chunk lanes of an archive of the port's Writer, at the anchors
    of its sidecar, and of damaged copies of its streams."""
    frames, sizes, hints = archive_parts(mixed_archive()[0])
    plans, hufreg, _ = parse(frames, sizes)
    lanes, anchors = [], []
    for p, fh in zip(plans, hints):
        assert ZD._frame_hints_usable(p, fh)
        for bp, bh in zip(p.blocks, fh):
            for s, lane in enumerate(bp.huf_lanes or ()):
                lanes.append(lane)
                anchors.append((bh.lit, s))
    rng = np.random.default_rng(43)
    n_clean = len(lanes)
    for j in range(0, n_clean, 5):
        lanes.append(ZD._HufLane(damage(lanes[j].stream, rng, 40),
                                 lanes[j].n_out, lanes[j].tid))
        anchors.append(anchors[j])
    inp, _ = ZD.huf_lane_inputs(lanes, anchors)
    assert len(inp["sid"]) > 4 * len(lanes)
    syms, ok = _port(inp, hufreg)
    j_syms, j_ok = JZ.huf_decode_anchored(
        jnp.asarray(JZ._win32(inp["bank"]).reshape(-1)),
        inp["bank"].shape[1], jnp.asarray(inp["sid"]),
        jnp.asarray(inp["bits"]), jnp.asarray(inp["n"]),
        jnp.asarray(inp["tid"]), jnp.asarray(jax_huf_tables(hufreg)),
        inp["cap"])
    np.testing.assert_array_equal(syms, np.asarray(j_syms))
    np.testing.assert_array_equal(ok, np.asarray(j_ok))
    assert ok[inp["sid"] < n_clean].all()
