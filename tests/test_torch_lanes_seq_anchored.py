"""The sequence lane decoder's plain version against the reference's XLA
fse_decode_anchored (pass B': one lane per 128-sequence chunk from the
Writer's (bit position, states, rep1) checkpoints): ll, ml, off and ok
are equal (tolerance: none) on the frames of the port's Writer that
publish every anchor, and on damaged copies of their streams."""

import numpy as np
import torch

import jax.numpy as jnp
from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_lanes_inputs import (archive_parts, damage, mixed_archive,
                                     parse, words_archive)


def test_seq_lanes_match_reference_anchored():
    frames, sizes, hints = [a + b for a, b in zip(
        archive_parts(mixed_archive()[0]), archive_parts(words_archive()[0]))]
    plans, _, fsereg = parse(frames, sizes)
    bps, anchors = [], []
    for p, fh in zip(plans, hints):
        if not ZD._frame_hints_usable(p, fh):
            continue
        for bp, bh in zip(p.blocks, fh):
            if bp.n_seq > 0:
                bps.append(bp)
                anchors.append(bh.seq)
    rng = np.random.default_rng(59)
    n_clean = len(bps)
    for j in range(n_clean):
        bps.append(ZD._BlockPlan(**{**bps[j].__dict__, "seq_stream":
                                    damage(bps[j].seq_stream, rng, 30)}))
        anchors.append(anchors[j])
    inp, spans = ZD.seq_lane_inputs(bps, anchors)
    assert len(inp["sid"]) > 2 * len(bps)
    tabs = fsereg.packed()
    got = L.seq_lanes(tabs=torch.from_numpy(tabs),
                      **ZD._upload(inp, "cpu"))
    ref = JZ.fse_decode_anchored(
        jnp.asarray(JZ._win32(inp["bank"]).reshape(-1)),
        inp["bank"].shape[1], jnp.asarray(inp["sid"]),
        jnp.asarray(inp["bits"]), jnp.asarray(inp["n"]),
        jnp.asarray(inp["states"]), jnp.asarray(inp["rep1"]),
        jnp.asarray(inp["tids"]), jnp.asarray(tabs), inp["cap"])
    for g, r in zip(got[:3] + got[4:], ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ok = got[4].numpy()
    assert ok[inp["sid"] < n_clean].all()
