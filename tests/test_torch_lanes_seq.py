"""The sequence lane decoder's plain version against the reference's XLA
fse_decode_seq_lanes (pass B: one lane per block, tagged repcodes):
ll, ml, tagged offsets, rep_final and ok are equal (tolerance: none) on
the sequence sections of the port's frames and of stock libzstd at
levels 1, 3 and 19, which together use predefined, RLE, compressed and
repeat tables, and on damaged copies of them."""

import numpy as np
import torch

import jax.numpy as jnp
from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from test_torch_lanes_inputs import (damage, own_frames, parse,
                                     section_modes, stock_frames,
                                     zstd_level_frames)


def _compare(bps, fsereg):
    inp, _ = ZD.seq_lane_inputs(bps)
    tabs = fsereg.packed()
    got = L.seq_lanes(tabs=torch.from_numpy(tabs),
                      **ZD._upload(inp, "cpu"))
    ref = JZ.fse_decode_seq_lanes(
        jnp.asarray(JZ._win32(inp["bank"])), jnp.asarray(inp["bits"]),
        jnp.asarray(inp["n"]), jnp.asarray(inp["tids"]),
        jnp.asarray(inp["tls"]), jnp.asarray(tabs), inp["cap"])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got[4].numpy()


def _blocks(frames):
    plans, _, fsereg = parse(frames)
    jplans = []
    jh, jf = JZ._HufReg(), JZ._FseReg()
    for f in frames:
        jplans.append(JZ._parse_frame_impl(f, jh, jf))
    np.testing.assert_array_equal(fsereg.packed(), jf.packed())
    return [bp for p in plans for bp in p.blocks if bp.n_seq > 0], fsereg


def test_seq_lanes_match_reference_plain():
    frames = own_frames()[0] + stock_frames()[0] + zstd_level_frames()[0]
    assert section_modes(frames)[1] == {"predefined", "rle", "compressed",
                                        "repeat"}
    bps, fsereg = _blocks(frames)
    ok = _compare(bps, fsereg)
    assert ok.all()
    assert max(bp.n_seq for bp in bps) > 100


def test_seq_lanes_damaged_streams_match_reference():
    frames = own_frames()[0] + zstd_level_frames()[0]
    bps, fsereg = _blocks(frames)
    rng = np.random.default_rng(53)
    bad = [ZD._BlockPlan(**{**bp.__dict__,
                            "seq_stream": damage(bp.seq_stream, rng, 1 + i % 4)})
           for i, bp in enumerate(bps)]
    ok = _compare(bad, fsereg)
    assert not ok.all()
