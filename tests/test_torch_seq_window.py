"""The sequence lanes as csrc/fse_lanes.cu walks them (tables staged with
ctab folded in, lanes grouped into blocks, six fields a sequence read
from a register window, steps that a window cannot read exactly through
read_at; numpy mirror libzseek_tpu_torch/testing/seq_mirror.py) against
the port's plain version (ops/lanes.seq_lanes on CPU tensors) and the
reference's XLA fse_decode_seq_lanes and fse_decode_anchored
(libzseek_tpu/ops/zstd_decode.py:443, :620).  ll, ml, off, the final
repcodes and ok are equal (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import torch

from libzseek_tpu.ops import zstd_decode as JZ
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing import seq_mirror as SM
from libzseek_tpu_torch.testing.corpus import log_corpus
from test_torch_lanes_inputs import (archive_parts, damage, own_frames,
                                     parse, stock_frames, words_archive,
                                     zstd_level_frames)

LANE_KEYS = ("sid", "bits", "n", "states", "rep1", "tids", "tls")


def _three(inp, tabs, tagged_ref, plain=True):
    """(mirror, plain) outputs equal; the reference's where tagged_ref
    says which function holds them (None: none); the mirror's stats."""
    stats = {}
    mir = SM.seq_mirror(tabs=tabs, stats=stats, **inp)
    if plain:
        got = L.seq_lanes(tabs=torch.from_numpy(tabs),
                          **ZD._upload(inp, "cpu"))
        for a, b in zip(mir, got):
            np.testing.assert_array_equal(a, b.numpy())
    if tagged_ref is True:
        ref = JZ.fse_decode_seq_lanes(
            jnp.asarray(JZ._win32(inp["bank"])), jnp.asarray(inp["bits"]),
            jnp.asarray(inp["n"]), jnp.asarray(inp["tids"]),
            jnp.asarray(inp["tls"]), jnp.asarray(tabs), inp["cap"])
        pairs = zip(mir, ref)
    elif tagged_ref is False:
        ref = JZ.fse_decode_anchored(
            jnp.asarray(JZ._win32(inp["bank"]).reshape(-1)),
            inp["bank"].shape[1], jnp.asarray(inp["sid"]),
            jnp.asarray(inp["bits"]), jnp.asarray(inp["n"]),
            jnp.asarray(inp["states"]), jnp.asarray(inp["rep1"]),
            jnp.asarray(inp["tids"]), jnp.asarray(tabs), inp["cap"])
        pairs = zip(mir[:3] + mir[4:], ref)
    else:
        pairs = ()
    for a, r in pairs:
        np.testing.assert_array_equal(a, np.asarray(r))
    return mir, stats


def _shuffled(inp, rng, rows=False):
    """The lanes in another order; rows=True moves the bank's rows with
    them (pass B's reference reads row l for lane l)."""
    perm = rng.permutation(len(inp["sid"]))
    out = {k: (v[perm].copy() if k in LANE_KEYS else v)
           for k, v in inp.items()}
    if rows:
        out["bank"] = inp["bank"][inp["sid"][perm]]
        out["sid"] = np.arange(len(perm), dtype=np.int32)
    return out


def _widened(inp, SB):
    """The same lanes over a bank of SB-byte rows (longer than the stage)."""
    bank = np.zeros((inp["bank"].shape[0], SB), np.uint8)
    bank[:, : inp["bank"].shape[1]] = inp["bank"]
    return dict(inp, bank=bank)


def _odd_tables(tabs):
    """tabs with two crafted tables appended: codes and nbs past what a
    window reads (offset code 40, state reads of 30 bits) and an RLE-like
    table of one large code."""
    wide = tabs[0].copy()
    wide[::3] = (wide[::3] & ~255) | 40
    wide[1::5] = (wide[1::5] & ~(255 << 8)) | (30 << 8)
    rle = np.full(512, 33 | (2 << 8) | (7 << 16), np.int32)
    return np.concatenate([tabs, wide[None], rle[None]]).astype(np.int32)


def test_tagged_walk_matches_plain_and_reference():
    """Pass B on the port's, libzstd's and libzstd level 1/19 frames'
    sequence sections (predefined, RLE, compressed and repeat tables),
    damaged copies, the lanes shuffled, and a bank wider than the stage
    (the stream read from global memory: the same outputs); the first
    700 sequences of a 12,136-sequence block; then crafted lanes (mirror
    and plain only): tables past the window's widths, wrong logs, n past
    cap, bits past the row's end."""
    frames = own_frames()[0] + stock_frames()[0] + zstd_level_frames()[0]
    plans, _, fsereg = parse(frames)
    bps = [bp for p in plans for bp in p.blocks if bp.n_seq > 0]
    rng = np.random.default_rng(71)
    bad = [ZD._BlockPlan(**{**bp.__dict__,
                            "seq_stream": damage(bp.seq_stream, rng, 2)})
           for bp in bps[::2]]
    inp, _ = ZD.seq_lane_inputs(bps + bad)
    tabs = fsereg.packed()
    n_good = len(bps)
    mir, st = _three(inp, tabs, True)
    ok = mir[4]
    assert ok[:n_good].all() and not ok[n_good:].all()
    assert st["staged_streams"] == len(ok) and st["slow_steps"] == 0
    assert st["steps"] > 400
    _three(_shuffled(inp, rng, rows=True), tabs, True)
    _three(_shuffled(inp, rng), tabs, None)
    # the same lanes over rows longer than the stage: the same outputs
    st = {}
    for a, b in zip(SM.seq_mirror(tabs=tabs, stats=st,
                                  **_widened(inp, 128 * 1024)), mir):
        np.testing.assert_array_equal(a, b)
    assert st["staged_streams"] == 0
    # the first 700 sequences of a 12,136-sequence block (log-like lines
    # through libzstd; the plain version walks ~1 ms a sequence)
    raw = log_corpus(np.random.default_rng(3), 96 * 1024).tobytes()
    plans, _, logreg = parse([golden.zstd_compress(raw, level=3)])
    long_inp, _ = ZD.seq_lane_inputs([bp for p in plans for bp in p.blocks
                                      if bp.n_seq > 0])
    assert long_inp["n"][0] > 12000
    long_inp["n"][0] = 700
    _, st = _three(long_inp, logreg.packed(), None)
    assert st["steps"] == 700 and st["slow_steps"] == 0
    # crafted lanes
    odd = _odd_tables(tabs)
    T = len(tabs)
    k = len(inp["sid"])
    big = np.argsort(-inp["n"], kind="stable")[:8]    # the longest lanes
    crafted = {kk: (np.concatenate([v, v[big]]) if kk in LANE_KEYS else v)
               for kk, v in inp.items()}
    crafted["tids"][k] = (T, T, T)                  # past the window
    crafted["tids"][k + 1] = (T + 1, T + 1, T + 1)  # one large code
    crafted["tids"][k + 2, 1] = T + 7               # clamped table id
    crafted["tls"][k + 3] = (9, 9, 9)               # wrong logs
    crafted["n"][k + 4] = crafted["cap"] + 5        # n past cap
    crafted["bits"][k + 5] = 8 * inp["bank"].shape[1] + 40   # past the row
    crafted["tls"][k + 6] = (0, 0, 0)
    _, st = _three(crafted, odd, None)
    assert st["slow_steps"] > 0 and st["global_entries"] > 0


def test_anchored_walk_matches_plain_and_reference():
    """Pass B' at the checkpoints of an archive of the port's Writer (a
    block of 1,194 sequences, every anchor published), damaged copies, the
    lanes four times over (two blocks of lanes), shuffled with a third on
    other tables (read from tabs), a bank wider than the stage; then crafted
    checkpoints (mirror and plain only): states outside [0, 512), bits past
    the row's end and below 0, tables past the window's widths."""
    frames, sizes, hints = archive_parts(words_archive()[0])
    plans, _, fsereg = parse(frames, sizes)
    bps, anchors = [], []
    for p, fh in zip(plans, hints):
        if ZD._frame_hints_usable(p, fh):
            for bp, bh in zip(p.blocks, fh):
                if bp.n_seq > 0:
                    bps.append(bp)
                    anchors.append(bh.seq)
    rng = np.random.default_rng(73)
    n_clean = len(bps)
    for j in range(n_clean):
        bps.append(ZD._BlockPlan(**{**bps[j].__dict__, "seq_stream":
                                    damage(bps[j].seq_stream, rng, 30)}))
        anchors.append(anchors[j])
    inp, _ = ZD.seq_lane_inputs(bps, anchors)
    # the chunks four times over: 80 lanes, two blocks
    inp = {k: (np.concatenate([v] * 4) if k in LANE_KEYS else v)
           for k, v in inp.items()}
    tabs = fsereg.packed()
    mir, st = _three(inp, tabs, False)
    assert mir[4][inp["sid"] < n_clean].all()
    assert st["global_lanes"] == 0 and st["slow_steps"] == 0
    assert len(inp["sid"]) > SM.ANCHOR_THREADS
    # shuffled, a third of the lanes on the registry's other tables
    mixed = _shuffled(inp, rng)
    k = len(inp["sid"]) // 3
    mixed["tids"][:k] = rng.integers(0, len(tabs), (k, 3))
    _, st = _three(mixed, tabs, False)
    assert st["global_lanes"] > 0
    st = {}
    for a, b in zip(SM.seq_mirror(tabs=tabs, stats=st,
                                  **_widened(inp, 128 * 1024)), mir):
        np.testing.assert_array_equal(a, b)
    # crafted checkpoints
    odd = _odd_tables(tabs)
    T = len(tabs)
    c = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in inp.items()}
    c["states"][0] = (600, -3, 512)
    c["states"][1, 2] = 1 << 20
    c["bits"][2] = 8 * c["bank"].shape[1] + 100
    c["bits"][3] = -50
    c["tids"][4] = (T, T, T)
    c["tids"][5] = (T + 1, T, T + 1)
    c["tids"][6] = (-1, T + 9, 2)
    _, st = _three(c, odd, None)
    assert st["slow_steps"] > 0 and st["global_entries"] > 0
