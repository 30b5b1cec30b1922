"""The lane route's kernels on the card against their plain versions: the
Huffman and sequence lane decoders (plain and anchored passes) and K6,
each call the route makes replayed on the CPU with the same inputs.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.
Outputs are bytes, integers and flags and must be equal (tolerance:
none)."""

import io

import numpy as np
import pytest
import torch

import libzseek_tpu_torch as port
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.ops import exec_blocks as X
from libzseek_tpu_torch.ops import lanes as L
from libzseek_tpu_torch.ops import zstd_decode as ZD
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from libzseek_tpu_torch.testing.damage import lane_variants
from test_torch_cuda_inputs import (cuda_device, huf_plain_edges,
                                    leftover_bits_frame, own_frames,
                                    record_lane_calls,
                                    replay_on_cpu, stock_frames)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _archive(device):
    data = mixed_corpus(np.random.default_rng(11), 2 << 20).tobytes()
    sink = io.BytesIO()
    w = port.Writer(sink, device=device, min_frame_size=512 * 1024)
    for pos in range(0, len(data), 512 * 1024):
        w.write(data[pos: pos + 512 * 1024])
    w.close()
    return sink.getvalue(), data


def _variants_match_plain(calls, cuda):
    """Each recorded lane-decoder call's variants (testing/damage.py
    lane_variants: damaged streams, shuffled lanes, mixed tables, rows
    longer than the tagged arm's stage) on the card equal the plain
    version's; every arm meets each variant."""
    seen = set()
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
    for i, (fn, a, kw, _) in enumerate(calls):
        if fn.__name__ not in ("huf_lanes", "seq_lanes"):
            continue
        arm = (fn.__name__, kw.get("exact", kw.get("tagged")))
        for name, v in lane_variants({k: cpu(x) for k, x in kw.items()},
                                     i).items():
            got = fn(**{k: (x.to(cuda) if isinstance(x, torch.Tensor)
                            else x) for k, x in v.items()})
            ref = fn(**v)
            for x, y in zip(got, ref):
                np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
            seen.add((arm, name))
    arms = {a for a, _ in seen}
    assert len(arms) == 4 and all((a, n) in seen for a in arms
                                  for n in ("damaged", "shuffled",
                                            "mixed tables")), seen
    assert any(n == "wide" and a[0] == "seq_lanes" and a[1]
               for a, n in seen), seen


def test_lane_kernels_match_plain(cuda, monkeypatch):
    """Every kernel call of the lane route on the port's frames, stock
    libzstd's and an archive with its hints; damaged streams give the
    same flags; every arm of both decoders on damaged streams, shuffled
    lanes, mixed tables and (the tagged arm) rows longer than its stage;
    the Huffman plain arm's pieces on long, damaged, short
    and over-long streams, at and below bit 0 and with a table of code
    length 0 (tests/test_torch_cuda_inputs.huf_plain_edges)."""
    frames, raws = own_frames(device="cuda")
    sf, sr = stock_frames()
    frames, raws = frames + sf[:-1], raws + sr[:-1]
    res, calls = record_lane_calls(monkeypatch, frames,
                                   [len(r) for r in raws], None, cuda)
    assert res == raws
    assert {c[0].__name__ for c in calls} == {"huf_lanes", "seq_lanes",
                                              "execute_blocks"}
    replay_on_cpu(calls)
    plain_calls = calls
    archive, data = _archive("cuda")
    r = port.Reader(archive, device="cpu", decoder="lanes")
    n = r.seek_table.num_frames
    fr = [r._read_frame_bytes(i) for i in range(n)]
    res, calls = record_lane_calls(monkeypatch, fr,
                                   [r.seek_table.frame_d_size(i)
                                    for i in range(n)], r._hints, cuda)
    assert b"".join(res) == data
    assert not any(c[2].get("exact", True) is True for c in calls
                   if c[0].__name__ == "huf_lanes")     # anchored only
    replay_on_cpu(calls)
    _variants_match_plain(plain_calls + calls, cuda)
    # damaged Huffman and sequence lanes
    rng = np.random.default_rng(3)
    huf, fse = ZD._HufReg(), ZD._FseReg()
    plans = [ZD._parse_frame_impl(f, huf, fse) for f in frames]
    lanes = [l for p in plans for bp in p.blocks for l in bp.huf_lanes or ()]
    bad = []
    for l in lanes:
        b = bytearray(l.stream)
        b[int(rng.integers(0, max(1, len(b) - 1)))] ^= 0x5A
        bad.append(ZD._HufLane(bytes(b), l.n_out, l.tid))
    inp, _ = ZD.huf_lane_inputs(lanes + bad)
    W, TLS = huf.weights_arr()
    outs = []
    for dev in (cuda, torch.device("cpu")):
        dt = ZD.build_dtabs(torch.from_numpy(W).to(dev),
                            torch.from_numpy(TLS).to(dev))
        outs.append(L.huf_lanes(dtabs=dt, **ZD._upload(inp, dev)))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    assert not outs[1][1].all()
    # the plain arm's pieces on long, damaged, short and over-long streams
    inp, dtabs = huf_plain_edges(np.random.default_rng(5))
    n0 = L.huf_plain_launches
    outs = [L.huf_lanes(dtabs=dtabs.to(dev), **ZD._upload(inp, dev))
            for dev in (cuda, torch.device("cpu"))]
    assert L.huf_plain_launches == n0 + 1
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    assert outs[1][1][:3].all() and not outs[1][1][3:].any()


def test_k6_and_the_lane_route_on_the_card(cuda, monkeypatch):
    """K6 against plain on overlapping copies (offsets 1-33); the lane
    route on the card returns the input as host bytes and as CUDA
    tensors, K6 and the pointer-doubling executor each take a batch, and
    a corrupt frame raises."""
    rng = np.random.default_rng(5)
    seqs = [(5, 9, 1), (3, 12, 2), (4, 10, 3), (2, 11, 4), (6, 20, 7),
            (31, 40, 31), (3, 64, 32), (33, 70, 33), (1, 6, 5)]
    S = 16
    ll = np.zeros((2, S), np.int32)
    ml = np.zeros((2, S), np.int32)
    off = np.ones((2, S), np.int32)
    for j, (a, m, o) in enumerate(seqs):
        ll[0, j], ml[0, j], off[0, j] = a, m, o
    c0 = sum(a + m for a, m, _ in seqs)
    ll[1, :2], ml[1, :2], off[1, :2] = (4, 4), (100, 300), (c0 + 4, 90)
    c1 = 408
    lit = rng.integers(0, 256, (2, 256), np.uint8)
    meta = np.array([[len(seqs), c0, 0], [2, c1, c0]], np.int32)
    args = [torch.from_numpy(a) for a in (
        lit, ll, ml, off, meta, np.array([0, 2], np.int32),
        np.array([0, c0 + c1], np.int64))]
    got = X.execute_blocks(*[a.to(cuda) for a in args], c0 + c1)
    ref = X.execute_blocks(*args, c0 + c1)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.cpu().numpy(), y.numpy())
    assert ref[1].tolist() == [1, 1]

    archive, data = _archive("cuda")
    before = dict(ZD.routes)
    k6 = X.launches
    with port.Reader(archive, device=cuda, decoder="lanes") as r:
        assert r.pread_full(len(data), 0) == data
    with port.Reader(archive, device=cuda, decoder="lanes",
                     device_cache=True) as r:
        assert r.pread_full(4096, 1 << 20) == data[1 << 20: (1 << 20) + 4096]
        assert all(t.device.type == cuda.type
                   for t in r._cache._map.values())
    frames, raws = stock_frames()
    assert ZD.decode_frames_lanes(frames[-1:], [len(raws[-1])],
                                  device=cuda) == raws[-1:]
    routes = {k: ZD.routes[k] - before[k] for k in before}
    assert routes["anchored_frames"] > 0 and routes["k6_batches"] > 0
    assert routes["pointer_doubling_batches"] == 1 and X.launches > k6
    bad, raw = leftover_bits_frame()
    with pytest.raises(FormatError):
        ZD.decode_frames_lanes([bad], [len(raw)], device=cuda)
