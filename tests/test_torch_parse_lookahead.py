"""K1's warp walk, its look-ahead: the positions the lanes of a dual-arm
miss run take and the bytes, buckets and tags each lane computes from the
window's words (ops/parse_linked.run_positions and lane_hashes, mirrors
of csrc/parse_linked.cu's run_dual and insert_span), against the serial
walk's miss steps and _row_hashes, the plain walk's table of every
position.  Integers: tolerance none."""

import numpy as np

from libzseek_tpu_torch.ops.parse_linked import (LANES, _row_hashes,
                                                 lane_hashes, run_positions)

N = 4096


def _window(seed):
    """Two 4 KiB rows of small-vocabulary text with repeats."""
    rng = np.random.default_rng(seed)
    voc = np.frombuffer(b"the cat sat on a mat; ", np.uint8)
    win = rng.choice(voc, 2 * N).astype(np.uint8)
    win[N + 500: N + 900] = win[100: 500]
    return win


def test_run_positions_and_probe_values():
    """Every lane's position is the serial walk's next probe after the
    lanes before it missed; at every probe position (unclamped loads),
    in strict and non-strict rows, with and without the dual table, its
    buckets and tags equal _row_hashes'."""
    win = _window(3)
    limit = 2 * N - 12
    wb = win.tobytes()
    for strict in (True, False):
        for dual in (True, False):
            (H, T), lng = _row_hashes(win, strict, dual)
            for ip, miss, accel in ((N, 0, 8), (N + 3, 1000, 8),
                                    (N + 101, 7000, 10), (limit - 50, 0, 14),
                                    (limit - 5, 300, 5)):
                p, d, valid = run_positions(ip, miss, accel, limit)
                q, m = ip, miss
                for j in range(LANES):
                    assert p[j] == q and d[j] == 1 + (m >> accel)
                    assert valid[j] == (q < limit)
                    q, m = q + 1 + (m >> accel), m + 1
                pv = p[valid]
                assert len(pv) > 0
                w, ext4, main, long_ = lane_hashes(win, pv, strict, dual)
                for k, x in enumerate(pv.tolist()):
                    assert int(w[k]) == int.from_bytes(wb[x: x + 4], "little")
                    assert int(ext4[k]) == int.from_bytes(wb[x + 4: x + 8],
                                                          "little")
                assert main[0] == [H[x] for x in pv]
                assert main[1] == [T[x] for x in pv]
                if dual:
                    assert long_[0] == [lng[0][x] for x in pv]
                    assert long_[1] == [lng[1][x] for x in pv]
                else:
                    assert long_ is None


def test_insert_values_at_the_clamped_end():
    """A match's inserts reach the window's last bytes, where the
    reference's loads repeat the last word: with clamped loads the
    lanes' values equal _row_hashes' there, in strict and non-strict
    rows, and they differ from the unclamped loads' wherever those would
    read past the window."""
    win = _window(5)
    p = np.arange(2 * N - 12, 2 * N - 1)
    for strict in (True, False):
        for dual in (True, False):
            (H, T), lng = _row_hashes(win, strict, dual)
            _, _, main, long_ = lane_hashes(win, p, strict, dual,
                                            clamped=True)
            assert main == ([H[x] for x in p], [T[x] for x in p])
            if dual:
                assert long_ == ([lng[0][x] for x in p],
                                 [lng[1][x] for x in p])
    padded = np.concatenate([win, np.full(8, 0xA5, np.uint8)])
    _, e_cl, _, _ = lane_hashes(win, p, True, True, clamped=True)
    _, e_pad, _, _ = lane_hashes(padded, p, True, True)
    past = p + 8 > 2 * N
    assert (e_cl[past] != e_pad[past]).all()
    assert (e_cl[~past] == e_pad[~past]).all()
