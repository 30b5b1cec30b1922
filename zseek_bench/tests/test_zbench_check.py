"""The comparison that decides `correct`, on archives the port writes on
the CPU: a write cell decodes every frame of one kept archive, and a read
is judged by its length as well as by its bytes."""

import io

import numpy as np
import pytest

from zseek_bench import check, traffic
from zseek_bench.reference import archive as ref

FRAME = 1 << 14


@pytest.fixture(scope="module")
def written():
    from libzseek_tpu_torch import Writer
    data = traffic.mixed_corpus(np.random.default_rng(8), 16 * FRAME)
    data = data.tobytes()
    sink = io.BytesIO()
    w = Writer(sink, "zstd", device="cpu", min_frame_size=FRAME,
               batch_frames=4)
    for p in range(0, len(data), FRAME):
        w.write(data[p: p + FRAME])
    w.close()
    return data, sink.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_frame_of_the_whole_archive_is_decoded(written, seed,
                                                     monkeypatch):
    data, a = written
    seen = []
    decode = ref.decode_frame

    def counting(buf, off, c, codec):
        seen.append(off)
        return decode(buf, off, c, codec)

    monkeypatch.setattr(check.ref, "decode_frame", counting)
    got = check.check_write([a], data, "zstd", seed, 0)
    assert all(v == 0 for v, _ in got.values())
    frames = ref.structure(a, "zstd")
    assert len(frames) == 16
    assert {off for off, _, _ in frames} <= set(seen)
    assert len(seen) == 16 + check.FRAMES_DRAWN


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_damaged_frame_is_found_on_every_seed(written, seed):
    data, a = written
    off, c, _ = ref.structure(a, "zstd")[9]
    bad = bytearray(a)
    bad[off + c // 2] ^= 0xFF
    bad = bytes(bad)
    got = check.check_write([bad], data, "zstd", seed, 0)
    assert got["archives_malformed"][0] + got["frames_wrong"][0] >= 1


def test_a_short_read_is_wrong():
    data = bytes(range(256)) * 64
    good = [(100, data[100: 4196]), (0, data[:4096])]
    assert check.check_reads(good, data, 4096, 0)["reads_wrong"] == (0, 0)
    short = [(100, data[100: 4195]), (0, b"")]
    assert check.check_reads(short, data, 4096, 0)["reads_wrong"] == (2, 0)
