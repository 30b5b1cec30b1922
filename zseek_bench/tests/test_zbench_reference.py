"""The plain reference decoders against the stock libraries (libzstd and
liblz4 through ctypes) and against the port's CPU archives, and the
archive walk against damaged archives."""

import io

import numpy as np
import pytest

from zseek_bench import traffic
from zseek_bench.reference import archive, lz4, xxhash, zstd


@pytest.fixture(scope="module")
def golden():
    from libzseek_tpu_torch.testing import golden as g
    if not (g.have_zstd() and g.have_lz4()):
        pytest.skip("no system libzstd or liblz4")
    return g


def _inputs():
    rng = np.random.default_rng(21)
    for n in (0, 1, 77, 4096, 300_001):
        yield f"mixed-{n}", traffic.mixed_corpus(rng, n).tobytes()
    # long runs of short matches, over 4096 sequences a 128 KiB block
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo"]
    idx = rng.integers(0, len(words), 60_000).tolist()
    yield "lines", b"".join(b"%02x %s;\n" % (i * 37 % 256, words[i])
                            for i in idx)


@pytest.mark.parametrize("level", [-3, 1, 3, 9, 19])
def test_zstd_decodes_what_libzstd_writes(golden, level):
    for name, data in _inputs():
        frame = golden.zstd_compress(data, level, strategy=None)
        out, end = zstd.decode_frame(frame)
        assert out == data and end == len(frame), name


@pytest.mark.parametrize("independent", [True, False])
def test_lz4_decodes_what_liblz4_writes(golden, independent):
    for name, data in _inputs():
        frame = golden.lz4f_compress(data, block_independent=independent)
        out, end = lz4.decode_frame(frame)
        assert out == data and end == len(frame), name


def test_xxhash_matches_the_ports():
    from libzseek_tpu_torch.format.xxhash import xxh32, xxh64
    rng = np.random.default_rng(2)
    for n in (0, 3, 4, 31, 32, 33, 1000):
        d = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxhash.xxh64(d) == xxh64(d) and xxhash.xxh32(d) == xxh32(d)


def _port_archive(codec: str, data: bytes) -> bytes:
    from libzseek_tpu_torch import Writer
    sink = io.BytesIO()
    w = Writer(sink, codec, device="cpu", min_frame_size=1 << 16,
               batch_frames=4)
    for p in range(0, len(data), 1 << 16):
        w.write(data[p: p + (1 << 16)])
    w.close()
    return sink.getvalue()


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_port_archive_walks_and_decodes(codec):
    data = traffic.mixed_corpus(np.random.default_rng(4), 1 << 18).tobytes()
    a = _port_archive(codec, data)
    frames = archive.structure(a, codec)
    assert len(frames) == 4
    got = b"".join(archive.decode_frame(a, off, c, codec)
                   for off, c, _ in frames)
    assert got == data
    # a damaged seek table or frame is refused
    with pytest.raises(archive.ArchiveError):
        archive.structure(a[:-1] + b"\0", codec)
    off, c, _ = frames[1]
    bad = bytearray(a)
    bad[off + c // 2] ^= 0xFF
    try:
        out = archive.decode_frame(bytes(bad), off, c, codec)
    except ValueError:
        return
    assert out != data[1 << 16: 2 << 16]


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_damaged_frames_raise_archive_error_alone(codec):
    """Whatever byte of a frame is flipped, or wherever it is cut, the
    plain decoder returns or raises a ValueError, and never trips on its
    own walk (the check counts a ValueError as a wrong frame)."""
    data = traffic.mixed_corpus(np.random.default_rng(6), 1 << 18).tobytes()
    a = _port_archive(codec, data)
    off, c, _ = archive.structure(a, codec)[0]     # the text frame
    frame = a[off: off + c]
    damaged = [frame[:k] for k in range(1, c, max(1, c // 97))]
    for k in range(0, c, max(1, c // 211)):
        bad = bytearray(frame)
        bad[k] ^= 0xFF
        damaged.append(bytes(bad))
    for d in damaged:
        try:
            archive.decode_frame(d, 0, len(d), codec)
        except ValueError:
            pass


def test_a_sequence_count_cut_short_is_an_archive_error():
    # one compressed block of 2 bytes: no literals, then the first byte
    # of a three-byte sequence count, which the block ends before
    frame = bytes.fromhex("28b52ffd" "20" "05" "150000" "00ff")
    with pytest.raises(archive.ArchiveError):
        archive.decode_frame(frame, 0, len(frame), "zstd")
