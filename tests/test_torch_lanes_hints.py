"""The port's reader half of the decode-hints sidecar against the JAX
package's: hints.parse on the sidecar of an archive of the port's Writer,
and the Reader's _load_hints on that archive (equal records)."""

import dataclasses

from libzseek_tpu.format import hints as JH
from libzseek_tpu.runtime.reader import Reader as JaxReader
import libzseek_tpu_torch as port
from libzseek_tpu_torch.format import hints as PH
from test_torch_lanes_inputs import mixed_archive


def _plain(frames):
    """Hints as nested tuples and lists, comparable across the packages."""
    return [[None if bh is None else
             (None if bh.lit is None else dataclasses.astuple(bh.lit),
              None if bh.seq is None else dataclasses.astuple(bh.seq))
             for bh in fr] for fr in frames]


def test_hints_parse_matches_jax():
    archive, _ = mixed_archive()
    blob_end = len(archive) - (8 + 8 * 4 + 9)   # the seek table's bytes
    total = int.from_bytes(archive[blob_end - 4: blob_end], "little")
    blob = archive[blob_end - total: blob_end]
    got, ref = PH.parse(blob), JH.parse(blob)
    assert got is not None and len(got) == 4
    assert _plain(got) == _plain(ref)
    assert PH.parse(blob[:-9]) is None and JH.parse(blob[:-9]) is None
    assert PH.parse(b"\x00" * 32) is None


def test_reader_load_hints_matches_jax():
    archive, data = mixed_archive()
    r = port.Reader(archive, device="cpu", decoder="lanes")
    j = JaxReader(archive)
    assert r._hints is not None and len(r._hints) == 4
    assert _plain(r._hints) == _plain(j._hints)
    assert _plain([r._frame_hints(2)]) == _plain([j._frame_hints(2)])
    assert _plain(port.Reader(archive, device="cpu")._hints) == \
        _plain(j._hints)                                 # "auto"
    assert port.Reader(archive, device="cpu",
                       decoder="fused")._hints is None
