"""K6's plain version against the reference kernel, on the reference's own
rows.

The JAX package's decode_frames runs its lane route with the block
executor forced on (tests/test_torch_lanes_inputs.capture_k6); every
array it passes to pallas_match.execute_blocks_smem, which runs in
interpret mode, is recorded and fed, unchanged but for its padding rows,
to the port's ops/exec_blocks.execute_blocks on the CPU with the frames'
chain layout.  Every block is ok and its first `content` bytes equal the
reference's output row (tolerance: none, bytes)."""

import numpy as np

from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from test_torch_lanes_inputs import (archive_parts, blocks_per_frame,
                                     capture_k6, check_rows, mixed_archive,
                                     port_archive)


def test_plain_k6_matches_pallas_on_mixed_frames(monkeypatch):
    """Four 256 KiB frames of two blocks, one per regime of the mixed
    corpus, through the anchored lanes (the archive's hints)."""
    archive, data = mixed_archive()
    frames, sizes, hints = archive_parts(archive)
    res, calls = capture_k6(monkeypatch, frames, sizes, hints)
    assert b"".join(res) == data
    assert len(calls) == 1
    args, out = calls[0]
    assert check_rows(args, out, blocks_per_frame(frames, sizes),
                      sizes) == 8


def test_plain_k6_matches_pallas_after_a_full_frame(monkeypatch):
    """A batch whose second frame starts after a frame that fills the
    reference's 256 KiB ring, through the plain lanes (no hints); then a
    short text frame."""
    rng = np.random.default_rng(23)
    raws = [mixed_corpus(rng, 256 * 1024).tobytes(),
            text_corpus(rng, 200 * 1024).tobytes(),
            text_corpus(rng, 3000).tobytes()]
    frames = []
    for r in raws:
        frames += archive_parts(port_archive(r, len(r)))[0]
    sizes = [len(r) for r in raws]
    res, calls = capture_k6(monkeypatch, frames, sizes)
    assert res == raws
    assert len(calls) == 1
    args, out = calls[0]
    assert check_rows(args, out, blocks_per_frame(frames, sizes),
                      sizes) == 5
