"""The LZ4 decoder's kernels on the card against its plain version:
hand-written linked and independent frames whose copies overlap
themselves (offsets 1-31), reach 32 bytes or more back, cross into the
previous block, and the bad cases; and a reader window of the codec's
and liblz4's frames with damaged copies and a short last frame.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.  out,
out_lens and ok are integers and must be equal (tolerance: none; out
where ok)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import LZ4Codec
from libzseek_tpu_torch.format import lz4f
from libzseek_tpu_torch.ops import lz4_decode as LD
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from test_torch_cuda_inputs import cuda_device, rows_of_blocks, seq_block

pytestmark = pytest.mark.cuda
BLOCK = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _both(comp, clens, unc, F, linked, cuda, max_seqs=None):
    args = [torch.from_numpy(a) for a in (comp, clens, unc)]
    got = LD.lz4_decode_frames(*(a.to(cuda) for a in args), F,
                               max_seqs=max_seqs, linked=linked)
    ref = LD.lz4_decode_frames(*args, F, max_seqs=max_seqs, linked=linked)
    got = [a.cpu().numpy() for a in got]
    ref = [a.numpy() for a in ref]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0][ref[2]], ref[0][ref[2]])
    return got


def test_crafted_frames_match_plain(cuda):
    b0 = seq_block([(b"ab", 2, 61), (b"XYZ", 1, 300),
                    (bytes(range(40)), 40, 200), (b"", 500, 20),
                    (b"q" * 300, 7, 100), (b"k", 31, 64)], b"END0")
    frames = [
        [(b0, False), (seq_block([(b"", 100, 150)], b"E1"), False),
         (b"RAW" * 50, True)],
        [(b0, False), (seq_block([(b"hello world", 6, 40)], b"t"), False)],
        [(seq_block([(b"ab", 10, 8)], b"t"), False)],           # before
        [(b0, False), (seq_block([(b"", 50, 9)]), False)],      # past blk
        [(seq_block([(b"a", 0, 5)], b"t"), False)],              # offset 0
        [(b0[:-3], False), (b0, False)],                         # truncated
        [(seq_block([(b"ab", 2, 6)] * 10, b"!"), False), (b0, False)],
    ]
    comp, clens, unc = rows_of_blocks(frames, 4096)
    for linked in (True, False):
        for max_seqs in (None, 7):
            ok = _both(comp, clens, unc, 3 * 4096, linked, cuda,
                       max_seqs)[2]
            assert ok.tolist() == [
                linked, True, False, linked, False, False,
                max_seqs is None]


def test_window_with_damage_and_a_short_frame(cuda):
    """Linked and independent frames of the codec (on the card) and of
    liblz4, eight damaged copies of the first, the last frame 3,000
    bytes; then the codec's own window decode of the good frames (the
    card route, to_device=True, and the host route)."""
    rng = np.random.default_rng(101)
    raws = [mixed_corpus(rng, 4 * BLOCK).tobytes(),
            mixed_corpus(rng, 2 * BLOCK + 77).tobytes(),
            rng.integers(0, 4, 3000, np.uint8).tobytes()]
    for independent in (False, True):
        codec = LZ4Codec(device="cuda", block_independent=independent)
        frames = codec.compress_frames(raws)
        frames += [golden.lz4f_compress(r, block_independent=independent)
                   for r in raws]
        frames += [frames[0]] * 8
        blocks = []
        for f in frames:
            info = lz4f.parse_frame_header(f)
            blocks.append([(f[b.offset: b.offset + b.size], b.uncompressed)
                           for b in lz4f.parse_blocks(f, info,
                                                      info.header_size)[0]])
        for j in range(8):
            blk, u = blocks[6 + j][1]
            b = bytearray(blk)
            for p in rng.integers(0, len(b), 1 + j % 3).tolist():
                b[p] = int(rng.integers(0, 256))
            blocks[6 + j][1] = (bytes(b[: len(b) - (j == 7) * 11]), u)
        M = max(len(b) for f in blocks for b, _ in f)
        comp, clens, unc = rows_of_blocks(blocks, (M + 4095) // 4096 * 4096)
        out, out_lens, ok = _both(comp, clens, unc, 4 * BLOCK,
                                  not independent, cuda)
        assert ok[:6].all()
        for r, raw in enumerate(raws + raws):
            assert out[r, : len(raw)].tobytes() == raw
            assert not out[r, len(raw):].any()
        sizes = [len(r) for r in raws]
        assert codec.decompress_frames(frames[:3], sizes) == raws
        dev = codec.decompress_frames(frames[:3], sizes, to_device=True)
        assert [t.cpu().numpy().tobytes() for t in dev] == raws
