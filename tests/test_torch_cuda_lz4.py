"""K5 and the LZ4 decoder's CUDA kernels against their plain versions on
the card.

Marked `cuda`: they need an NVIDIA GPU with sm_90a and nvcc, and skip
elsewhere (the check runs inside the tests, not at import).  On the GPU
machine (which has no jax, hence --noconftest):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py`.  Outputs
are bytes, lengths and flags and must be equal (tolerance: none)."""

import numpy as np
import pytest
import torch

from libzseek_tpu_torch import LZ4Codec
from libzseek_tpu_torch.errors import FormatError
from libzseek_tpu_torch.format import lz4f
from libzseek_tpu_torch.ops import lz4_decode as LD
from libzseek_tpu_torch.ops import lz4_emit as LE
from libzseek_tpu_torch.testing import golden
from libzseek_tpu_torch.testing.corpus import mixed_corpus, text_corpus
from test_torch_cuda_inputs import cuda_device, same

pytestmark = pytest.mark.cuda

BK = 4096
BLOCK = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    return cuda_device()


def _k5_cases():
    """(D, lens, min_ref, level): three linked 4 KiB rows; eight rows in
    three frames with a short block; a batch whose row 0 is the previous
    block of its first row's frame (the seed); four 64 KiB rows of every
    mixed regime at each level arm; and the same rows independent."""
    rng = np.random.default_rng(23)
    s = rng.choice(np.frombuffer(b"a modest shared vocabulary ", np.uint8),
                   8 * BK).astype(np.uint8)
    s[BK + 100: BK + 400] = s[50: 350]
    D = np.zeros((9, BK), np.uint8)
    D[1:] = s.reshape(8, BK)
    cases = [(D[:4], np.full(3, 2 * BK, np.int32),
              np.array([BK, BK, 2 * BK], np.int32), 0)]
    lens = np.full(8, 2 * BK, np.int32)
    lens[6] = BK + 1000
    D8 = D.copy()
    D8[7, 1000:] = 0
    mr = np.array([(i + 1) * BK if i in (0, 3, 7) else i * BK
                   for i in range(8)], np.int32)
    cases.append((D8, lens, mr, 0))
    x = mixed_corpus(np.random.default_rng(41), 4 * BLOCK)
    Ds = np.zeros((4, BLOCK), np.uint8)
    Ds[0] = x[:BLOCK]
    Ds[1, :BLOCK - 7] = x[7: BLOCK]
    Ds[2] = x[BLOCK: 2 * BLOCK]
    cases.append((Ds, np.array([2 * BLOCK - 7, 2 * BLOCK, 2 * BLOCK],
                               np.int32),
                  np.array([0, 2 * BLOCK, 2 * BLOCK], np.int32), 0))
    Dm = np.zeros((5, BLOCK), np.uint8)
    Dm[1:] = x.reshape(4, BLOCK)
    linked = np.array([BLOCK, BLOCK, 2 * BLOCK, 4 * BLOCK], np.int32)
    for level in (-1, 0, 3, 9):
        cases.append((Dm, np.full(4, 2 * BLOCK, np.int32), linked, level))
    cases.append((Dm, np.full(4, 2 * BLOCK, np.int32),
                  (np.arange(4, dtype=np.int32) + 1) * BLOCK, 0))
    return cases


def test_k5_kernel_matches_plain(cuda):
    for D, lens, mr, level in _k5_cases():
        cap = LE.out_cap(D.shape[1])
        kw = LZ4Codec._level_params(level)
        args = [torch.from_numpy(a) for a in (D, lens, mr)]
        got = LE.lz4_emit(*[a.to(cuda) for a in args], cap, **kw)
        ref = LE.lz4_emit(*args, cap, **kw)
        same(got, ref)


def test_lz4_decoder_matches_plain(cuda):
    rng = np.random.default_rng(5)
    text = text_corpus(rng, 2 * BLOCK + 5000).tobytes()
    m = mixed_corpus(rng, 4 * BLOCK).tobytes()
    noise = rng.integers(0, 256, BLOCK + 99, np.uint8).tobytes()
    raws = [text, m, noise, b"abcabcabcabc"]
    for independent in (False, True):
        codec = LZ4Codec(device="cuda", block_independent=independent)
        frames = codec.compress_frames(raws)
        frames += [golden.lz4f_compress(r, block_independent=independent)
                   for r in raws]
        sizes = [len(r) for r in raws] * 2
        assert codec.decompress_frames(frames, sizes) == raws + raws
        dev = codec.decompress_frames(frames, sizes, to_device=True)
        assert all(t.is_cuda for t in dev)
        assert [t.cpu().numpy().tobytes() for t in dev] == raws + raws
        # the decoder on the codec's packed rows, and on damaged copies
        # of the first frame's second block
        parsed = []
        for f in frames:
            info = lz4f.parse_frame_header(f)
            parsed.append(lz4f.parse_blocks(f, info, info.header_size)[0])
        K, M = 8, BLOCK
        comp = np.zeros((len(frames) + 12, K, M), np.uint8)
        clens = np.zeros((len(frames) + 12, K), np.int32)
        unc = np.zeros((len(frames) + 12, K), bool)
        for r, (f, blocks) in enumerate(zip(frames, parsed)):
            for k, b in enumerate(blocks):
                comp[r, k, : b.size] = np.frombuffer(f, np.uint8, b.size,
                                                     b.offset)
                clens[r, k] = b.size
                unc[r, k] = b.uncompressed
        for j in range(12):
            r = len(frames) + j
            comp[r], clens[r], unc[r] = comp[0], clens[0], unc[0]
            for p in rng.integers(0, int(clens[r, 1]), 1 + j % 3).tolist():
                comp[r, 1, p] = int(rng.integers(0, 256))
            if j == 11:
                clens[r, 1] -= 9
        F = 4 * BLOCK
        args = [torch.from_numpy(a) for a in (comp, clens, unc)]
        for max_seqs in (None, 40):
            got = LD.lz4_decode_frames(*[a.to(cuda) for a in args], F,
                                       max_seqs=max_seqs,
                                       linked=not independent)
            ref = LD.lz4_decode_frames(*args, F, max_seqs=max_seqs,
                                       linked=not independent)
            ok = ref[2].numpy()
            np.testing.assert_array_equal(got[2].cpu().numpy(), ok)
            np.testing.assert_array_equal(got[1].cpu().numpy(),
                                          ref[1].numpy())
            np.testing.assert_array_equal(got[0].cpu().numpy()[ok],
                                          ref[0].numpy()[ok])
            if max_seqs is None:
                assert ok[: len(frames)].all()
    bad = bytearray(frames[0])
    first = parsed[0][0].offset
    bad[first: first + 3] = bytes(3)     # token 0, offset 0
    for to_device in (True, False):       # the card's route, the host's
        with pytest.raises(FormatError):
            LZ4Codec(device="cuda").decompress_frames(
                [bytes(bad)], [len(text)], to_device=to_device)
