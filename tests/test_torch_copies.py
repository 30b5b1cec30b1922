"""The port's copies of the JAX package's JAX-free modules against their
originals: the format layer (zstd frame and block headers, seek table,
hints sidecar, FSE table descriptions, Huffman tree descriptions) and
the testing layer (corpus generators, libzstd bindings).  Bytes and
arrays, compared exactly, on inputs from numpy seeds."""

import numpy as np

from libzseek_tpu.format import hints as jhints
from libzseek_tpu.format import seek_table as jst
from libzseek_tpu.format import zstd_frame as jzf
from libzseek_tpu.ops import fse as jfse
from libzseek_tpu.ops import huffman as jhuf
from libzseek_tpu.testing import corpus as jcorpus
from libzseek_tpu.testing import golden as jgolden
from libzseek_tpu_torch.format import hints, seek_table, zstd_frame
from libzseek_tpu_torch.ops import fse, huffman
from libzseek_tpu_torch.testing import corpus, golden


def test_format_copies_match_originals():
    rng = np.random.default_rng(41)
    for n in (0, 1, 255, 256, 65791, 65792, 1 << 20, (1 << 32) + 5):
        h = zstd_frame.build_frame_header(n)
        assert h == jzf.build_frame_header(n)
        assert zstd_frame.parse_frame_header(h) == \
            zstd_frame.FrameHeader(**vars(jzf.parse_frame_header(h)))
    for bt in (0, 1, 2):
        b = zstd_frame.build_block_header(bt, 12345, bt == 2)
        assert b == jzf.build_block_header(bt, 12345, bt == 2)
        assert zstd_frame.parse_block_header(b, 0) == \
            jzf.parse_block_header(b, 0)
    for flag in (False, True):
        ours, ref = seek_table.FrameLog(flag), jst.FrameLog(flag)
        for c, d in rng.integers(1, 1 << 31, (20, 2)).tolist():
            ours.log_frame(c, d, checksum=c ^ d)
            ref.log_frame(c, d, checksum=c ^ d)
        blob = ours.serialize()
        assert blob == ref.serialize() and ours.size() == ref.size()
        a = seek_table.parse_seek_table_bytes(blob)
        b = jst.parse_seek_table_bytes(blob)
        np.testing.assert_array_equal(a.d_offsets, b.d_offsets)
        assert a.frame_for_offset(int(a.d_offsets[7]) + 3) == \
            b.frame_for_offset(int(b.d_offsets[7]) + 3)
    blocks = [hints.BlockHints(hints.StreamAnchors(512, [[1, 2], [3], [], [9]]),
                               hints.SeqAnchors(128, [70, 90],
                                                [(1, 2, 3), (4, 5, 6)],
                                                [1, 9])),
              None, hints.BlockHints(None, hints.SeqAnchors(128, [], []))]
    jblocks = [jhints.BlockHints(
        jhints.StreamAnchors(512, [[1, 2], [3], [], [9]]),
        jhints.SeqAnchors(128, [70, 90], [(1, 2, 3), (4, 5, 6)], [1, 9])),
        None, jhints.BlockHints(None, jhints.SeqAnchors(128, [], []))]
    assert hints.serialize([blocks, blocks[:1]]) == \
        jhints.serialize([jblocks, jblocks[:1]])
    for log, nsym in ((5, 29), (6, 36), (9, 53)):
        counts = rng.integers(0, 50, nsym) * (rng.random(nsym) < 0.7)
        norm = jhuf.normalize_counts(counts, log, int(counts.sum()))
        desc = fse.write_norm_counts(norm, log)
        assert desc == jfse.write_norm_counts(norm, log)
        got, ref = fse.read_norm_counts(desc, 0, nsym - 1), \
            jfse.read_norm_counts(desc, 0, nsym - 1)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
        for a, b in zip(vars(fse.build_decode_table(norm, log)).values(),
                        vars(jfse.build_decode_table(norm, log)).values()):
            np.testing.assert_array_equal(a, b)
        et, jet = fse.build_encode_table(norm, log), \
            jfse.build_encode_table(norm, log)
        for a, b in zip(vars(et).values(), vars(jet).values()):
            np.testing.assert_array_equal(a, b)
    for n_sym in (2, 40, 140):      # direct and FSE-compressed weights
        counts = np.zeros(256, np.int64)
        counts[rng.choice(256, n_sym, replace=False)] = \
            1 + (rng.pareto(1.0, n_sym) * 30).astype(np.int64)
        tree = jhuf.write_weights(jhuf.build_ctable(counts))
        got, ref = huffman.read_weights(tree, 0), jhuf.read_weights(tree, 0)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_testing_copies_match_originals():
    for n in (0, 1000, 1 << 16):
        for gen in ("mixed_corpus", "text_corpus"):
            a = getattr(corpus, gen)(np.random.default_rng(n), n)
            b = getattr(jcorpus, gen)(np.random.default_rng(n), n)
            np.testing.assert_array_equal(a, b)
    assert golden.have_zstd() == jgolden.have_zstd()
    if not golden.have_zstd():
        return
    data = corpus.mixed_corpus(np.random.default_rng(5), 300_000).tobytes()
    for level, strategy in ((1, golden.ZSTD_fast), (3, golden.ZSTD_fast),
                            (19, None)):
        fr = golden.zstd_compress(data, level, strategy)
        assert fr == jgolden.zstd_compress(data, level, strategy)
        assert golden.zstd_frame_decompress(fr, len(data)) == data
        assert golden.zstd_decompress(fr + fr) == data + data
