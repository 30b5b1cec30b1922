"""The codecs' round-robin over four injected CPU devices (as
tests/test_torch_workers.py) for the zstd parsers that run per block:
the sort parser, and the hash parser on either entropy arm (K2's, and
the XLA arm with its literals plane).  Each archive is byte-identical to
workers=1's on the same 512 KiB of mixed_corpus, `_rr` counts the
batches, and stock libzstd decodes it."""

import pytest

from libzseek_tpu_torch.testing import golden
from test_torch_workers import mixed_512k, round_robin_matches, zstd

pytestmark = pytest.mark.skipif(not golden.have_zstd(),
                                reason="system libzstd unavailable")


def test_round_robin_sort_parser(monkeypatch):
    round_robin_matches(monkeypatch, zstd(1, parser="sort"),
                        "_dispatch_parse", golden.zstd_decompress,
                        mixed_512k(), 1 << 17)


def test_round_robin_hash_parser(monkeypatch):
    data = mixed_512k()
    for entropy in ("auto", "xla"):
        round_robin_matches(monkeypatch,
                            zstd(1, parser="hash", entropy=entropy),
                            "_dispatch_parse", golden.zstd_decompress,
                            data, 1 << 17)
