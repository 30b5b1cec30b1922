"""The hash-parser path's refusals: unknown parser and entropy names (the
sort parser is accepted), K7's retired seeded arm (ROADMAP A11) and
malformed K7 inputs, and device="cuda" without a card."""

import pytest
import torch

from libzseek_tpu_torch import ZstdCodec
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.ops.hash_parse import hash_parse


def test_codec_keywords():
    c = ZstdCodec(level=1, device="cpu", parser="sort")
    assert (c.parser, c.seg_size, c.max_len) == ("sort", 8, 32)
    for kw in (dict(parser="lazy"), dict(parser=None),
               dict(entropy="vector"), dict(entropy="SMEM")):
        with pytest.raises(ParameterError):
            ZstdCodec(device="cpu", **kw)
    for parser in ("auto", "linked", "hash"):
        for entropy in ("auto", "smem", "xla"):
            c = ZstdCodec(device="cpu", parser=parser, entropy=entropy)
            assert c.parser == ("linked" if parser == "auto" else parser)
            assert c.entropy == entropy


def test_k7_refusals(monkeypatch):
    x = torch.zeros((2, 4096), dtype=torch.uint8)
    lens = torch.full((2,), 4096, dtype=torch.int32)
    for kw in (dict(start_ip=64), dict(end_margin=5),
               dict(min_ref=torch.zeros(2, dtype=torch.int32))):
        with pytest.raises(ParameterError, match="A11"):
            hash_parse(x, lens, **kw)
    for bad in ((x[:, :4094], lens), (x.to(torch.int32), lens),
                (x, lens.to(torch.int64)), (x, lens[:1]),
                (torch.zeros((2, 1 << 18), dtype=torch.uint8), lens)):
        with pytest.raises(ParameterError):
            hash_parse(*bad)
    assert int(hash_parse(x, lens)[3].sum()) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ParameterError):
        ZstdCodec(parser="hash")
