"""The traffic generator: the same seed gives the same bytes and offsets,
and the corpus is the port's own generator's bytes."""

import hashlib

import numpy as np

from zseek_bench import traffic

BIG_SEED = 2**31 + 2**20 + 7       # a seed past 32 signed bits


def test_mixed_corpus_is_fixed_by_the_seed():
    cfg = {"input_bytes": 1 << 20}
    a = traffic.corpus(cfg, 11)
    assert a == traffic.corpus(cfg, 11)
    assert a != traffic.corpus(cfg, 12)
    assert hashlib.sha256(a).hexdigest() == \
        "832432b99f0d2135f4996c81b740fefbf1ccbc17dc37f2f5594c2fabc060cfb6"
    q = len(a) // 4
    assert a[2 * q: 3 * q] == bytes(q)               # the zero quarter
    assert a[q: q + 337] == a[q + 337: q + 674]      # the period-337 repeat
    assert len(traffic.corpus(cfg, BIG_SEED)) == 1 << 20


def test_corpus_matches_the_ports_generator():
    from libzseek_tpu_torch.testing import corpus as port
    ours = traffic.mixed_corpus(np.random.default_rng(5), 100_003)
    theirs = port.mixed_corpus(np.random.default_rng(5), 100_003)
    assert np.array_equal(ours, theirs)


def test_uniform_offsets_are_fixed_by_the_seed_and_in_range():
    mix = {"read_bytes": 4096}
    a = traffic.offsets(mix, 1 << 20, BIG_SEED, 10_000)
    assert np.array_equal(a, traffic.offsets(mix, 1 << 20, BIG_SEED,
                                             10_000))
    assert not np.array_equal(a, traffic.offsets(mix, 1 << 20, BIG_SEED,
                                                 10_000, stream=1))
    assert a.min() >= 0 and a.max() <= (1 << 20) - 4096
