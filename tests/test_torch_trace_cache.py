"""The Reader's frame cache counter: a lookup with count=False counts
nothing and leaves the LRU order as find() would."""

from libzseek_tpu_torch.runtime.cache import FrameCache


def test_find_without_count_counts_nothing_and_keeps_the_lru_order():
    c = FrameCache(2)
    c.insert(0, b"a")
    c.insert(1, b"b")
    assert c.find(0, count=False) == b"a"     # 0 is now the MRU entry
    assert c.find(5, count=False) is None
    assert (c.hits, c.misses) == (0, 0)
    c.insert(2, b"c")                          # evicts 1, the LRU
    assert c.find(1) is None and c.find(0) == b"a"
    assert (c.hits, c.misses) == (1, 1)
