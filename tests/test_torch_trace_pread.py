"""The Reader's cache counter: each frame a caller's pread asks for counts
one hit or one miss."""

import numpy as np
import pytest

from libzseek_tpu_torch import Reader
from test_torch_trace_inputs import FRAME, archive


@pytest.mark.parametrize("device_cache", [False, True])
def test_each_pread_counts_one_hit_or_one_miss(device_cache):
    """N preads, each inside one frame (sequential streaks, which take the
    readahead and the prefetch windows, then random frames), on a Reader
    with an 8-frame cache over a 64-frame archive."""
    data, arch = archive("lz4")
    rng = np.random.default_rng(3)
    frames = list(range(24)) + rng.integers(0, 64, 40).tolist() + \
        list(range(40, 56))
    r = Reader(arch, device="cpu", cache_frames=8,
               device_cache=device_cache)
    for f in frames:
        off = f * FRAME + int(rng.integers(0, FRAME - 100))
        assert r.pread(100, off) == data[off: off + 100]
    st = r.close()
    assert st.cache_hits + st.cache_misses == len(frames)
    assert st.cache_hits > 0 and st.cache_misses > 0
