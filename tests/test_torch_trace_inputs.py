"""Shared helpers of the span tests (tests/test_torch_trace*.py).  It
holds no tests.

The span tests are split into files of at most two tests each, so that
pytest-xdist's loadfile schedule (files by test count, largest first)
queues them after every reference test file: see ROADMAP.md on
tests/test_linked_parse.py."""

import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libzseek_tpu_torch import Writer
from libzseek_tpu_torch.testing.corpus import mixed_corpus
from libzseek_tpu_torch.utils import trace

FRAME = 1 << 12


@pytest.fixture(autouse=True)
def empty_log():
    """Each test starts and ends with an empty span log (autouse in every
    module that imports it)."""
    trace.drain()
    yield
    trace.drain()


def on():
    return profile(activities=[ProfilerActivity.CPU])


def count_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return entered


def archive(codec, frames=64):
    data = mixed_corpus(np.random.default_rng(29), frames * FRAME).tobytes()
    buf = io.BytesIO()
    w = Writer(buf, codec, device="cpu", min_frame_size=FRAME,
               batch_frames=8)
    for p in range(0, len(data), FRAME):
        w.write(data[p: p + FRAME])
    w.close()
    return data, buf.getvalue()
