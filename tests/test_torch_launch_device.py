"""Two repairs for launches on several cards, and the rest of
runtime/io.py.

Every CUDA launch goes through kernels.launch, which makes the launch's
device the calling thread's current one and passes that device's
current stream (the CUDA runtime launches on the current device, and a
Writer's finishing thread or a Reader's prefetch thread starts on device
0): no module of ops/ reads a stream itself, and kernels.launch, run
with a stand-in library and stand-in CUDA calls, enters the device it is
given and passes its stream last.  No kernel's dynamic shared-memory
attribute is set once a process (a `static` result), since the attribute
belongs to the kernel in one device's context.  The io additions
(WriteSink, ReadSource, CallbackReadSource, CountingSink, copies of
libzseek_tpu/runtime/io.py) are held to the JAX package's oracle
(tests/test_writer_reader.py:134,144) with the port's Writer, and a
Reader over a CallbackReadSource returns the bytes a BytesIOSource
gives."""

import contextlib
import glob
import io
import os
import re

import pytest
import torch

from libzseek_tpu_torch import kernels
from libzseek_tpu_torch.errors import ZseekError
from libzseek_tpu_torch.runtime import io as zio
from libzseek_tpu_torch.runtime.reader import Reader
from libzseek_tpu_torch.runtime.writer import Writer

PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "libzseek_tpu_torch")


def test_launches_enter_their_device(monkeypatch):
    launched = {}
    for path in glob.glob(os.path.join(PKG, "ops", "*.py")):
        src = open(path).read()
        assert "cuda_stream" not in src, path
        for name in re.findall(r'kernels\.launch\(\s*"(\w+)"', src):
            launched[name] = launched.get(name, 0) + 1
    assert set(launched) == set(kernels.SIGNATURES), launched
    assert sum(launched.values()) == 12, launched
    for path in glob.glob(os.path.join(PKG, "csrc", "*.cu")):
        src = open(path).read()
        assert not re.search(
            r"static\s+(const\s+)?cudaError_t\s+\w+\s*=\s*"
            r"cudaFuncSetAttribute", src), path

    entered, calls = [], []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, entered[-1], args)) \
                or (7 if args[0] == "fail" else 0)

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield
        entered.append(None)

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + dev.index

    monkeypatch.setattr(kernels, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    dev = torch.device("cuda", 3)
    kernels.launch("zk_decode", dev, 1, 2)
    assert calls == [("zk_decode", dev, (1, 2, 1003))]
    assert entered == [dev, None]
    with pytest.raises(RuntimeError, match="zk_lz4_emit: CUDA error 7"):
        kernels.launch("zk_lz4_emit", dev, "fail")


def test_io_additions_match_the_oracle():
    assert {"WriteSink", "ReadSource", "CallbackReadSource",
            "CountingSink"} <= set(vars(zio))
    sink = zio.CountingSink()
    w = Writer(sink, "lz4", device="cpu", min_frame_size=1 << 16)
    st = w.close()
    assert st.frames == 0
    assert sink.bytes_written == 8 + 9  # bare seek table
    with pytest.raises(ZseekError):
        w.write(b"too late")
    sink = zio.CountingSink()
    w = Writer(sink, "lz4", device="cpu", min_frame_size=1 << 16)
    w.write(b"abc")
    st1 = w.close()
    st2 = w.close()
    assert st1.frames == st2.frames == 1

    data = bytes(range(256)) * 600
    inner = io.BytesIO()
    sink = zio.CountingSink(inner)
    w = Writer(sink, device="cpu", min_frame_size=1 << 15)
    w.write(data)
    w.close()
    arch = inner.getvalue()
    assert sink.bytes_written == len(arch)
    src = zio.BytesIOSource(arch)
    cb = zio.CallbackReadSource(src.pread, src.fsize)
    assert cb.fsize() == len(arch)
    got = Reader(cb, device="cpu").pread_full(len(data), 0)
    assert got == Reader(src, device="cpu").pread_full(len(data), 0) == data
