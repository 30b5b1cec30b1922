"""The port's public API against the JAX package's: the zseek_* shims
and parameter structs on tests/test_api.py's cases, with archives
written through one package's shims read back through the other's; the
exports; and `workers` on one device (tolerance none: bytes)."""

import dataclasses
import io

import numpy as np
import pytest
import torch

import libzseek_tpu
import libzseek_tpu_torch as port
from libzseek_tpu import api as japi
from libzseek_tpu_torch import api
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.utils import device as udev


def _write(mod, data, params=None, **kw):
    """data in 50,000-byte writes through the full-open shim."""
    buf = io.BytesIO()
    w = mod.zseek_writer_open_full(buf, params, **kw)
    for pos in range(0, len(data), 50_000):
        assert mod.zseek_write(w, data[pos: pos + 50_000])
    st = mod.zseek_writer_close(w)
    return buf.getvalue(), st


def test_shims_both_ways():
    """zstd through the full-open shims (nb_workers=2, a 4-frame cache),
    LZ4 through zseek_writer_open and an uncached reader, null params,
    and seek-table checksums: each archive written by one package's shims
    and read by the other's, preads, reads and stats equal."""
    rng = np.random.default_rng(103)
    data = rng.integers(0, 200, 300_000, np.uint8).tobytes()
    cpu = dict(device="cpu")
    for wmod, rmod, wkw, rkw in ((api, japi, cpu, {}), (japi, api, {}, cpu)):
        for name, P in (("zstd", wmod.ZstdParams), ("lz4", wmod.LZ4Params)):
            params = wmod.CompressionParams(
                type=name, **{name: P(compression_level=1, nb_workers=2)})
            arch, st = _write(wmod, data, params, min_frame_size=1 << 16,
                              **wkw)
            assert st.frames == 3 and st.compressed_size < len(arch)
            r = rmod.zseek_reader_open_full(io.BytesIO(arch), cache_size=4,
                                            **rkw)
            assert rmod.zseek_pread(r, 100, 5000) == data[5000:5100]
            assert rmod.zseek_pread(r, 999, 77_777) == data[77_777:78_776]
            assert rmod.zseek_read(r, 50) == data[:50]
            assert rmod.zseek_read(r, 70) == data[50:120]
            assert rmod.zseek_reader_stats(r).frames == st.frames
            assert rmod.zseek_reader_close(r).frames == st.frames
        buf = io.BytesIO()
        w = wmod.zseek_writer_open(buf, "lz4", min_frame_size=1 << 15, **wkw)
        wmod.zseek_write(w, data[:200_000])
        assert wmod.zseek_writer_stats(w).decompressed_size == 200_000
        wmod.zseek_writer_close(w)
        r = rmod.zseek_reader_open_full(io.BytesIO(buf.getvalue()),
                                        cache_size=0, **rkw)
        assert rmod.zseek_pread(r, 999, 77_777) == data[77_777:78_776]
        assert rmod.zseek_reader_stats(r).cache_entries == 0
        arch, _ = _write(wmod, b"x" * 100_000, **wkw)
        r = rmod.zseek_reader_open(io.BytesIO(arch), **rkw)
        assert rmod.zseek_pread(r, 10, 0) == b"x" * 10
        arch, wst = _write(wmod, data, wmod.CompressionParams(
            type="zstd", zstd=wmod.ZstdParams(compression_level=3)),
            min_frame_size=1 << 17, checksums=True, **wkw)
        r = rmod.open_reader(io.BytesIO(arch), verify_checksums=True, **rkw)
        assert r.seek_table.checksums is not None
        assert rmod.zseek_pread(r, 500, 123_456) == data[123_456:123_956]
        st = rmod.zseek_reader_stats(r)
        assert st.seek_table_size == 8 + 12 * st.frames + 9 == \
            wst.seek_table_size


def test_exports_structs_and_workers(monkeypatch):
    """Every name the JAX package exports, the structs' fields and
    defaults, the unknown-type refusal, and `workers`: > 1 on one device
    uses that device alone (zstd: that many worker pipelines on it, LZ4:
    no round-robin); over several devices (listed by a patched
    _visible_devices) the batches take the first `workers` in turn, and
    zstd's worker i takes device i mod n."""
    for name in ("ZseekError", "Reader", "Writer", "open_reader",
                 "open_writer", "zseek_pread", "zseek_read",
                 "zseek_reader_close", "zseek_reader_open",
                 "zseek_reader_stats", "zseek_write", "zseek_writer_close",
                 "zseek_writer_open", "zseek_writer_stats"):
        assert hasattr(libzseek_tpu, name) and hasattr(port, name), name
    assert set(japi.__all__) <= set(dir(api))
    for cls in ("ZstdParams", "LZ4Params", "CompressionParams"):
        ref = [(f.name, f.default) for f in
               dataclasses.fields(getattr(japi, cls))]
        assert [(f.name, f.default) for f in
                dataclasses.fields(getattr(api, cls))] == ref, cls
    assert issubclass(ParameterError, port.ZseekError)
    with pytest.raises(ParameterError):
        api.zseek_writer_open_full(io.BytesIO(), api.CompressionParams(
            type="brotli"), device="cpu")
    data = bytes(range(256)) * 700
    buf = io.BytesIO()
    with api.open_writer(buf, workers=3, device="cpu",
                         min_frame_size=1 << 16) as w:
        w.write(data)
        assert w._codec._devices == [torch.device("cpu")] * 3 and \
            w._codec._rr == 0
    assert api.Reader(buf.getvalue(), device="cpu").pread_full(
        len(data), 0) == data
    lz4 = port.LZ4Codec(device="cpu", workers=8)
    assert lz4.device.type == "cpu" and lz4._devices is None
    for bad in (dict(max_batch_blocks=0), dict(max_batch_blocks=65)):
        with pytest.raises(ParameterError):
            port.ZstdCodec(device="cpu", **bad)
    assert port.ZstdCodec(device="cpu", level=4,
                          max_batch_blocks=128).max_batch_blocks == 128
    assert port.ZstdCodec(device="cpu", parser="sort",
                          max_batch_blocks=1000).max_batch_blocks == 1000
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert udev.worker_devices(4, cuda) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert udev.worker_devices(1, cuda) is None
    assert udev.worker_devices(None, cuda) is None
    assert udev.worker_devices(4, cuda) == [cuda, torch.device("cuda", 1)]
    assert udev.pipeline_devices(1, cuda) is None
    assert udev.pipeline_devices(3, cuda) == \
        [cuda, torch.device("cuda", 1), cuda]
    cpus = [torch.device("cpu", i) for i in range(4)]
    monkeypatch.setattr(udev, "_visible_devices", lambda dev: cpus)
    for cls in (port.ZstdCodec, port.LZ4Codec):
        c = cls(device="cpu", workers=3)
        assert c._devices == cpus[:3]
        assert [c._batch_device() for _ in range(5)] == \
            cpus[:3] + cpus[:2] and c._rr == 5
        assert cls(device="cpu", workers=1)._devices is None
