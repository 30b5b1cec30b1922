"""The port's consumer CLI and its error model.

`python -m libzseek_tpu_torch.example --zstd|--lz4 FILE --device cpu`
(the counterpart of tools/example.py) writes ~300 KiB of mixed_corpus
(seed 67) into FILE.zsk in 4 KiB writes, reads it back sequentially and
at random through the default routes, prints SUCCESS and removes the
archive; without a card, the default device fails cleanly (the error's
errbuf text, FAIL, exit 1, no archive left).  The error classes are the
JAX package's: ERRBUF_SIZE, ZseekError.errbuf() (the message cut to the
C library's 80-byte buffer, its terminator included) and
IOCallbackError, equal to libzseek_tpu/errors.py's on the same
messages."""

import os
import subprocess
import sys

import numpy as np
import torch

from libzseek_tpu import errors as jerr
from libzseek_tpu_torch import errors
from libzseek_tpu_torch.testing.corpus import mixed_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", "libzseek_tpu_torch.example", *args],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300, cwd=ROOT)


def test_example_cli_round_trip(tmp_path):
    path = tmp_path / "sample.bin"
    path.write_bytes(mixed_corpus(np.random.default_rng(67),
                                  300 * 1024).tobytes())
    for flag in ("--zstd", "--lz4"):
        res = _run(flag, str(path), "--device", "cpu")
        assert res.returncode == 0, res.stdout + res.stderr[-3000:]
        lines = res.stdout.splitlines()
        assert lines[-1] == "SUCCESS", res.stdout
        assert "frames=1 " in lines[-2] and "decompressed=307200" in \
            lines[-2], res.stdout
        assert sorted(os.listdir(tmp_path)) == ["sample.bin"]
    res = _run("--lz4", str(path), "--device", "cpu", "--keep")
    assert res.returncode == 0 and (tmp_path / "sample.bin.zsk").exists()
    if not torch.cuda.is_available():
        os.unlink(tmp_path / "sample.bin.zsk")
        res = _run("--zstd", str(path))
        assert res.returncode == 1
        assert res.stdout.splitlines()[-2:] == [
            "error: device='cuda' requested but no CUDA device is "
            "available", "FAIL"], res.stdout
        assert sorted(os.listdir(tmp_path)) == ["sample.bin"]


def test_errbuf_matches_the_jax_error_model():
    assert errors.ERRBUF_SIZE == jerr.ERRBUF_SIZE == 80
    for n in (0, 1, 78, 79, 80, 81, 200):
        msg = "".join(chr(97 + i % 26) for i in range(n))
        for name in ("ZseekError", "FormatError", "IOCallbackError",
                     "ParameterError"):
            ours = getattr(errors, name)(msg)
            theirs = getattr(jerr, name)(msg)
            assert isinstance(ours, errors.ZseekError)
            assert ours.errbuf() == theirs.errbuf() == msg[:79]
            assert len(ours.errbuf()) == min(n, errors.ERRBUF_SIZE - 1)
