"""The multi-process write over torch.distributed
(libzseek_tpu_torch/parallel/distributed.py, the counterpart of
libzseek_tpu/parallel/distributed.py): two OS processes of
libzseek_tpu_torch.testing.dist_worker on the CPU, joined over gloo on
localhost, each under its own timeout.  Process 0 checks the ordered
gather of crafted rows (DIST-OK) and the archive of uneven shards that
write_archive assembles, decoded by stock libzstd (DIST-WRITE-OK); its
bytes equal, by sha256, the archive one process makes of the same frames
at world size 1, both with the port's write_archive and with the JAX
package's (given the port's codec, so JAX only gathers and writes the
seek table), and its seek table lists each frame's (compressed,
decompressed) sizes in frame order."""

import hashlib
import io
import os
import re
import socket
import subprocess
import sys

import pytest

from libzseek_tpu.parallel import distributed as JD
from libzseek_tpu_torch.errors import ParameterError
from libzseek_tpu_torch.format.seek_table import parse_seek_table_bytes
from libzseek_tpu_torch.parallel import distributed as PD
from libzseek_tpu_torch.runtime.zstd_codec import ZstdCodec
from libzseek_tpu_torch.testing import dist_worker, golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.skipif(not golden.have_zstd(),
                    reason="system libzstd unavailable")
def test_two_process_gloo_write():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, "-m", "libzseek_tpu_torch.testing.dist_worker",
         str(rank), "2", str(port), "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=ROOT, env=env)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, _, err in outs:
        assert rc == 0, (rc, err[-2000:])
    assert "DIST-OK" in outs[0][1]
    m = re.search(r"DIST-WRITE-OK frames=(\d+) bytes=\d+ sha256=(\w+)",
                  outs[0][1])
    assert m and int(m.group(1)) == 2 + 3, outs[0][1]
    whole = [f for shard in dist_worker.frames(2) for f in shard]
    archives = []
    for write in (PD.write_archive, JD.write_archive):
        sink = io.BytesIO()
        assert write(sink, whole, codec=ZstdCodec(
            device="cpu", collect_hints=False)) == len(whole)
        archives.append(sink.getvalue())
    assert archives[0] == archives[1]
    arch = archives[0]
    assert hashlib.sha256(arch).hexdigest() == m.group(2)
    payloads = ZstdCodec(device="cpu", collect_hints=False) \
        .compress_frames(whole)
    st = parse_seek_table_bytes(arch)
    assert st.num_frames == len(whole)
    for i, (p, f) in enumerate(zip(payloads, whole)):
        assert (st.frame_c_size(i), st.frame_d_size(i)) == (len(p), len(f))
        c0 = st.frame_c_offset(i)
        assert arch[c0: c0 + len(p)] == p


def test_initialize_without_configuration(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    PD.initialize()
    assert not PD.dist.is_initialized()
    assert PD.is_writer_process() and PD._world() == (0, 1)
    with pytest.raises(ParameterError):
        PD.initialize(num_processes=2, process_id=5)
