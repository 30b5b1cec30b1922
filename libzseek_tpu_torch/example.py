"""Round-trip example of the port, the consumer CLI.

Counterpart of tools/example.py (itself the reference library's
test/example.c): compresses FILE into FILE.zsk through open_writer in
4 KiB writes with 1 MiB minimum frames (example.c:12-14), then reopens
the archive and checks it: a sequential pread loop against the original
(example.c:56-87) and a random-access pass of 64 preads.  Prints the
reader's stats, then SUCCESS or FAIL (exit code 0 or 1); an error of
the library prints its errbuf text and FAIL.  It writes and
reads on the card unless asked for the CPU (--device cpu runs the
kernels' plain versions), through the default decode routes.

Usage: python -m libzseek_tpu_torch.example --zstd|--lz4 FILE [--keep]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from libzseek_tpu_torch.api import open_reader, open_writer
from libzseek_tpu_torch.errors import ZseekError

CHUNK_SIZE = 4096          # example.c:13
MIN_FRAME_SIZE = 1 << 20   # example.c:14
READ_CHUNK = 4096


def compress(path: str, out_path: str, codec: str, device: str) -> None:
    with open(path, "rb") as f, \
            open_writer(out_path, codec, device=device,
                        min_frame_size=MIN_FRAME_SIZE) as w:
        while True:
            buf = f.read(CHUNK_SIZE)
            if not buf:
                break
            w.write(buf)


def verify(path: str, archive: str, device: str) -> bool:
    with open(path, "rb") as f:
        original = f.read()
    ok = True
    r = open_reader(archive, device=device, cache_frames=8)
    # sequential pread scan (example.c decompress loop)
    pos = 0
    while pos < len(original):
        chunk = r.pread_full(READ_CHUNK, pos)
        if not chunk or original[pos: pos + len(chunk)] != chunk:
            print(f"sequential mismatch at offset {pos}")
            ok = False
            break
        pos += len(chunk)
    if pos != len(original):
        ok = False
    # random-access pass
    rng = np.random.default_rng(0)
    for _ in range(64):
        off = int(rng.integers(0, max(1, len(original))))
        size = int(rng.integers(1, 1 << 16))
        if r.pread_full(size, off) != original[off: off + size]:
            print(f"random pread mismatch at offset {off}")
            ok = False
            break
    st = r.close()
    print(f"frames={st.frames} compressed={st.compressed_size} "
          f"decompressed={st.decompressed_size} "
          f"ratio={st.compressed_size / max(1, st.decompressed_size):.4f} "
          f"cache_hits={st.cache_hits} cache_misses={st.cache_misses}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libzseek_tpu_torch.example",
        description="Write FILE into a seekable archive and read it back.")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--zstd", action="store_true")
    g.add_argument("--lz4", action="store_true")
    ap.add_argument("file")
    ap.add_argument("--keep", action="store_true",
                    help="keep the .zsk archive afterwards")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernels run (cpu: their plain versions)")
    args = ap.parse_args(argv)
    codec = "zstd" if args.zstd else "lz4"
    archive = args.file + ".zsk"
    try:
        compress(args.file, archive, codec, args.device)
        ok = verify(args.file, archive, args.device)
    except ZseekError as e:      # the C example prints its errbuf
        print(f"error: {e.errbuf()}")
        ok = False
    finally:
        if not args.keep and os.path.exists(archive):
            os.unlink(archive)
    print("SUCCESS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
