"""The benchmark of libzseek_tpu_torch, the PyTorch and CUDA port.

    python3 -m zseek_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of the repository's BENCHMARK.json on the card and prints
one JSON line.  Configurations (`configs/<name>.json`), traffic mixes
(`traffic/<name>.json`) and metrics (`metrics/<name>.py`) are files of
their own, found by the names in BENCHMARK.json.  The yardstick lives
here and takes nothing from the port but its public Writer and Reader,
its `zseek.*` profiler ranges and its counters: the input generator, the
arithmetic, the table of peaks and a plain decoder of the archive format
(`reference/`) that decides `correct`.
"""
