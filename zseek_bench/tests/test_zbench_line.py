"""The result line's shape, the harness's refusals, and what it imports.
The runs here are CPU runs of the port's plain kernels at a small size
(run_cell(device="cpu")): their numbers are no device's."""

import json
import os
import subprocess
import sys

import pytest

from zseek_bench import run

CELLS = ["zstd3_f1m.write", "lz4_f1m.write", "zstd3_f1m.scan",
         "zstd3_f1m.pread"]
SMALL = {"input_bytes": 1 << 18, "min_frame_size": 1 << 16,
         "write_bytes": 1 << 16}
BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_line_shape(cell, trace):
    line = run.run_cell(cell, 2**31 + 99, 0.2, trace, device="cpu",
                        overrides=SMALL)
    json.dumps(line)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert all(c["value"] <= c["limit"] == 0
               for c in line["checks"].values())
    units = {m["name"]: m["unit"]
             for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        want = {m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want


def test_no_card_means_no_line(tmp_path):
    """Without CUDA the command exits non-zero and prints nothing on
    standard output (this sandbox has no card)."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "zseek_bench.run",
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=run.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmark_in_the_checkout_means_no_line(tmp_path):
    """A directory with BENCHMARK.json and zseek_bench/ alone (no port)
    gives no line and a non-zero exit."""
    import shutil
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "zseek_bench"),
                    tmp_path / "zseek_bench")
    p = subprocess.run([sys.executable, "-m", "zseek_bench.run",
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "libzseek_tpu_torch_x", sys)
    assert "libzseek_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "libzseek_tpu.api", sys)
    assert run.forbidden_modules() == ["libzseek_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; from zseek_bench import run;"
            "run.run_cell('zstd3_f1m.pread', 3, 0.1, True, device='cpu',"
            " overrides={'input_bytes': 1 << 17});"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "libzseek_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "libzseek_tpu"}
