"""A configuration, a traffic mix and a metric are added as new files and
entries, in a copy of the benchmark, without editing a file that is
there; the harness finds them by name and runs the new cell."""

import hashlib
import json
import os
import shutil

import pytest

from zseek_bench import run, spec

REPO = run.ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "zseek_bench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


@pytest.fixture()
def copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "zseek_bench"), root / "zseek_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(root)


def _add_cell(root):
    b = os.path.join(root, "zseek_bench")
    cfg = json.load(open(os.path.join(b, "configs", "lz4_f1m.json")))
    cfg["name"] = "lz4_f64k"
    cfg["min_frame_size"] = 1 << 16
    json.dump(cfg, open(os.path.join(b, "configs", "lz4_f64k.json"), "w"))
    json.dump({"op": "pread", "read_bytes": 1024},
              open(os.path.join(b, "traffic", "pread_1k.json"), "w"))
    with open(os.path.join(b, "metrics", "pread_p50_ms.py"), "w") as f:
        f.write("from zseek_bench import measure\n\n\n"
                "def read(rec):\n"
                "    return 1e3 * measure.percentile(rec.call_s, 50)\n")
    p = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(p))
    bench["configs"].append({"name": "lz4_f64k", "source": "x",
                             "file": "zseek_bench/configs/lz4_f64k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lz4_f64k.pread_1k",
                               "config": "lz4_f64k", "traffic": "pread_1k",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][3]["workloads"].append("lz4_f64k.pread_1k")
    bench["per_layer"].append({"name": "pread_p50_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "runtime", "moves": "pread_p99_ms",
                               "workloads": ["lz4_f64k.pread_1k"]})
    json.dump(bench, open(p, "w"))


def test_new_files_and_entries_make_a_cell(copy):
    before = _digests(copy)
    _add_cell(copy)
    after = _digests(copy)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    cell = spec.load(copy, "lz4_f64k.pread_1k")
    assert cell.config["min_frame_size"] == 1 << 16
    assert cell.mix["read_bytes"] == 1024
    assert [m["name"] for m in cell.per_layer] == ["pread_p50_ms"]
    assert {m["name"] for m in cell.end_to_end} == {"pread_p99_ms",
                                                    "setup_s"}
    for trace in (False, True):
        line = run.run_cell("lz4_f64k.pread_1k", 5, 0.2, trace,
                            device="cpu", root=copy,
                            overrides={"input_bytes": 1 << 18})
        assert line["correct"], line["checks"]
        want = {"pread_p50_ms"} if trace else {"pread_p99_ms", "setup_s"}
        assert set(line["metrics"]) == want


def test_every_metric_of_benchmark_json_has_a_reader():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(spec.reader(REPO, m["name"]))
    for w in bench["workloads"]:
        cell = spec.load(REPO, w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
