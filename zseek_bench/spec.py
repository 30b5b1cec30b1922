"""Finds a cell's parts by the names in BENCHMARK.json: its configuration
(the `file` of its `configs` entry), its traffic mix
(`zseek_bench/traffic/<traffic>.json`) and a reader for each metric it
reports (`zseek_bench/metrics/<metric>.py`, a module with
`read(record) -> float | None`).  A later cell, mix, configuration or
metric is new files and entries; no file here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list        # BENCHMARK.json entries that the cell reports
    per_layer: list


def load(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "zseek_bench", "traffic",
                           w["traffic"] + ".json")) as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, mix, e2e, per)


def reader(root: str, metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = os.path.join(root, "zseek_bench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "zseek_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
