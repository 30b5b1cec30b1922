"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 -m zseek_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the input from the seed, builds or loads the port's native
library and CUDA kernels (their caches are build/ inside the checkout)
and warms the cell's own path once; the window then runs the cell's
traffic for --seconds.  With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics from a
torch.profiler trace of the window.  After the window, what the window
produced is held to the plain reference (check.py); each number compared
is printed beside its limit on standard error and, last, in the line.
Exits non-zero without a line when no card (or too few) is visible, when
the port cannot be imported, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "libzseek_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port keeps its
    own builds in build/torch_native and build/torch_kernels)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", "zseek_bench", sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, overrides=None,
             t0: float | None = None) -> dict:
    """One run of a cell: the result line as a dict.  device="cpu" and
    `overrides` (keys of the configuration and the mix, such as a smaller
    input) are for the CPU tests alone, which run the port's plain kernels at a small size;
    the command line always runs the cell as it stands, on the card."""
    from zseek_bench import check, drive, spec, traffic
    from zseek_bench.trace import Tracer
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load(root, workload)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: spec.reader(root, m["name"]) for m in metrics
               if m["name"] != "setup_s"}
    config = dict(cell.config, **(overrides or {}))
    mix = dict(cell.mix, **(overrides or {}))
    import torch
    if device == "cuda":
        torch.cuda.init()
    data = traffic.corpus(config, seed)
    drv = drive.DRIVERS[mix["op"]](config, mix, data, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t0
    with Tracer(trace, device == "cuda") as tr:
        with tr.window():
            rec = drv.window(seconds)
    rec.trace = tr.trace
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                    for d in range(cell.chips))
           if device == "cuda" else 0}
    if trace:
        dev["busy_s"] = rec.trace.busy_s if rec.trace else 0.0
        dev["window_s"] = rec.trace.window_s if rec.trace else rec.window_s
    if device == "cuda":
        dev["power_limit"] = _power_limit()
    drv.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    if mix["op"] == "write":
        print(f"{len(rec.archives)} archives kept for the check, "
              f"{rec.dropped} not kept", file=sys.stderr)
        checks = check.check_write([s.value() for s in rec.archives], data,
                                   config["codec"], seed, rec.failed)
    elif mix["op"] == "scan":
        checks = check.check_passes(rec.passes, data, rec.failed)
    else:
        checks = check.check_reads(rec.answers, data, int(mix["read_bytes"]),
                                   rec.failed)
    print(f"window {rec.window_s:.3f} s, {rec.attempted} calls; the check "
          f"took {time.perf_counter() - tc:.3f} s", file=sys.stderr)
    out = {}
    for m in metrics:
        v = setup_s if m["name"] == "setup_s" else readers[m["name"]](rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": rec.attempted, "failed": rec.failed,
            "metrics": out, "device": dev}
    if trace and rec.trace:
        line["breakdown"] = {"device_ops": rec.trace.device_ops,
                             "idle_gaps": rec.trace.idle_gaps}
    missing = [m["name"] for m in cell.end_to_end
               if not trace and m["name"] not in out]
    if missing:
        print(f"end-to-end metrics without a value: {missing}",
              file=sys.stderr)
        line["correct"] = False
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m zseek_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _caches(ROOT)
    import torch
    from zseek_bench import spec
    chips = spec.load(ROOT, a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import libzseek_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port cannot be imported: {e}", file=sys.stderr)
        return 4
    line = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 5
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
