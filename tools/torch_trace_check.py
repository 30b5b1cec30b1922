#!/usr/bin/env python3
"""Checks of the port's span log (libzseek_tpu_torch/utils/trace.py) on a
CUDA card, in the benchmark's traced runs.

    python3 tools/torch_trace_check.py [SECONDS] [SEED] [CELL ...]

First whether torch.autograd.profiler._is_profiler_enabled exists and
reads True on a worker thread while a CUDA profiler runs (and what the
profiler's own per-thread flag, torch.autograd._profiler_enabled, reads
there), and the host cost of one span entered and left, in µs over
100,000: trace.span with no profiler running, record_function with none
(what every range cost before the span helper), and trace.span while a
CPU profiler runs.  Then, for each cell of BENCHMARK.json named (all four by
default), one traced run through zseek_bench.run.run_cell, keeping the
profiler's events, and prints one JSON line:

  log_entries, dropped: the span log at the end of the window;
  offset_us: for every calling-thread span, |log start - event start| and
    |log end - event end| against the profiler's record_function event
    of the same span (paired by name, in order): count, median, largest;
  fetch_after_kernel: for write cells, of the zseek.fetch entries on the
    finishing thread, the share whose end falls after the end of their
    batch's last kernel, taken as the last kernel to end before the
    first device-to-host copy that starts after the fetch started (the
    stream runs the batch's kernels before the fetch's copy), with the
    median and largest shortfall of those that do not; and the fetch's
    end less the end of the device-to-host copy nearest it (median,
    least, largest);
  spans: each span's total and self seconds by thread (the pools'
    numbered threads merged) and name, from the log;
  metrics: the run's per-layer metrics.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELLS = ["zstd3_f1m.write", "lz4_f1m.write", "zstd3_f1m.scan",
         "zstd3_f1m.pread"]


def flags() -> dict:
    import torch
    from torch.autograd import profiler as P
    from torch.profiler import ProfilerActivity, profile
    seen = {}

    def probe():
        seen["module_flag"] = getattr(P, "_is_profiler_enabled", None)
        seen["thread_flag"] = bool(torch.autograd._profiler_enabled())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        seen["main_thread_flag"] = bool(torch.autograd._profiler_enabled())
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "has_module_flag": hasattr(P, "_is_profiler_enabled"),
            "worker": seen}


def costs(n: int = 100_000) -> dict:
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    from libzseek_tpu_torch.utils import trace

    def per(fn):
        t = time.perf_counter()
        for _ in range(n):
            with fn("zseek.t_cost"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"span_off_us": per(trace.span),
           "record_function_off_us": per(torch.profiler.record_function)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_us"] = per(trace.span)
    trace.drain()
    return out


def _ns(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def analyse(events, log) -> dict:
    from torch.autograd import DeviceType
    from zseek_bench.trace import MARK
    mark = next(e for e in events if e.name() == MARK
                and e.device_type() == DeviceType.CPU)
    tid = mark.start_thread_id()
    main = threading.main_thread().name
    ev: dict[str, list] = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith(
                "zseek.") and e.start_thread_id() == tid:
            ev.setdefault(e.name(), []).append(_ns(e))
    mine: dict[str, list] = {}
    for s in log:
        if s.thread == main:
            mine.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    offs = []
    for name, got in mine.items():
        want = sorted(ev.get(name, []))
        got = sorted(got)
        if len(want) != len(got):
            continue            # a span cut by the profiler's edges
        for (a, b), (c, d) in zip(got, want):
            offs += [abs(a - c) / 1e3, abs(b - d) / 1e3]
    out = {"offset_us": {"n": len(offs) // 2,
                         "median": statistics.median(offs) if offs else None,
                         "max": max(offs) if offs else None}}
    kernels = sorted(_ns(e) for e in events
                     if e.device_type() == DeviceType.CUDA
                     and not e.name().startswith(("zseek.", "Memcpy",
                                                  "Memset")))
    k_ends = sorted(b for _, b in kernels)
    fetch = [s for s in log if s.name == "zseek.fetch"
             and s.thread.startswith(("zseek-finish", "zseek-lz4"))]
    if fetch:
        out["fetch_after_kernel"] = _fetches(events, fetch, k_ends)
    return out


def _fetches(events, fetch, k_ends) -> dict:
    """Each zseek.fetch span of the finishing thread against the
    device-to-host copies of the trace."""
    import bisect
    from torch.autograd import DeviceType
    d2h = sorted(_ns(e) for e in events if e.device_type() == DeviceType.CUDA
                 and e.name().startswith("Memcpy DtoH"))
    first = [a for a, _ in d2h]
    ends = sorted(b for _, b in d2h)
    after, short, nearest = [], [], []
    for s in fetch:
        i = bisect.bisect_left(first, s.start_ns)
        j = bisect.bisect_right(k_ends, first[i]) - 1 if i < len(d2h) else -1
        if j >= 0:
            after.append(s.end_ns >= k_ends[j])
            if not after[-1]:
                short.append((k_ends[j] - s.end_ns) / 1e3)
        i = bisect.bisect_left(ends, s.end_ns)
        near = [ends[k] for k in (i - 1, i) if 0 <= k < len(ends)]
        if near:
            nearest.append(min((s.end_ns - e for e in near), key=abs) / 1e3)
    med = statistics.median
    return {"fetches": len(fetch), "n": len(after),
            "share": sum(after) / len(after) if after else None,
            "short_us": [med(short), max(short)] if short else None,
            "end_minus_nearest_copy_end_us":
            [med(nearest), min(nearest), max(nearest)] if nearest else None}


def main(argv) -> int:
    import torch
    from libzseek_tpu_torch.utils import trace
    from zseek_bench import run
    from zseek_bench import trace as ztrace
    seconds = float(argv[0]) if argv else 51.0
    seed = int(argv[1]) if len(argv) > 1 else 2**31 + 7
    cells = argv[2:] or CELLS
    run._caches(ROOT)
    print(json.dumps({"flags": flags(), "costs": costs(),
                      "card": torch.cuda.get_device_name(0),
                      "power_limit": run._power_limit()}), flush=True)
    kept = {}
    real = ztrace.reduce

    def keep(events):
        kept["events"] = list(events)
        return real(kept["events"])

    ztrace.reduce = keep
    for cell in cells:
        trace.drain()
        line = run.run_cell(cell, seed, seconds, True)
        log = trace.spans()
        out = {"cell": cell, "log_entries": len(log),
               "dropped": trace.dropped(), "correct": line["correct"]}
        out.update(analyse(kept.pop("events"), log))
        own = trace.self_ns(log)
        spans = {}
        for s in log:
            key = f"{s.thread.rsplit('_', 1)[0]} {s.name}"
            tot, self_s = spans.get(key, (0.0, 0.0))
            spans[key] = (tot + (s.end_ns - s.start_ns) / 1e9,
                          self_s + own[s.id] / 1e9)
        out["spans"] = spans
        out["metrics"] = {k: v["value"] for k, v in line["metrics"].items()}
        out["idle_gaps"] = line.get("breakdown", {}).get("idle_gaps")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
