"""The traced window: torch.profiler over the window (CPU and CUDA), reduced
to the device's kernel and copy intervals, the self time of the port's
`zseek.*` ranges on the calling thread, and a breakdown of the device
time by kernel and of the idle gaps by the range the host was in.

The port opens its `zseek.*` ranges with torch.profiler.record_function;
the profiler sees those of the thread that started it only (the Writer's
finishing thread and the Reader's prefetch threads go unseen).
"""

from __future__ import annotations

import contextlib
import dataclasses

from zseek_bench import measure

SPAN = "zseek."


@dataclasses.dataclass
class Trace:
    window_s: float        # the traced window's length
    kernels: list          # (start s, end s) of each CUDA kernel
    copies: list           # (start s, end s) of each copy or memset
    span_self_s: dict      # zseek.* name -> self seconds, calling thread
    span_calls: dict       # zseek.* name -> ranges closed
    device_ops: list       # [name, seconds] of the kernels that took most
    idle_gaps: list        # [range the host was in, seconds idle]

    @property
    def kernel_s(self) -> float:
        return measure.union_s(self.kernels)

    @property
    def busy_s(self) -> float:
        return measure.union_s(self.kernels + self.copies)


def _times(e) -> tuple[float, float]:
    if hasattr(e, "start_ns"):
        a, d = e.start_ns(), e.duration_ns()
        return a / 1e9, (a + d) / 1e9
    a, d = e.start_us(), e.duration_us()
    return a / 1e6, (a + d) / 1e6


def _self_times(spans) -> tuple[dict, dict, list]:
    """Self time of each range (its length less that of the ranges nested
    in it) and, for the idle gaps, the innermost range at each instant as
    disjoint (start, end, name) pieces."""
    self_s: dict[str, float] = {}
    calls: dict[str, int] = {}
    pieces = []
    stack: list[list] = []          # [name, start, end, cursor]

    def close(top):
        name, _, end, cur = top
        self_s[name] = self_s.get(name, 0.0) + max(0.0, end - cur)
        pieces.append((cur, end, name))
        calls[name] = calls.get(name, 0) + 1
        if stack:
            stack[-1][3] = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= a:
            close(stack.pop())
        if stack:
            parent = stack[-1]
            self_s[parent[0]] = self_s.get(parent[0], 0.0) + \
                max(0.0, a - parent[3])
            pieces.append((parent[3], a, parent[0]))
        stack.append([name, a, b, a])
    while stack:
        close(stack.pop())
    return self_s, calls, sorted(p for p in pieces if p[1] > p[0])


def _gaps_by_span(busy: list, pieces: list, lo: float, hi: float) -> dict:
    """Idle seconds of the device between lo and hi, by the innermost
    range the calling thread was in ("host" outside every range)."""
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    out: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            pa, pb, name = pieces[k]
            d = min(b, pb) - max(a, pa)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            k += 1
        out["host"] = out.get("host", 0.0) + (b - a) - covered
    return out


def reduce(events) -> Trace:
    """A Trace of the profiler's kineto events inside the window's own
    range (MARK), on the thread that opened it."""
    from torch.autograd import DeviceType
    events = list(events)
    mark = [e for e in events if e.name() == MARK
            and e.device_type() == DeviceType.CPU]
    if len(mark) != 1:
        raise RuntimeError(f"{len(mark)} window ranges in the trace")
    lo, hi = _times(mark[0])
    tid = mark[0].start_thread_id()
    kernels, copies, spans = [], [], []
    per_kernel: dict[str, float] = {}
    for e in events:
        name = e.name()
        if name == MARK:
            continue
        a, b = _times(e)
        a, b = max(a, lo), min(b, hi)      # the window's part alone
        if b <= a:
            continue
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN):
                continue
            if name.startswith(("Memcpy", "Memset")):
                copies.append((a, b))
            else:
                kernels.append((a, b))
                per_kernel[name] = per_kernel.get(name, 0.0) + (b - a)
        elif name.startswith(SPAN) and e.start_thread_id() == tid:
            spans.append((name, a, b))
    self_s, calls, pieces = _self_times(spans)
    busy = measure.merged(kernels + copies)
    gaps = _gaps_by_span(busy, pieces, lo, hi)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(hi - lo, kernels, copies, self_s, calls,
                 [[k, v] for k, v in top], [[k, v] for k, v in idle])


MARK = "zseek_bench.window"


class Tracer:
    """`with Tracer(on, cuda) as t:` around the set-up's end and the
    window, and `with t.window():` around the window alone; then
    t.trace (None when off)."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.trace = None
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def window(self):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(MARK)

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = reduce(
                    self._prof.profiler.kineto_results.events())
        return False
