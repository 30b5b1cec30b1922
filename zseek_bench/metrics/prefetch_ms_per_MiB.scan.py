"""Total length of the port's zseek.prefetch spans (one prefetch window,
decoded and put in the cache) on the Reader's zseek-prefetch threads, per
MiB read in the traced window.  Read from the port's span log, which
holds every thread's spans while the profiler runs; two threads, so it
may exceed the window.  None where the port has no span log."""
from zseek_bench import measure


def read(rec):
    if rec.op != "scan" or rec.trace is None or not rec.read_bytes:
        return None
    try:
        from libzseek_tpu_torch.utils import trace
    except ImportError:
        return None
    ns = sum(s.end_ns - s.start_ns for s in trace.spans()
             if s.name == "zseek.prefetch"
             and s.thread.startswith("zseek-prefetch"))
    if not ns:
        return None
    return 1e-6 * ns / (rec.read_bytes / measure.MIB)
