"""Total length of the port's zseek.finish spans (one batch fetched and
assembled) on the Writer's finishing thread (zseek-finish for zstd,
zseek-lz4 for LZ4), per MiB written in the traced window.  Read from the
port's span log, which holds every thread's spans while the profiler
runs.  None where the port has no span log."""
from zseek_bench import measure

THREADS = ("zseek-finish", "zseek-lz4")


def read(rec):
    if rec.op != "write" or rec.trace is None or not rec.in_bytes:
        return None
    try:
        from libzseek_tpu_torch.utils import trace
    except ImportError:
        return None
    ns = sum(s.end_ns - s.start_ns for s in trace.spans()
             if s.name == "zseek.finish" and s.thread.startswith(THREADS))
    if not ns:
        return None
    return 1e-6 * ns / (rec.in_bytes / measure.MIB)
