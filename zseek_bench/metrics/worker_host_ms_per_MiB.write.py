"""Host stages on the zstd stream's worker threads: the total length of
the port's zseek.layout and zseek.plan spans on zseek-worker-<i> threads,
per MiB written in the traced window, from the port's span log.  Beside
the one-worker cell's plan_ms_per_MiB plus layout_ms_per_MiB, it shows
how much running them on several threads at once stretches them.  None
where the port has no span log or ran no worker pipeline."""
from zseek_bench import measure

THREADS = "zseek-worker-"
SPANS = ("zseek.layout", "zseek.plan")


def read(rec):
    if rec.op != "write" or rec.trace is None or not rec.in_bytes:
        return None
    try:
        from libzseek_tpu_torch.utils import trace
    except ImportError:
        return None
    ns = sum(s.end_ns - s.start_ns for s in trace.spans()
             if s.name in SPANS and s.thread.startswith(THREADS))
    if not ns:
        return None
    return 1e-6 * ns / (rec.in_bytes / measure.MIB)
