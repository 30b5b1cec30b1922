"""Worker pipelines at work at once, on average: the total length of the
port's zseek.worker spans (one batch run whole on a zstd stream's worker
thread, zseek-worker-<i>) over the traced window's length, from the
port's span log.  1.0 is one pipeline at a time, 4.0 all four.  None
where the port has no span log or ran no worker pipeline (one worker, or
a port whose workers only pick the batches' devices)."""

THREADS = "zseek-worker-"


def read(rec):
    if rec.op != "write" or rec.trace is None or not rec.trace.window_s:
        return None
    try:
        from libzseek_tpu_torch.utils import trace
    except ImportError:
        return None
    ns = sum(s.end_ns - s.start_ns for s in trace.spans()
             if s.name == "zseek.worker" and s.thread.startswith(THREADS))
    if not ns:
        return None
    return 1e-9 * ns / rec.trace.window_s
