"""The 99th percentile of the host-clock time of each Writer.write and
Writer.close call of the window (the reference benchmark's per-write
latency)."""
from zseek_bench import measure


def read(rec):
    if rec.op != "write" or not rec.call_s:
        return None
    return 1e3 * measure.percentile(rec.call_s, 99)
