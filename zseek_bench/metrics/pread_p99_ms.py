"""The 99th percentile of every pread_full of the window, on the host
clock per call; a call that failed counts as missing (above all)."""
from zseek_bench import measure


def read(rec):
    if rec.op != "pread" or not rec.call_s:
        return None
    return 1e3 * measure.percentile(rec.call_s, 99)
