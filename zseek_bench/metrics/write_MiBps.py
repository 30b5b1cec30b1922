"""Input MiB through Writer.write and close, over the whole window."""
from zseek_bench import measure


def read(rec):
    if rec.op != "write" or not rec.in_bytes:
        return None
    return measure.rate_mib_s(rec.in_bytes, rec.window_s)
