"""Decompressed MiB that the reads returned, over the whole window."""
from zseek_bench import measure


def read(rec):
    if rec.op != "scan" or not rec.read_bytes:
        return None
    return measure.rate_mib_s(rec.read_bytes, rec.window_s)
