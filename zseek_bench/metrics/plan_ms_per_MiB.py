"""Self time of the port's zseek.plan ranges (the calling thread) per MiB
written in the traced window."""
from zseek_bench import measure


def read(rec):
    t = rec.trace
    if rec.op != "write" or t is None or "zseek.plan" not in t.span_self_s:
        return None
    return 1e3 * t.span_self_s["zseek.plan"] / (rec.in_bytes / measure.MIB)
