"""Self time of the port's zseek.prefetch_wait ranges (the calling thread
blocked on a prefetch window of the Reader) per MiB read in the traced
window."""
from zseek_bench import measure


def read(rec):
    t = rec.trace
    if rec.op != "scan" or t is None or not rec.read_bytes or \
            "zseek.prefetch_wait" not in t.span_self_s:
        return None
    return 1e3 * t.span_self_s["zseek.prefetch_wait"] / \
        (rec.read_bytes / measure.MIB)
