"""Self time of the port's zseek.stream_wait ranges (the calling thread
blocked on the Writer's finishing thread) per MiB written in the traced
window."""
from zseek_bench import measure


def read(rec):
    t = rec.trace
    if rec.op != "write" or t is None or not rec.in_bytes or \
            "zseek.stream_wait" not in t.span_self_s:
        return None
    return 1e3 * t.span_self_s["zseek.stream_wait"] / \
        (rec.in_bytes / measure.MIB)
