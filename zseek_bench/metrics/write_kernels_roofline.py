"""The least time the card's memory needs to read the input once and
write the archive once ((input + archive bytes) / 3.35 TB/s), as a share
of the union of the traced window's CUDA kernel intervals."""
from zseek_bench import measure


def read(rec):
    t = rec.trace
    if rec.op != "write" or t is None or not t.kernels:
        return None
    return measure.byte_roofline_pct(rec.in_bytes + rec.out_bytes,
                                     t.kernel_s)
