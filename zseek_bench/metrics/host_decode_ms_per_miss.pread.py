"""Self time of the port's decode ranges on the calling thread
(zseek.parse, upload, hostlit, execute, fetch and k4) per frame-cache
miss of the traced window."""

STAGES = ("zseek.parse", "zseek.upload", "zseek.hostlit", "zseek.execute",
          "zseek.fetch", "zseek.k4")


def read(rec):
    t = rec.trace
    if rec.op != "pread" or t is None or not rec.misses:
        return None
    spent = sum(t.span_self_s.get(s, 0.0) for s in STAGES)
    if not spent:
        return None
    return 1e3 * spent / rec.misses
