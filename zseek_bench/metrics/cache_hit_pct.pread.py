"""The Reader's frame-cache hits as a share of its lookups over the window
(ReaderStats.cache_hits and cache_misses)."""


def read(rec):
    if rec.op != "pread" or rec.hits + rec.misses == 0:
        return None
    return 100.0 * rec.hits / (rec.hits + rec.misses)
