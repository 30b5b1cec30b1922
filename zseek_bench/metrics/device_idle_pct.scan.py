"""100 less the device's busy share of the traced window: the union of
its CUDA kernel and copy intervals over the window's length (scan cells)."""


def read(rec):
    t = rec.trace
    if rec.op != "scan" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
