"""Every byte the sink received (frames, decode-hint sidecar, seek table)
over the input bytes, across the window's archives."""


def read(rec):
    if rec.op != "write" or not rec.in_bytes:
        return None
    return rec.out_bytes / rec.in_bytes
