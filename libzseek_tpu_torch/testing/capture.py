"""The arguments a codec passes to one of its kernels' wrappers, for
running that wrapper again at the path's real inputs (the port's card
tests and chip_smoke.py)."""

from __future__ import annotations

import inspect


def first_call(module, name: str, codec, frames) -> inspect.BoundArguments:
    """Compress `frames` with `codec`, and return the arguments of its
    first call to module.name (the call itself runs as usual)."""
    real = getattr(module, name)
    got = []

    def spy(*a, **kw):
        if not got:
            got.append(inspect.signature(real).bind(*a, **kw))
        return real(*a, **kw)
    setattr(module, name, spy)
    try:
        codec.compress_frames(frames)
    finally:
        setattr(module, name, real)
    if not got:
        raise RuntimeError(f"the codec never called {name}")
    return got[0]
