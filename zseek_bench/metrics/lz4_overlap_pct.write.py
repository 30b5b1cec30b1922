"""Share of the LZ4 stream's batch dispatches that launched while an
earlier batch still ran on the card: 100 x the port's zseek.overlap marks
over its zseek.dispatch spans on the calling thread, from the port's
span log.  0 where the port dispatches and never marks (its batches run
one after another); None where the port has no span log or dispatched
nothing in the traced window."""


def read(rec):
    if rec.op != "write" or rec.trace is None:
        return None
    try:
        from libzseek_tpu_torch.utils import trace
    except ImportError:
        return None
    log = trace.spans()
    calling = {s.thread for s in log if s.name == "zseek.dispatch"}
    dispatches = sum(s.name == "zseek.dispatch" for s in log)
    if not dispatches:
        return None
    marks = sum(s.name == "zseek.overlap" and s.thread in calling
                for s in log)
    return 100.0 * marks / dispatches
