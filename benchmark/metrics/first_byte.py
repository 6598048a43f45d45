"""first_byte.<op>: how long a caller waits for the first restored byte:
from each op's start (the program's span "op") to the start of its first
archive.write (runtime/sharding.py), averaged over the window's ops that
write, in the metric's unit (s or ms)."""

from ._program import ops

SCALE = {"s": 1.0, "ms": 1e3}


def read(run, metric):
    by = ops(run)
    if by is None:
        return None
    waits = [min(r.start for r in recs if r.name == "archive.write")
             - op.start for op, recs in by
             if any(r.name == "archive.write" for r in recs)]
    if not waits:
        return None
    return sum(waits) / len(waits) * SCALE[metric["unit"]]
