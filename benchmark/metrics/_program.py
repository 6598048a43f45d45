"""The program's own spans, for the readers of program_span and
program_counter metrics.

jampack_tpu_torch.runtime.metrics records a span at each layer boundary
while torch's profiler records, as it does over a traced window: a Record
(id, name, op, parent, thread, start, end, counts) on the host clock,
time.perf_counter, onto which trace.py maps the device's operations.  An
op is the span "op" that cli.run opens; every span inside the call
carries its id.  A run without device operations (the CPU) reads
nothing, and neither does a program without the recorder."""

from jampack_tpu_torch.runtime import metrics as program

ROOT = "op"
# spans that only contain others: the op, a window of blocks, the wait on a
# worker, a batch of blocks
CONTAINERS = (ROOT, "archive.window", "archive.wait", "block.batch")


def ops(run):
    """[(op record, the records of that op)] for every program op that
    began inside the traced window, or None."""
    records = getattr(program, "records", None)
    if run.device is None or not run.device.ops or records is None:
        return None
    lo, hi = run.window
    found = records()
    roots = {r.id: (r, []) for r in found
             if r.name == ROOT and lo <= r.start <= hi}
    for r in found:
        if r.op in roots:
            roots[r.op][1].append(r)
    return list(roots.values()) or None


def per_op(run, metric, match):
    """The spans whose name `match` accepts, summed over every thread and
    averaged over the window's ops, in the metric's unit (s or ms); None
    where there are none."""
    found = [r for _, recs in ops(run) or () for r in recs
             if match(r.name)]
    if not found:
        return None
    return run.per_op(sum(r.end - r.start for r in found), metric["unit"])


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def intersect(xs: list, ys: list) -> list:
    """The intervals two sorted lists of disjoint intervals share."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def total(intervals) -> float:
    return sum(b - a for a, b in intervals)
