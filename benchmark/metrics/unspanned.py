"""unspanned.<op>: the share of the card's idle time inside the ops (the
program's "op" spans) during which no program span is open but the
containers (the op, archive.window, archive.wait, block.batch), in
percent: idle time that no layer of the program accounts for.

It also hands the window's program spans, as (name, thread, start, end),
to the run's host spans, so that the harness names each idle gap of the
breakdown by the innermost program span open at its middle."""

from ._program import CONTAINERS, intersect, merged, ops, total


def read(run, metric):
    by = ops(run)
    if by is None:
        return None
    spans = [r for _, recs in by for r in recs]
    run.spans.records.extend((r.name, r.thread, r.start, r.end)
                             for r in spans)
    idle = intersect(merged(run.device.gaps(*run.window)),
                     merged((op.start, op.end) for op, _ in by))
    if not idle:
        return 0.0
    inner = merged((r.start, r.end) for r in spans
                   if r.name not in CONTAINERS)
    return 100.0 * (1.0 - total(intersect(idle, inner)) / total(idle))
