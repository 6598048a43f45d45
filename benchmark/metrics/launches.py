"""launches.<op>: the port's hand-written kernels launched an op: the
count the program's span "op" carries (the change in the summed
_build.Kernel.launches over the cli.run call), averaged over the window's
ops."""

from ._program import ops


def read(run, metric):
    by = ops(run)
    if by is None:
        return None
    return sum(op.counts["launches"] for op, _ in by) / len(by)
