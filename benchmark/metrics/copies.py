"""copies.<op>: time an op in the block runtime's copies between host and
card (runtime/device_decode.py): block.upload, the join, the copy and the
H2D of a batch's payloads, and block.fetch, each block's D2H into
pageable memory, summed over the threads, in the metric's unit (s or
ms)."""

from ._program import per_op

NAMES = ("block.upload", "block.fetch")


def read(run, metric):
    return per_op(run, metric, lambda name: name in NAMES)
