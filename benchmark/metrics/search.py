"""search.<op>: time an op in the encode's -f1/-f2 filter search
(kernels/filters_search.py as runtime/device_encode.py calls it: the span
block.search, the host's reads of the card's scores included), summed
over the threads, in the metric's unit (s or ms)."""

from ._program import per_op


def read(run, metric):
    return per_op(run, metric, lambda name: name == "block.search")
