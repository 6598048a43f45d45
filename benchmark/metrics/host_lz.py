"""host_lz.<op>: time an op in the encode's LZ passes on the host
(runtime/device_encode.py, engines.NativeEngine.lz_encode): the spans
block.lz_pre, the dedupe pre-pass, and block.lz, the configured finder,
summed over the threads, in the metric's unit (s or ms)."""

from ._program import per_op

NAMES = ("block.lz_pre", "block.lz")


def read(run, metric):
    return per_op(run, metric, lambda name: name in NAMES)
