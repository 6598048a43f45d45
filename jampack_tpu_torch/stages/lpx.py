"""Lpx span split and the per-block Lpx gate: the port's copies of
jampack_tpu/stages/lpx.py::_split_spans and of the gate constants of
jampack_tpu/runtime/pipeline.py (:154-165).  tests/test_torch_standalone.py
holds them equal to their originals.

The span split is format-visible: a block of n bytes is cut into ceil(n/b)
contiguous spans of b = n // spans bytes, the last one shorter, each coded
with its own model state (lpx.cpp:150-169).  The gate keeps the stage only
when it zeroes at least NUM/DEN of the block's bytes (-Sa), in integer
arithmetic.
"""

LPX_AUTO_GAIN_NUM = 1
LPX_AUTO_GAIN_DEN = 100


def _split_spans(n: int, spans: int = 4):
    block = n // spans
    if block == 0:
        # degenerate tiny input: the reference would loop forever; treat the
        # whole input as one span (format-equivalent for n < 4)
        return [(0, n)] if n else []
    spans = []
    i = 0
    while i < n:
        ln = block if (i + block) < n else (n - i)
        spans.append((i, ln))
        i += block
    return spans


def gain_gate(zeros_before: int, zeros_after: int, n: int) -> bool:
    """pipeline._lpx_gain_gate on counts: True when the stage's output of
    an n-byte block holds enough more zero bytes than its input."""
    if n == 0:
        return False
    return ((zeros_after - zeros_before) * LPX_AUTO_GAIN_DEN
            >= n * LPX_AUTO_GAIN_NUM)
