"""Decode of a golden archive of tests/fixtures through the port on the CPU
(the plain versions of the kernels), for the test_torch_fixtures*.py
files.  The seven archives that frame Lpx spans are spread over four
files, so that pytest-xdist (--dist loadfile) runs them on several
workers: the plain versions walk the JAM archives' single 1 MiB entropy
chunk and 22 KiB Lpx spans one Python step at a time, 15-60 s an
archive."""

import io
import os

import torch

from jampack_tpu_torch.format import framing
from jampack_tpu_torch.runtime.device_decode import decompress_stream_device

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def decode_golden(name: str):
    """Decode archive `name` on the CPU; returns (its span words, whether
    it gave golden_input.bin back)."""
    arc = _read(name)
    words = []
    stream = io.BytesIO(arc)
    while (rec := framing.read_block(stream)) is not None:
        words.append(rec[0].lpx_spans)
    out = io.BytesIO()
    # one thread: the plain walks are bound by Python's per-op overhead,
    # and the other workers' large tensor ops keep the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        comp, raw = decompress_stream_device(io.BytesIO(arc), out, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert comp == len(arc) and raw == len(out.getvalue())
    return words, out.getvalue() == _read("golden_input.bin")
