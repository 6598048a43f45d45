"""Decode of a golden archive of tests/fixtures through the port on the CPU
(the plain versions of the kernels), for the test_torch_fixtures*.py
files, and the encode of golden_input.bin into the six JAM archives, for
the test_torch_lz_encode_golden*.py files.  The archives are spread over
several files, so that pytest-xdist (--dist loadfile) runs them on several
workers: the plain versions walk the JAM archives' single 1 MiB entropy
chunk and 22 KiB Lpx spans one Python step at a time, 15-60 s an
archive each way."""

import contextlib
import io
import os

import torch

from jampack_tpu_torch.format import framing
from jampack_tpu_torch.runtime.device_decode import decompress_stream_device
from jampack_tpu_torch.runtime.device_encode import compress_stream_device
from jampack_tpu_torch.runtime.options import Options

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
    with one_thread():
        comp, raw = decompress_stream_device(io.BytesIO(arc), out, "cpu")
    assert comp == len(arc) and raw == len(out.getvalue())
    return words, out.getvalue() == _read("golden_input.bin")


@contextlib.contextmanager
def one_thread():
    """One torch thread: the plain walks are bound by Python's per-op
    overhead, and the other workers' large tensor ops keep the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# each JAM fixture's flags (tests/test_golden.py): -f0, the defaults (-m0
# -f1 -S4), -f2, -m1, -m2 and the store configuration -m3
GOLDEN_OPTIONS = {"golden_f0.jam": {"filters": 0}, "golden_f1.jam": {},
                  "golden_f2.jam": {"filters": 2},
                  "golden_m1.jam": {"match_finder": 1},
                  "golden_m2.jam": {"match_finder": 2},
                  "golden_m3.jam": {"match_finder": 3}}


def encode_golden(name: str):
    """Encode golden_input.bin on the CPU with archive `name`'s flags.
    Returns (whether the archive equals `name`, whether it decodes back to
    the input)."""
    data = _read("golden_input.bin")
    arc, out = io.BytesIO(), io.BytesIO()
    with one_thread():
        raw, comp = compress_stream_device(io.BytesIO(data), arc,
                                           Options(**GOLDEN_OPTIONS[name]),
                                           "cpu")
        decompress_stream_device(io.BytesIO(arc.getvalue()), out, "cpu")
    assert raw == len(data) and comp == len(arc.getvalue())
    return arc.getvalue() == _read(name), out.getvalue() == data


ARCHIVES = sorted(f for f in os.listdir(FIXTURES)
                  if f.startswith("golden_") and not f.endswith(".bin"))


def decode_golden_engine(name: str, engine) -> bool:
    """Decode archive `name` through runtime.pipeline.decompress_stream
    with a stage engine of the port; whether it gave golden_input.bin
    back."""
    from jampack_tpu_torch.runtime.pipeline import decompress_stream

    arc, out = _read(name), io.BytesIO()
    with one_thread():
        comp, raw = decompress_stream(io.BytesIO(arc), out, engine)
    assert raw == len(out.getvalue())
    return out.getvalue() == _read("golden_input.bin")
