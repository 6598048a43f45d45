"""The port's block encode with the Lpx stage, on the CPU: byte-identical to
the native host engine (the byte contract) with -S4, -S4096, -S4096 -Sa and
-f2 -S8 -Sa, on a block whose -Sa gate keeps the stage and on one whose
gate drops it, and decoded back by the port; a two-block stream whose span
words read back as S and 0; the port's CLI against the JAX package's."""

import io
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Options, compress_block_ex, compress_stream
from jampack_tpu_torch.format import framing
from jampack_tpu_torch.runtime.device_decode import (
    decode_block_device,
    decompress_stream_device,
)
from jampack_tpu_torch.runtime.device_encode import (
    compress_stream_device,
    encode_block_device_ex,
)

from lpx_cases import log_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csv(n: int) -> np.ndarray:
    """Short fixed-width lines: the Lpx model fires within a few KiB."""
    out = bytearray()
    i = 0
    while len(out) < n:
        out += b"%05d,1,OK\n" % (i % 100000)
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def _opt(filters, spans, auto, lanes=4, chunk=4096, units=120):
    return Options(blocksize=1 << 20, match_finder=3, filters=filters,
                   rans_lanes=lanes, ans_chunk=chunk, anchor_units=units,
                   lpx_spans=spans, lpx_auto=auto)


@pytest.mark.parametrize("kind", ["records", "random"])
@pytest.mark.parametrize("filters,spans,auto", [(1, 4, False),
                                                (1, 4096, False),
                                                (1, 4096, True),
                                                (2, 8, True)])
def test_lpx_block_encode_matches_native(kind, filters, spans, auto):
    data = (log_records(12000) if kind == "records" else
            np.random.default_rng(spans).integers(0, 256, 5000,
                                                  dtype=np.uint8))
    opt = _opt(filters, spans, auto)
    got = encode_block_device_ex(data, opt, "cpu")
    assert got == compress_block_ex(data, opt, NativeEngine())
    # the gate keeps the stage on the records' 1.5 KiB spans of -f2 -S8
    # and drops it on their 3-byte spans and on random bytes
    kept = not auto or (kind == "records" and spans == 8)
    assert got[2] == (spans if kept else 0)
    back = decode_block_device(got[1], got[0], opt.blocksize, 120, 4, got[2],
                               "cpu")
    assert np.array_equal(back, data)


def test_mixed_stream_frames_each_block_with_its_span_word(monkeypatch):
    """A block whose gate keeps the stage, then a tail whose gate drops
    it: the span words read back as 4 and 0.  The blocks are 16 KiB, to
    keep the plain walks short: the options record is a copy with that
    block size (both encoders read only its attributes), and the port's
    reader takes it (its floor is the CLI's 1 MiB)."""
    monkeypatch.setattr(framing, "MIN_BLOCKSIZE", 16 << 10)
    data = np.concatenate([_csv(16 << 10), np.random.default_rng(9).integers(
        0, 256, 5000, dtype=np.uint8)]).tobytes()
    opt = SimpleNamespace(**{**vars(_opt(1, 4, True)), "blocksize": 16 << 10})
    want = io.BytesIO()
    compress_stream(io.BytesIO(data), want, opt, NativeEngine())
    got = io.BytesIO()
    compress_stream_device(io.BytesIO(data), got, opt, "cpu")
    assert got.getvalue() == want.getvalue()
    words = []
    stream = io.BytesIO(got.getvalue())
    while (rec := framing.read_block(stream)) is not None:
        words.append(rec[0].lpx_spans)
    assert words == [4, 0]
    back = io.BytesIO()
    decompress_stream_device(io.BytesIO(got.getvalue()), back, "cpu")
    assert back.getvalue() == data


def _cli(*args, pkg="jampack_tpu_torch"):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli",
                           *map(str, args)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_cli_encodes_spans_and_the_gate(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(np.concatenate([log_records(9000), _csv(4000)]).tobytes())
    flags = ["-m3", "-f1", "-c4", "-L4", "-u24", "-S8", "-Sa"]
    host, dev, back = (tmp_path / k for k in ("host.jt3", "dev.jt3", "back"))
    res = _cli("c", src, host, *flags, pkg="jampack_tpu")
    assert res.returncode == 0, res.stderr
    res = _cli("c", src, dev, *flags, "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert dev.read_bytes() == host.read_bytes()
    res = _cli("d", dev, back, "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert back.read_bytes() == src.read_bytes()
