"""Token-dense -m1 blocks decode on the port (ROADMAP A9), on the CPU.

The JAX device decode sizes its LZ token slots for the dedupe pass's
matches of >= 256 B (plan_shapes' max(out_cap // 256, 4096)); -m1 emits a
token for each match of >= 4 B.  The port sizes its slots by the stream
(runtime/device_decode.token_slots), so an archive that its own `cli c`
writes decodes; the JAX device decode raises on the same archive, a
recorded fault of the JAX package that the port does not share."""

import io

import numpy as np
import pytest

from jampack_tpu.runtime import device_decode as jdd
from jampack_tpu_torch import cli
from jampack_tpu_torch.format import framing
from jampack_tpu_torch.runtime import device_decode as dd
from jampack_tpu_torch.runtime.engines import GpuEngine, NativeEngine
from jampack_tpu_torch.runtime.pipeline import decompress_stream
from jampack_tpu_torch.stages.lz77 import read_token

from golden_cases import one_thread
from lpx_cases import short_lines

FLAGS = ["-b1", "-m1", "-f0", "-S0"]  # 1 MiB blocks: 8,192 slots in JAX


def _tokens(stream: np.ndarray) -> int:
    buf, pos, t = stream.tobytes(), 0, 0
    while pos < len(buf):
        _, lit, off, pos = read_token(buf, pos)
        t += 1
        if off == 0:
            break
        pos += lit
    return t


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """(input bytes, the archive the port's `cli c` writes, its block)."""
    tmp = tmp_path_factory.mktemp("a9")
    data = short_lines(128 << 10)
    src, arc = tmp / "in.bin", tmp / "in.jt3"
    src.write_bytes(data.tobytes())
    with one_thread():
        assert cli.run(["cli", "c", str(src), str(arc), *FLAGS,
                        "--device", "cpu"]) == 0
    blob = arc.read_bytes()
    header, payload = framing.read_block(io.BytesIO(blob))
    return data, blob, header, payload


def test_block_holds_more_tokens_than_plan_shapes_slots(dense):
    data, blob, header, payload = dense
    eng = NativeEngine()
    s2 = eng.filters_encode(eng.lz_encode(data, 0), 0)
    s4 = eng.lz_encode(s2, 1)
    tokens = _tokens(s4)
    meta = dd.block_meta(payload, header.lanes)
    shapes = dd.plan_shapes([meta], [len(payload)], header.blocksize,
                            header.lanes)
    assert tokens > shapes["max_tokens"] == 8192
    slots = dd.token_slots(int(meta["chunk_olens"].sum()), shapes["out_cap"])
    assert tokens <= slots and s4.size // 2 <= slots
    with one_thread():
        got = GpuEngine("cpu").lz_decode(s4, cap=len(s2))
    assert np.array_equal(got, s2)


def test_port_decodes_its_own_token_dense_archive(dense):
    data, blob, _, _ = dense
    out = io.BytesIO()
    with one_thread():
        dd.decompress_stream_device(io.BytesIO(blob), out, "cpu")
    assert out.getvalue() == data.tobytes()
    back = io.BytesIO()
    decompress_stream(io.BytesIO(blob), back, NativeEngine())
    assert back.getvalue() == data.tobytes()


def test_jax_device_decode_raises_on_it(dense):
    """The recorded fault of the JAX package (ROADMAP C9): its slots run
    out on this block."""
    _, _, header, payload = dense
    with pytest.raises(ValueError, match="corrupt stream"):
        jdd.decode_block_device(payload, header.crc, header.blocksize,
                                header.units, header.lanes, header.lpx_spans)


def test_token_slots_bound():
    assert dd.token_slots(0, 0) == 4096
    assert dd.token_slots(9 << 20, 1 << 20) == 9 << 19
    assert dd.token_slots(100, 2 << 20) == 1 << 20
