"""The port's multi-host flow (runtime/distributed.py): P simulated hosts
decode or encode disjoint block sets and stitch them back, byte-identical
to the single-process paths of the port and of the JAX package; and two
OS processes that meet in a gloo process group through initialize(),
each writing its part, stitched by the parent."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from jampack_tpu.runtime.engines import NativeEngine as JNativeEngine
from jampack_tpu.runtime.pipeline import Options as JOptions
from jampack_tpu.runtime.pipeline import compress_stream as jcompress_stream
from jampack_tpu_torch.runtime import distributed
from jampack_tpu_torch.runtime.engines import NativeEngine
from jampack_tpu_torch.runtime.options import Options
from jampack_tpu_torch.runtime.pipeline import compress_stream, decompress_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(42)


def test_owner_partition_is_total_and_disjoint():
    owners = [distributed.owner(i, 4) for i in range(100)]
    assert set(owners) == set(range(4))
    assert distributed.owner(5, 0) == 0


@pytest.mark.parametrize("P", [1, 2, 3])
def test_multihost_decode_stitch(tmp_path, P):
    data = (b"multi host block stream " * 8000
            + bytes(RNG.integers(0, 256, 120000, dtype=np.uint8)))
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc,
                    Options(filters=0, blocksize=1 << 20),
                    engine=NativeEngine())
    blob = arc.getvalue()
    distributed.initialize()  # single-process no-op
    out_dir = str(tmp_path / "parts")
    for p in range(P):
        distributed.decompress_stream_part(io.BytesIO(blob), out_dir, p, P,
                                           engine=NativeEngine())
    out_path = str(tmp_path / "restored.bin")
    assert distributed.stitch(out_dir, out_path, P) == len(data)
    with open(out_path, "rb") as f:
        assert f.read() == data
    if P > 1:
        os.remove(os.path.join(out_dir, "manifest1.json"))
        with pytest.raises(FileNotFoundError):
            distributed.stitch(out_dir, out_path, P)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("tail", ["ragged", "exact"])
def test_multihost_encode_stitch(tmp_path, P, tail):
    """The stitched archive equals the port's single-process
    compress_stream and the JAX package's, the trailing empty block of an
    exact multiple included."""
    bs = 1 << 20
    n = 3 * bs if tail == "exact" else 3 * bs + 70000
    data = (b"multi host encode " * (n // 18 + 1))[:n]
    want = io.BytesIO()
    compress_stream(io.BytesIO(data), want, Options(filters=1, blocksize=bs),
                    engine=NativeEngine())
    jwant = io.BytesIO()
    jcompress_stream(io.BytesIO(data), jwant,
                     JOptions(filters=1, blocksize=bs),
                     engine=JNativeEngine())
    assert want.getvalue() == jwant.getvalue()
    out_dir = str(tmp_path / "aparts")
    for p in range(P):
        distributed.compress_stream_part(io.BytesIO(data), len(data), out_dir,
                                         p, P, Options(filters=1,
                                                       blocksize=bs),
                                         engine=NativeEngine())
    out_path = str(tmp_path / "stitched.jam")
    total = distributed.stitch_archive(out_dir, out_path, P)
    with open(out_path, "rb") as f:
        got = f.read()
    assert total == len(got)
    assert got == want.getvalue()


WORKER = r"""
import os, sys
sys.path.insert(0, sys.argv[5])
sys.modules["jax"] = None
sys.modules["jampack_tpu"] = None
import torch.distributed as dist

pid, port, tmp, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]

from jampack_tpu_torch.runtime import distributed
from jampack_tpu_torch.runtime.engines import NativeEngine
from jampack_tpu_torch.runtime.options import Options

distributed.initialize(f"127.0.0.1:{port}", 2, pid)
assert dist.get_world_size() == 2 and dist.get_rank() == pid
dist.barrier()
opt = Options(blocksize=1 << 20, match_finder=0, filters=1)
if mode == "compress":
    raw = os.path.join(tmp, "raw.bin")
    with open(raw, "rb") as inp:
        distributed.compress_stream_part(inp, os.path.getsize(raw), tmp, pid,
                                         2, opt, engine=NativeEngine())
else:
    with open(os.path.join(tmp, "archive.jam"), "rb") as inp:
        distributed.decompress_stream_part(inp, tmp, pid, 2,
                                           engine=NativeEngine())
distributed.shutdown()
assert not dist.is_initialized()
print("WORKER_OK", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(tmp, mode):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(p), str(port), tmp, mode, REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    try:
        outs = [proc.communicate(timeout=120)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for p, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"worker {p} failed:\n{out}"
        assert f"WORKER_OK {p}" in out, out


def test_two_process_gloo_compress_decode(tmp_path):
    """Two processes meet through initialize() (gloo), each writes its
    part; the parent's stitched archive equals the single-process
    archives of the port and of the JAX package, and the two-process
    decode stitched back gives the input."""
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", dtype=np.uint8)
    rng = np.random.default_rng(11)
    raw = alpha[rng.integers(0, 16, 3 * (1 << 20) + 1500)].tobytes()
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "raw.bin"), "wb") as f:
        f.write(raw)
    _run_pair(tmp, "compress")
    arch = os.path.join(tmp, "archive.jam")
    distributed.stitch_archive(tmp, arch, 2)
    ref = io.BytesIO()
    compress_stream(io.BytesIO(raw), ref,
                    Options(blocksize=1 << 20, match_finder=0, filters=1),
                    engine=NativeEngine())
    jref = io.BytesIO()
    jcompress_stream(io.BytesIO(raw), jref,
                     JOptions(blocksize=1 << 20, match_finder=0, filters=1),
                     engine=JNativeEngine())
    with open(arch, "rb") as f:
        stitched = f.read()
    assert stitched == ref.getvalue() == jref.getvalue()
    _run_pair(tmp, "decode")
    out_path = os.path.join(tmp, "round.bin")
    distributed.stitch(tmp, out_path, 2)
    with open(out_path, "rb") as f:
        assert f.read() == raw
    plain = io.BytesIO()
    decompress_stream(io.BytesIO(stitched), plain, NativeEngine())
    assert plain.getvalue() == raw
