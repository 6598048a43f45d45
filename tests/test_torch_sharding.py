"""The port's sharded paths on meshes of "cpu" entries (the plain versions
of the kernels): codec_block_step against the JAX package's, exactly;
roundtrip_blocks on 2 and 3 entries; archives across three entries
byte-identical to the port's compress_stream with the native engine; the
fused compute walls and the trace at tiny shapes; and the dry run."""

import io
import os

import numpy as np
import pytest
import torch

from golden_cases import one_thread
import jax

from jampack_tpu.runtime.sharding import codec_block_step as jax_step
from jampack_tpu_torch import dryrun
from jampack_tpu_torch.format import framing
from jampack_tpu_torch.runtime import metrics, sharding
from jampack_tpu_torch.runtime.engines import NativeEngine
from jampack_tpu_torch.runtime.options import Options
from jampack_tpu_torch.runtime.pipeline import compress_block_ex, compress_stream

MESH3 = ["cpu"] * 3


def _records(n: int) -> np.ndarray:
    out = bytearray()
    i = 0
    while len(out) < n:
        out += (b"ts=2026-08-20T09:%02d:%02d level=INFO module=core "
                b"id=%06d\n" % (i // 60 % 60, i % 60, i))
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def _text(n: int, seed: int) -> np.ndarray:
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", np.uint8)
    return alpha[np.random.default_rng(seed).integers(0, 16, n)]


def test_codec_block_step_equals_jax():
    """recon, bwt and metric on random 120 x 16-byte blocks."""
    block = np.random.default_rng(3).integers(0, 256, 120 * 16,
                                              dtype=np.uint8)
    with one_thread():
        recon, bwt, metric = sharding.codec_block_step(torch.from_numpy(block))
    jrecon, jbwt, jmetric = jax.jit(jax_step)(block)
    assert np.array_equal(recon.numpy(), np.asarray(jrecon))
    assert np.array_equal(recon.numpy(), block)
    assert np.array_equal(bwt.numpy(), np.asarray(jbwt))
    assert int(metric) == int(jmetric)


@pytest.mark.parametrize("entries", [2, 3])
def test_roundtrip_blocks(entries):
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, (2 * entries, 120 * 8), dtype=np.uint8)
    with one_thread():
        recon, bwt, metric = sharding.roundtrip_blocks(blocks,
                                                       ["cpu"] * entries)
        one = [sharding.codec_block_step(torch.from_numpy(b))[1].numpy()
               for b in blocks]
    assert np.array_equal(recon, blocks)
    assert np.array_equal(bwt, np.stack(one))
    assert metric == int(bwt.astype(np.uint64).sum())
    with pytest.raises(ValueError, match="divide"):
        sharding.roundtrip_blocks(blocks[:-1], ["cpu"] * entries)


CASES = {
    # -m3 -f1 with a ragged tail: three same-length blocks batch together,
    # the tail runs alone
    "m3_f1_ragged": (dict(match_finder=3, filters=1, lpx_spans=8),
                     lambda: [_text(4096, s) for s in range(3)]
                     + [_text(1500, 9)]),
    # the reference's defaults (-m0 -f1 -S4): the host finders, a block at
    # a time on its entry
    "m0_defaults": (dict(match_finder=0, filters=1),
                    lambda: [_text(4096, s) for s in range(3)]),
    # -Sa: the gate keeps Lpx on the records (span word 2) and drops it on
    # random bytes (0); batches of 2 over three entries put the two
    # records blocks in one batch
    "m3_Sa_mixed": (dict(match_finder=3, filters=0, lpx_spans=2,
                         lpx_auto=True),
                    lambda: [_records(8192), _records(8192)[::-1].copy()]
                    + [np.random.default_rng(s).integers(
                        0, 256, 2048).astype(np.uint8) for s in (7, 8)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_archive_across_three_entries(case, monkeypatch):
    """encode_archive_sharded on ["cpu"] * 3 in batches of 2 gives the
    native engine's archive byte for byte (a block a read, framed at
    -b1), and decode_archive_sharded gives the input back."""
    kw, make = CASES[case]
    parts = make()
    opt = Options(blocksize=1 << 20, rans_lanes=4, ans_chunk=2048,
                  anchor_units=16, **kw)
    want = io.BytesIO()
    compress_stream(dryrun._Chunked(parts), want, opt, NativeEngine())
    got = io.BytesIO()
    monkeypatch.setattr(sharding, "_mesh_batch", lambda mesh, size: 2)
    with one_thread():
        raw, comp = sharding.encode_archive_sharded(
            dryrun._Chunked(parts), got, opt, MESH3)
    assert got.getvalue() == want.getvalue()
    assert (raw, comp) == (sum(p.size for p in parts), len(want.getvalue()))
    if case == "m3_Sa_mixed":
        stream, words = io.BytesIO(got.getvalue()), []
        while (rec := framing.read_block(stream)) is not None:
            words.append(rec[0].lpx_spans)
        assert words == [2, 2, 0, 0]
    seen = []
    with one_thread():
        plain = sharding.decode_archive_sharded(
            io.BytesIO(got.getvalue()), MESH3,
            progress=lambda r, c: seen.append((r, c)))
    assert plain == b"".join(p.tobytes() for p in parts)
    assert seen[-1] == (len(plain), len(want.getvalue()))


def test_feof_rule_and_corrupt_block_index():
    """An empty input gets the one empty block (the reference's feof rule
    at K = 0); a corrupt payload's error names the block's index in the
    archive, here block 2, the first block of the second entry's run."""
    opt = Options(blocksize=1 << 20, match_finder=3, filters=0,
                  rans_lanes=4, ans_chunk=2048, anchor_units=16, lpx_spans=0)
    empty, want = io.BytesIO(), io.BytesIO()
    with one_thread():
        sharding.encode_archive_sharded(io.BytesIO(b""), empty, opt,
                                        ["cpu", "cpu"])
    compress_stream(io.BytesIO(b""), want, opt, NativeEngine())
    assert empty.getvalue() == want.getvalue()
    assert sharding.decode_archive_sharded(io.BytesIO(empty.getvalue()),
                                           ["cpu", "cpu"]) == b""
    parts = [_text(3000, s) for s in range(4)]
    arc = io.BytesIO()
    with one_thread():
        sharding.encode_archive_sharded(dryrun._Chunked(parts), arc, opt,
                                        ["cpu", "cpu"])
    stream, ends = io.BytesIO(arc.getvalue()), []
    while framing.read_block(stream) is not None:
        ends.append(stream.tell())
    assert len(ends) == 4
    bad = bytearray(arc.getvalue())
    bad[ends[2] - 100] ^= 0x10  # inside block 2's payload
    with one_thread(), pytest.raises(ValueError, match="block 2"):
        sharding.decode_archive_sharded(io.BytesIO(bytes(bad)),
                                        ["cpu", "cpu"])


def test_mesh_and_batch(monkeypatch):
    assert sharding.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.make_mesh(["cuda:0"])
    # 80% of 10 GiB over 8 MiB blocks: (1,024 - 47) // 88 blocks; two
    # entries on one device share it; MAX_BATCH caps 1 MiB blocks, which
    # fit thousands, at 32
    monkeypatch.setattr(sharding, "available_memory", lambda: 10 << 30)
    assert sharding.batch_blocks(8 << 20, "cpu") == 11
    assert sharding.batch_blocks(8 << 20, "cpu", 2) == 5
    assert sharding._mesh_batch([torch.device("cpu")] * 2, 8 << 20) == 5
    monkeypatch.setattr(sharding, "available_memory", lambda: 1 << 40)
    assert sharding.batch_blocks(1 << 20, "cpu") == sharding.MAX_BATCH == 32
    assert sharding.batch_blocks(1 << 30, "cpu") == 1
    # the host holds the window: 80% of 1 GiB over 4 x 8 MiB a block of
    # each of two entries is 12 blocks, whatever the cards could take
    monkeypatch.setattr(sharding, "available_memory", lambda: 1 << 30)
    monkeypatch.setattr(sharding, "batch_blocks", lambda size, d, w: 32)
    assert sharding._mesh_batch([torch.device("cpu")] * 2, 8 << 20) == 12
    assert sharding._mesh_batch([torch.device("cpu")] * 2, 1 << 30) == 1


def test_encode_refuses_a_host_engine_and_f3():
    opt = Options(blocksize=1 << 20, match_finder=3, filters=0)
    with pytest.raises(ValueError, match="host engine"):
        sharding.encode_archive_sharded(io.BytesIO(b"x"), io.BytesIO(), opt,
                                        ["cpu"], engine=NativeEngine())
    with pytest.raises(NotImplementedError):
        sharding.encode_archive_sharded(
            io.BytesIO(b"x"), io.BytesIO(),
            Options(blocksize=1 << 20, match_finder=3, filters=3), ["cpu"])


def test_compute_walls_and_trace(tmp_path):
    """The fused walls at a tiny shape on the CPU (host clock) and the
    trace of a decode, which writes its file."""
    opt = Options(blocksize=1 << 20, match_finder=3, filters=0,
                  rans_lanes=4, ans_chunk=1024, anchor_units=16, lpx_spans=2)
    data = _text(600, 2)
    crc, payload, spans = compress_block_ex(data, opt, NativeEngine())
    with one_thread():
        dec = metrics.fused_decode_compute_wall(payload, opt.blocksize, 16, 4,
                                                spans, trials=1, device="cpu")
        enc = metrics.fused_encode_compute_wall(data, opt, trials=1,
                                                device="cpu")
        with metrics.device_trace(str(tmp_path / "trace")):
            sharding.decode_archive_sharded(io.BytesIO(
                framing_block(crc, payload, opt, spans)), ["cpu"])
    assert 0 < dec < 60 and 0 < enc < 60
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0


def framing_block(crc, payload, opt, spans) -> bytes:
    out = io.BytesIO()
    framing.write_block(out, crc, payload, opt.blocksize, opt.anchor_units,
                        opt.rans_lanes, spans)
    return out.getvalue()


def test_dryrun_multichip_two_cpu_entries():
    with one_thread():
        dryrun.dryrun_multichip(["cpu", "cpu"])
    fn, args = dryrun.entry("cpu")
    assert fn is sharding.codec_block_step and args[0].numel() == 120 * 512
