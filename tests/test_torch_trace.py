"""The port's spans and counters (runtime/metrics.py) on the CPU: nothing
is recorded with tracing off; a traced `cli d` on a ["cpu"] mesh is one op
whose spans carry its id into the worker thread; the Marks clock keeps the
`times=` keys of the block runtime; the recorder's bound; `--trace DIR`.
The test marked gpu holds the op's launch count to the kernels' counters
on the card.

Small blocks, as tests/test_torch_bench_archive.py takes them: the CLI's
parsed block size and framing.MIN_BLOCKSIZE are lowered for the calls."""

import gc
import json
import time

import numpy as np
import pytest
import torch

from golden_cases import one_thread
from jampack_tpu_torch import cli
from jampack_tpu_torch.format import framing
from jampack_tpu_torch.kernels import _build
from jampack_tpu_torch.runtime import metrics
from jampack_tpu_torch.runtime.device_decode import decode_blocks_device
from jampack_tpu_torch.runtime.device_encode import encode_block_device_ex
from jampack_tpu_torch.runtime.options import Options

# (block bytes, cli c flags): JT3's -Sa gate and 960 units need a few KiB;
# the JAM plain walks are slow past 2 KiB
CONFIGS = {"jt3": (8192, ["-m3", "-f1", "-c16", "-L4", "-u960", "-S4096",
                          "-Sa"]),
           "jam": (2048, [])}
# the times= keys of each path, as the block runtime gave them before the
# Marks clock (decode: a JAM block; encode: -m0 -f1 -S4, the host-LZ route)
DECODE_KEYS = ["concat", "d2h", "filters", "h2d", "host_crc", "host_meta",
               "ibwt", "lpx", "lz", "lz_dedupe", "rank", "rans", "rle0",
               "status"]
ENCODE_KEYS = ["bwt", "d2h", "d2h_s2", "deal", "filters", "h2d", "h2d_s3",
               "host_crc", "lpx", "lz", "lz_pre", "model", "rank", "rans",
               "rle0", "search", "splice"]


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma\n", b"delta, ", b"epsilon "]
    return b"".join(words[i] for i in rng.integers(0, len(words), n))[:n]


@pytest.fixture
def archive(tmp_path, monkeypatch):
    """archive(label) -> (input bytes, the archive's path): four blocks at
    the label's size and flags, written by the native engine."""
    block = {}
    parse = cli._parse

    def small_blocks(argv):
        mode, inp, outp, opt = parse(argv)
        opt.blocksize = block["bytes"]
        return mode, inp, outp, opt

    monkeypatch.setattr(cli, "_parse", small_blocks)
    monkeypatch.setattr(framing, "MIN_BLOCKSIZE", 1)

    def make(label):
        block["bytes"], flags = CONFIGS[label]
        data = _text(3 * block["bytes"] + 100, 1)
        src, arc = tmp_path / "in", tmp_path / f"{label}.arc"
        src.write_bytes(data)
        assert cli.run(["cli", "c", str(src), str(arc), *flags, "--engine",
                        "native"]) == 0
        return data, arc

    return make


def _since(t0: float) -> list:
    """The records since t0 but the garbage collections', which may fall
    anywhere."""
    return [r for r in metrics.records()
            if r.start >= t0 and r.name != "gc.collect"]


def test_off_records_nothing(archive, tmp_path):
    data, arc = archive("jam")
    before = metrics.records()
    with one_thread():
        assert cli.run(["cli", "d", str(arc), str(tmp_path / "back"),
                        "--device", "cpu"]) == 0
    assert (tmp_path / "back").read_bytes() == data
    assert metrics.records() == before


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_one_op_a_call_into_the_worker(archive, tmp_path, label):
    data, arc = archive(label)
    t0 = time.perf_counter()
    with metrics.tracing(), one_thread():
        assert cli.run(["cli", "d", str(arc), str(tmp_path / "back"),
                        "--device", "cpu"]) == 0
    assert (tmp_path / "back").read_bytes() == data
    got = _since(t0)
    ops = [r for r in got if r.name == metrics.ROOT]
    assert len(ops) == 1
    op = ops[0]
    assert all(r.op == op.id and op.start <= r.start <= r.end <= op.end
               for r in got)
    assert op.counts["raw"] == len(data) and op.counts["launches"] == 0
    assert op.counts["syncs"] == sum(r.name.startswith("sync.") for r in got)
    by = {r.id: r for r in got}
    named = {}
    for r in got:
        named.setdefault(r.name, []).append(r)
    assert len(named["archive.window"]) == 1
    window = named["archive.window"][0]
    assert by[window.parent] is op
    for batch in named["block.batch"]:
        assert by[batch.parent] is window and batch.thread != window.thread
    assert len(named["block.crc"]) == 4 and len(named["block.fetch"]) == 4
    assert sum(r.counts["bytes"] for r in named["archive.write"]) == len(data)
    assert sum(r.counts["bytes"] for r in named["block.fetch"]) == len(data)
    assert sum(r.counts["bytes"] for r in named["block.crc"]) == len(data)
    for name in ("cli.setup", "cli.open", "cli.close", "archive.read",
                 "block.meta", "block.plan", "block.upload", "block.chain",
                 "chain.rans", "chain.status", "sync.status"):
        assert name in named, name


def test_marks_keep_the_times_keys():
    """The block runtime's times= split through one Marks clock: the keys
    it gave before, and a span for each stage when tracing is on."""
    data = np.frombuffer(_text(2048, 3), np.uint8)
    opt = Options(blocksize=1 << 20, match_finder=0, filters=1, lpx_spans=4)
    enc, dec = {}, {}
    t0 = time.perf_counter()
    with metrics.tracing(), one_thread():
        crc, payload, used = encode_block_device_ex(data, opt, "cpu", enc)
        got = decode_blocks_device([payload], [crc], opt.blocksize, 120, 0,
                                   [used], "cpu", dec)
    assert got[0].tobytes() == data.tobytes()
    assert sorted(enc) == ENCODE_KEYS and sorted(dec) == DECODE_KEYS
    assert all(v >= 0 for v in (*enc.values(), *dec.values()))
    recs = _since(t0)
    names = {r.name for r in recs}
    for crc_mark in ("block.host_crc", "block.crc"):
        assert [r.counts["bytes"] for r in recs
                if r.name == crc_mark] == [data.size]
    for key in ("host_crc", "lz_pre", "h2d", "search", "d2h_s2", "lz",
                "h2d_s3", "d2h", "splice", "meta", "plan", "upload", "chain",
                "fetch", "crc"):
        assert f"block.{key}" in names, key
    for key in ("filters", "lpx", "bwt", "rank", "rle0", "deal", "model",
                "rans", "h2d", "concat", "ibwt", "lz", "lz_dedupe", "status"):
        assert f"chain.{key}" in names, key


def test_recorder_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(metrics, "_recorder", metrics.Recorder(limit=3))
    gc.disable()
    try:
        with metrics.tracing():
            for k in range(5):
                with metrics.span(f"s{k}", k=k):
                    pass
    finally:
        gc.enable()
    assert [(r.name, r.counts) for r in metrics.records()] == [
        ("s2", {"k": 2}), ("s3", {"k": 3}), ("s4", {"k": 4})]
    assert metrics.dropped() == 2


def test_garbage_collections_are_spans():
    t0 = time.perf_counter()
    gc.collect()
    with metrics.tracing(), metrics.span("outer") as outer:
        gc.collect()
    got = [r for r in metrics.records()
           if r.start >= t0 and r.name == "gc.collect"]
    assert [(r.parent, r.counts) for r in got] == [
        (outer.id, {"generation": 2})]


def test_stage_engine_spans():
    stats = metrics.StageMetrics()
    t0 = time.perf_counter()
    with stats.stage("bwt_forward", 10):
        pass
    with metrics.tracing(), stats.stage("bwt_forward", 30):
        pass
    assert stats.summary()["bwt_forward"]["calls"] == 2
    assert [(r.name, r.counts) for r in _since(t0)] == [
        ("engine.bwt_forward", {"bytes": 30})]


def test_cli_trace_writes_the_spans(archive, tmp_path):
    data, arc = archive("jam")
    logdir = tmp_path / "trace"
    assert cli.run(["cli", "d", str(arc), str(tmp_path / "back"), "--engine",
                    "native", "-v", f"--trace={logdir}"]) == 0
    assert (tmp_path / "back").read_bytes() == data
    assert metrics._tracing == 0
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    op = [e for e in spans if e["name"] == metrics.ROOT]
    assert len(op) == 1 and op[0]["args"]["raw"] == len(data)
    assert {"cli.setup", "cli.open", "cli.close",
            "engine.ans_decode"} <= {e["name"] for e in spans}
    mark = next(e for e in events if e["name"] == metrics.TRACE_MARK)
    for e in spans:
        assert mark["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= (
            mark["ts"] + mark["dur"])


@pytest.mark.gpu
def test_op_launches_are_the_kernels_launches(archive, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jampack_tpu_torch import bench

    kernels = bench._kernels()
    assert set(kernels) == set(_build.KERNELS)
    for label in sorted(CONFIGS):
        data, arc = archive(label)
        before = sum(k.launches for k in kernels)
        t0 = time.perf_counter()
        with metrics.tracing():
            assert cli.run(["cli", "d", str(arc), str(tmp_path / "back"),
                            "--device", "cuda:0"]) == 0
        assert (tmp_path / "back").read_bytes() == data
        op = next(r for r in _since(t0) if r.name == metrics.ROOT)
        launched = sum(k.launches for k in kernels) - before
        assert op.counts["launches"] == launched > 0, label
