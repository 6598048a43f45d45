"""The readers of the program's own spans (metrics/_program.py and its
readers) on a built run: two ops of made-up program spans, a device trace
of made-up kernel intervals, and the harness's op records around them."""

import pytest

from benchmark import harness, registry, trace
from benchmark.spans import Spans
from jampack_tpu_torch.runtime import metrics as program

MAIN, WORKER = 1, 2

# (id, name, op, parent, thread, start, end, counts): op 1 a restore that
# decodes one batch in the worker, op 10 one that writes early
RECORDS = [
    (2, "cli.setup", 1, 1, MAIN, 10.0, 10.05, {}),
    (3, "cli.open", 1, 1, MAIN, 10.05, 10.1, {}),
    (4, "archive.read", 1, 1, MAIN, 10.1, 10.4, {}),
    (5, "archive.window", 1, 1, MAIN, 10.5, 19.5, {"blocks": 2}),
    (6, "archive.wait", 1, 5, MAIN, 10.6, 18.0, {}),
    (7, "block.batch", 1, 5, WORKER, 10.6, 18.0, {"blocks": 2}),
    (8, "block.upload", 1, 7, WORKER, 10.6, 11.0, {"bytes": 100}),
    (9, "block.chain", 1, 7, WORKER, 11.0, 12.0, {}),
    (11, "sync.status", 1, 7, WORKER, 11.5, 12.0, {}),
    (12, "block.fetch", 1, 7, WORKER, 12.0, 12.5, {"bytes": 50}),
    (13, "block.crc", 1, 7, WORKER, 12.5, 18.0, {}),
    (14, "archive.write", 1, 5, MAIN, 18.0, 19.0, {"bytes": 50}),
    (15, "cli.close", 1, 1, MAIN, 19.5, 20.0, {}),
    (1, "op", 1, 0, MAIN, 10.0, 20.0, {"syncs": 1, "launches": 12}),
    (16, "cli.setup", 10, 10, MAIN, 21.0, 21.2, {}),
    (17, "sync.lz_head", 10, 10, WORKER, 21.2, 21.3, {}),
    (18, "archive.write", 10, 10, MAIN, 23.0, 24.0, {"bytes": 7}),
    (10, "op", 10, 0, MAIN, 21.0, 25.0, {"syncs": 1, "launches": 4}),
    # a warm-up op before the window: not read
    (20, "op", 20, 0, MAIN, 1.0, 2.0, {"syncs": 0, "launches": 99}),
    (21, "sync.status", 20, 20, MAIN, 1.0, 2.0, {}),
]
KERNELS = [("k1", 11.0, 11.9, "kernel"), ("k2", 21.5, 22.0, "kernel")]
METRICS = {m["name"]: m for m in registry.benchmark()["per_layer"]}


def built(device=True):
    ops = [harness.Record(9.9, 20.1, 100, True, 0, "a"),
           harness.Record(20.9, 25.1, 100, True, 0, "a")]
    found = None
    if device:
        found = trace.DeviceTrace()
        found.ops = list(KERNELS)
    spans = Spans()
    for r in ops:
        spans.records.append(("cli.run", MAIN, r.start, r.end))
    return harness.Run(ops, 1.0, 1, 2, spans, found)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(program, "records",
                        lambda: [program.Record(*r) for r in RECORDS])


def read(name, run):
    return registry.reader(name).read(run, METRICS[name])


def test_per_op_sums(recorded):
    run = built()
    assert read("wait.restore", run) == pytest.approx((0.5 + 0.1) / 2)
    assert read("wait.objects", run) == pytest.approx((0.5 + 0.1) / 2 * 1e3)
    assert read("copies.restore", run) == pytest.approx((0.4 + 0.5) / 2)
    io = 0.05 + 0.3 + 1.0 + 0.5 + 1.0
    assert read("io.restore", run) == pytest.approx(io / 2)
    assert read("io.objects", run) == pytest.approx(io / 2 * 1e3)
    assert read("launches.restore", run) == pytest.approx(8.0)


def test_first_byte(recorded):
    assert read("first_byte.restore", built()) == pytest.approx(
        ((18.0 - 10.0) + (23.0 - 21.0)) / 2)


def test_unspanned_share(recorded):
    # idle inside the ops: op 1 [10, 20] less the kernel [11, 11.9], op 10
    # [21, 25] less [21.5, 22]; no span but containers open: op 1 [10.4,
    # 10.6] and [19, 19.5], op 10 [21.3, 21.5], [22, 23] and [24, 25]
    idle = (10.0 - 0.9) + (4.0 - 0.5)
    bare = 0.2 + 0.5 + 0.2 + 1.0 + 1.0
    assert read("unspanned.restore", built()) == pytest.approx(
        100.0 * bare / idle)


def test_gaps_named_by_program_spans(recorded):
    run = built()
    harness.program_spans(run)
    lo, hi = run.window
    named = trace.idle_gaps(run.device, run.spans, lo, hi)
    assert [n for n, _ in named] == ["block.crc", "archive.write", "op"]
    assert [s for _, s in named] == pytest.approx([21.5 - 11.9, 3.1, 1.1])


def test_nothing_to_read(recorded, monkeypatch):
    names = [n for n in METRICS if n.split(".")[0] in (
        "wait", "copies", "io", "first_byte", "launches", "unspanned")]
    assert len(names) == 14
    cpu = built(device=False)
    assert all(read(n, cpu) is None for n in names)
    # a program without the recorder, as the parent of the recorder is
    monkeypatch.delattr(program, "records")
    run = built()
    assert all(read(n, run) is None for n in names)
    assert len(run.spans.records) == 2
