"""A run's result line, and the entry point's exits."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, registry
from benchmark import run as entry

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
def test_line_small(workload, small):
    got = harness.run_cell(workload, 2**31 + 77, 0.5, False, "cpu",
                           small(workload))
    assert list(got) == KEYS + ["checks"]
    assert got["correct"] is True and got["failed"] == 0
    assert got["attempted"] >= 1
    wanted = {m["name"] for m in registry.metrics(BENCH, workload, False)}
    assert set(got["metrics"]) == wanted
    for m in got["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    # the op's own checks after the window (a backup's), each as sound
    after = {"backup": {"plain_blocks_bad": [0, 0],
                        "restore_bytes_wrong": [0, 0]}}
    op = registry.traffic(registry.cell(BENCH, workload)["traffic"])["op"]
    assert got["checks"] == {"ops_failed": [0, 0], "ops_wrong": [0, 0],
                             "bytes_wrong": [0, 0], **after.get(op, {})}


def test_traced_line_small(small):
    workload = "jt3-prod.restore"
    got = harness.run_cell(workload, 5, 0.5, True, "cpu", small(workload))
    assert list(got)[:5] == KEYS and list(got)[-1] == "checks"
    # no card: the host spans read, the device's metrics find nothing
    assert set(got["metrics"]) == {"archive_self.restore",
                                   "crc.restore", "meta.restore"}
    assert got["device"]["busy_s"] == 0 and got["device"]["window_s"] > 0


def test_same_seed_same_work(small):
    workload = "jt3-prod.objects"
    a = harness.run_cell(workload, 9, 0.5, False, "cpu", small(workload))
    b = harness.run_cell(workload, 9, 0.5, False, "cpu", small(workload))
    assert a["metrics"]["stored_pct"] == b["metrics"]["stored_pct"]


def test_no_card_no_line():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def fake_card(monkeypatch, line):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(entry, "run_cell", lambda *a, **k: line)


LINE = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
        "device": {}, "checks": {"ops_failed": [0, 0]}}


def test_line_is_last(monkeypatch, capsys):
    fake_card(monkeypatch, LINE)
    assert entry.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == LINE
    assert err.strip().splitlines()[-1] == "check ops_failed: 0 (limit 0)"


def test_jax_in_the_process_no_line(monkeypatch, capsys):
    fake_card(monkeypatch, LINE)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert entry.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "jaxlib" in err
