"""Cells, configurations, traffic, corpus classes and metrics are found by
name, and a new file is found without an edit."""

import json

import numpy as np
import pytest

from benchmark import harness, registry

BENCH = registry.benchmark()


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg) and set(c["reduced"]) == set(
            cfg["reduced"])
    for w in BENCH["workloads"]:
        t = registry.traffic(w["traffic"])
        assert callable(registry.op(t["op"]).setup)
        for spec in t["classes"]:
            assert callable(registry.corpus(spec["class"]).generate)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


def test_cell_metrics_by_trace():
    e2e = [m["name"] for m in registry.metrics(BENCH, "jt3-prod.objects",
                                               False)]
    layer = [m["name"] for m in registry.metrics(BENCH, "jt3-prod.objects",
                                                 True)]
    assert e2e == ["stored_pct", "setup_s"]
    assert "read_p95_ms.objects" in layer
    assert "archive_self.objects" in layer and "crc.restore" not in layer


def test_read_tail_per_layer():
    """The per-layer read tail is the nearest-rank 95th percentile of every
    read, as the end-to-end reader takes it."""
    recs = [harness.Record(0.0, ms / 1e3, 1, True, 0, "x")
            for ms in range(100, 0, -1)]
    run = harness.Run(recs, 0.0, 0, 0, None, None)
    for name in ("read_p95_ms.objects", "object_read_p95_ms"):
        assert registry.reader(name).read(run, {}) == pytest.approx(95.0)


def test_per_layer_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_unknown_cell_names_the_cells():
    with pytest.raises(KeyError, match="jam-default.restore"):
        registry.cell(BENCH, "no-such.cell")


def test_new_files_are_found(tmp_path, monkeypatch):
    from benchmark import corpus, metrics

    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "configs" / "cfg-x.json").write_text(json.dumps(
        {"name": "cfg-x", "flags": ["-m3"], "block_bytes": 4096}))
    (tmp_path / "traffic" / "mix-x.json").write_text(json.dumps(
        {"op": "restore", "classes": [{"class": "ones_x", "params": {}}]}))
    (tmp_path / "ones_x.py").write_text(
        "import numpy as np\n"
        "def generate(n, rng, layout):\n    return np.ones(n, np.uint8)\n")
    (tmp_path / "count_x.py").write_text(
        "def read(run, metric):\n    return len(run.records)\n")
    monkeypatch.setattr(registry, "CONFIGS", str(tmp_path / "configs"))
    monkeypatch.setattr(registry, "TRAFFIC", str(tmp_path / "traffic"))
    monkeypatch.setattr(corpus, "__path__", [*corpus.__path__,
                                             str(tmp_path)])
    monkeypatch.setattr(metrics, "__path__", [*metrics.__path__,
                                              str(tmp_path)])
    assert registry.config("cfg-x", {"block_bytes": 8})["block_bytes"] == 8
    spec = registry.traffic("mix-x")["classes"][0]
    out = registry.corpus(spec["class"]).generate(5, None, None)
    assert np.array_equal(out, np.ones(5, np.uint8))
    assert registry.reader("count_x.objects").read(
        type("R", (), {"records": [1, 2]}), {}) == 2
