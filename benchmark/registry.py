"""Everything the harness runs, found by the name BENCHMARK.json gives it.

    configs/<config>.json      a configuration: the CLI flags and sizes
    traffic/<traffic>.json     a traffic mix: its op kind and parameters
    ops/<op>.py                an op kind: set-up and the jobs of its window
    corpus/<class>.py          a corpus class: generate(n, rng, **params)
    metrics/<quantity>.py      the reader of metric <quantity> or
                               <quantity>.<suffix>: read(run, metric)

A new cell, mix, class or metric is a new file; no file here needs an
edit to find it."""

import copy
import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
CONFIGS = os.path.join(HERE, "configs")
TRAFFIC = os.path.join(HERE, "traffic")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _merged(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    out.update(override or {})
    return out


def benchmark(path: str = None) -> dict:
    return _json(path or BENCHMARK)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; the cells are "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def config(name: str, override: dict = None) -> dict:
    """configs/<name>.json, with `override`'s keys replaced (tests)."""
    return _merged(_json(os.path.join(CONFIGS, f"{name}.json")), override)


def traffic(name: str, override: dict = None) -> dict:
    """traffic/<name>.json, with `override`'s keys replaced (tests)."""
    return _merged(_json(os.path.join(TRAFFIC, f"{name}.json")), override)


def op(kind: str):
    return importlib.import_module(f"{__package__}.ops.{kind}")


def corpus(cls: str):
    return importlib.import_module(f"{__package__}.corpus.{cls}")


def reader(metric: str):
    """The module that reads `metric`: metrics/<the name up to its first
    dot>.py."""
    return importlib.import_module(
        f"{__package__}.metrics.{metric.split('.', 1)[0]}")


def metrics(bench: dict, workload: str, traced: bool) -> list:
    """The metrics a run of `workload` reports: its end-to-end metrics
    without a trace, its per-layer metrics with one (each entry whose
    `workloads` names the cell, or that has no such key)."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]
