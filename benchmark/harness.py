"""The harness: set-up, the window and the readings of one run of a cell.

A cell of BENCHMARK.json names a configuration (configs/<name>.json: the
CLI flags and sizes) and a traffic mix (traffic/<name>.json: an op kind of
ops/ and its parameters).  Set-up makes the corpus from the seed
(corpus/), has the port write what the op reads, and runs ops of the
cell's own kind to warm every shape.  The window then runs ops back to
back, one caller, each one jampack_tpu_torch.cli.run with the
configuration's flags on the cell's cards (--device), until the seconds
have passed; the op that is running then finishes inside the window.
Every byte each op gives back is compared with the seeded input
(reference/compare.py).  Once the window has closed and the card's peak
memory has been read, the checks the op's set-up left in `ctx.after` run
(a backup's plain decode and restore of its archive), outside set-up and
the window.  A traced run puts the window under torch.profiler (trace.py)
and spans around the program's layers (spans.py).
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from dataclasses import dataclass

import numpy as np
import torch
from jampack_tpu_torch import cli

from . import registry, trace
from .metrics import _program
from .reference.compare import Sink
from .spans import OP, Spans

PROGRAM = "jampack_tpu_torch.cli"


@dataclass
class Job:
    """One op: cli <mode> <source> <the sink>; `answer` is what it must
    give back; `archive`, where the op writes one, the file that holds its
    answer."""
    mode: str
    source: str
    answer: np.ndarray
    archive: str = None


@dataclass
class Record:
    start: float
    end: float
    raw: int  # bytes the op had to give back
    ok: bool  # cli.run returned 0
    wrong: int  # bytes given back wrong, missing or extra
    source: str
    archive: str = None  # the job's


@dataclass
class Run:
    """What the metric readers read."""
    records: list
    setup_s: float
    stored: int  # archive bytes the port wrote in set-up
    raw: int  # the raw bytes they hold
    spans: Spans
    device: "trace.DeviceTrace"  # None without a trace

    @property
    def window(self):
        return self.records[0].start, self.records[-1].end

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    def per_op(self, seconds: float, unit: str) -> float:
        return seconds / len(self.records) * {"s": 1.0, "ms": 1e3}[unit]


class _Discard:
    """A stdout for the CLI's summary lines."""

    def write(self, s):
        return len(s)

    def flush(self):
        pass


class Context:
    """Set-up's view of a run: the corpus, the work directory, the CLI on
    the cell's cards and the sink that checks what it gives back."""

    def __init__(self, config, traffic, seed, work, device):
        self.config, self.traffic = config, traffic
        self.seed = seed & (2**64 - 1)
        self.work, self.device = work, device
        self.sink = Sink(os.path.join(work, "out.fifo"))
        self.stored = self.raw = 0
        # checks to run once the window has closed: each () -> {name:
        # [value, limit]}, the value at most the limit where it holds
        self.after = []

    def rng(self, *key) -> np.random.Generator:
        """A generator of the seed and `key` (strings or ints)."""
        words = [zlib.crc32(k.encode()) if isinstance(k, str) else int(k)
                 for k in key]
        return np.random.default_rng(np.random.SeedSequence(
            self.seed, spawn_key=tuple(words)))

    def block(self, i: int) -> np.ndarray:
        """Corpus block i: block_bytes of class i mod the traffic's
        classes, drawn from the seed; the class's layout (vocabulary,
        templates, pools, tones) from the traffic's layout_seed, the same
        for every seed, so that a seed changes the bytes and not the
        work."""
        spec = self.traffic["classes"][i % len(self.traffic["classes"])]
        layout = np.random.default_rng(np.random.SeedSequence(
            int(self.traffic["layout_seed"]),
            spawn_key=(zlib.crc32(spec["class"].encode()),)))
        return registry.corpus(spec["class"]).generate(
            int(self.config["block_bytes"]), self.rng("block", i), layout,
            **spec["params"])

    def path(self, name: str) -> str:
        return os.path.join(self.work, name)

    def cli(self, *argv) -> bool:
        """jampack_tpu_torch.cli.run(argv) on the cell's cards, its summary
        line discarded; False (the traceback on stderr) where it raises or
        exits non-zero."""
        try:
            with contextlib.redirect_stdout(_Discard()):
                return cli.run([PROGRAM, *argv, "--device", self.device]) == 0
        except (Exception, SystemExit):
            traceback.print_exc(file=sys.stderr)
            return False

    def encode(self, data: np.ndarray, name: str) -> str:
        """The port's archive of `data` with the configuration's flags,
        at work/<name>; its size counts into stored_pct."""
        src, dst = self.path(name + ".raw"), self.path(name)
        with open(src, "wb") as f:
            f.write(data.tobytes())
        ok = self.cli("c", src, dst, *self.config["flags"])
        os.remove(src)
        if not ok:
            flags = " ".join(self.config["flags"])
            raise RuntimeError(f"set-up: cli c {flags} failed on {name}")
        self.stored += os.path.getsize(dst)
        self.raw += data.size
        return dst

    def do(self, job: Job) -> Record:
        self.sink.expect(job.answer)
        start = time.perf_counter()
        ok = self.cli(job.mode, job.source, self.sink.path)
        end = time.perf_counter()
        return Record(start, end, job.answer.size, ok,
                      self.sink.result(opened=ok), job.source, job.archive)

    def warm(self, job: Job) -> None:
        rec = self.do(job)
        if not rec.ok or rec.wrong:
            raise RuntimeError(f"set-up: the warm-up op on {job.source} "
                               f"failed or gave {rec.wrong} bytes wrong")


def checks(records: list) -> dict:
    """Each number compared, with its limit: an op's answer is exact."""
    return {
        "ops_failed": [sum(not r.ok for r in records), 0],
        "ops_wrong": [sum(bool(r.wrong) for r in records), 0],
        "bytes_wrong": [sum(r.wrong for r in records), 0],
    }


def _cards(device: str, count: int) -> list:
    """The card indices a run uses: cuda:N, or the first `count`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    return [dev.index] if dev.index is not None else list(range(count))


def _device_record(cards: list, count: int) -> dict:
    if not cards:
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]),
            "count": count,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(c))
                                     for c in cards),
            "power_limit": limit}


def _window(ctx, jobs, seconds: float, spans: Spans, traced: bool):
    """Ops back to back until `seconds` have passed since the first began:
    (records, the DeviceTrace of a traced run or None)."""
    records = []
    with trace.window(traced, ctx.work) as found:
        for job in jobs:
            rec = ctx.do(job)
            records.append(rec)
            spans.add(OP, rec.start, rec.end)
            if rec.end - records[0].start >= seconds:
                break
    return records, found


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda:0", overrides: dict = None,
             start: float = None) -> dict:
    """One run of `workload`; returns the result line as a dict.  `start`
    is the host clock's reading when the process started (set-up counts
    from it; default: now).  `overrides` ({"config": {...}, "traffic":
    {...}}) replaces keys of the cell's files, for tests at small sizes."""
    start = time.perf_counter() if start is None else start
    bench = registry.benchmark()
    overrides = overrides or {}
    cell = registry.cell(bench, workload)
    config = registry.config(cell["config"], overrides.get("config"))
    traffic = registry.traffic(cell["traffic"], overrides.get("traffic"))
    wanted = registry.metrics(bench, workload, traced)
    readers = {m["name"]: registry.reader(m["name"]) for m in wanted}
    targets = {}
    for r in readers.values() if traced else ():
        targets.update(getattr(r, "SPANS", {}))
    cards = _cards(device, cell["chips"])
    spans = Spans()
    with tempfile.TemporaryDirectory(prefix="benchmark-") as work:
        ctx = Context(config, traffic, seed, work, device)
        try:
            jobs = registry.op(traffic["op"]).setup(ctx)
            for c in cards:
                torch.cuda.synchronize(c)
                torch.cuda.reset_peak_memory_stats(c)
            setup_s = time.perf_counter() - start
            with spans.installed(targets):
                records, found = _window(ctx, jobs, seconds, spans, traced)
            result = {"correct": None, "attempted": len(records),
                      "failed": sum(not r.ok for r in records),
                      "metrics": {},
                      "device": _device_record(cards, cell["chips"])}
            print(f"window: {len(records)} op(s) of "
                  f"{[round(r.end - r.start, 3) for r in records]} s",
                  file=sys.stderr)
            compared = checks(records)
            for check in ctx.after:
                compared.update(check())
        finally:
            ctx.sink.close()
        run = Run(records, setup_s, ctx.stored, ctx.raw, spans, found)
        for m in wanted:
            value = readers[m["name"]].read(run, m)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    if found is not None:
        lo, hi = run.window
        result["device"].update(busy_s=found.busy(lo, hi), window_s=hi - lo)
        if found.ops:
            program_spans(run)
            result["breakdown"] = {
                "device_ops": found.top_ops(),
                "idle_gaps": trace.idle_gaps(found, spans, lo, hi)}
    result["correct"] = all(v <= lim for v, lim in compared.values())
    result["checks"] = compared
    return result


def program_spans(run: Run) -> None:
    """Hand the program's own spans of the window's ops to the run's host
    spans, so that each idle gap of the breakdown is named by the
    innermost span open at its middle, the program's included."""
    run.spans.records.extend((r.name, r.thread, r.start, r.end)
                             for _, recs in _program.ops(run) or ()
                             for r in recs)
