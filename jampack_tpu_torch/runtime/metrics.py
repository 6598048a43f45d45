"""Observability: per-stage timing, throughput and ratio accounting (the
port's copy of StageMetrics and InstrumentedEngine of
jampack_tpu/runtime/metrics.py; tests/test_torch_standalone.py holds
InstrumentedEngine equal to its original line for line and StageMetrics
to its original's report).

The reference has printf-only progress (jampack.cpp:226-231); here every
pipeline stage can be timed per block, aggregated across threads, and
reported as MB/s + share-of-wall-time: the CLI's -v for the stage engines.
The device path has a torch.profiler trace (device_trace) and the
device-compute walls of the fused block decode and encode, timed by CUDA
events (the JAX package's metrics.py:87-165).

Spans and counters: span(name, **counts) marks a layer boundary of the
program, and Marks is the one clock over a run of stages (the block
runtime's and the chains').  While tracing is on, each closed span is a
Record in memory: its name, the id of the cli.run call it belongs to
(the root span, ROOT), its parent's id, the thread, its start and end on
time.perf_counter() (the host clock onto which a profiler trace is
mapped) and a few counts.  Tracing is on inside tracing() and while
torch's profiler records; otherwise a span site costs two lookups.
Span contexts cross into the archive runtime's worker threads
(runtime/sharding.py runs each job in a copy of the submitter's context).
Each garbage collection is a span "gc.collect" of whichever thread ran
it: a collection stops every thread of the process.
"""

import contextvars
import gc
import itertools
import json
import sys
import threading
import time
from collections import defaultdict, deque, namedtuple
from contextlib import contextmanager

from ..kernels._build import launched


class StageMetrics:
    """Thread-safe accumulator of (stage -> bytes, seconds, calls)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stats = defaultdict(lambda: [0, 0.0, 0])  # bytes, secs, calls

    @contextmanager
    def stage(self, name: str, nbytes: int):
        t0 = time.perf_counter()
        try:
            with span("engine." + name, bytes=nbytes):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self.stats[name]
                s[0] += nbytes
                s[1] += dt
                s[2] += 1

    def summary(self) -> dict:
        total = sum(s[1] for s in self.stats.values()) or 1e-12
        out = {}
        for name, (nbytes, secs, calls) in sorted(self.stats.items()):
            out[name] = {
                "MB": round(nbytes / 1e6, 3),
                "s": round(secs, 4),
                "MB/s": round(nbytes / 1e6 / secs, 2) if secs > 0 else None,
                "share": round(secs / total, 3),
                "calls": calls,
            }
        return out

    def report(self) -> str:
        lines = []
        for name, row in self.summary().items():
            lines.append(
                f"  {name:<16} {row['MB']:>10.2f} MB {row['s']:>8.3f} s "
                f"{(row['MB/s'] or 0):>9.1f} MB/s  {row['share']*100:>5.1f}%"
            )
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(self.summary())


class InstrumentedEngine:
    """Wraps any engine, timing every stage call into a StageMetrics."""

    def __init__(self, engine, metrics: StageMetrics = None):
        self._engine = engine
        self.metrics = metrics or StageMetrics()
        self.name = f"{engine.name}+metrics"

    def __getattr__(self, attr):
        fn = getattr(self._engine, attr)
        if not callable(fn):
            return fn

        def wrapped(data, *args, **kwargs):
            try:
                nbytes = int(getattr(data, "size", 0) or len(data))
            except TypeError:
                nbytes = 0
            with self.metrics.stage(attr, nbytes):
                return fn(data, *args, **kwargs)

        return wrapped


# ---------------------------------------------------------------------------
# Spans and counters

ROOT = "op"  # the span of one cli.run call; its id is its records' op
LIMIT = 1 << 20  # records kept; the oldest beyond it are dropped and counted

Record = namedtuple("Record", "id name op parent thread start end counts")


class Recorder:
    """The closed spans, at most `limit` of them, in memory; nothing is
    written during a run."""

    def __init__(self, limit: int = LIMIT):
        # reentrant: a garbage collection that an allocation under the lock
        # starts records its span from the same thread
        self._lock = threading.RLock()
        self._records = deque(maxlen=limit)
        self.dropped = 0

    def add(self, record: Record, root=None) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(record)
            if root is not None and record.name.startswith("sync."):
                root.counts["syncs"] += 1

    def records(self) -> list:
        with self._lock:
            return list(self._records)


_recorder = Recorder()
_tracing = 0  # open tracing() blocks
_tracing_lock = threading.Lock()
_ids = itertools.count(1)
_current = contextvars.ContextVar("jampack_tpu_torch.span", default=None)


def records() -> list:
    """A copy of the recorded spans, oldest first."""
    return _recorder.records()


def dropped() -> int:
    """Spans dropped past the recorder's bound."""
    return _recorder.dropped


@contextmanager
def tracing():
    """Record spans while the block runs (they also record while torch's
    profiler does)."""
    global _tracing
    with _tracing_lock:
        _tracing += 1
    try:
        yield
    finally:
        with _tracing_lock:
            _tracing -= 1


def _on() -> bool:
    """Whether spans record: inside tracing(), or while torch's profiler
    records (it cannot where torch is not imported)."""
    if _tracing:
        return True
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and profiler._is_profiler_enabled


def _record(name: str, start: float, end: float, counts: dict,
            parent=None, id_: int = None, root=None) -> None:
    root = root or (parent.root if parent is not None else None)
    _recorder.add(Record(id_ or next(_ids), name,
                         root.id if root is not None else 0,
                         parent.id if parent is not None else 0,
                         threading.get_ident(), start, end, counts), root)


_gc_start = None


def _gc_span(phase: str, info: dict) -> None:
    """A gc.callbacks hook: each collection while tracing is on is a span
    "gc.collect" with its generation."""
    global _gc_start
    if phase == "start":
        _gc_start = time.perf_counter() if _on() else None
    elif _gc_start is not None:
        _record("gc.collect", _gc_start, time.perf_counter(),
                {"generation": info["generation"]}, _current.get())
        _gc_start = None


gc.callbacks.append(_gc_span)


class _Span:
    """An open span; recorded when its block ends.  The root span counts
    the kernel launches (_build.Kernel.launches, summed) and the sync.*
    spans of its op."""

    __slots__ = ("name", "counts", "id", "parent", "root", "start", "_token",
                 "_launched")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        self.parent = _current.get()
        self.id = next(_ids)
        if self.name == ROOT:
            self.root = self
            self.counts["syncs"] = 0
            self._launched = launched()
        else:
            self.root = self.parent.root if self.parent is not None else None
        self._token = _current.set(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _current.reset(self._token)
        if self.root is self:
            self.counts["launches"] = launched() - self._launched
        _record(self.name, self.start, end, self.counts, self.parent, self.id,
                self.root)
        return False

    def add(self, **counts) -> None:
        """Counts known only inside the block."""
        self.counts.update(counts)


class _Off:
    """The span of a site while tracing is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, **counts):
    """A context manager spanning a layer boundary, with counts such as
    bytes; a span named ROOT opens a new op."""
    return _Span(name, counts) if _on() else _OFF


class Marks:
    """One clock over a run of stages, each starting where the one before
    ended: mark(name) closes the span "<layer>.<name>" that opened at the
    previous mark (at the clock's start for the first).  With a dict
    `times` it first synchronizes the calling thread's stream on the device
    (not the whole card, where other workers run) and adds the stage's
    wall seconds to times[key], key the name unless given (None: not
    timed).  Without `times` nothing is synchronized, so a span holds the
    host's time to enqueue its stage; with tracing off too, a mark does
    nothing."""

    def __init__(self, dev, times: dict = None, layer: str = "block"):
        self.times, self.layer = times, layer
        self.stream = None
        if times is not None and dev.type == "cuda":
            import torch

            self.stream = torch.cuda.current_stream(dev)
        self.t0 = time.perf_counter()

    def __call__(self, name: str, key: str = "", layer: str = None,
                 **counts) -> None:
        traced = _on()
        if self.times is None and not traced:
            return
        if self.stream is not None:
            self.stream.synchronize()
        now = time.perf_counter()
        if self.times is not None and key is not None:
            key = key or name
            self.times[key] = self.times.get(key, 0.0) + now - self.t0
        if traced:
            _record(f"{layer or self.layer}.{name}", self.t0, now, counts,
                    _current.get())
        self.t0 = now


TRACE_MARK = "jampack_tpu_torch.trace"


@contextmanager
def device_trace(logdir: str):
    """torch.profiler trace around a device-path region, with the CPU and
    (where this machine has a card) the CUDA activities; on exit the
    Chrome trace is written to logdir/trace.json (chrome://tracing or
    Perfetto read it), with the spans recorded meanwhile as host events
    (category "span") on the profiler's clock: the annotation TRACE_MARK
    opens the region beside a reading of the host clock, as
    benchmark/trace.py maps a window.  Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(TRACE_MARK):
            start = time.perf_counter()
            yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, start)


def _add_spans(path: str, start: float) -> None:
    """The spans recorded since `start` into the Chrome trace at `path`."""
    import os

    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    marks = [e for e in events if e.get("name") == TRACE_MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {TRACE_MARK} annotation")
    offset = float(marks[0]["ts"]) - start * 1e6
    events.extend(
        {"name": r.name, "cat": "span", "ph": "X", "pid": os.getpid(),
         "tid": r.thread, "ts": r.start * 1e6 + offset,
         "dur": (r.end - r.start) * 1e6,
         "args": {"id": r.id, "op": r.op, "parent": r.parent, **r.counts}}
        for r in records() if r.start >= start)
    with open(path, "w") as f:
        json.dump(trace, f)


def _best_wall(fn, trials: int, dev) -> float:
    """Best of `trials` runs of fn() in seconds after one warm-up run: CUDA
    events on the calling thread's stream for a card, the host clock for
    the CPU."""
    import torch

    fn()
    best = float("inf")
    for _ in range(trials):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def fused_decode_compute_wall(payload: bytes, blocksize: int, units: int,
                              lanes: int, lpx_spans: int, trials: int = 3,
                              device="cuda") -> float:
    """Best-of-trials device-compute wall, in seconds, of the fused block
    decode (kernels/device_stages.decode_block_core): the payload is staged
    on the card and the metadata parsed outside the timed region; the
    fetch of the output and the host CRC are not timed (the JAX package's
    fused_decode_compute_wall; the reference times its kernel, not the
    copy, in bwt.cpp).  The chain's own status fetches (the LZ parse's)
    stay inside."""
    import numpy as np
    import torch

    from ..device import resolve
    from ..kernels.device_stages import decode_block_core
    from .device_decode import block_meta, plan_shapes, token_slots

    dev = resolve(device)
    meta = block_meta(payload, lanes)
    shapes = plan_shapes([meta], [len(payload)], blocksize, lanes)
    slots = token_slots(int(meta["chunk_olens"].sum()), shapes["out_cap"])
    pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)

    def run():
        _, _, ok = decode_block_core(pay, meta, lanes, units,
                                     shapes["out_cap"], slots, lpx_spans)
        if not ok:
            raise ValueError("device decode failed (corrupt stream)")

    return _best_wall(run, trials, dev)


def fused_encode_compute_wall(data, opt, trials: int = 3,
                              device="cuda") -> float:
    """Best-of-trials device-compute wall, in seconds, of the fused block
    encode in the JAX function's configuration (the store framing, no
    filter picks, opt's static Lpx span count without the gate): the
    stage-1 stream is staged on the card outside the timed region; the
    metadata fetch and the splice (host and transfer work) are not timed.
    The mirror of fused_decode_compute_wall."""
    import numpy as np
    import torch

    from ..device import resolve
    from ..format.constants import ANS_CHUNK_SIZE
    from ..kernels.encode_stages import END_TOKEN, encode_back, encode_front

    dev = resolve(device)
    tok = torch.as_tensor(END_TOKEN, device=dev)
    s1 = torch.cat([tok, torch.from_numpy(
        np.array(data, dtype=np.uint8)).to(dev)])
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)

    def run():
        s2, _ = encode_front(s1, None, lpx_spans=int(opt.lpx_spans))
        encode_back(torch.cat([tok, s2]), units=int(opt.anchor_units),
                    chunk=chunk, lanes=int(opt.rans_lanes))

    return _best_wall(run, trials, dev)
