"""Observability: per-stage timing, throughput and ratio accounting (the
port's copy of StageMetrics and InstrumentedEngine of
jampack_tpu/runtime/metrics.py; tests/test_torch_standalone.py holds the
two classes equal to their originals line for line).

The reference has printf-only progress (jampack.cpp:226-231); here every
pipeline stage can be timed per block, aggregated across threads, and
reported as MB/s + share-of-wall-time: the CLI's -v for the stage engines.
The device path has a torch.profiler trace (device_trace) and the
device-compute walls of the fused block decode and encode, timed by CUDA
events (the JAX package's metrics.py:87-165).
"""

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class StageMetrics:
    """Thread-safe accumulator of (stage -> bytes, seconds, calls)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stats = defaultdict(lambda: [0, 0.0, 0])  # bytes, secs, calls

    @contextmanager
    def stage(self, name: str, nbytes: int):
        t0 = time.perf_counter()
        try:
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


@contextmanager
def device_trace(logdir: str):
    """torch.profiler trace around a device-path region, with the CPU and
    (where this machine has a card) the CUDA activities; on exit the
    Chrome trace is written to logdir/trace.json (chrome://tracing or
    Perfetto read it).  Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
