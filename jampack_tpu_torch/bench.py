"""The port's bench: its end-to-end numbers on one line.

    python -m jampack_tpu_torch.bench [--trials 5] [--seed 0] [--keys bwt,block,archive]
    python -m jampack_tpu_torch.bench --device cpu --size 1920 --trials 1 --keys bwt,block   (tests)

Three groups of keys, each through the port's own entry points:

  bwt      the metric of record, bwt_codec_combined_8mb: the BWT codec
           cycle on one textlike block of 8 MiB less 8 MiB % 1920 bytes,
           on the card.  Forward: the suffix sort (kernels/sa.py
           sa_doubling_core), the BWT emission and the anchors
           isa[u * step] + 1, converted to int32 at the end of the forward
           step, inside its time.  Inverse: the LF map (ibwt.combined_map)
           and the anchored chase (ibwt.chase, K3).  At 120 anchor units
           (the reference's fixed count; the value) and at 1,920 (the
           native stream's); both inverses must give the block back.  The
           value is 2 n / (t_fwd + t_inv) in GB/s.
  block    one 8 MiB block through the block runtime: the native engine's
           -m0 -f0 encode; the fused encode of -m3 -f0 with the production
           JT3 stream (16 KiB chunks, 4 lanes, 960 units, 4,096 Lpx spans)
           and with spans 0, byte-identical to the native engine; its
           device-compute wall; four blocks in one batch; the fused decode
           of the native -m0 -f0 stream and of its -Sa (lpx_auto) form,
           exact; its compute wall; four blocks in one batch; the auto
           stream's size against the reference's default (-m0 -f1 -S4)
           on the same block.  Each key carries the `times=` split of one
           run (`<key>_times`).
  archive  cli c|d in process on 32 MiB (records, random, text, records;
           one 8 MiB block each): jt3 (-m3 -f0 -u960 -c16 -L4 -S8 -Sa,
           whose gate keeps Lpx on the records only) and jam (no flag: the
           reference's default -m0 -f1 -S4), each encoded by --engine
           native and --engine fused, byte-identical, and the fused archive
           decoded by --engine fused, exact.  The first call of each is
           timed on its own (`<key>_first_s`, what a user pays once).

Timing: the host clock around work that ends in torch.cuda.synchronize(),
one first call, then --trials runs; a key's value is the median, with
`<key>_min`, `<key>_max` and `<key>_n` beside it.  The compute walls time
by CUDA events (runtime/metrics.py), one run a call.  The last line of
stdout is one JSON object: {"metric", "value", "unit", "device", "extra"};
progress goes to stderr.

There is no fallback: a broken byte contract, an inexact decode or a kernel
that fails to build or launch raises, and the process exits non-zero
without its line; --device cuda (the default) raises without a card.
--device cpu is for the tests: the same code on the plain PyTorch versions
of the kernels, where nothing is timed: each step runs once, with its
`times=` split, every timed key is null and the device is
{"platform": "cpu"}.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve

METRIC = "bwt_codec_combined_8mb"
GROUPS = ("bwt", "block", "archive")
BLOCK = 8 << 20  # the reference's default block (format.hpp:20)
REF_UNITS = 120  # the reference's anchor units (the metric of record)
NATIVE_UNITS = 1920  # the native stream's
# The production JT3 stream (bench.py's PROD_*): 16 KiB entropy chunks,
# 4 rANS lanes, 960 anchor units, 4,096 Lpx spans.
PROD_CHUNK = 16 << 10
PROD_LANES = 4
PROD_UNITS = 960
PROD_SPANS = 4096
ARCHIVE_BLOCKS = 4
ARCHIVE_FLAGS = {"jt3": ["-m3", "-f0", "-u960", "-c16", "-L4", "-S8", "-Sa"],
                 "jam": []}
JT3_ARCHIVE_SPANS = 8


class ContractError(RuntimeError):
    """A byte contract or an exactness check failed."""


def textlike(n: int, seed: int = 0) -> np.ndarray:
    """The JAX bench's corpus (bench.py:56-60): 30 letters, uniform."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    return alpha[(x >> 16) % 30]


def archive_input(block: int, seed: int) -> bytes:
    """tools/fused_cli_chip.py's input from `seed`: four blocks of `block`
    bytes, log records (the -Sa gate keeps Lpx), random bytes and textlike
    (it drops it), log records."""
    out = bytearray()
    i = 0
    while len(out) < block:
        out += (b"ts=2026-08-20T09:%02d:%02d level=INFO module=core "
                b"id=%06d\n" % (i // 60 % 60, i % 60, i))
        i += 1
    rec = bytes(out[:block])
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, 256, block, dtype=np.uint8).tobytes()
    x = rng.integers(0, 2**32, block, dtype=np.uint32)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    txt = alpha[(x >> 16) % 30].tobytes()
    return rec + rnd + txt + rec


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _kernels() -> list:
    """Every hand-written kernel of the port (their launch counters)."""
    from .kernels import (_build, block_scatter, device_stages,  # noqa: F401
                          encode_stages, hist, ibwt, lpc, lpx, rank, rans,
                          rans_encode)

    return list(_build.KERNELS)


class Report:
    """The line being built: timed keys, contract flags, splits and the
    launches of each key."""

    def __init__(self, dev: torch.device, trials: int):
        self.dev = dev
        self.measured = dev.type == "cuda"
        # timed runs a step: none on the CPU, where nothing is measured
        self.trials = trials if self.measured else 0
        self.extra = {}
        self.contracts = {}
        self.launches = {}
        self._kernels = _kernels()

    def sync(self) -> None:
        if self.measured:
            torch.cuda.synchronize(self.dev)

    def wall(self, fn):
        """(seconds, fn()) by the host clock, synchronized."""
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return time.perf_counter() - t0, out

    def check(self, name: str, ok: bool) -> None:
        self.contracts[name] = bool(ok)
        if not ok:
            raise ContractError(f"contract failed: {name}")

    def put(self, key: str, values, scale: float = 1.0, digits: int = 5):
        """key = the median of values x scale, with its min, max and n; null
        where nothing was measured."""
        values = [v * scale for v in values] if self.measured else []
        self.extra[key] = (round(statistics.median(values), digits)
                           if values else None)
        self.extra[key + "_min"] = round(min(values), digits) if values else None
        self.extra[key + "_max"] = round(max(values), digits) if values else None
        self.extra[key + "_n"] = len(values)

    def value(self, key: str, seconds: float, digits: int = 3) -> None:
        """A set-up time: one measured wall, null on the CPU."""
        self.extra[key] = round(seconds, digits) if self.measured else None

    @contextlib.contextmanager
    def counting(self, key: str):
        """The kernels launched inside the block, by name, as launches[key]."""
        before = [k.launches for k in self._kernels]
        yield
        self.launches[key] = {
            k.name: k.launches - b for k, b in zip(self._kernels, before)
            if k.launches - b}

    def step(self, key: str, fn, work: float, check, digits: int = 5):
        """Run fn(times) once (check(result)), then `trials` timed runs on
        a card and one with a `times=` dict; the rate work / wall goes to
        `key` and the split to `<key>_times`.  On the CPU the first run
        carries the dict and nothing is timed.  Returns the first result."""
        split = {}
        with self.counting(key):
            _, first = self.wall(lambda: fn(None if self.measured else split))
            check(first)
            walls = []
            for _ in range(self.trials):
                dt, out = self.wall(lambda: fn(None))
                check(out)
                walls.append(dt)
            if self.measured:
                check(fn(split))
        self.put(key, [work / w for w in walls], digits=digits)
        self.extra[key + "_times"] = {k: round(v, 6) for k, v in split.items()}
        return first


def forward_step(t: torch.Tensor, units: int, stats: dict = None):
    """The metric's forward step on a (n,) uint8 tensor, n a multiple of
    units: (the BWT body, the (units,) int32 anchors isa[u * step] + 1),
    the root bench.py's `forward` with the port's functions.  `stats` as in
    sa.sa_doubling_core (the doubling rounds)."""
    from .kernels import sa

    n = t.numel()
    step = n // units
    _, isa, prev_sorted = sa.sa_doubling_core(t, n, stats)
    bwt = sa.bwt_from_prev_sorted(prev_sorted, isa[0], n)
    return bwt, (isa[: units * step: step] + 1).to(torch.int32)


def inverse_step(bwt: torch.Tensor, anchors: torch.Tensor,
                 units: int) -> torch.Tensor:
    """The metric's inverse step: the LF map and the anchored chase (K3 on
    a card), the root bench.py's `inverse` with the port's functions."""
    from .kernels import ibwt

    lf, sbyte = ibwt.combined_map(bwt, anchors[0])
    return ibwt.chase(lf, sbyte, anchors, units)


def bwt_keys(rep: Report, data: np.ndarray) -> float:
    """The metric of record and its parts; returns the value (or None)."""
    from .kernels import ibwt

    n = data.size
    t = torch.from_numpy(data).to(rep.dev)
    value = None
    for units in (REF_UNITS, NATIVE_UNITS):
        tag, stats = f"u{units}", {}

        def exact(out):
            rep.check(f"bwt_exact_{tag}",
                      np.array_equal(out.cpu().numpy(), data))

        with rep.counting(f"bwt_{tag}"):
            bwt, anchors = forward_step(t, units, stats)
            exact(inverse_step(bwt, anchors, units))
            fwd, inv = [], []
            for _ in range(rep.trials):
                dt, (bwt, anchors) = rep.wall(
                    lambda: forward_step(t, units, stats))
                fwd.append(dt)
                dt, out = rep.wall(lambda: inverse_step(bwt, anchors, units))
                inv.append(dt)
                exact(out)
            # K3 alone, for its share of the inverse
            lf, sbyte = ibwt.combined_map(bwt, anchors[0])
            chase = [rep.wall(lambda: ibwt.chase(lf, sbyte, anchors, units))[0]
                     for _ in range(rep.trials)]
        key = METRIC if units == REF_UNITS else (
            f"bwt_codec_native_stream_u{units}_gbps")
        rep.put(key, [2 * n / 1e9 / (f + i) for f, i in zip(fwd, inv)])
        rep.put(f"bwt_forward_{tag}_ms", fwd, 1e3, 3)
        rep.put(f"bwt_inverse_{tag}_ms", inv, 1e3, 3)
        rep.put(f"bwt_chase_{tag}_ms", chase, 1e3, 3)
        rep.extra["sa_rounds"] = stats["rounds"]
        if units == REF_UNITS:
            value = rep.extra.pop(METRIC)
        del bwt, anchors, lf, sbyte
        _log(f"bwt at {units} units: exact")
    rep.extra["bwt_bytes"] = n
    return value


def block_keys(rep: Report, data: np.ndarray, seed: int) -> None:
    """The block-level end-to-end keys (bench.py's _e2e_metrics)."""
    from .runtime.device_decode import decode_block_device, decode_blocks_device
    from .runtime.device_encode import (encode_block_device,
                                        encode_block_device_ex,
                                        encode_blocks_device)
    from .runtime.engines import NativeEngine
    from .runtime.metrics import (InstrumentedEngine, fused_decode_compute_wall,
                                  fused_encode_compute_wall)
    from .runtime.options import Options
    from .runtime.pipeline import compress_block, compress_block_ex

    n = int(data.size)
    mb, gb = n / 1e6, n / 1e9
    dev = rep.dev
    native = NativeEngine()
    blocks = [data] + [textlike(n, seed + s) for s in (1, 2, 3)]

    def same(name, want):
        return lambda got: rep.check(name, got == want)

    def exact(name, want):
        return lambda got: rep.check(name, len(got) == len(want) and all(
            np.array_equal(g, w) for g, w in zip(got, want)))

    # the native engine's encode (-m0 -f0)
    nopt = Options(blocksize=n, filters=0, match_finder=0)

    def native_encode(times):
        if times is None:
            return compress_block(data, nopt, native)
        eng = InstrumentedEngine(native)
        out = compress_block(data, nopt, eng)
        times.update({k: v["s"] for k, v in eng.metrics.summary().items()})
        return out

    _, pay = rep.step("encode_native_8mb_mbps", native_encode, mb,
                      lambda got: None, 2)
    rep.extra["encode_native_8mb_bytes"] = len(pay)

    # the fused encode, -m3 -f0 on the production stream, and with spans 0
    def prod(**kw):
        return Options(blocksize=n, filters=0, rans_lanes=PROD_LANES,
                       ans_chunk=PROD_CHUNK, anchor_units=PROD_UNITS, **kw)

    eopt = prod(match_finder=3, lpx_spans=PROD_SPANS)
    want = compress_block(data, eopt, native)
    rep.step("encode_e2e_fused_8mb_mbps",
             lambda times: encode_block_device(data, eopt, dev, times), mb,
             same("encode_fused_equals_native", want), 2)
    aopt = prod(match_finder=3, lpx_spans=0)
    crc, pay, spans = compress_block_ex(data, aopt, native)
    rep.check("encode_auto_spans_0", spans == 0)
    rep.step("encode_e2e_fused_8mb_auto_mbps",
             lambda times: encode_block_device_ex(data, aopt, dev, times), mb,
             same("encode_auto_equals_native", (crc, pay, 0)), 2)
    # each call warms up and times one run (on the CPU: runs, untimed)
    with rep.counting("encode_compute_fused_8mb_auto_mbps"):
        walls = [fused_encode_compute_wall(data, aopt, 1, dev)
                 for _ in range(rep.trials or 1)]
    rep.put("encode_compute_fused_8mb_auto_mbps", [mb / w for w in walls],
            digits=2)
    rep.step("encode_aggregate_b4_mbps",
             lambda times: encode_blocks_device(blocks, aopt, dev, times),
             4 * mb,
             lambda got: rep.check("encode_b4_block0_equals_auto",
                                   got[0] == (crc, pay, 0)), 2)

    # the fused decode of the native -m0 -f0 stream, and of its -Sa form
    dopt = prod(match_finder=0, lpx_spans=PROD_SPANS)
    dcrc, dpay = compress_block(data, dopt, native)
    rep.step("decode_e2e_fused_8mb_gbps",
             lambda times: [decode_block_device(
                 dpay, dcrc, n, PROD_UNITS, PROD_LANES, PROD_SPANS, dev,
                 times)], gb, exact("decode_exact", [data]))
    xopt = prod(match_finder=0, lpx_spans=PROD_SPANS, lpx_auto=True)
    xcrc, xpay, used = compress_block_ex(data, xopt, native)
    rep.extra["lpx_auto_spans_used"] = used
    rep.extra["auto_payload_bytes"] = len(xpay)
    rep.step("decode_e2e_fused_8mb_auto_gbps",
             lambda times: [decode_block_device(
                 xpay, xcrc, n, PROD_UNITS, PROD_LANES, used, dev, times)],
             gb, exact("decode_auto_exact", [data]))
    with rep.counting("decode_compute_fused_8mb_auto_gbps"):
        walls = [fused_decode_compute_wall(xpay, n, PROD_UNITS, PROD_LANES,
                                           used, 1, dev)
                 for _ in range(rep.trials or 1)]
    rep.put("decode_compute_fused_8mb_auto_gbps", [gb / w for w in walls])
    streams = [compress_block_ex(b, xopt, native) for b in blocks]
    rep.check("decode_b4_spans_shared",
              all(s[2] == used for s in streams))
    rep.step("decode_aggregate_b4_gbps",
             lambda times: decode_blocks_device(
                 [s[1] for s in streams], [s[0] for s in streams], n,
                 PROD_UNITS, PROD_LANES, used, dev, times), 4 * gb,
             exact("decode_b4_exact", blocks))

    # the ratio the auto stream pays against the reference's default
    jopt = Options(blocksize=n, match_finder=0, filters=1, anchor_units=120,
                   ans_chunk=1 << 20, rans_lanes=0, lpx_spans=4)
    jam = len(compress_block(data, jopt, native)[1])
    rep.extra["jam_default_bytes"] = jam
    rep.extra["ratio_vs_jam_default_pct"] = round(
        100 * (len(xpay) / jam - 1), 2)
    _log("block keys: every contract held")


def _span_words(path: str) -> list:
    from .format import framing

    words = []
    with open(path, "rb") as f:
        while (rec := framing.read_block(f, want_payload=False)) is not None:
            words.append(rec[0].lpx_spans)
    return words


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def archive_keys(rep: Report, label: str, block: int, seed: int,
                 device: str, work: str) -> None:
    """cli c|d in process, with ARCHIVE_FLAGS[label] and -b block >> 20,
    on archive_input(block, seed) written under `work`: the native encode,
    the fused encode (byte-identical to it) and the fused decode (exact);
    `device` is the CLI's --device."""
    from . import cli

    src = os.path.join(work, f"{label}.in")
    data = archive_input(block, seed)
    with open(src, "wb") as f:
        f.write(data)
    mb = len(data) / 1e6
    flags = [*ARCHIVE_FLAGS[label], f"-b{block >> 20}"]
    paths = {k: os.path.join(work, f"{label}.{k}")
             for k in ("native", "fused", "out")}

    def cli_run(argv):
        with contextlib.redirect_stdout(sys.stderr):
            code = cli.run(["jampack_tpu_torch.cli", *argv,
                            "--device", device])
        if code != 0:
            raise RuntimeError(f"cli {' '.join(argv)} exited {code}")

    runs = (
        ("encode_native", ["c", src, paths["native"], *flags,
                           "--engine", "native"], lambda: None),
        ("encode_fused", ["c", src, paths["fused"], *flags],
         lambda: rep.check(f"archive_{label}_fused_equals_native",
                           _read(paths["fused"]) == _read(paths["native"]))),
        ("decode_fused", ["d", paths["fused"], paths["out"]],
         lambda: rep.check(f"archive_{label}_decode_exact",
                           _read(paths["out"]) == data)),
    )
    for name, argv, check in runs:
        key = f"archive_{label}_{name}_32mb"
        with rep.counting(key + "_mbps"):
            first, _ = rep.wall(lambda: cli_run(argv))
            check()
            walls = []
            for _ in range(rep.trials):
                walls.append(rep.wall(lambda: cli_run(argv))[0])
                check()
        rep.value(key + "_first_s", first)
        rep.put(key + "_mbps", [mb / w for w in walls], digits=2)
    words = _span_words(paths["fused"])
    rep.extra[f"archive_{label}_span_words"] = words
    rep.extra[f"archive_{label}_bytes"] = os.path.getsize(paths["fused"])
    rep.check(f"archive_{label}_blocks", len(words) == ARCHIVE_BLOCKS + 1)
    if label == "jt3":
        rep.check("archive_jt3_spans_mix_0_and_8",
                  0 in words and JT3_ARCHIVE_SPANS in words)
    _log(f"archive {label}: byte-identical and exact; span words {words}")


def _device_record(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "name_power_limit": smi}


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m jampack_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, for the tests")
    ap.add_argument("--size", type=int, default=BLOCK,
                    help="the block in bytes (the archive's blocks: "
                         "size >> 20 MiB)")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", default=",".join(GROUPS),
                    help="a comma list of " + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    keys = args.keys.split(",")
    unknown = set(keys) - set(GROUPS)
    if unknown:
        ap.error(f"unknown key groups {sorted(unknown)}")
    if args.trials < 1:
        ap.error("--trials must be at least 1")
    return args, keys


def run(argv) -> dict:
    """The bench's line as a dict (argv without the program name)."""
    args, keys = _args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rep = Report(dev, args.trials)
    device = _device_record(dev)
    from . import native

    t, _ = rep.wall(native.build)
    rep.value("setup_native_build_s", t)
    if rep.measured:
        from .kernels import _build

        t, _ = rep.wall(_build.load)
        rep.value("setup_kernels_load_s", t)
    n = args.size - args.size % (REF_UNITS * 16)
    data = textlike(n, args.seed)
    value = None
    if "bwt" in keys:
        value = bwt_keys(rep, data)
    if "block" in keys:
        block_keys(rep, data, args.seed)
    if "archive" in keys:
        with tempfile.TemporaryDirectory() as work:
            for label in ARCHIVE_FLAGS:
                archive_keys(rep, label, args.size, args.seed, args.device,
                             work)
    rep.extra["contracts"] = rep.contracts
    rep.extra["launches"] = rep.launches
    rep.extra["trials"] = args.trials
    rep.extra["seed"] = args.seed
    return {"metric": METRIC, "value": value, "unit": "GB/s",
            "device": device, "extra": rep.extra}


def main(argv=None) -> int:
    line = run(sys.argv[1:] if argv is None else argv)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
