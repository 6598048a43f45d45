"""Command line of the port.

    python -m jampack_tpu_torch.cli <c|d> input output [-b# -m# -f# -t# -T -v] [-u# -c# -L# -S# -Sa] [--engine E] [--device cuda|cpu] [--trace DIR]
    python -m jampack_tpu_torch.cli i archive          (dump block headers)

Flags and messages are jampack_tpu.cli's (_parse is a copy): -b block size
in MB, -m match finder (0 dedupe, 1 hash chain, 2 suffix array, 3 store),
-f filters (0 off, 1 heuristic, 2 brute force, 3 the per-stage device
search), -t threads, -T one block at a time, -v a per-stage report; the
JTX/JT3 stream parameters -u# anchor units, -c# ANS chunk KB, -L# rANS
lanes, -S# Lpx spans (0 skips the stage), -Sa the per-block Lpx gate.

--engine (--engine=E or --engine E):
  fused   the default: the whole block chain on the GPU, the archive
          spread over the cards (runtime/sharding.py): a window of
          (cards x batch) blocks at a time, each card's run of it in
          batches (runtime/device_decode.py, device_encode.py), written in
          file order as it finishes.  d reads every archive; c takes
          -m0..-m3 with -f0/-f1/-f2 (the LZ match finders of -m0/-m1/-m2
          on the host, a block at a time) and refuses -f3, which runs on
          --engine gpu.  With no flag c writes the reference's default JAM
          archive (-m0 -f1 -S4).
  gpu     the per-stage engine on the GPU (the JAX package's tpu engine):
          each stage one call through the port's kernels, -f3 included.
  hybrid  the native host stages and the BWT on the GPU where the block
          passes the reference's 80%-of-VRAM gate (its -g mode).
  native  the native C++ host engine.
  numpy   the Python/numpy spec engine (slow; for checks).
The stage engines (gpu, hybrid, native, numpy) run blocks on -t threads
(default: every core, clamped by host memory) with the reference's
read-ahead window.  --engine tpu is refused: its counterpart here is gpu.
--device picks the card for fused, gpu and hybrid: cuda, the default, is
every card of the host for fused and the current card for the others;
cuda:N is that card.  There is no fallback to the CPU: --device cpu runs
the plain PyTorch versions of the kernels and exists for tests.

--trace DIR runs the call under torch.profiler and records the program's
spans (runtime/metrics.py): DIR/trace.json holds the device's and the
host's events and the spans, on the profiler's clock.
"""

import sys
import time
from collections import deque
from contextlib import contextmanager
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .format import framing
from .format.constants import DEFAULT_BLOCKSIZE, MAX_BLOCKSIZE, MIN_BLOCKSIZE
from .runtime.metrics import span
from .runtime.options import (
    Options,
    validate_lpx_spans,
    validate_match_finder,
    validate_rans_lanes,
)
from .runtime.pipeline import compress_block_ex, decompress_block

ENGINES = ("fused", "gpu", "hybrid", "native", "numpy")


def _split_flags(argv):
    """(argv without --device/--engine/--trace, the device or 'cuda', the
    engine or 'fused', the trace directory or None); each takes `--flag
    value` or `--flag=value`."""
    rest, i = [], 0
    found = {"--device": "cuda", "--engine": "fused", "--trace": None}
    while i < len(argv):
        arg = argv[i]
        name = arg.split("=", 1)[0]
        if name in found:
            if "=" in arg:
                found[name] = arg.split("=", 1)[1]
            elif i + 1 < len(argv):
                found[name] = argv[i + 1]
                i += 1
            else:
                raise SystemExit(f"{name} needs a value")
        else:
            rest.append(arg)
        i += 1
    return rest, found["--device"], found["--engine"], found["--trace"]


def _parse(argv):
    """(mode, input, output, Options) from the reference's flags
    (main.cpp:65-89 semantics) and the JTX/JT3 stream parameters; a copy
    of jampack_tpu.cli._parse without its engine choice."""
    mode, inp, outp = argv[1], argv[2], argv[3]
    if inp == outp:
        raise SystemExit("Refusing to write to input, change the output directory.")
    opt = Options(blocksize=DEFAULT_BLOCKSIZE, match_finder=0, filters=1)
    threads = 0
    multiblock = True
    for arg in argv[4:]:
        if arg.startswith("--"):
            if arg != "--verbose":
                raise SystemExit(f"Unknown option: {arg}")
        elif arg.startswith("-") and len(arg) >= 2:
            p = arg[1:]
            while p:
                c = p[0]
                rest = p[1:]
                num = ""
                while rest and (rest[0].isdigit()):
                    num += rest[0]
                    rest = rest[1:]
                if c == "b" and num:
                    # in place, so stream parameters set by earlier flags
                    # survive regardless of flag order
                    opt.blocksize = int(min(max(int(num) << 20,
                                                MIN_BLOCKSIZE),
                                            MAX_BLOCKSIZE))
                elif c == "u" and num:
                    opt.anchor_units = int(num)  # native JTX container
                elif c == "c" and num:
                    opt.ans_chunk = int(num) << 10  # ANS chunk in KB
                elif c == "L" and num:
                    opt.rans_lanes = validate_rans_lanes(int(num))
                elif c == "S" and num:
                    opt.lpx_spans = validate_lpx_spans(int(num))
                elif c == "S" and rest[:1] == "a":
                    opt.lpx_auto = True
                    rest = rest[1:]
                elif c == "m" and num:
                    opt.match_finder = validate_match_finder(int(num))
                elif c == "f" and num:
                    opt.filters = int(num)
                elif c == "t" and num:
                    threads = int(num)
                elif c == "T":
                    multiblock = False
                elif c == "v":
                    pass
                else:
                    raise SystemExit(f"Unknown option character "
                                     f"'{c}' in {arg}")
                p = rest
    opt.threads = threads
    opt.multiblock = multiblock
    return mode, inp, outp, opt


# plan_workers, _Progress and info are copies of jampack_tpu.cli's, held
# equal line for line by tests/test_torch_standalone.py

def plan_workers(opt) -> int:
    """Memory/core-aware block-parallel worker count.

    The reference clamps instance count against the host (jampack.cpp:186-192)
    and documents encode memory as 6N*K for K instances on N-byte blocks
    (main.cpp:3-4).  Default K = core count; K is clamped so 6N*K (plus the
    2-deep read-ahead window's raw blocks, ~2N*K) fits in available memory.
    """
    from .runtime.sysinfo import available_memory, core_count

    if not opt.multiblock:
        return 1
    workers = opt.threads if opt.threads > 0 else core_count()
    per_worker = 8 * opt.blocksize  # 6N working set + 2N window buffers
    mem_cap = max(int(available_memory() // per_worker), 1)
    return max(min(workers, mem_cap), 1)


class _Progress:
    """Live per-block progress line (jampack.cpp:226-231,273-278 analog):
    MB processed, ratio, MB/s, carriage-return overwritten on stderr."""

    def __init__(self, label: str, enabled: bool = True):
        self.label = label
        self.enabled = enabled and sys.stderr.isatty()
        self.t0 = time.time()
        self.shown = False

    def update(self, raw: int, comp: int) -> None:
        if not self.enabled:
            return
        dt = time.time() - self.t0
        rate = (raw / 1e6) / dt if dt > 0 else 0.0
        ratio = (comp / raw * 100) if raw else 0.0
        print(f"\r{self.label}: {raw / 1e6:.1f} MB ({ratio:.2f}%) "
              f"@ {rate:.2f} MB/s", end="", file=sys.stderr, flush=True)
        self.shown = True

    def done(self) -> None:
        if self.shown:
            print(file=sys.stderr)


def _make_engine(name: str, threads: int, device):
    """A stage engine by its --engine name."""
    from .runtime import engines

    if name == "numpy":
        from .runtime.pipeline import Engine

        return Engine()
    if name == "gpu":
        return engines.GpuEngine(device)
    if name == "hybrid":
        return engines.HybridEngine(threads=threads, device=device)
    return engines.NativeEngine(threads=threads)


def info(path: str) -> int:
    """Dump block headers (jampack.cpp:174-180 DisplayHeaderContents
    counterpart): per block magic kind, crc, compressed/block sizes, and
    JTX stream parameters."""
    total_c = 0
    n = 0
    with open(path, "rb") as f:
        while True:
            rec = framing.read_block(f)
            if rec is None:
                break
            h, payload = rec
            native = framing.is_native(h.units, h.lanes, h.lpx_spans)
            v3 = h.lpx_spans != framing.DEFAULT_LPX_SPANS
            kind = ("JT3" if v3 else "JTX") if native else "JAM"
            extra = (f" units={h.units} lanes={h.lanes} spans={h.lpx_spans}"
                     if native else "")
            print(f"block {n}: {kind} crc=0x{h.crc:08x} csize={h.csize} "
                  f"blocksize={h.blocksize}{extra}")
            total_c += h.csize + framing.header_size(h.units, h.lanes,
                                                     h.lpx_spans)
            n += 1
    print(f"{n} blocks, {total_c} compressed bytes")
    return 0


def _summary(raw: int, comp: int, dt: float, label: str) -> None:
    ratio = (comp / raw * 100) if raw else 0.0
    rate = (raw / 1e6) / dt if dt > 0 else 0.0
    print(f"{raw / 1e6:.2f} MB <=> {comp / 1e6:.2f} MB ({ratio:.2f}%) "
          f"@ {rate:.2f} MB/s in {dt:.2f}s [{label}]")


def _mesh_label(mesh) -> str:
    import torch

    names = []
    for dev in mesh:
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev))
        if name not in names:
            names.append(name)
    return f"fused x{len(mesh)}: {', '.join(names)}"


@contextmanager
def _files(inp, outp):
    """(input, output) opened in a span cli.open (an output FIFO waits
    there for its reader) and closed in a span cli.close."""
    with span("cli.open"):
        fin = open(inp, "rb")
        try:
            fout = open(outp, "wb")
        except BaseException:
            fin.close()
            raise
    try:
        yield fin, fout
    finally:
        with span("cli.close"):
            try:
                fout.close()
            finally:
                fin.close()


def _run_fused(mode, inp, outp, opt, device):
    """c and d through runtime/sharding.py across the mesh --device names
    (cuda: every card of this host; cuda:N: that card alone; cpu: the
    plain versions), a window of (cards x batch) blocks at a time, written
    as it finishes.  Returns (raw bytes, compressed bytes)."""
    from .runtime.sharding import (decode_archive_to, encode_archive_sharded,
                                   make_mesh)

    with span("cli.setup"):
        if mode == "c" and opt.filters not in (0, 1, 2):
            raise SystemExit(f"--engine fused: -f{opt.filters}: the fused "
                             f"encode runs -f0/-f1/-f2; the -f3 device "
                             f"filter search runs on --engine gpu")
        mesh = make_mesh() if device == "cuda" else make_mesh([device])
    start = time.time()
    progress = _Progress("compressing" if mode == "c" else "decompressing")
    with _files(inp, outp) as (fin, fout):
        if mode == "c":
            raw, comp = encode_archive_sharded(fin, fout, opt, mesh,
                                               progress=progress.update)
        else:
            raw, comp = decode_archive_to(fin, fout, mesh, progress.update)
    with span("cli.close"):
        progress.done()
        _summary(raw, comp, time.time() - start, _mesh_label(mesh))
    return raw, comp


def _encode_blocks(fin, fout, opt, engine, workers, progress):
    """The stage engines' encode: blocks on `workers` threads behind a
    read-ahead window of 2 x workers (jampack_tpu.cli.run's loop)."""
    raw = comp = 0

    def encode_one(blob):
        data = np.frombuffer(blob, dtype=np.uint8)
        return compress_block_ex(data, opt, engine)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        window = deque()
        # feof semantics (jampack.cpp:205-214): an input of exactly
        # K*blocksize bytes (incl. K=0) gets one trailing EMPTY
        # block — archive bytes are the contract
        pending_empty = True
        eof = False
        while True:
            while not eof and len(window) < workers * 2:
                blob = fin.read(opt.blocksize)
                if not blob:
                    eof = True
                    if pending_empty:
                        window.append(pool.submit(encode_one, b""))
                    break
                raw += len(blob)
                pending_empty = len(blob) == opt.blocksize
                window.append(pool.submit(encode_one, blob))
            if not window:
                break
            crc, payload, spans = window.popleft().result()
            framing.write_block(fout, crc, payload, opt.blocksize,
                                opt.anchor_units, opt.rans_lanes, spans)
            comp += len(payload) + framing.HEADER_SIZE
            progress.update(raw, comp)
    return raw, comp


def _decode_blocks(fin, fout, engine, workers, progress):
    raw = comp = 0

    def decode_one(args):
        header, payload = args
        return decompress_block(payload, header.crc, engine,
                                header.blocksize, header.units,
                                header.lanes, header.lpx_spans)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        window = deque()
        while True:
            while len(window) < workers * 2:
                rec = framing.read_block(fin)
                if rec is None:
                    break
                comp += rec[0].csize + framing.HEADER_SIZE
                window.append(pool.submit(decode_one, rec))
            if not window:
                break
            data = window.popleft().result()
            fout.write(data.tobytes())
            raw += data.size
            progress.update(raw, comp)
    return raw, comp


def run(argv) -> int:
    argv, device, engine_name, trace = _split_flags(list(argv))
    if len(argv) >= 3 and argv[1] == "i":
        return info(argv[2])
    if len(argv) < 4:
        print(__doc__)
        return 0
    if trace is None:
        return _run(argv, device, engine_name)
    from .runtime.metrics import device_trace, tracing

    with tracing(), device_trace(trace):
        return _run(argv, device, engine_name)


def _run(argv, device, engine_name) -> int:
    """One c or d call, the span "op" around it."""
    with span("op") as op:
        with span("cli.setup"):
            mode, inp, outp, opt = _parse(argv)
            if mode not in ("c", "d"):
                raise SystemExit("Invalid option!")
            if engine_name == "tpu":
                raise SystemExit("--engine tpu: the port runs on the GPU; "
                                 "its per-stage device engine is --engine "
                                 "gpu")
            if engine_name not in ENGINES:
                raise SystemExit(f"--engine {engine_name}: the engines are "
                                 f"{', '.join(ENGINES)}")
        if engine_name == "fused":
            raw, comp = _run_fused(mode, inp, outp, opt, device)
            op.add(raw=raw, comp=comp)
            return 0
        with span("cli.setup"):
            engine = _make_engine(engine_name, opt.threads, device)
            verbose = any(a in ("-v", "--verbose") for a in argv[4:])
            if verbose:
                from .runtime.metrics import InstrumentedEngine

                engine = InstrumentedEngine(engine)
            start = time.time()
            workers = plan_workers(opt)
        progress = _Progress("compressing" if mode == "c"
                             else "decompressing")
        with _files(inp, outp) as (fin, fout):
            if mode == "c":
                raw, comp = _encode_blocks(fin, fout, opt, engine, workers,
                                           progress)
            else:
                raw, comp = _decode_blocks(fin, fout, engine, workers,
                                           progress)
        with span("cli.close"):
            progress.done()
            _summary(raw, comp, time.time() - start, engine.name)
        op.add(raw=raw, comp=comp)
    if verbose:
        print(f"per-stage (aggregated across {workers} threads):")
        print(engine.metrics.report())
        routes = getattr(engine, "routes", None)
        if routes is not None:
            print("bwt routes: " + ", ".join(
                f"{k} {routes[k]}" for k in ("device", "host")))
    return 0


def main():
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
