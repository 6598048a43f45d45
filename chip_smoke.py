#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives jampack_tpu_torch's paths on cuda:0.  The script imports nothing of
JAX and nothing of jampack_tpu: the oracle archives come from a separate
process, `python -m jampack_tpu.cli c` with its native host engine.  The
paths: the fused block decode of the production JT3 stream (-c16 -L4 -u960
-S4096 -Sa, the CLI's -f1), of JAM archives with the reference's default
flags (-m0 -f1 -S4) and -m1, the fused block encode of the store
configuration with the three filter modes (-m3 -f0/-f1/-f2 -c16 -L4 -u960
-S0) and with the Lpx stage (-S4096 -Sa; -S4, JAM), the host-LZ encode
route (-m0/-m1/-m2: the LZ match finders on the host around the device
stages) with the reference's default flags, -m1, -m2 and the JT3 stream,
and the stage engines (--engine native, hybrid and gpu):

  1. facts     nvidia-smi name and power limit; NVIDIA, torch, CUDA versions
  2. build     nvcc builds the eleven kernels from csrc/, one process each;
               g++ the native engine's library from native/src/
  3. oracle    host encode of a 32 MiB, four-block textlike archive in the
               production stream; every block must frame lpx_spans = 0 (the
               Lpx gate drops the stage on text)
  4. parity    each decode kernel against its plain PyTorch version, exact,
               on the stage inputs of the archive's first 8 MiB block, with
               both times from CUDA events after a warm-up; K1's cycles a
               step; K3 also queued behind a busy stream, and at each
               sub-chain length D of 16-128 (its measuring entry), exact,
               with the time of its three phases (jump table, anchor walk,
               sub-chains); K2 also on the
               worst case of its walk, 513 chunks x 16,384 B of period-256
               data (every step rank 255; plain timed on 4 chunks), and the
               path (staged or direct) it takes
  5. decode    the archive through `jampack_tpu_torch.cli d` on cuda, with
               the decode kernels' launch counts zeroed just before: bytes
               and per-block CRCs must match, and every kernel must have
               run (K11, the token parse, twice a block); then the
               per-stage split of one block, and K11 against its plain
               version on that block's one-token lz stage, timed
  6. parity    each encode kernel against its plain version, exact, on the
               stage inputs of the first 8 MiB block of the -f0 encode; K4's
               cycles a symbol step and K5's an op of a state, K5 also at
               8, 16 and 32 lanes a chain (its measuring entry), exact,
               timed; K6 also on the period-256 worst case, and its path
  7. fused     the 32 MiB through `cli c -m3 -f0 ...` on cuda, encode
               launch counts zeroed just before: the archive must equal the
               oracle's byte for byte, and every encode kernel must have run
               once a batch (the blocks of one length in a card's run of a
               window), the trailing empty block a batch of its own
  8. round     that archive through `cli d` on cuda, decode counts zeroed:
               the input comes back, every decode kernel ran
  9. split     the per-stage times of block 0's -f0 device encode
 10. parity    the filter kernels at the shapes of an 8 MiB block of
               structured data (interleaved int16 sines with noise): K8
               both ways on the 4,128 LPC lanes of the -f2 sweep, K7 on
               the sweep's 12,513 lanes and on the -f1 candidates' sorted
               lanes; the torch.bincount of the same pairs is timed beside;
               K8's cycles a step, and its time with every length 0 and on
               one block of 32 lanes alone; K7's time per launch, with
               every length 0 and on zero bytes, and that of the f32 scores
               of the same tables
 11. f1        the 32 MiB through `cli c -m3 -f1 ...` on cuda, every launch
               count zeroed just before: byte-identical to the oracle, K7
               launched for every block
 12. f1 data   the structured 8 MiB through `cli c -m3 -f1 ...`, counts
               zeroed: byte-identical to the oracle, some chunk picked a
               filter (the candidates and the previous pick applied on the
               card); its decode on cuda gives the input back
 13. f2        the structured 8 MiB through `cli c -m3 -f2 ...`, counts
               zeroed: byte-identical to the oracle; then its decode on
               cuda, counts zeroed: K8 (decode direction) must run, so some
               chunk picked LPC, and the input must come back
 14. split     the per-stage times of block 0's -f1 (text and structured)
               and -f2 encodes; then K8 on the rows of the -f2 path itself
               (the 129 rows the encode applies, the rows its decode
               inverts), exact against its plain version, with cycles a step
 15. lpx -Sa   8 MiB each of text, log records and 10-byte lines through
               `cli c -m3 -f1 -c16 -L4 -u960 -S4096 -Sa`, counts zeroed:
               byte-identical to the oracle, span words [0, 0, 4096, 0]
               (the gate keeps the stage on the short lines only), K10
               once a block; its decode on cuda, K10 once; K10 against its
               plain version, exact, both ways on the short lines' 4,097
               spans, timed, also with each padding of a span's shared
               memory (0 and 1 record), with 1, 2, 5 and 20 spans a
               warp and with eight-word records, exact, and that block's
               stage split both ways
 16. JAM -S4   the log records through `cli c -m3 -f1 -S4` (JAM framing):
               byte-identical to the oracle and decoded; K10 timed both
               ways at 4 spans of 2 MiB, held against the oracle, and with
               four-word records, held against the eight-word ones
 17. defaults  8 MiB of text, its last tenth log records, encoded by the
               oracle with the reference's default flags (-m0 -f1 -S4,
               JAM) and with -m1, decoded through `cli d`: exact, K11
               twice a block and K10 once; K11 against its plain version on
               each archive's lz stage (one token; many on -m1), timed;
               on the -m1 stage also at each sub-chain length D of 8-64,
               exact, and the time of its head and of each chain phase
 18. host LZ   the host-LZ encode route: `cli c` on cuda with the
               reference's default flags (-m0 -f1 -S4, JAM) and -m1 on the
               same 8 MiB, -m2 on its last tenth (the log records: the -m2
               finder walks text too slowly on the host; its rate on 64
               KiB of the text is printed), and -m0
               with the JT3 stream (-c16 -L4 -u960 -S4096 -Sa), counts
               zeroed before each: byte-identical to the oracle, K4, K5,
               K6 and K10 once a block, K7 at least once; each decoded on
               cuda; block 0's stage split with the host LZ keys (lz_pre,
               lz) apart and the oracle's wall beside; K6 timed at the JAM
               shape (1 MiB chunks)
 19. A9        8 MiB of 61-byte log records through `cli c -m1` (fused),
               byte-identical to the oracle: its lz stage holds more tokens
               than plan_shapes gives the JAX decode; `cli d` on cuda gives
               it back, K11 twice a block; the token count and the slots
               the port's decode takes (token_slots) are printed
 20. engines   the stage engines through `cli c|d --engine ...` on cuda
               with -v (each run's per-stage seconds printed, launch counts
               zeroed before each): native on phase 17's 8 MiB with no
               flag, -m1, -f2, -S0 and the JT3 stream, byte-identical to
               the oracle and read back; hybrid on the same 8 MiB, the
               native engine's bytes, the BWT on the device route both
               ways; gpu, the per-stage engine, with -b1 on the last 2 MiB,
               -f1 (JAM) equal to the native engine's archive and -f3 -c16
               -L4 -u960 equal to the native engine with GpuEngine("cpu")'s
               -f3 stage, each read back through --engine gpu and native;
               each GpuEngine device stage on one 8 MiB block (the filters
               -f1/-f2/-f3, Lpx -S4 both ways, lz_decode of the -m1 stage,
               the BWT both ways) against the native engine's (-f3 against
               its CPU run), with its seconds and launches; `cli i` of a
               JAM, a JTX and a JT3 archive against the JAX CLI's
 21. golden    all eight golden fixtures decode to golden_input.bin
 22. tool      K9, the block scatter of tools/pallas_dma_bench.py (no path
               of the codec runs it), exact against its plain version at
               S = 1024, 4096 and 16384 int32 elements a block, 8 Mi in
               all, timed beside index_copy_
 23. batch     (run after phase 20, in its temporary directory) the oracle
               encodes the 32 MiB with the reference's defaults (-m0 -f1
               -S4, JAM); both 32 MiB archives (JT3 of phase 3, JAM) decode
               one block at a time and as one batch
               (decode_blocks_device): exact, the stage split of each, K1,
               K2 and K10 once a batch, each of their wrappers timed on the
               one-block calls and on the batch's call, and the peak device
               memory of one block and of four; the 4 x 8 MiB likewise
               through the -m3 -f1 encode in JAM (-S4) and JT3 (-c16 -L4
               -u960 -S4096 -Sa) streams (encode_blocks_device: K4, K5, K6
               and K10 once a batch, byte-identical to the blocks one at a
               time, decoded back); the CLI's default batch itself
               (sharding.batch_blocks' count, the four JAM blocks
               repeated) decoded and encoded as one batch each: exact,
               each batched kernel once, and the card's reserved peak
               within batch_blocks' budget; `cli d` of the JAM archive and `cli c
               -m0 -f1 -S4` of the 32 MiB through runtime/sharding.py,
               exact and byte-identical to the oracle; decode_archive_sharded
               of both archives and encode_archive_sharded -m3 -f1 on
               ["cuda:0", "cuda:0"] (and on every card when there are more),
               against the input and the oracle; codec_block_step on 8 MiB
               less 8 bytes (120 units divide it); dryrun_multichip(["cuda:0",
               "cuda:0"]); the compute walls of the production and JAM blocks
               both ways; one device_trace of a batched decode, whose file
               must exist; the numbers as one "phase23 {...}" line
 24. bench     `python -m jampack_tpu_torch.bench --trials 3` in process
               (the port's bench: the BWT codec cycle at 120 and 1,920
               units, the block keys; the 32 MiB archive run through `cli
               c|d` at --trials 1, for the script's time), every launch
               count zeroed just before: every contract
               holds, every timed key is a number, K3 runs at both unit
               counts; its line as "phase24 {...}"

Any failure raises, so the script exits non-zero without its last line.
The last lines are the kernels JSON (times, launches on the path that
runs each kernel, named by "path", and the bound: the largest of the bytes
over 3.35 TB/s, the integer operations over 67 T/s and the
serial-dependency floor, which serial_ms gives alone; K1, K4, K5, K8,
K10 and the rank walks also give cycles_per_step at the boost clock, the rank
walks worst_ms, their period-256 time, K3 ms_queued, its D as "jump",
depth_ms and phase_ms, K5 its lanes a chain as "lanes" and lanes_ms, K8
its decode time, zero_lens_ms and one_block (the probes above) and
path_ms, its time on the -f2 path's own rows, K7 group_ms, its time
a launch, store_ms and zero_bytes_ms (the probes above), and score_ms,
that of the f32 scores of the same tables, K10 its decode time, its
times at the JAM shape, jam_ms, and with four-word records,
jam_four_word_ms, at -S4096 with eight-word records, eight_word_ms,
with each padding of a span's shared memory, ms_by_pad, and by spans a
warp, ms_by_lanes, and K11, its headline on the -m1 stage beside the -m1
decode's launches, its cycles_per_token, depth_ms and phase_ms (the D
sweep and the phases above; its bound is bytes and operations alone,
and serial_ms the floor of a one-thread walk, outside it) and its rows
on the -m0 stage, m0, and on the production stream's one-token stage,
one_token (with
fetch_ms, the time of a status fetch alone), each with the path and
launches of its own run); K4, K5, K6, K7 and K10 give their launches on
each encode of phase 18, host_lz_launches, and K6 its time at the JAM
shape, jam_ms and jam_cycles_per_step; K11 the numbers of phase 19,
token_dense; every kernel the stage engines launched in phase 20 its
launches there by run, engine_launches; every kernel phase 23's batched
and one-at-a-time runs launched its launches by run, batch_launches; every
kernel the bench launched its launches by bench key, bench_launches; then
the nvidia-smi line, and {"ok": true, "device": {...}}.
Exits 1 at once when no GPU is present.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = 8 << 20
NBLOCKS = 4
PROD_FLAGS = ["-c16", "-L4", "-u960", "-S4096", "-Sa"]
STREAM = ["-c16", "-L4", "-u960", "-S0"]
F0_FLAGS = ["-m3", "-f0", *STREAM]
F1_FLAGS = ["-m3", "-f1", *STREAM]
F2_FLAGS = ["-m3", "-f2", *STREAM]
SA_SPANS = 4096
SA_FLAGS = ["-m3", "-f1", "-c16", "-L4", "-u960", f"-S{SA_SPANS}", "-Sa"]
JAM_FLAGS = ["-m3", "-f1", "-S4"]
CHUNK = 16 << 10  # the entropy chunk of both streams
FEW = 4  # chunks on which the worst cases' plain versions are timed

# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s,
# and the float32 rate outside the tensor cores, taken as the ceiling of the
# kernels' int32 operations.  The serial floor counts each dependent
# integer op of the longest chain at 4 cycles at the 1.98 GHz boost clock.
HBM_BPS = 3.35e12
OPS_PER_S = 67e12
DEP_CYCLES = 4
CLOCK_HZ = 1.98e9
# K11's calls each fetch their status, so a few of them time unevenly:
# its timings average this many
K11_REPS = 50


def textlike(n: int, seed: int):
    """bench.py's textlike corpus (30-letter alphabet, uniform)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    return alpha[(x >> 16) % 30]


def structured(n: int, seed: int):
    """Two interleaved int16 channels (sums of sines) with noise: the kind
    of sampled data for which -f2 picks LPC."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(-(-n // 4))
    ch = [4000 * np.sin(t / 300.0) + 3000 * np.sin(t / 47.0),
          6000 * np.cos(t / 410.0)]
    x = np.stack([c + rng.normal(0, 2, t.size) for c in ch], 1)
    return x.astype(np.int16).view(np.uint8).reshape(-1)[:n]


def log_records(n: int):
    """Log-like text records (a copy of tests/test_lpx_skip.py::_records):
    field names repeat on every 61-byte line, ids vary."""
    import numpy as np

    out = bytearray()
    i = 0
    while len(out) < n:
        out += b"ts=2026-08-20T09:%02d:%02d level=INFO module=core id=%06d\n" \
            % (i // 60 % 60, i % 60, i)
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def short_lines(n: int):
    """10-byte lines ("%05d,1,OK"): the Lpx model fires within the 2 KiB
    spans of -S4096, where it does not on the 61-byte log records."""
    import numpy as np

    out = bytearray()
    i = 0
    while len(out) < n:
        out += b"%05d,1,OK\n" % (i % 100000)
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def period256(chunks: int, width: int, seed: int):
    """The worst case of the rank walks: `chunks` rows of `width` bytes
    (a multiple of 256), each a seeded permutation P of the 256 byte values
    repeated.  Step i < 256 has rank i; every later step has rank 255.
    Returns (rows, ranks, freqs) with the SRC rank rows written from the
    period alone: every frequency is width / 256, so the buckets follow
    the byte values, and bucket v holds the rank of v's first step (its
    place in P) and then 255s."""
    import numpy as np

    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(256) for _ in range(chunks)])
    per = width // 256
    rows = np.tile(perms.astype(np.uint8), (1, per))
    ranks = np.full((chunks, 256, per), 255, np.uint8)
    ranks[:, :, 0] = np.argsort(perms, axis=1)
    freqs = np.full((chunks, 256), per, np.int32)
    return rows, ranks.reshape(chunks, width), freqs


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def oracle(src: str, dst: str, flags) -> float:
    """The host encode of src by `python -m jampack_tpu.cli c` (its native
    engine) in a process of its own; returns its wall seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "jampack_tpu.cli", "c", src,
                          dst, *flags], cwd=HERE, capture_output=True,
                         text=True, timeout=600)
    check(res.returncode == 0, f"oracle encode {flags} failed:\n{res.stderr}")
    return time.perf_counter() - t0


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cuda_ms(fn, reps: int, busy: bool = False) -> float:
    """Mean milliseconds of fn() over reps runs, from CUDA events.  busy:
    the stream first sleeps ~10 ms, so that every launch is queued before
    the first runs and a kernel shorter than its Python launch is timed
    back to back."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    if busy:
        torch.cuda._sleep(int(CLOCK_HZ / 100))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: int, steps: int, dep: int) -> dict:
    """The least time the card could take: the largest of the bytes moved
    (each input read once, each output written once) over the HBM rate,
    the integer ops over the peak rate, and the serial floor of `steps`
    steps of `dep` dependent ops.  bound_by is "bytes" or "operations"
    (either operations term); serial_ms is the floor alone."""
    t_bytes = moved / HBM_BPS * 1e3
    t_serial = steps * dep * DEP_CYCLES / CLOCK_HZ * 1e3
    t_ops = max(ops / OPS_PER_S * 1e3, t_serial)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "serial_ms": t_serial}


def parity(name, kernel_fn, plain_fn, reps, busy=False):
    """Run both versions (first calls are the warm-up), require exact
    equality, then time each (busy: see cuda_ms).  Returns (outputs, row
    of the kernels JSON without launches and bound)."""
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    check(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
    ms = cuda_ms(kernel_fn, reps, busy)
    plain_ms = cuda_ms(plain_fn, 1, busy)
    print(f"parity {name}: exact; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    return got, {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                 "library_ms": None}


def cycles_per_step(ms: float, steps: int) -> float:
    """A serial walk's time per step in cycles of the boost clock."""
    return ms * 1e-3 * CLOCK_HZ / steps


def k11_parity(stages, args, dev) -> dict:
    """K11 on one lz stage's arguments (buf, n, max_tokens, out_cap),
    exact against its plain version (every output array and the count,
    length and bad flag), timed as the stage calls it: the head and up to
    9 chain launches, one or two status fetches.  Returns the kernels JSON
    row without launches."""
    import torch

    buf, n, max_tokens, out_cap = args

    def run(parse, wrap):
        *arrays, tok, olen, bad = parse(buf, n, max_tokens, out_cap)
        return (*(wrap(a) for a in arrays),
                torch.tensor([tok, olen, int(bad)], device=dev))

    got, row = parity(f"lz_parse ({n} B)",
                      lambda: run(stages.lz_parse, lambda a: a),
                      lambda: run(stages.lz_parse_plain,
                                  lambda a: torch.from_numpy(a).to(dev)), 5)
    tok, bad = int(got[5][0]), bool(got[5][2])
    check(not bad, "the token parse flagged a stream the path decodes")
    # timed again after the plain version, which leaves the card idle for
    # tens of ms: the first of two timings, discarded, warms it up
    for _ in range(2):
        row["ms"] = cuda_ms(lambda: stages.lz_parse(*args), K11_REPS)
    # the bound: what any parse must move, a 16-byte window a token (the
    # literal runs between are not read), the five int32 slots of
    # max_tokens + 1 written once and the 3-int status; about 60 integer
    # ops a token.  serial_ms is the floor of the one-thread walk: t
    # tokens of 14 dependent ops (the window load as 8, the varint
    # arithmetic 6).  The design's own floor, the stage read once by its
    # candidate pass and its t / D hops of the jump table (each a load,
    # counted as 8 op latencies, and a sign test), is printed apart
    hops = -(-tok // stages.LZ_JUMP)
    design = max(n / HBM_BPS * 1e3, bound(0, 0, hops, 9)["serial_ms"])
    print(f"lz_parse ({n} B, {tok} tokens): the design's floor "
          f"{design:.5f} ms (the stage read once; {hops} hops of D = "
          f"{stages.LZ_JUMP})")
    return {**row, "tokens": tok, "stream_bytes": n,
            "cycles_per_token": cycles_per_step(row["ms"], max(tok, 1)),
            **bound(16 * tok + 20 * (max_tokens + 1) + 12, 60 * tok, 0, 0),
            "serial_ms": bound(0, 0, tok, 14)["serial_ms"]}


def k11_sweep(stages, args, want) -> dict:
    """K11 on one lz stage at each sub-chain length D, exact against
    `want` (its outputs at the wrapper's D), timed as the stage calls it;
    and, at the wrapper's D, the time of the head (with its fetch) and of
    each chain phase (the differences of runs that stop after it).
    Returns {"jump": D, "depth_ms": {D: ms}, "phase_ms": {phase: ms}}."""
    import torch

    depth_ms = {}
    for depth in (8, 16, 32, 64):
        got = stages._lz_parse_at(*args, jump=depth)
        check(all(torch.equal(g, w) for g, w in zip(got[:5], want[:5]))
              and got[5:] == want[5:], f"lz_parse at D = {depth} differs")
        depth_ms[str(depth)] = cuda_ms(
            lambda: stages._lz_parse_at(*args, jump=depth), K11_REPS)
    upto = [cuda_ms(lambda: stages._lz_parse_at(*args, stop=k), K11_REPS)
            for k in range(6)]
    names = ["head", "candidates", "jump table", "hops", "sub-chains",
             "finish"]
    phase_ms = {names[0]: upto[0], **{
        names[k]: upto[k] - upto[k - 1] for k in range(1, 6)}}
    print("lz_parse by D: " + ", ".join(
        f"D = {d}: {v:.4f} ms" for d, v in depth_ms.items())
        + f"; at D = {stages.LZ_JUMP}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in phase_ms.items()))
    return {"jump": stages.LZ_JUMP, "depth_ms": depth_ms,
            "phase_ms": phase_ms}


def worst_case(name, run, plain, want, path):
    """The period-256 worst case of a rank walk: run(slice) launches the
    kernel on those chunks, plain(slice) its plain version.  On every chunk
    the kernel must give `want` (CPU tensors); on the first FEW chunks it
    must equal the plain version, which is timed there.  Returns the
    kernel's ms on every chunk."""
    import torch

    got = run(slice(None))
    for g, w in zip(got, want):
        check(torch.equal(g.cpu(), w),
              f"{name} (period 256) differs from the period's")
    few = slice(0, FEW)
    for g, w in zip(run(few), plain(few)):
        check(torch.equal(g, w),
              f"{name} (period 256) differs from its plain version")
    ms = cuda_ms(lambda: run(slice(None)), 5)
    plain_ms = cuda_ms(lambda: plain(few), 1)
    print(f"parity {name} (period 256, every step from the 256th rank 255): "
          f"{got[0].shape[0]} chunks of {CHUNK} B, exact, path {path}; "
          f"kernel {ms:.3f} ms ({cycles_per_step(ms, CHUNK):.0f} cycles a "
          f"step), plain {plain_ms:.1f} ms on {FEW} chunks")
    return ms


def chase_sweep(ibwt, lf, sbyte, anchors, units, want) -> dict:
    """K3 at each sub-chain length D of its measuring entry, exact against
    `want`, and the time of each of its three phases (CUDA events over runs
    that stop after phase 1, 2 and 3, each queued behind a busy stream).  Returns {"depth_ms": {D: ms},
    "phase_ms": {D: [jump table, anchor walk, sub-chains]}}."""
    import torch

    depth_ms, phase_ms = {}, {}
    for depth in (16, 32, 64, 128):
        check(torch.equal(ibwt._chase_at(lf, sbyte, anchors, units, depth),
                          want), f"ibwt_chase at D = {depth} differs")
        upto = [cuda_ms(lambda: ibwt._chase_at(lf, sbyte, anchors, units,
                                               depth, k), 5, busy=True)
                for k in (1, 2, 3)]
        depth_ms[str(depth)] = upto[2]
        phase_ms[str(depth)] = [upto[0], upto[1] - upto[0], upto[2] - upto[1]]
        print(f"ibwt_chase D = {depth}: {upto[2]:.4f} ms; jump table "
              f"{upto[0]:.4f} ({depth.bit_length() - 1} passes), anchor walk "
              f"{upto[1] - upto[0]:.4f}, sub-chains {upto[2] - upto[1]:.4f}"
              + (" (the wrapper's D)" if depth == ibwt.JUMP else ""))
    return {"depth_ms": depth_ms, "phase_ms": phase_ms}


def zero(kernels) -> None:
    import torch

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()


def decode_cli(cli, kernels, arc, out):
    """`cli d` of `arc` on cuda with the kernels' launch counts zeroed just
    before; every kernel must have run.  Returns (wall s, launches)."""
    zero(kernels)
    t0 = time.perf_counter()
    check(cli.run(["cli", "d", arc, out, "--device", "cuda"]) == 0,
          "decode failed")
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    for k, n in zip(kernels, launches):
        check(n > 0, f"{k.name} was not launched on the decode path")
    return wall, launches


def encode_cli(cli, kernels, src, dst, flags):
    """`cli c` (the device encode) of src on cuda with every launch count
    zeroed just before.  Returns (wall s, launches, archive bytes)."""
    zero(kernels)
    t0 = time.perf_counter()
    check(cli.run(["cli", "c", src, dst, *flags, "--device", "cuda"]) == 0,
          f"device encode {flags} failed")
    wall = time.perf_counter() - t0
    return wall, [k.launches for k in kernels], read(dst)


def span_words(framing, data: bytes) -> list:
    """The Lpx span word of every block of an archive."""
    import io

    f, words = io.BytesIO(data), []
    while (rec := framing.read_block(f)) is not None:
        words.append(rec[0].lpx_spans)
    return words


def count_blocks(framing, data: bytes) -> int:
    return len(span_words(framing, data))


def block_lengths(size: int, blocksize: int) -> list:
    """The raw length of each block the encode of `size` bytes frames, the
    reference's trailing empty block of an exact multiple included."""
    return [min(blocksize, size - i) for i in range(0, size, blocksize)] + (
        [0] if size % blocksize == 0 else [])


def cli_batches(keys, per: int, cards: int, keep=lambda k: True) -> int:
    """The batches the fused CLI runs (runtime/sharding.py) for blocks
    with these keys, the span words on decode and the raw lengths of a -m3
    encode: a window of per x cards blocks at a time, cut into one run a
    card, one batch a distinct key of a run (counted where keep(key))."""
    n = 0
    for w in range(0, len(keys), per * cards):
        window = keys[w:w + per * cards]
        step = -(-len(window) // cards)
        for r in range(0, len(window), step):
            n += sum(1 for k in set(window[r:r + step]) if keep(k))
    return n


@contextlib.contextmanager
def caught(module, name: str, calls: list):
    """While active, module.name records the positional arguments of each
    call in `calls` (tensors cloned) before it runs."""
    real = getattr(module, name)

    def spy(*args):
        calls.append(tuple(a.clone() if hasattr(a, "clone") else a
                           for a in args))
        return real(*args)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def host_lz_route(cli, de, dd, encode_stages, all_kernels, dec_kernels, lpx,
                  tmp, msrc, mixed, oracle_s, dev):
    """Phase 18: the host-LZ encode route through `cli c` on cuda, every
    launch count zeroed just before each encode.  The default flags and
    -m1 on phase 17's data (its oracle archives), the -m0 JT3 stream on
    the same data, -m2 on its last tenth, the log records: the -m2 finder
    walks the text so slowly on the host (in the oracle and the port
    alike; its rate on 64 KiB of the text is printed) that 8 MiB of it
    would not fit the run.  Each archive
    must equal the oracle's and decode back on cuda; K4, K5, K6 and K10
    must run once a block, K7 at least once.  Then block 0's stage split
    with the host LZ keys apart, the oracle's wall beside the port's, and
    K6 timed at the JAM shape (1 MiB chunks, one warp each).  Returns
    ({kernel name: {path: launches}}, K6's row entries at the JAM
    shape)."""
    from jampack_tpu_torch import native
    from jampack_tpu_torch.format import framing
    from jampack_tpu_torch.runtime.options import Options

    t0 = time.perf_counter()
    native.lz_encode(mixed[:64 << 10], 2)
    m2_us = (time.perf_counter() - t0) / (64 << 10) * 1e6
    print(f"host-LZ: the -m2 finder on 64 KiB of the text: {m2_us:.1f} us "
          f"a byte on the host (8 MiB: {m2_us * BLOCK / 1e6:.0f} s)")
    tail = mixed[-(BLOCK // 10):]
    tsrc = os.path.join(tmp, "records-tail.bin")
    with open(tsrc, "wb") as f:
        f.write(tail.tobytes())
    jam = {"blocksize": BLOCK, "filters": 1, "lpx_spans": 4}
    jt3 = ["-m0", "-c16", "-L4", "-u960", f"-S{SA_SPANS}", "-Sa"]
    runs = [("-m0 -f1 -S4 (default)", [], msrc, mixed, "-m0",
             Options(match_finder=0, **jam)),
            ("-m1", ["-m1"], msrc, mixed, "-m1",
             Options(match_finder=1, **jam)),
            ("-m2 (log records)", ["-m2"], tsrc, tail, None,
             Options(match_finder=2, **jam)),
            ("-m0 JT3", jt3, msrc, mixed, None,
             Options(blocksize=BLOCK, match_finder=0, filters=1,
                     rans_lanes=4, ans_chunk=16 << 10, anchor_units=960,
                     lpx_spans=SA_SPANS, lpx_auto=True))]
    names = [k.name for k in all_kernels]
    once = ["rank_encode", "model_pairs", "rans_encode", "lpx_walk"]
    out = {name: {} for name in once + ["joint_hist"]}
    k6 = {}
    back = os.path.join(tmp, "host-lz.out")
    for i, (label, flags, src, data, reuse, opt) in enumerate(runs):
        host_arc = (os.path.join(tmp, f"mixed8{reuse}.jam") if reuse else
                    os.path.join(tmp, f"host-lz{i}.arc"))
        host_s = oracle_s[reuse] if reuse else oracle(src, host_arc, flags)
        dev_arc = os.path.join(tmp, f"dev-lz{i}.arc")
        enc_s, launches, dev_bytes = encode_cli(cli, all_kernels, src,
                                                dev_arc, flags)
        check(dev_bytes == read(host_arc),
              f"the {label} archive differs from the oracle's")
        nblk = count_blocks(framing, dev_bytes)
        got = dict(zip(names, launches))
        for name in once:
            check(got[name] == nblk, f"{label}: {name} launched "
                  f"{got[name]} times for {nblk} blocks")
        check(got["joint_hist"] >= nblk, f"{label}: joint_hist launched "
              f"{got['joint_hist']} times for {nblk} blocks")
        for name in out:
            out[name][label] = got[name]
        words = span_words(framing, dev_bytes)
        kernels = dec_kernels + ([lpx.KERNEL] if all(words) else [])
        dec_s, _ = decode_cli(cli, kernels, dev_arc, back)
        check(read(back) == data.tobytes(),
              f"the {label} archive did not decode")
        times, calls = {}, []
        with caught(encode_stages, "rank_encode", calls):
            t0 = time.perf_counter()
            de.encode_block_device_ex(data[:BLOCK], opt, dev, times)
            block_s = time.perf_counter() - t0
        host = {k: times.pop(k) for k in ("lz_pre", "lz")}
        print(f"host-LZ {label}: {data.size} B -> {len(dev_bytes)} B in "
              f"{enc_s:.3f} s (`cli c`, {nblk} blocks, span words {words}),"
              f" the oracle {host_s:.3f} s; byte-identical; `cli d` "
              f"{dec_s:.3f} s, exact; launches " + ", ".join(
                  f"{k}={got[k]}" for k in out))
        print(f"host-LZ {label} block 0 stages (s): host LZ " + ", ".join(
            f"{k}={v:.4f}" for k, v in host.items()) + "; " + ", ".join(
            f"{k}={v:.4f}" for k, v in times.items())
            + f"; block wall {block_s:.3f} s")
        if i == 0:
            rows_j, olens_j = calls[0]
            ms = cuda_ms(lambda: encode_stages.rank_encode(rows_j, olens_j),
                         2)
            steps = int(olens_j.max())
            k6 = {"jam_ms": ms, "jam_chunks": rows_j.shape[0],
                  "jam_cycles_per_step": cycles_per_step(ms, steps)}
            print(f"rank_encode at the JAM shape: {rows_j.shape[0]} chunks "
                  f"of <= {steps} B, one warp each: {ms:.3f} ms "
                  f"({k6['jam_cycles_per_step']:.0f} cycles a step)")
    return out, k6


def token_dense(cli, dd, device_stages, all_kernels, dec_kernels, lpx, tmp,
                dev) -> dict:
    """Phase 19 (ROADMAP A9): 8 MiB of 61-byte log records through `cli c
    -m1` (the fused encode, with the host LZ finders) hold more LZ tokens
    than plan_shapes gives the JAX decode; the archive must equal the
    oracle's and decode on cuda through `cli d`, K11 twice a block.
    Returns its numbers for K11's row."""
    from jampack_tpu_torch.format import framing

    data = log_records(BLOCK)
    src = os.path.join(tmp, "records-a9.bin")
    host_arc = os.path.join(tmp, "records-a9.host.jam")
    dev_arc = os.path.join(tmp, "records-a9.dev.jam")
    back = os.path.join(tmp, "records-a9.out")
    with open(src, "wb") as f:
        f.write(data.tobytes())
    host_s = oracle(src, host_arc, ["-m1"])
    enc_s, _, dev_bytes = encode_cli(cli, all_kernels, src, dev_arc, ["-m1"])
    check(dev_bytes == read(host_arc),
          "the -m1 log-records archive differs from the oracle's")
    nblk = count_blocks(framing, dev_bytes)
    dec_s, launches = decode_cli(cli, dec_kernels + [lpx.KERNEL], dev_arc,
                                 back)
    check(read(back) == data.tobytes(), "the token-dense archive did not decode")
    check(launches[3] == 2 * nblk, f"lz_parse launched {launches[3]} times "
          f"for {nblk} blocks")
    with open(dev_arc, "rb") as f:
        h, pay = framing.read_block(f)
    meta = dd.block_meta(pay, h.lanes)
    shapes = dd.plan_shapes([meta], [len(pay)], h.blocksize, h.lanes)
    slots = dd.token_slots(int(meta["chunk_olens"].sum()), shapes["out_cap"])
    calls = []
    with caught(device_stages, "lz_parse", calls):
        dd.decode_block_device(pay, h.crc, h.blocksize, h.units, h.lanes,
                               h.lpx_spans, dev)
    check(calls[0][2] == slots, "the decode did not size its slots by "
          "token_slots")
    tokens = device_stages.lz_parse(*calls[0])[5]
    check(tokens > shapes["max_tokens"],
          f"{tokens} tokens: not more than plan_shapes' {shapes['max_tokens']}")
    print(f"A9: {BLOCK} B of log records through `cli c -m1` in {enc_s:.3f} "
          f"s, byte-identical to the oracle ({host_s:.1f} s); the -m1 lz "
          f"stage of block 0 holds {tokens} tokens against plan_shapes' "
          f"{shapes['max_tokens']} slots; the port's decode took "
          f"{slots + 1} slots (token_slots); `cli d` {dec_s:.3f} s, exact; "
          f"lz_parse {launches[3]} launches for {nblk} blocks "
          f"({launches[3] // nblk} a block)")
    return {"tokens": tokens, "plan_shapes_slots": shapes["max_tokens"],
            "slots": slots + 1, "launches": launches[3], "blocks": nblk}


def captured(fn, *args):
    """(fn's return, what it printed), the print echoed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    text = buf.getvalue()
    print(text, end="")
    return ret, text


def engine_cli(cli, kernels, mode, src, dst, flags, engine, dev="cuda"):
    """`cli c|d` with a stage engine on `dev`, -v, every launch count
    zeroed just before.  Returns (wall s, {kernel name: launches}, the -v
    text)."""
    zero(kernels)
    t0 = time.perf_counter()
    ret, text = captured(cli.run, ["cli", mode, src, dst, *flags, "-v",
                                   "--engine", engine, "--device", str(dev)])
    check(ret == 0, f"cli {mode} --engine {engine} {flags} failed")
    wall = time.perf_counter() - t0
    return wall, {k.name: k.launches for k in kernels}, text


@contextlib.contextmanager
def recorded(module, name: str, calls: list):
    """While active, module.name records (args, kwargs) of each call in
    `calls`, tensors cloned, before it runs."""
    real = getattr(module, name)

    def keep(a):
        return a.clone() if hasattr(a, "clone") else a

    def spy(*args, **kwargs):
        calls.append((tuple(keep(a) for a in args),
                      {k: keep(v) for k, v in kwargs.items()}))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def peak_bytes(fn, dev) -> int:
    """Device bytes fn() allocates at its peak above what was live."""
    import torch

    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def one_and_batch(name, fn, one_calls, batch_calls, reps: int) -> dict:
    """A batched stage's wrapper timed on the arguments the one-block path
    gave it (each block's call) and on the batch's one call: CUDA events,
    the mean of `reps` runs after a warm-up.  Returns {"one_ms": the sum
    over the blocks, "batch_ms": the batch's, "calls": blocks}."""
    one = 0.0
    for args, kw in one_calls:
        fn(*args, **kw)
        one += cuda_ms(lambda: fn(*args, **kw), reps)
    (args, kw), = batch_calls
    fn(*args, **kw)
    batch = cuda_ms(lambda: fn(*args, **kw), reps)
    print(f"  {name}: {len(one_calls)} one-block calls {one:.3f} ms in all; "
          f"the batch's one call {batch:.3f} ms")
    return {"one_ms": one, "batch_ms": batch, "calls": len(one_calls)}


def batch_phase(cli, dd, de, device_stages, encode_stages, lpx, rans,
                rank, rans_encode, sharding, metrics, dryrun, kernels, tmp,
                src, prod_arc, f1_arc, want, per, cards, dev):
    """Phase 23: batched blocks and several workers.  Returns the kernels
    JSON's batch_launches ({kernel name: {run: launches}}) and the
    numbers PERF.md records ({"decode": ..., "encode": ..., ...})."""
    import io

    import numpy as np
    import torch

    from jampack_tpu_torch.format import framing
    from jampack_tpu_torch.runtime import sysinfo
    from jampack_tpu_torch.runtime.options import Options

    launches = {}

    def counted(run, label):
        zero(kernels)
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        for k in kernels:
            if k.launches:
                launches.setdefault(k.name, {})[label] = k.launches
        return got, wall, {k.name: k.launches for k in kernels}

    def walled(run) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    result = {"decode": {}, "encode": {}, "peak_bytes": {}}
    jam_arc = os.path.join(tmp, "textlike32.jam")
    jam_s = oracle(src, jam_arc, ["-m0", "-f1", "-S4"])
    print(f"phase 23: oracle JAM archive (-m0 -f1 -S4) of the 32 MiB in "
          f"{jam_s:.1f} s, {os.path.getsize(jam_arc)} B")

    # ---- the batch against one block at a time: decode
    for label, path in (("jt3", prod_arc), ("jam", jam_arc)):
        with open(path, "rb") as f:
            recs = []
            while (rec := framing.read_block(f)) is not None:
                recs.append(rec)
        h0 = recs[0][0]
        words = [h.lpx_spans for h, _ in recs]
        t_one, t_batch = {}, {}

        def one_run(times):
            return [dd.decode_block_device(p, h.crc, h.blocksize, h.units,
                                           h.lanes, h.lpx_spans, dev, times)
                    for h, p in recs]

        def batch_run(times):
            return dd.decode_blocks_device(
                [p for _, p in recs], [h.crc for h, _ in recs],
                h0.blocksize, h0.units, h0.lanes, words, dev, times)

        # in turns: one, batch (stages synchronized), batch, one (not)
        one, one_s, one_l = counted(lambda: one_run(t_one),
                                    f"decode {label} one at a time")
        batch, batch_s, batch_l = counted(lambda: batch_run(t_batch),
                                          f"decode {label} batch")
        walls = [walled(lambda: batch_run(None)),
                 walled(lambda: one_run(None))]
        check(b"".join(o.tobytes() for o in one) == want
              and b"".join(b.tobytes() for b in batch) == want,
              f"the {label} batch or its blocks did not decode to the input")
        groups = len(set(words))
        check(batch_l["rans_decode"] == batch_l["rank_decode"] == groups
              and batch_l["lpx_walk"] == len({w for w in words if w > 0}),
              f"decode {label}: the batch launched {batch_l}")
        print(f"decode {label}: {len(recs)} blocks one at a time "
              f"{one_s:.3f} s, as one batch {batch_s:.3f} s (stages "
              f"synchronized); unsynchronized batch {walls[0]:.3f} s, one "
              f"at a time {walls[1]:.3f} s; exact; launches one at a time "
              f"{one_l}, batch {batch_l}")
        print(f"  stages one at a time (s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in t_one.items()))
        print(f"  stages of the batch (s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in t_batch.items()))
        # the batched stages' wrappers, one block's calls against the
        # batch's; and the peak memory of one block and of the four full
        # blocks, for sharding.batch_blocks
        full = recs[:NBLOCKS]
        c_one = {"K1": [], "K2": [], "K10": []}
        c_batch = {"K1": [], "K2": [], "K10": []}

        def run(calls, blocks):
            with recorded(device_stages, "decode_lanes_wide", calls["K1"]), \
                    recorded(device_stages, "rank_decode", calls["K2"]), \
                    recorded(lpx, "lpx_walk", calls["K10"]):
                dd.decode_blocks_device(
                    [p for _, p in blocks], [h.crc for h, _ in blocks],
                    h0.blocksize, h0.units, h0.lanes,
                    [h.lpx_spans for h, _ in blocks], dev)

        for blk in full:
            run(c_one, [blk])
        run(c_batch, full)
        stage_ms = {
            "K1": one_and_batch(f"rans_decode ({label})",
                                rans.decode_lanes_wide, c_one["K1"],
                                c_batch["K1"], 2),
            "K2": one_and_batch(f"rank_decode ({label})", rank.rank_decode,
                                c_one["K2"], c_batch["K2"], 2)}
        if c_batch["K10"]:
            stage_ms["K10"] = one_and_batch(f"lpx_walk decode ({label})",
                                            lpx.lpx_walk, c_one["K10"],
                                            c_batch["K10"], 1)
        del c_one, c_batch
        if label == "jam":
            jam_full = full
        peaks = [peak_bytes(lambda: dd.decode_blocks_device(
            [p for _, p in full[:b]], [h.crc for h, _ in full[:b]],
            h0.blocksize, h0.units, h0.lanes,
            [h.lpx_spans for h, _ in full[:b]], dev), dev)
            for b in (1, len(full))]
        result["peak_bytes"][f"decode {label}"] = peaks
        print(f"  peak device memory: {peaks[0]} B for one block, {peaks[1]}"
              f" B for {len(full)}")
        result["decode"][label] = {
            "blocks": len(recs), "one_s": one_s, "batch_s": batch_s,
            "batch_wall_s": walls[0], "one_wall_s": walls[1],
            "one_stages": t_one, "batch_stages": t_batch,
            "kernel_ms": stage_ms}

    # ---- the batch against one block at a time: the -m3 encode
    blocks = [np.frombuffer(want[i * BLOCK:(i + 1) * BLOCK], np.uint8)
              for i in range(NBLOCKS)]
    streams = {"jam": Options(blocksize=BLOCK, match_finder=3, filters=1,
                              lpx_spans=4),
               "jt3": Options(blocksize=BLOCK, match_finder=3, filters=1,
                              rans_lanes=4, ans_chunk=16 << 10,
                              anchor_units=960, lpx_spans=SA_SPANS,
                              lpx_auto=True)}
    for label, opt in streams.items():
        t_one, t_batch = {}, {}
        one, one_s, one_l = counted(lambda: [de.encode_block_device_ex(
            b, opt, dev, t_one) for b in blocks], f"encode {label} one at a "
            "time")
        batch, batch_s, batch_l = counted(lambda: de.encode_blocks_device(
            blocks, opt, dev, t_batch), f"encode {label} batch")
        walls = [walled(lambda: de.encode_blocks_device(blocks, opt, dev)),
                 walled(lambda: [de.encode_block_device_ex(b, opt, dev)
                                 for b in blocks])]
        check(one == batch, f"encode {label}: the batch differs from its "
                            "blocks one at a time")
        if label == "jam":
            jam_one = one
        for name in ("rank_encode", "model_pairs", "rans_encode", "lpx_walk"):
            check(batch_l[name] == 1,
                  f"encode {label}: {name} launched {batch_l[name]} times")
        back = dd.decode_blocks_device([b[1] for b in batch],
                                       [b[0] for b in batch], BLOCK,
                                       opt.anchor_units, opt.rans_lanes,
                                       [b[2] for b in batch], dev)
        check(all(np.array_equal(x, y) for x, y in zip(back, blocks)),
              f"encode {label}: the batch's payloads did not decode")
        print(f"encode {label} (-m3 -f1): {NBLOCKS} blocks one at a time "
              f"{one_s:.3f} s, as one batch {batch_s:.3f} s (stages "
              f"synchronized); unsynchronized batch {walls[0]:.3f} s, one at "
              f"a time {walls[1]:.3f} s; byte-identical; "
              f"span words {[b[2] for b in batch]}; launches one at a time "
              f"{one_l}, batch {batch_l}")
        print(f"  stages one at a time (s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in t_one.items()))
        print(f"  stages of the batch (s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in t_batch.items()))
        names = {"K6": (encode_stages, "rank_encode",
                        encode_stages.rank_encode),
                 "K4": (encode_stages, "model_pairs_wide",
                        rans_encode.model_pairs_wide),
                 "K5": (encode_stages, "rans_reverse_encode_wide",
                        rans_encode.rans_reverse_encode_wide),
                 "K10": (lpx, "lpx_walk", lpx.lpx_walk)}
        c_one = {k: [] for k in names}
        c_batch = {k: [] for k in names}

        def run_enc(calls, bl):
            with contextlib.ExitStack() as stack:
                for k, (mod, attr, _) in names.items():
                    stack.enter_context(recorded(mod, attr, calls[k]))
                de.encode_blocks_device(bl, opt, dev)

        for b in blocks:
            run_enc(c_one, [b])
        run_enc(c_batch, blocks)
        stage_ms = {k: one_and_batch(f"{attr} ({label})", fn, c_one[k],
                                     c_batch[k], 1)
                    for k, (_, attr, fn) in names.items()}
        del c_one, c_batch
        peaks = [peak_bytes(lambda: de.encode_blocks_device(blocks[:b], opt,
                                                            dev), dev)
                 for b in (1, NBLOCKS)]
        result["peak_bytes"][f"encode {label}"] = peaks
        print(f"  peak device memory: {peaks[0]} B for one block, {peaks[1]}"
              f" B for {NBLOCKS}")
        result["encode"][label] = {
            "blocks": NBLOCKS, "one_s": one_s, "batch_s": batch_s,
            "batch_wall_s": walls[0], "one_wall_s": walls[1],
            "one_stages": t_one, "batch_stages": t_batch,
            "kernel_ms": stage_ms}
    fixed, per_block = [], []
    for key, (p1, pn) in result["peak_bytes"].items():
        b = (pn - p1) / (NBLOCKS - 1)
        per_block.append(b / BLOCK)
        fixed.append((p1 - b) / BLOCK)
    result["peak_per_byte"] = {"fixed": max(fixed),
                               "per_block": max(per_block)}
    print(f"peak device memory a batch, in block bytes: "
          f"{max(fixed):.2f} + {max(per_block):.2f} x B (the larger of "
          f"decode's and encode's fits; sharding has "
          f"{sharding.PEAK_FIXED_PER_BYTE} + "
          f"{sharding.PEAK_PER_BLOCK_PER_BYTE} x B); batch_blocks gives "
          f"{per} blocks of 8 MiB a batch on this card")

    # ---- the CLI's default batch itself: the four full JAM blocks
    # repeated to batch_blocks' count, one batch each way; the card's
    # reserved peak (what the caching allocator holds, all phases' live
    # tensors included) must stay within batch_blocks' budget
    budget = 0.8 * sysinfo.device_memory(dev)
    reps = [jam_full[i % NBLOCKS] for i in range(per)]
    runs = {
        "decode": (lambda t: dd.decode_blocks_device(
            [p for _, p in reps], [h.crc for h, _ in reps], BLOCK,
            reps[0][0].units, reps[0][0].lanes,
            [h.lpx_spans for h, _ in reps], dev, t),
            lambda got: all(np.array_equal(g, blocks[i % NBLOCKS])
                            for i, g in enumerate(got)),
            ("rans_decode", "rank_decode", "lpx_walk")),
        "encode": (lambda t: de.encode_blocks_device(
            [blocks[i % NBLOCKS] for i in range(per)], streams["jam"], dev,
            t),
            lambda got: got == [jam_one[i % NBLOCKS] for i in range(per)],
            ("rank_encode", "model_pairs", "rans_encode", "lpx_walk"))}
    result["default_batch"] = {"blocks": per, "budget_bytes": budget}
    for what, (run_big, exact, names) in runs.items():
        t_big = {}
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        got, big_s, big_l = counted(lambda: run_big(t_big),
                                    f"{what} jam default batch")
        reserved = torch.cuda.max_memory_reserved(dev)
        allocated = torch.cuda.max_memory_allocated(dev)
        check(exact(got), f"the default batch of {per} JAM blocks: {what} "
                          "differs from the blocks one at a time")
        del got
        for name in names:
            check(big_l[name] == 1, f"the default batch's {what}: {name} "
                                    f"launched {big_l[name]} times")
        check(reserved <= budget,
              f"the default batch's {what} reserved {reserved} B of the "
              f"card, over batch_blocks' budget of {budget:.0f} B")
        print(f"default batch, {what} JAM: {per} blocks of 8 MiB in "
              f"{big_s:.3f} s (stages synchronized), exact, each batched "
              f"kernel once; peak reserved {reserved} B, allocated "
              f"{allocated} B, budget {budget:.0f} B")
        print(f"  stages (s): " + ", ".join(
            f"{k}={v:.4f}" for k, v in t_big.items()))
        result["default_batch"][what] = {
            "s": big_s, "stages": t_big, "reserved_bytes": reserved,
            "allocated_bytes": allocated}
    del reps

    # ---- the CLI through runtime/sharding.py on the 32 MiB archives
    through = []

    def spy_on(name):
        real = getattr(sharding, name)

        def spy(*args, **kwargs):
            through.append(name)
            return real(*args, **kwargs)
        return real, spy

    out = os.path.join(tmp, "phase23.out")
    dev_jam = os.path.join(tmp, "textlike32.dev.jam")
    saved = {}
    for name in ("decode_archive_to", "encode_archive_sharded"):
        saved[name], spy = spy_on(name)
        setattr(sharding, name, spy)
    try:
        words = span_words(framing, read(jam_arc))
        d_s, d_l = decode_cli(cli, [rans.KERNEL, rank.KERNEL, lpx.KERNEL],
                              jam_arc, out)
        check(read(out) == want, "`cli d` of the JAM archive differs")
        check(d_l[0] == d_l[1] == cli_batches(words, per, cards) and
              d_l[2] == cli_batches(words, per, cards, lambda w: w > 0),
              f"`cli d` (JAM) launches {d_l}")
        c_s, c_l, c_bytes = encode_cli(cli, kernels, src, dev_jam,
                                       ["-m0", "-f1", "-S4"])
        check(c_bytes == read(jam_arc),
              "`cli c -m0 -f1 -S4` differs from the oracle's JAM archive")
    finally:
        for name, real in saved.items():
            setattr(sharding, name, real)
    check(through == ["decode_archive_to", "encode_archive_sharded"],
          f"the fused CLI did not go through sharding: {through}")
    print(f"cli --engine fused via sharding: d (JAM, 32 MiB) {d_s:.3f} s, "
          f"exact, launches {d_l}; c -m0 -f1 -S4 {c_s:.3f} s, "
          f"byte-identical to the oracle")
    result["cli"] = {"decode_jam_s": d_s, "encode_jam_s": c_s}

    # ---- two workers on one card, and every card when there are more
    meshes = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        meshes.append(sharding.make_mesh())
    result["mesh"] = {}
    for mesh in meshes:
        key = " ".join(str(d) for d in mesh)
        t0 = time.perf_counter()
        for path in (prod_arc, jam_arc):
            with open(path, "rb") as f:
                check(sharding.decode_archive_sharded(f, mesh) == want,
                      f"decode_archive_sharded on {key} differs")
        dec_s = time.perf_counter() - t0
        opt_f1 = Options(blocksize=BLOCK, match_finder=3, filters=1,
                         rans_lanes=4, ans_chunk=16 << 10, anchor_units=960,
                         lpx_spans=0)
        got = io.BytesIO()
        t0 = time.perf_counter()
        with open(src, "rb") as f:
            sharding.encode_archive_sharded(f, got, opt_f1, mesh)
        enc_s = time.perf_counter() - t0
        check(got.getvalue() == read(f1_arc),
              f"encode_archive_sharded -m3 -f1 on {key} differs from the "
              "oracle's")
        print(f"mesh {key}: decode of both 32 MiB archives {dec_s:.3f} s, "
              f"the -m3 -f1 encode {enc_s:.3f} s, byte-identical")
        result["mesh"][key] = {"decode_both_s": dec_s, "encode_f1_s": enc_s}

    # ---- the flagship step on one 8 MiB block (120 units divide it)
    n = 120 * (BLOCK // 120)
    block = torch.from_numpy(np.frombuffer(want[:n], np.uint8).copy()).to(dev)
    sharding.codec_block_step(block)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    recon, bwt, metric = sharding.codec_block_step(block)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    check(torch.equal(recon, block), "codec_block_step did not invert")
    check(int(metric) == int(bwt.long().sum()) & 0xFFFFFFFF,
          "codec_block_step's metric")
    print(f"codec_block_step: {n} B, exact, {step_s:.3f} s (second run)")
    result["codec_block_step_s"] = step_s
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(["cuda:0", "cuda:0"])
    print(f"dryrun_multichip(['cuda:0', 'cuda:0']): ok in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the compute walls, production and JAM blocks
    walls = {}
    for label, path in (("jt3", prod_arc), ("jam", jam_arc)):
        with open(path, "rb") as f:
            h, p = framing.read_block(f)
        walls[f"decode {label}"] = metrics.fused_decode_compute_wall(
            p, h.blocksize, h.units, h.lanes, h.lpx_spans, 3, dev)
    for label, opt in (("jt3", Options(blocksize=BLOCK, match_finder=3,
                                       rans_lanes=4, ans_chunk=16 << 10,
                                       anchor_units=960, lpx_spans=0)),
                       ("jam", Options(blocksize=BLOCK, match_finder=3,
                                       lpx_spans=4))):
        walls[f"encode {label}"] = metrics.fused_encode_compute_wall(
            blocks[0], opt, 3, dev)
    print("compute walls (s, best of 3, CUDA events): " + ", ".join(
        f"{k}={v:.4f}" for k, v in walls.items()))
    result["walls"] = walls

    # ---- one trace of a batched decode
    with open(jam_arc, "rb") as f:
        recs = []
        while (rec := framing.read_block(f)) is not None:
            recs.append(rec)
    logdir = os.path.join(tmp, "trace")
    with metrics.device_trace(logdir) as prof:
        dd.decode_blocks_device([p for _, p in recs], [h.crc for h, _ in recs],
                                BLOCK, 120, 0, [h.lpx_spans for h, _ in recs],
                                dev)
        torch.cuda.synchronize(dev)
    trace = os.path.join(logdir, "trace.json")
    check(os.path.exists(trace) and os.path.getsize(trace) > 0,
          "device_trace wrote no trace")
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages())
    print(f"device_trace: {os.path.getsize(trace)} B of Chrome trace; "
          f"device time in it {device_us / 1e3:.3f} ms")
    result["trace"] = {"bytes": os.path.getsize(trace),
                       "device_ms": device_us / 1e3}
    return launches, result


def engines_phase(cli, engines, pipeline, dd, kernels, tmp, msrc, mixed,
                  dev) -> dict:
    """Phase 20: the stage engines on the card.  The native engine through
    `cli c|d --engine native` on phase 17's 8 MiB with no flag, -m1, -f2,
    -S0 and the JT3 stream, each byte-identical to the oracle and read
    back; the hybrid engine on the same 8 MiB, the native engine's bytes,
    its BWT on the device route; the per-stage GPU engine with -b1 on a 2
    MiB slice, -f1 (JAM) equal to the native engine's and -f3 -c16 -L4
    -u960 equal to the native engine with GpuEngine("cpu")'s -f3 filter
    stage (its torch ops on the CPU: -f3 is the one stage whose bytes are
    this engine's own; the whole run on the CPU's plain walks would take
    minutes), each read back through --engine gpu and --engine native;
    each device stage of GpuEngine on one 8 MiB block against the native
    engine's (-f3 against its CPU run), with its seconds and launches; and
    `cli i` of each framing against `python -m jampack_tpu.cli i`.
    Returns {kernel name: {run: launches}} on the engine path."""
    import functools

    from jampack_tpu_torch.format import framing

    engine_cli_ = functools.partial(engine_cli, dev=dev)
    back = os.path.join(tmp, "engine.out")
    want = mixed.tobytes()
    launches = {}
    jt3 = ["-c16", "-L4", "-u960", f"-S{SA_SPANS}", "-Sa"]
    arcs = {}
    for label, flags in (("no flag", []), ("-m1", ["-m1"]), ("-f2", ["-f2"]),
                         ("-S0", ["-S0"]), ("JT3", jt3)):
        host_arc = os.path.join(tmp, f"engine-host{len(arcs)}.arc")
        nat_arc = os.path.join(tmp, f"engine-native{len(arcs)}.arc")
        host_s = oracle(msrc, host_arc, flags)
        enc_s, _, _ = engine_cli_(cli, kernels, "c", msrc, nat_arc, flags,
                                 "native")
        check(read(nat_arc) == read(host_arc),
              f"--engine native {label}: the archive differs from the oracle's")
        dec_s, _, _ = engine_cli_(cli, kernels, "d", nat_arc, back, [],
                                 "native")
        check(read(back) == want, f"--engine native {label} did not decode")
        arcs[label] = nat_arc
        print(f"engine native {label}: `cli c` {enc_s:.3f} s, byte-identical "
              f"to the oracle ({host_s:.3f} s); `cli d` {dec_s:.3f} s, exact")

    hyb_arc = os.path.join(tmp, "engine-hybrid.arc")
    enc_s, _, enc_text = engine_cli_(cli, kernels, "c", msrc, hyb_arc, [],
                                    "hybrid")
    check(read(hyb_arc) == read(arcs["no flag"]),
          "--engine hybrid: the archive differs from the native engine's")
    dec_s, got, dec_text = engine_cli_(cli, kernels, "d", hyb_arc, back, [],
                                      "hybrid")
    check(read(back) == want, "--engine hybrid did not decode")
    nblk = count_blocks(framing, read(hyb_arc))
    for text in (enc_text, dec_text):
        check(f"bwt routes: device {nblk}, host 0" in text,
              "the hybrid BWT did not take the device route")
    # K3 chases every block but the trailing empty one (a rehearsal on the
    # CPU runs the plain versions, which launch nothing)
    check(got["ibwt_chase"] == nblk - 1 or str(dev) == "cpu",
          f"K3 ran {got['ibwt_chase']} times on the hybrid decode of "
          f"{nblk} blocks")
    launches["ibwt_chase"] = {"hybrid decode": got["ibwt_chase"]}
    print(f"engine hybrid: `cli c` {enc_s:.3f} s, the native engine's "
          f"bytes; `cli d` {dec_s:.3f} s, exact; the BWT on the device route "
          f"in {nblk} blocks each way")

    piece = mixed[-(2 << 20):]
    psrc = os.path.join(tmp, "engine-slice.bin")
    with open(psrc, "wb") as f:
        f.write(piece.tobytes())
    t0 = time.perf_counter()
    for label, flags in (("-f1", ["-b1", "-f1"]),
                         ("-f3", ["-b1", "-f3", "-c16", "-L4", "-u960"])):
        gpu_arc = os.path.join(tmp, f"engine-gpu{label}.arc")
        enc_s, got, _ = engine_cli_(cli, kernels, "c", psrc, gpu_arc, flags,
                                   "gpu")
        for name, n in got.items():
            if n:
                launches.setdefault(name, {})[f"gpu encode {label}"] = n
        if label == "-f1":
            ref_arc = os.path.join(tmp, "engine-native-slice.arc")
            engine_cli_(cli, kernels, "c", psrc, ref_arc, flags, "native")
            ref = read(ref_arc)
            what = "the native engine's"
        else:
            import io

            cpu_gpu = engines.GpuEngine("cpu")

            class CpuF3(engines.NativeEngine):
                def filters_encode(self, data, mode):
                    return cpu_gpu.filters_encode(data, mode)

            out = io.BytesIO()
            opt = cli._parse(["cli", "c", psrc, gpu_arc, *flags])[3]
            pipeline.compress_stream(io.BytesIO(piece.tobytes()), out, opt,
                                     CpuF3())
            ref = out.getvalue()
            arcs["-f3 (JTX)"] = gpu_arc
            what = "the native engine's with GpuEngine('cpu')'s -f3 stage"
        check(read(gpu_arc) == ref,
              f"--engine gpu {label}: the archive differs from {what}")
        for engine in ("gpu", "native"):
            dec_s, got, _ = engine_cli_(cli, kernels, "d", gpu_arc, back, [],
                                       engine)
            check(read(back) == piece.tobytes(),
                  f"--engine gpu {label} archive: --engine {engine} did not "
                  "decode it")
            if engine == "gpu":
                for name, n in got.items():
                    if n:
                        launches.setdefault(name, {})[
                            f"gpu decode {label}"] = n
        print(f"engine gpu {label}: `cli c` of {piece.size} B ({flags}) "
              f"{enc_s:.3f} s, equal to {what}; read back through --engine "
              f"gpu ({dec_s:.3f} s for native) and native, exact")
    print(f"engine gpu: the sub-phase took {time.perf_counter() - t0:.1f} s")

    nat, gpu = engines.NativeEngine(), engines.GpuEngine(dev)
    block = mixed[:BLOCK]
    s1 = nat.lz_encode(block, 0)
    s2 = nat.filters_encode(s1, 1)
    s3 = nat.lpx_encode(s2, 4)
    s4 = nat.lz_encode(s3, 1)
    cap = int(BLOCK * 1.05) + 1024
    fwd = nat.bwt_forward(s4, 120)
    cases = [
        ("filters_encode 1", lambda: gpu.filters_encode(s1, 1),
         lambda: nat.filters_encode(s1, 1)),
        ("filters_encode 2", lambda: gpu.filters_encode(s1, 2),
         lambda: nat.filters_encode(s1, 2)),
        ("filters_encode 3", lambda: gpu.filters_encode(s1, 3),
         lambda: engines.GpuEngine("cpu").filters_encode(s1, 3)),
        ("lpx_encode -S4", lambda: gpu.lpx_encode(s2, 4),
         lambda: nat.lpx_encode(s2, 4)),
        ("lpx_decode -S4", lambda: gpu.lpx_decode(s3, 4),
         lambda: nat.lpx_decode(s3, 4)),
        ("lz_decode -m1", lambda: gpu.lz_decode(s4, cap),
         lambda: nat.lz_decode(s4, cap)),
        ("bwt_forward", lambda: gpu.bwt_forward(s4, 120),
         lambda: nat.bwt_forward(s4, 120)),
        ("bwt_inverse", lambda: gpu.bwt_inverse(fwd, 120),
         lambda: nat.bwt_inverse(fwd, 120))]
    import numpy as np

    for label, run, ref in cases:
        run()  # the first call of a shape warms up
        zero(kernels)
        t0 = time.perf_counter()
        got = run()
        sec = time.perf_counter() - t0
        ran = {k.name: k.launches for k in kernels if k.launches}
        t0 = time.perf_counter()
        check(np.array_equal(got, np.asarray(ref(), np.uint8)),
              f"GpuEngine.{label} differs from its reference")
        ref_s = time.perf_counter() - t0
        for name, n in ran.items():
            launches.setdefault(name, {})[f"stage {label}"] = n
        print(f"engine gpu stage {label}: {sec:.4f} s on the card "
              f"({', '.join(f'{k}={v}' for k, v in ran.items()) or 'no kernel'}"
              f"), equal to its reference ({ref_s:.3f} s)")

    for label, arc in (("JAM", arcs["no flag"]), ("JTX", arcs["-f3 (JTX)"]),
                       ("JT3", arcs["JT3"])):
        _, mine = captured(cli.run, ["cli", "i", arc])
        res = subprocess.run([sys.executable, "-m", "jampack_tpu.cli", "i",
                              arc], cwd=HERE, capture_output=True, text=True,
                             timeout=120)
        check(res.returncode == 0 and res.stdout == mine,
              f"`cli i` of the {label} archive differs from the JAX CLI's")
        print(f"cli i {label}: equal to `python -m jampack_tpu.cli i`")
    return launches


def bench_phase(bench, rows) -> dict:
    """`python -m jampack_tpu_torch.bench --trials 3` in process, the
    archive group at --trials 1 (the script's time), with every kernel's
    launch count zeroed just before: every contract must hold and every
    timed key be a number; K3 must run at 120 and 1,920 units, and the
    decode and encode kernels on the block keys.  Adds each kernel's
    launches by bench key to its row as bench_launches.  Returns the
    bench's line, the archive group's keys merged in."""
    import math

    zero(bench._kernels())
    t0 = time.perf_counter()
    line = bench.run(["--trials", "3", "--keys", "bwt,block"])
    archive = bench.run(["--trials", "1", "--keys", "archive"])["extra"]
    wall = time.perf_counter() - t0
    extra = line["extra"]
    for key in ("contracts", "launches"):
        extra[key].update(archive.pop(key))
    archive["archive_trials"] = archive.pop("trials")
    extra.update({k: v for k, v in archive.items() if k not in extra})
    check(extra["contracts"] and all(extra["contracts"].values()),
          f"bench contracts {extra['contracts']}")
    timed = {"value": line["value"], **{
        k: v for k, v in extra.items()
        if k.endswith(("_mbps", "_gbps", "_ms", "_s", "_min", "_max"))}}
    # a set-up time may round to 0 (a library already built); a rate not
    bad = [k for k, v in timed.items()
           if isinstance(v, bool) or not isinstance(v, (int, float))
           or not math.isfinite(v) or v < 0 or (v == 0 and k[-2:] != "_s")]
    check(not bad, f"bench keys that are not numbers: {bad}")
    launches = extra["launches"]
    for key in ("bwt_u120", "bwt_u1920"):
        check(launches[key].get("ibwt_chase", 0) > 0,
              f"K3 did not run on the bench's {key}")
    for key, names in (
            ("decode_e2e_fused_8mb_gbps", ("rans_decode", "rank_decode",
                                           "ibwt_chase", "lz_parse",
                                           "lpx_walk")),
            ("encode_e2e_fused_8mb_mbps", ("rank_encode", "model_pairs",
                                           "rans_encode", "lpx_walk")),
            ("archive_jam_encode_fused_32mb_mbps", ("joint_hist",))):
        missing = [n for n in names if not launches[key].get(n)]
        check(not missing, f"the bench's {key} did not launch {missing}")
    for key, counts in launches.items():
        for name, n in counts.items():
            if name in rows:
                rows[name].setdefault("bench_launches", {})[key] = n
    print(f"bench: {wall:.1f} s; {bench_summary(line)}; contracts "
          f"{len(extra['contracts'])} held; launches by key {launches}")
    return line


def bench_summary(line) -> str:
    e = line["extra"]
    return (f"{line['metric']} {line['value']} {line['unit']} (forward "
            f"{e['bwt_forward_u120_ms']} ms, inverse "
            f"{e['bwt_inverse_u120_ms']} ms, K3 {e['bwt_chase_u120_ms']} "
            f"ms); decode {e['decode_e2e_fused_8mb_gbps']} GB/s, encode "
            f"{e['encode_e2e_fused_8mb_mbps']} MB/s a block")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from jampack_tpu_torch import bench, cli, dryrun, native
    from jampack_tpu_torch.format import framing
    from jampack_tpu_torch.kernels import (
        _build,
        block_scatter,
        device_stages,
        encode_stages,
        filters_search,
        hist,
        ibwt,
        lpc,
        lpx,
        rank,
        rans,
        rans_encode,
        sa,
    )
    from jampack_tpu_torch.runtime import device_decode as dd
    from jampack_tpu_torch.runtime import device_encode as de
    from jampack_tpu_torch.runtime import engines, metrics, pipeline, sharding
    from jampack_tpu_torch.runtime.options import Options

    dev = torch.device("cuda:0")
    # the fused CLI's batch (blocks of 8 MiB a card) and its cards
    per = sharding.batch_blocks(BLOCK, dev)
    cards = len(sharding.make_mesh())
    dec_kernels = [rans.KERNEL, rank.KERNEL, ibwt.KERNEL,
                   device_stages.LZ_KERNEL]
    enc_kernels = [encode_stages.RANK_KERNEL, rans_encode.PAIRS_KERNEL,
                   rans_encode.REVERSE_KERNEL]
    all_kernels = dec_kernels[:3] + enc_kernels + [
        hist.KERNEL, lpc.KERNEL, lpx.KERNEL, device_stages.LZ_KERNEL,
        block_scatter.KERNEL]
    rows = {}

    # ---- 1. facts
    card = smi("name,power.limit")
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"facts: {card}; NVIDIA {smi('driver_version')}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; triton {triton_v}; "
          f"python {sys.version.split()[0]}")

    # ---- 2. build
    t0 = time.perf_counter()
    info = _build.build()
    lib = _build.load()
    check(lib is not None, "kernel library did not load")
    ptxas = [ln.split(":", 1)[-1].strip() for ln in info["log"].splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s,"
          f" built={info['built']}); " + " | ".join(ptxas))
    lz_info = native.build()
    print(f"build: the native library (g++, one process a source) "
          f"{lz_info['seconds']:.1f} s, built={lz_info['built']}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "textlike32.bin")
        arc = os.path.join(tmp, "textlike32.jt3")
        back = os.path.join(tmp, "textlike32.out")

        # ---- 3. oracle: the production archive, encoded on the host
        with open(src, "wb") as f:
            for seed in range(NBLOCKS):
                f.write(textlike(BLOCK, seed).tobytes())
        want = read(src)
        enc_s = oracle(src, arc, PROD_FLAGS)
        blocks = []
        with open(arc, "rb") as f:
            while (rec := framing.read_block(f)) is not None:
                blocks.append(rec)
        check(len(blocks) == NBLOCKS + 1, f"{len(blocks)} blocks framed")
        check(all(h.lpx_spans == 0 and h.units == 960 and h.lanes == 4
                  for h, _ in blocks), "a block framed Lpx spans > 0")
        print(f"oracle: {NBLOCKS * BLOCK} bytes -> {os.path.getsize(arc)} in "
              f"{enc_s:.1f} s on the host (python -m jampack_tpu.cli c; first"
              f" use builds the native engine); {len(blocks)} blocks, all "
              f"lpx_spans=0")

        # ---- 4. decode kernel parity at the slice shapes of block 0
        header, payload = blocks[0]
        meta = dd.block_meta(payload, header.lanes)
        C = meta["chunk_olens"].size
        pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)
        starts = torch.from_numpy(meta["starts"]).to(dev)
        rlens = torch.from_numpy(meta["rlens"]).to(dev)
        olens = torch.from_numpy(meta["chunk_olens"]).to(dev)
        crlens = torch.from_numpy(meta["chunk_rlens"]).to(dev)
        freqs = torch.from_numpy(meta["freqs"]).to(dev)
        rmax = int(meta["rlens"].max())
        ocap = int(meta["chunk_olens"].max())
        nsym = int(meta["rlens"].clip(0).sum())
        print(f"shapes: payload {len(payload)} B, {C} chunks, {starts.numel()} "
              f"chains of <= {rmax} symbols, chunks of <= {ocap} bytes")
        (syms, ok), row = parity(
            "rans_decode",
            lambda: rans.decode_lanes_wide(pay, starts, rlens, rmax, groups=C),
            lambda: rans.decode_lanes_wide_plain(pay, starts, rlens, rmax,
                                                 groups=C), 5)
        # per symbol: two range searches of the bank, two state updates and
        # renorms, the model update; the chain runs through the state
        rows["rans_decode"] = {**row, **bound(
            nbytes(pay, starts, rlens, syms, ok), 60 * nsym, rmax, 30),
            "cycles_per_step": cycles_per_step(row["ms"], rmax)}
        print(f"rans_decode: {rows['rans_decode']['cycles_per_step']:.0f} "
              f"cycles a step over {rmax} steps, one warp a chain")
        ranks, _ = device_stages.rle0_decode(syms, crlens, olens, ocap)
        (chunk_bytes, rok), row = parity(
            "rank_decode",
            lambda: rank.rank_decode(ranks, freqs, olens, ocap),
            lambda: rank.rank_decode_plain(ranks, freqs, olens, ocap), 5)
        total = int(meta["chunk_olens"].sum())
        rows["rank_decode"] = {**row, **bound(
            nbytes(ranks, freqs, olens, chunk_bytes, rok), 8 * total, ocap, 6),
            "cycles_per_step": cycles_per_step(row["ms"], ocap),
            "walk_path": rank.rank_decode_path(ranks.shape[1])}
        print(f"rank_decode: {rows['rank_decode']['cycles_per_step']:.0f} "
              f"cycles a step over {ocap} steps; path "
              f"{rows['rank_decode']['walk_path']} (rows of "
              f"{ranks.shape[1]} B)")
        wrows, wranks, wfreqs = period256(C, CHUNK, 1)
        w_rows, w_ranks, w_freqs = (torch.from_numpy(a).to(dev)
                                    for a in (wrows, wranks, wfreqs))
        w_olens = torch.full((C,), CHUNK, dtype=torch.int32, device=dev)
        rows["rank_decode"]["worst_ms"] = worst_case(
            "rank_decode",
            lambda sl: rank.rank_decode(w_ranks[sl], w_freqs[sl],
                                        w_olens[sl], CHUNK),
            lambda sl: rank.rank_decode_plain(w_ranks[sl], w_freqs[sl],
                                              w_olens[sl], CHUNK),
            (torch.from_numpy(wrows), torch.ones(C, dtype=torch.bool)),
            rank.rank_decode_path(CHUNK))
        stage = chunk_bytes.reshape(-1)[:total]
        n = total - 4 * header.units
        nlen = n - n % header.units
        anchors = device_stages.read_anchors(stage, n, header.units)
        lf, sbyte = ibwt.combined_map(stage[:nlen], anchors[0])
        print(f"shapes: BWT stage {total} B, chase {header.units} chains x "
              f"{nlen // header.units} steps over a {nlen}-entry map")
        (body,), row = parity(
            "ibwt_chase",
            lambda: (ibwt.chase(lf, sbyte, anchors, header.units),),
            lambda: (ibwt.chase_plain(lf, sbyte, anchors, header.units),), 5)
        # "ms" is timed as every row is; ms_queued behind a busy stream, as
        # the sweep's are, so the two methods sit side by side
        queued = cuda_ms(lambda: ibwt.chase(lf, sbyte, anchors, header.units),
                         5, busy=True)
        print(f"ibwt_chase: {row['ms']:.4f} ms; {queued:.4f} ms queued")
        rows["ibwt_chase"] = {**row, **bound(
            nbytes(lf, sbyte, anchors, body), 3 * nlen, nlen // header.units,
            3), "ms_queued": queued, "jump": ibwt.JUMP,
            **chase_sweep(ibwt, lf, sbyte, anchors, header.units, body)}

        # ---- 5. decode the archive through the CLI, counting launches
        dec_s, dec_launches = decode_cli(cli, dec_kernels, arc, back)
        got = read(back)
        check(got == want, "decoded archive differs from the input")
        want_batches = cli_batches([h.lpx_spans for h, _ in blocks], per,
                                   cards)
        check(dec_launches[0] == dec_launches[1] == want_batches,
              f"rans_decode / rank_decode launched {dec_launches[:2]} times "
              f"for {want_batches} batches of {len(blocks)} blocks")
        check(dec_launches[3] == 2 * len(blocks),
              f"lz_parse launched {dec_launches[3]} times for "
              f"{len(blocks)} blocks")
        for i, (h, _) in enumerate(blocks[:NBLOCKS]):
            part = np.frombuffer(got[i * BLOCK:(i + 1) * BLOCK], np.uint8)
            check(dd.integrity_check(part) == h.crc, f"block {i} CRC")
        print(f"decode: {len(got)} bytes in {dec_s:.3f} s = "
              f"{len(got) / dec_s / 1e9:.4f} GB/s (CLI wall, host CRC "
              f"included); bytes and {NBLOCKS} block CRCs match; launches "
              + ", ".join(f"{k.name}={c}" for k, c in zip(dec_kernels,
                                                          dec_launches)))
        times = {}
        t0 = time.perf_counter()
        dd.decode_block_device(payload, header.crc, header.blocksize, header.units,
                               header.lanes, header.lpx_spans, dev, times)
        block_s = time.perf_counter() - t0
        print("block 0 stages (s, synchronized): "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; block wall {block_s:.3f} s incl. host CRC")
        # K11 on the production stream's lz stage: one token
        calls = []
        with caught(device_stages, "lz_parse", calls):
            dd.decode_block_device(payload, header.crc, header.blocksize,
                                   header.units, header.lanes,
                                   header.lpx_spans, dev)
        k11_one = k11_parity(device_stages, calls[0], dev)
        check(k11_one["tokens"] == 1, "the store stream holds more tokens")
        # the floor of any parse: one fetch of a five-int status
        status = torch.zeros(5, dtype=torch.int32, device=dev)
        k11_one["fetch_ms"] = cuda_ms(lambda: status.tolist(), 20)
        print(f"lz_parse (one token, {k11_one['stream_bytes']} B): "
              f"{k11_one['ms']:.4f} ms, launch and status fetch (a fetch "
              f"alone {k11_one['fetch_ms']:.4f} ms)")

        # ---- 6. encode kernel parity at the slice shapes of block 0
        opt = Options(blocksize=BLOCK, match_finder=3, filters=0,
                      rans_lanes=4, ans_chunk=16 << 10, anchor_units=960,
                      lpx_spans=0)
        block0 = textlike(BLOCK, 0)
        tok = torch.as_tensor(encode_stages.END_TOKEN, device=dev)
        s2 = encode_stages.filter_stage(
            torch.cat([tok, torch.from_numpy(block0).to(dev)]))
        s4 = sa.forward_bwt(torch.cat([tok, s2]), 960)
        rows_in, olens_e = encode_stages.chunk_rows(s4, opt.ans_chunk)
        print(f"shapes: encode stage {s4.numel()} B, {rows_in.shape[0]} "
              f"chunks of <= {rows_in.shape[1]} bytes")
        (ranks_e, freqs_e), row = parity(
            "rank_encode",
            lambda: encode_stages.rank_encode(rows_in, olens_e),
            lambda: encode_stages.rank_encode_plain(rows_in, olens_e), 5)
        rows["rank_encode"] = {**row, **bound(
            nbytes(rows_in, olens_e, ranks_e, freqs_e), 10 * s4.numel(),
            rows_in.shape[1], 8),
            "cycles_per_step": cycles_per_step(row["ms"], rows_in.shape[1]),
            "walk_path": encode_stages.rank_encode_path(rows_in.shape[1])}
        print(f"rank_encode: {rows['rank_encode']['cycles_per_step']:.0f} "
              f"cycles a step over {rows_in.shape[1]} steps; path "
              f"{rows['rank_encode']['walk_path']}")
        rows["rank_encode"]["worst_ms"] = worst_case(
            "rank_encode",
            lambda sl: encode_stages.rank_encode(w_rows[sl], w_olens[sl]),
            lambda sl: encode_stages.rank_encode_plain(w_rows[sl],
                                                       w_olens[sl]),
            (torch.from_numpy(wranks), torch.from_numpy(wfreqs)),
            encode_stages.rank_encode_path(CHUNK))
        del w_rows, w_ranks, w_freqs
        syms_e, rlens_e = encode_stages.rle0_encode(ranks_e, olens_e)
        chains, crlens_e, mr = encode_stages.deal(syms_e, rlens_e,
                                                  opt.rans_lanes)
        nsym_e = int(crlens_e.clamp(min=0).sum())
        print(f"shapes: {chains.shape[0]} chains of <= {int(crlens_e.max())} "
              f"symbols (max_rlen {mr})")
        (lows, fqs, oks), row = parity(
            "model_pairs",
            lambda: rans_encode.model_pairs_wide(chains, crlens_e, mr),
            lambda: rans_encode.model_pairs_wide_plain(chains, crlens_e, mr), 5)
        rows["model_pairs"] = {**row, **bound(
            nbytes(chains, crlens_e, lows, fqs, oks), 50 * nsym_e, mr, 20),
            "cycles_per_step": cycles_per_step(row["ms"], mr)}
        print(f"model_pairs: {rows['model_pairs']['cycles_per_step']:.0f} "
              f"cycles a symbol step over {mr} steps, one warp a chain")
        check(bool(oks.all()), "model pass flagged a zero-frequency op")
        (bufs, ptrs), row = parity(
            "rans_encode",
            lambda: rans_encode.rans_reverse_encode_wide(lows, fqs, crlens_e, mr),
            lambda: rans_encode.rans_reverse_encode_wide_plain(lows, fqs,
                                                               crlens_e, mr), 5)
        # two ops per symbol, each a uint32 division and up to two emissions;
        # op i and op i - 4 share a state, so the serial chain is a state's
        # ceil(2 mr / 4) ops, not the chain's 2 mr
        per_state = -(-2 * mr // 4)
        rows["rans_encode"] = {**row, **bound(
            nbytes(lows, fqs, crlens_e, bufs, ptrs), 2 * 12 * nsym_e,
            per_state, 20),
            "cycles_per_step": cycles_per_step(row["ms"], per_state)}
        print(f"rans_encode: {rows['rans_encode']['cycles_per_step']:.0f} "
              f"cycles an op of a state over {per_state} ops; bound "
              f"{rows['rans_encode']['bound_ms']:.4f} ms (a floor of all "
              f"{2 * mr} ops in series would be "
              f"{bound(0, 0, 2 * mr, 20)['bound_ms']:.4f} ms)")
        # the packing: 8, 16 or 32 lanes a chain (4, 2 or 1 chains a warp)
        lanes_ms = {}
        for lanes in (8, 16, 32):
            at = rans_encode._encode_at(lows, fqs, crlens_e, mr, lanes)
            check(all(torch.equal(a, b) for a, b in zip(at, (bufs, ptrs))),
                  f"rans_encode at {lanes} lanes a chain differs")
            lanes_ms[str(lanes)] = cuda_ms(lambda: rans_encode._encode_at(
                lows, fqs, crlens_e, mr, lanes), 5)
            print(f"rans_encode at {lanes} lanes a chain: exact, "
                  f"{lanes_ms[str(lanes)]:.4f} ms"
                  + (" (the wrapper's)" if lanes == rans_encode.LANES else ""))
        rows["rans_encode"].update(lanes=rans_encode.LANES, lanes_ms=lanes_ms)

        # ---- 7. fused -f0 encode through the CLI, counting launches
        host_arc = os.path.join(tmp, "textlike32.f0.host.jt3")
        dev_arc = os.path.join(tmp, "textlike32.f0.dev.jt3")
        host_s = oracle(src, host_arc, F0_FLAGS)
        enc_s, launches, dev_bytes = encode_cli(cli, all_kernels, src,
                                                dev_arc, F0_FLAGS)
        enc_launches = launches[3:6]
        check(dev_bytes == read(host_arc),
              "fused -f0 archive differs from the oracle's")
        nblk = count_blocks(framing, dev_bytes)
        check(nblk == NBLOCKS + 1,
              f"{nblk} blocks framed; the trailing empty block is missing")
        want_batches = cli_batches(block_lengths(len(want), BLOCK), per, cards)
        for k, c in zip(enc_kernels, enc_launches):
            check(c == want_batches, f"{k.name} launched {c} times for "
                  f"{want_batches} batches of {nblk} blocks")
        print(f"fused -f0 encode: {NBLOCKS * BLOCK} bytes -> {len(dev_bytes)} "
              f"in {enc_s:.3f} s = {NBLOCKS * BLOCK / enc_s / 1e9:.4f} GB/s "
              f"(CLI wall, host CRC and splice included); byte-identical to "
              f"the oracle ({host_s:.1f} s); {nblk} blocks, the empty one "
              f"included; launches " + ", ".join(
                  f"{k.name}={c}" for k, c in zip(all_kernels, launches)))

        # ---- 8. round trip: the fused archive decodes on the card
        rt_s, rt_launches = decode_cli(cli, dec_kernels, dev_arc, back)
        check(read(back) == want, "fused archive did not decode to the input")
        want_batches = cli_batches(span_words(framing, dev_bytes), per,
                                   cards)
        check(rt_launches[1] == want_batches,
              f"rank_decode launched {rt_launches[1]} times for "
              f"{want_batches} batches of {nblk} blocks")
        print(f"round trip: fused archive decoded in {rt_s:.3f} s, exact; "
              "launches " + ", ".join(
                  f"{k.name}={c}" for k, c in zip(dec_kernels, rt_launches)))

        # ---- 9. stage split of block 0's -f0 device encode
        times = {}
        t0 = time.perf_counter()
        crc, payload0 = de.encode_block_device(block0, opt, dev, times)
        block_s = time.perf_counter() - t0
        with open(dev_arc, "rb") as f:
            first = framing.read_block(f)
        check((crc, payload0) == (first[0].crc, first[1]),
              "block 0 encode differs from the archive's")
        print("encode -f0 block 0 stages (s; device stages synchronized): "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; block wall {block_s:.3f} s")

        # ---- 10. filter kernel parity at the shapes of an 8 MiB block
        sblock = structured(BLOCK, 0)
        s1 = torch.cat([tok, torch.from_numpy(sblock).to(dev)])
        frows, flens, flens_np = encode_stages.filter_rows(s1)
        bands, lpc_in, lpc_lens = filters_search.sweep_inputs(frows, flens,
                                                              flens_np)
        nval = int(lpc_lens.sum())
        print(f"shapes: filter stage {s1.numel()} B in {frows.shape[0]} "
              f"chunks (last {int(flens_np[-1])} B); {lpc_in.shape[0]} LPC "
              f"lanes")
        (res,), row = parity(
            "lpc (encode)",
            lambda: (lpc.lpc(lpc_in, lpc_lens, False),),
            lambda: (lpc.lpc_plain(lpc_in, lpc_lens, False),), 5)
        (dec,), row_d = parity(
            "lpc (decode)",
            lambda: (lpc.lpc(res, lpc_lens, True),),
            lambda: (lpc.lpc_plain(res, lpc_lens, True),), 5)
        j = torch.arange(lpc_in.shape[1], device=dev)[None, :]
        check(torch.equal(dec, torch.where(j < lpc_lens[:, None], lpc_in, 0)),
              "lpc decode did not invert the encode")
        steps = int(lpc_lens.max())
        # the serial floor is 2 dependent ops a step both ways, the chains
        # csrc/lpc.cu walks: decode w' = (63 w + e) >> 6, a multiply-add
        # and a shift; encode, carrying S = w + b, S' = (S + k) - 4 (S >> 8)
        # with k from input bytes alone, a shift and a multiply-add
        rows["lpc"] = {**row, **bound(nbytes(lpc_in, lpc_lens, res),
                                      8 * nval, steps, 2),
                       "cycles_per_step": cycles_per_step(row["ms"], steps),
                       "decode_ms": row_d["ms"],
                       "decode_cycles_per_step": cycles_per_step(row_d["ms"],
                                                                 steps)}
        print(f"lpc: {lpc_in.shape[0]} lanes of <= {steps} steps; encode "
              f"{rows['lpc']['cycles_per_step']:.1f} cycles a step, decode "
              f"{row_d['ms']:.4f} ms ({rows['lpc']['decode_cycles_per_step']:.1f}"
              f" cycles a step; plain {row_d['plain_ms']:.1f} ms), inverts the "
              f"encode; bound {rows['lpc']['bound_ms']:.4f} ms (2 dependent "
              f"ops a step)")
        # where the walk's time goes: the zero stores alone (every length
        # 0), and one block of 32 lanes alone on the card (a warp on each
        # of one SM's four schedulers: no other warp, no shared HBM)
        zero_ms = cuda_ms(lambda: lpc.lpc(
            lpc_in, torch.zeros_like(lpc_lens), False), 5)
        one = {}
        for d, src_t in ((False, lpc_in), (True, res)):
            x, ln = src_t[:32], lpc_lens[:32]
            t = cuda_ms(lambda: lpc.lpc(x, ln, d), 5)
            one["decode" if d else "encode"] = {
                "ms": t, "cycles_per_step": cycles_per_step(t, int(ln.max()))}
        rows["lpc"].update(zero_lens_ms=zero_ms, one_block=one)
        print(f"lpc probes: every length 0 {zero_ms:.4f} ms; one block of 32 "
              f"lanes alone: encode {one['encode']['ms']:.4f} ms ("
              f"{one['encode']['cycles_per_step']:.1f} cycles a step), decode "
              f"{one['decode']['ms']:.4f} ms "
              f"({one['decode']['cycles_per_step']:.1f})")
        lanes = torch.cat(bands + [res])
        lane_lens = torch.cat([flens.repeat(1 + 2 * 32), lpc_lens])
        del bands, dec
        _, _, c_lanes, c_lens = filters_search.f1_candidates(frows, flens)
        f1_sorted = filters_search.sorted_lanes(c_lanes, c_lens)
        k7 = {}
        for label, ln, ll in (("-f2 sweep", lanes, lane_lens),
                              ("-f1 sorted", f1_sorted, c_lens)):
            G = filters_search._GROUP
            groups = [(ln[g:g + G], ll[g:g + G])
                      for g in range(0, ln.shape[0], G)]
            err, group_ms, score_ms = 0, [], []
            for a, b in groups:
                got_t = hist.joint_hist(a, b)
                d = got_t - hist.joint_hist_plain(a, b)
                err = max(err, int(d.abs().max()))
                group_ms.append(cuda_ms(lambda: hist.joint_hist(a, b), 3))
                score_ms.append(cuda_ms(
                    lambda: filters_search._scores_from_joint(got_t, b), 3))
                del got_t, d
            check(err == 0, f"joint_hist ({label}) differs from its plain "
                            f"version (max abs err {err})")
            ms = cuda_ms(lambda: [hist.joint_hist(a, b) for a, b in groups], 3)
            plain_ms = cuda_ms(
                lambda: [hist.joint_hist_plain(a, b) for a, b in groups], 1)
            lib_ms = cuda_ms(lambda: [torch.bincount(
                hist.pair_keys(a, b), minlength=a.shape[0] * 65536 + 1)
                for a, b in groups], 1)
            # where the time goes: the same launches with every length 0
            # (zero and store the tables, count nothing), and on zero bytes
            # (every load and the walk, but all pairs (0, 0): no atomic)
            zl = torch.zeros_like(groups[0][0])
            zeros = [(a, torch.zeros_like(b)) for a, b in groups]
            store_ms = cuda_ms(lambda: [hist.joint_hist(a, b)
                                        for a, b in zeros], 3)
            zero_bytes_ms = cuda_ms(lambda: [hist.joint_hist(
                zl[:a.shape[0]], b) for a, b in groups], 3)
            del zl, zeros
            moved = nbytes(ln, ll) + ln.shape[0] * 65536 * 4
            k7[label] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "group_ms": group_ms,
                         "score_ms": sum(score_ms), "store_ms": store_ms,
                         "zero_bytes_ms": zero_bytes_ms,
                         **bound(moved, 6 * int(ll.clamp(min=0).sum()), 64, 4)}
            print(f"parity joint_hist ({label}): {ln.shape[0]} lanes in "
                  f"{len(groups)} launches, exact; kernel {ms:.3f} ms ("
                  + " / ".join(f"{t:.3f}" for t in group_ms)
                  + f" a launch), plain {plain_ms:.1f} ms, torch.bincount "
                  f"{lib_ms:.3f} ms, bound {k7[label]['bound_ms']:.3f} ms; "
                  f"the f32 scores of the same tables (filters_search."
                  f"_scores_from_joint) {sum(score_ms):.3f} ms; every length "
                  f"0 {store_ms:.3f} ms, zero bytes {zero_bytes_ms:.3f} ms")
        rows["joint_hist"] = k7["-f2 sweep"]
        del lanes, lane_lens, res

        # ---- 11. -f1: the 32 MiB through the device encode
        host_arc = os.path.join(tmp, "textlike32.f1.host.jt3")
        dev_arc = os.path.join(tmp, "textlike32.f1.dev.jt3")
        host_s = oracle(src, host_arc, F1_FLAGS)
        f1_s, f1_launches, dev_bytes = encode_cli(cli, all_kernels, src,
                                                  dev_arc, F1_FLAGS)
        check(dev_bytes == read(host_arc),
              "fused -f1 archive differs from the oracle's")
        nblk = count_blocks(framing, dev_bytes)
        check(f1_launches[6] >= nblk,
              f"joint_hist launched {f1_launches[6]} times for {nblk} blocks")
        print(f"fused -f1 encode: {NBLOCKS * BLOCK} bytes -> {len(dev_bytes)} "
              f"in {f1_s:.3f} s = {NBLOCKS * BLOCK / f1_s / 1e9:.4f} GB/s; "
              f"byte-identical to the oracle ({host_s:.1f} s); {nblk} blocks;"
              " launches " + ", ".join(
                  f"{k.name}={c}" for k, c in zip(all_kernels, f1_launches)))

        # ---- 12. -f1 on the structured 8 MiB: filters picked and applied
        ssrc = os.path.join(tmp, "structured8.bin")
        host_arc = os.path.join(tmp, "structured8.f1.host.jt3")
        dev_arc = os.path.join(tmp, "structured8.f1.dev.jt3")
        with open(ssrc, "wb") as f:
            f.write(sblock.tobytes())
        host_s = oracle(ssrc, host_arc, F1_FLAGS)
        f1s_s, f1s_launches, dev_bytes = encode_cli(cli, all_kernels, ssrc,
                                                    dev_arc, F1_FLAGS)
        check(dev_bytes == read(host_arc),
              "fused -f1 archive of the structured block differs from the "
              "oracle's")
        check(f1s_launches[6] > 0, "the structured -f1 encode did not run "
                                   "joint_hist")
        picks = filters_search.pick_f1_configs(s1)
        kinds = {name: sum(1 for t, w in picks if w and t == k)
                 for k, name in enumerate(("delta", "lpc", "inline"))}
        kinds["raw"] = sum(1 for _, w in picks if not w)
        check(kinds["raw"] < len(picks),
              "no -f1 chunk of the structured block picked a filter")
        print(f"fused -f1 encode (structured): {BLOCK} bytes -> "
              f"{len(dev_bytes)} in {f1s_s:.3f} s; byte-identical to the "
              f"oracle ({host_s:.1f} s); picks {kinds}; launches " + ", ".join(
                  f"{k.name}={c}" for k, c in zip(all_kernels, f1s_launches)))
        f1s_dec_s, _ = decode_cli(cli, dec_kernels, dev_arc, back)
        check(read(back) == sblock.tobytes(),
              "the structured -f1 archive did not decode to the input")
        print(f"-f1 decode (structured): {f1s_dec_s:.3f} s, exact")

        # ---- 13. -f2: the structured 8 MiB, encode then decode
        host_arc = os.path.join(tmp, "structured8.f2.host.jt3")
        dev_arc = os.path.join(tmp, "structured8.f2.dev.jt3")
        host_s = oracle(ssrc, host_arc, F2_FLAGS)
        f2_s, f2_launches, dev_bytes = encode_cli(cli, all_kernels, ssrc,
                                                  dev_arc, F2_FLAGS)
        check(dev_bytes == read(host_arc),
              "fused -f2 archive differs from the oracle's")
        check(f2_launches[6] > 0 and f2_launches[7] > 0,
              "the -f2 encode did not run joint_hist and lpc")
        print(f"fused -f2 encode: {BLOCK} structured bytes -> "
              f"{len(dev_bytes)} in {f2_s:.3f} s; byte-identical to the "
              f"oracle ({host_s:.1f} s); launches " + ", ".join(
                  f"{k.name}={c}" for k, c in zip(all_kernels, f2_launches)))
        f2_dec_s, f2_dec = decode_cli(cli, dec_kernels + [lpc.KERNEL],
                                      dev_arc, back)
        check(read(back) == sblock.tobytes(),
              "the -f2 archive did not decode to the input")
        print(f"-f2 decode: {f2_dec_s:.3f} s, exact; lpc (decode direction) "
              f"launched {f2_dec[-1]} times, so some chunk picked LPC")

        # ---- 14. stage splits of block 0's -f1 and -f2 encodes
        for label, data, filters in (("-f1", block0, 1),
                                     ("-f1 structured", sblock, 1),
                                     ("-f2", sblock, 2)):
            opt.filters = filters
            times = {}
            t0 = time.perf_counter()
            de.encode_block_device(data, opt, dev, times)
            block_s = time.perf_counter() - t0
            print(f"encode {label} block 0 stages (s; device stages "
                  "synchronized): "
                  + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
                  + f"; block wall {block_s:.3f} s")

        # K8 at the path's own shapes: the rows the -f2 block encode applies
        # (encode_stages) and the rows its decode inverts (device_stages),
        # caught on their way into the wrapper
        calls = {}
        for mod in (encode_stages, device_stages):
            def catch(rows_t, lens_t, decode, _real=mod.lpc, _mod=mod):
                calls[_mod.__name__] = (rows_t.clone(), lens_t.clone(), decode)
                return _real(rows_t, lens_t, decode)
            mod.lpc = catch
        try:
            de.encode_block_device(sblock, opt, dev, {})
            with open(dev_arc, "rb") as f:
                h, pay2 = framing.read_block(f)
            dd.decode_block_device(pay2, h.crc, h.blocksize, h.units, h.lanes,
                                   h.lpx_spans, dev, {})
        finally:
            encode_stages.lpc = device_stages.lpc = lpc.lpc
        check(len(calls) == 2, "the -f2 encode or decode did not run K8")
        path_ms = {}
        for rows_t, lens_t, d in calls.values():
            label = "decode" if d else "apply"
            (_,), prow = parity(f"lpc ({label}, path rows)",
                                lambda: (lpc.lpc(rows_t, lens_t, d),),
                                lambda: (lpc.lpc_plain(rows_t, lens_t, d),), 5)
            st = int(lens_t.max())
            path_ms[label] = {"rows": rows_t.shape[0],
                              "lpc_rows": int((lens_t > 0).sum()),
                              "ms": prow["ms"], "plain_ms": prow["plain_ms"],
                              "cycles_per_step": cycles_per_step(prow["ms"],
                                                                 st)}
            print(f"lpc ({label}, path rows): {rows_t.shape[0]} rows, "
                  f"{path_ms[label]['lpc_rows']} of them LPC, <= {st} steps; "
                  f"{path_ms[label]['cycles_per_step']:.1f} cycles a step")
        rows["lpc"]["path_ms"] = path_ms

        # ---- 15. Lpx with the -Sa gate: text, log records and short
        # lines, 8 MiB each, through `cli c ... -S4096 -Sa`
        lsrc = os.path.join(tmp, "lpx24.bin")
        host_arc = os.path.join(tmp, "lpx24.host.jt3")
        dev_arc = os.path.join(tmp, "lpx24.dev.jt3")
        rblock, cblock = log_records(BLOCK), short_lines(BLOCK)
        lpx_in = textlike(BLOCK, 7).tobytes() + rblock.tobytes() + \
            cblock.tobytes()
        with open(lsrc, "wb") as f:
            f.write(lpx_in)
        host_s = oracle(lsrc, host_arc, SA_FLAGS)
        sa_s, sa_launches, dev_bytes = encode_cli(cli, all_kernels, lsrc,
                                                  dev_arc, SA_FLAGS)
        check(dev_bytes == read(host_arc),
              "the -S4096 -Sa archive differs from the oracle's")
        words = span_words(framing, dev_bytes)
        check(words == [0, 0, SA_SPANS, 0],
              f"-Sa span words {words}, not [0, 0, {SA_SPANS}, 0]")
        k10, k11 = all_kernels.index(lpx.KERNEL), all_kernels.index(
            device_stages.LZ_KERNEL)
        want_batches = cli_batches(block_lengths(len(lpx_in), BLOCK), per,
                                   cards)
        check(sa_launches[k10] == want_batches,
              f"lpx_walk launched {sa_launches[k10]} times encoding "
              f"{want_batches} batches of {len(words)} blocks")
        print(f"fused -S{SA_SPANS} -Sa encode: {len(lpx_in)} bytes (text, log "
              f"records, short lines) -> {len(dev_bytes)} in {sa_s:.3f} s; "
              f"byte-identical to the oracle ({host_s:.1f} s); span words "
              f"{words}; lpx_walk launched {sa_launches[k10]} times (the "
              "stage runs before the gate, once a batch)")
        sa_dec_s, sa_dec = decode_cli(cli, dec_kernels + [lpx.KERNEL],
                                      dev_arc, back)
        check(read(back) == lpx_in, "the -Sa archive did not decode")
        check(sa_dec[-1] == cli_batches(words, per, cards, lambda w: w > 0),
              f"lpx_walk launched {sa_dec[-1]} times decoding spans {words}")
        print(f"-Sa decode: {sa_dec_s:.3f} s, exact; lpx_walk launched "
              f"{sa_dec[-1]} time(s), lz_parse {sa_dec[3]}")
        # K10 at the -S4096 shape: the short lines' block, both ways
        opt_sa = Options(blocksize=BLOCK, match_finder=3, filters=1,
                         rans_lanes=4, ans_chunk=16 << 10, anchor_units=960,
                         lpx_spans=SA_SPANS, lpx_auto=True)
        calls = []
        with caught(lpx, "lpx_walk", calls):
            crc, pay_c, spans = de.encode_block_device_ex(cblock, opt_sa, dev)
            dd.decode_block_device(pay_c, crc, BLOCK, 960, 4, spans, dev)
        check(spans == SA_SPANS and len(calls) == 2,
              "the short lines' block did not run K10 both ways")
        (buf_e, st_e, ln_e, _, mx), (buf_d, st_d, ln_d, _, _) = calls
        (enc,), row = parity(
            f"lpx_walk (encode, -S{SA_SPANS})",
            lambda: (lpx.lpx_walk(buf_e, st_e, ln_e, False, mx),),
            lambda: (lpx.lpx_walk_plain(buf_e, st_e, ln_e, False),), 5)
        (dec,), row_d = parity(
            f"lpx_walk (decode, -S{SA_SPANS})",
            lambda: (lpx.lpx_walk(buf_d, st_d, ln_d, True, mx),),
            lambda: (lpx.lpx_walk_plain(buf_d, st_d, ln_d, True),), 5)
        check(torch.equal(enc, buf_d) and torch.equal(dec, buf_e),
              "the -Sa walks do not invert each other")
        n2 = buf_e.numel()
        # the chain of a step: the record load from shared memory (counted
        # as 8 op latencies, 32 cycles) and three dependent ops (compare,
        # select, address); about 60 integer ops a byte
        rows["lpx_walk"] = {
            **row, **bound(nbytes(buf_e, st_e, ln_e, enc), 60 * n2, mx, 11),
            "spans": st_e.numel(), "steps": mx,
            "cycles_per_step": cycles_per_step(row["ms"], mx),
            "decode_ms": row_d["ms"], "decode_plain_ms": row_d["plain_ms"],
            "decode_cycles_per_step": cycles_per_step(row_d["ms"], mx)}
        # the two layouts of a span's shared memory side by side
        # (csrc/lpx_walk.cu, Banks): a multiple of 128 bytes, and one
        # record more; the headline rows use lpx.BANK_PAD
        by_pad = {}
        for pad in (0, 1):
            by_pad[str(pad)] = {}
            for label, b_, s_, l_, d_, want_p in (
                    ("encode", buf_e, st_e, ln_e, False, enc),
                    ("decode", buf_d, st_d, ln_d, True, dec)):
                check(torch.equal(lpx._lpx_walk_at(b_, s_, l_, d_, mx, pad),
                                  want_p),
                      f"lpx_walk {label} with pad {pad} differs")
                by_pad[str(pad)][label] = cuda_ms(
                    lambda: lpx._lpx_walk_at(b_, s_, l_, d_, mx, pad), 5)
        rows["lpx_walk"]["ms_by_pad"] = by_pad
        print(f"lpx_walk -S{SA_SPANS} by pad: " + "; ".join(
            f"pad {p}: encode {v['encode']:.4f} ms "
            f"({cycles_per_step(v['encode'], mx):.0f} cycles a step), decode "
            f"{v['decode']:.4f} ({cycles_per_step(v['decode'], mx):.0f})"
            for p, v in by_pad.items()) + f" (BANK_PAD {lpx.BANK_PAD})")
        # spans a warp (csrc/lpx_walk.cu, Spans a block) on the same spans,
        # each block holding the same spans: 20 is more than a block
        # holds, so all of them share one warp
        by_lanes = {}
        for lanes in (1, 2, 5, 20):
            by_lanes[str(lanes)] = {}
            for label, b_, s_, l_, d_, want_p in (
                    ("encode", buf_e, st_e, ln_e, False, enc),
                    ("decode", buf_d, st_d, ln_d, True, dec)):
                check(torch.equal(lpx._lpx_walk_at(b_, s_, l_, d_, mx,
                                                   lanes=lanes), want_p),
                      f"lpx_walk {label} with {lanes} spans a warp differs")
                by_lanes[str(lanes)][label] = cuda_ms(
                    lambda: lpx._lpx_walk_at(b_, s_, l_, d_, mx, lanes=lanes),
                    5)
        rows["lpx_walk"].update(lanes=lpx.SPANS_A_WARP, ms_by_lanes=by_lanes)
        # eight-word records on the same spans beside the four words the
        # wrapper takes here (csrc/lpx_walk.cu: half the spans an SM)
        eight = {}
        for label, b_, s_, l_, d_, want_p in (
                ("encode", buf_e, st_e, ln_e, False, enc),
                ("decode", buf_d, st_d, ln_d, True, dec)):
            check(torch.equal(lpx._lpx_walk_at(b_, s_, l_, d_, mx, wide=True),
                              want_p),
                  f"lpx_walk {label} with eight-word records differs")
            eight[label] = cuda_ms(
                lambda: lpx._lpx_walk_at(b_, s_, l_, d_, mx, wide=True), 5)
        rows["lpx_walk"]["eight_word_ms"] = eight
        print(f"lpx_walk -S{SA_SPANS} with eight-word records: encode "
              f"{eight['encode']:.4f} ms, decode {eight['decode']:.4f}")
        print(f"lpx_walk -S{SA_SPANS} by spans a warp: " + "; ".join(
            f"{p}: encode {v['encode']:.4f} ms "
            f"({cycles_per_step(v['encode'], mx):.0f} cycles a step), decode "
            f"{v['decode']:.4f} ({cycles_per_step(v['decode'], mx):.0f})"
            for p, v in by_lanes.items())
            + f" (SPANS_A_WARP {lpx.SPANS_A_WARP})")
        print(f"lpx_walk -S{SA_SPANS}: {st_e.numel()} spans of <= {mx} B over "
              f"{n2} B; encode {row['ms']:.4f} ms "
              f"({rows['lpx_walk']['cycles_per_step']:.0f} cycles a step), "
              f"decode {row_d['ms']:.4f} ms "
              f"({rows['lpx_walk']['decode_cycles_per_step']:.0f}); bound "
              f"{rows['lpx_walk']['bound_ms']:.4f} ms")
        times = {}
        t0 = time.perf_counter()
        de.encode_block_device_ex(cblock, opt_sa, dev, times)
        enc_wall = time.perf_counter() - t0
        dtimes = {}
        t0 = time.perf_counter()
        dd.decode_block_device(pay_c, crc, BLOCK, 960, 4, spans, dev, dtimes)
        dec_wall = time.perf_counter() - t0
        print(f"encode -S{SA_SPANS} -Sa block (short lines) stages (s): "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; block wall {enc_wall:.3f} s; decode stages (s): "
              + ", ".join(f"{k}={v:.4f}" for k, v in dtimes.items())
              + f"; block wall {dec_wall:.3f} s")

        # ---- 16. JAM framing, -S4: the log records through `cli c -m3
        # -f1 -S4`, 4 spans of 2 MiB (wide records, a 64 KiB ring)
        rsrc = os.path.join(tmp, "records8.bin")
        host_arc = os.path.join(tmp, "records8.host.jam")
        dev_arc = os.path.join(tmp, "records8.dev.jam")
        with open(rsrc, "wb") as f:
            f.write(rblock.tobytes())
        host_s = oracle(rsrc, host_arc, JAM_FLAGS)
        jam_s, jam_launches, dev_bytes = encode_cli(cli, all_kernels, rsrc,
                                                    dev_arc, JAM_FLAGS)
        check(dev_bytes == read(host_arc),
              "the -m3 -f1 -S4 archive differs from the oracle's")
        check(dev_bytes[:3] == b"JAM", "the -S4 archive is not JAM-framed")
        words = span_words(framing, dev_bytes)
        check(jam_launches[k10] == cli_batches(
            block_lengths(rblock.size, BLOCK), per, cards),
              f"lpx_walk launched {jam_launches[k10]} times for "
              f"{len(words)} blocks")
        jam_dec_s, jam_dec = decode_cli(cli, dec_kernels + [lpx.KERNEL],
                                        dev_arc, back)
        check(read(back) == rblock.tobytes(), "the JAM archive did not decode")
        check(jam_dec[-1] == cli_batches(words, per, cards, lambda w: w > 0),
              "K10 did not run once a batch of the decode")
        print(f"fused -m3 -f1 -S4 (JAM): {BLOCK} bytes of log records -> "
              f"{len(dev_bytes)} in {jam_s:.3f} s, byte-identical to the "
              f"oracle ({host_s:.1f} s); decoded in {jam_dec_s:.3f} s, "
              f"exact; lpx_walk {jam_launches[k10]} + {jam_dec[-1]} launches")
        opt_jam = Options(blocksize=BLOCK, match_finder=3, filters=1,
                          lpx_spans=4)
        calls = []
        with caught(lpx, "lpx_walk", calls):
            crc, pay_r, spans = de.encode_block_device_ex(rblock, opt_jam,
                                                          dev)
            dd.decode_block_device(pay_r, crc, BLOCK, 120, 0, spans, dev)
        check(len(calls) == 2, "the JAM block did not run K10 both ways")
        # both layouts of a record: eight words (the wrapper's past 64
        # KiB) and four, which must give the same bytes
        jam, jam_four = {}, {}
        for (b_, s_, l_, d_, m_) in calls:
            label = "decode" if d_ else "encode"
            check(torch.equal(lpx._lpx_walk_at(b_, s_, l_, d_, m_, wide=False),
                              lpx.lpx_walk(b_, s_, l_, d_, m_)),
                  f"lpx_walk {label} (JAM) differs with four-word records")
            jam[label] = cuda_ms(lambda: lpx.lpx_walk(b_, s_, l_, d_, m_), 2)
            jam_four[label] = cuda_ms(
                lambda: lpx._lpx_walk_at(b_, s_, l_, d_, m_, wide=False), 2)
        jmx = calls[0][4]
        rows["lpx_walk"].update(
            jam_spans=calls[0][1].numel(), jam_steps=jmx,
            jam_ms=jam, jam_four_word_ms=jam_four, jam_bound_ms=bound(
                nbytes(calls[0][0]) * 2, 60 * calls[0][0].numel(), jmx,
                11)["bound_ms"],
            jam_cycles_per_step={k: cycles_per_step(v, jmx)
                                 for k, v in jam.items()})
        print(f"lpx_walk -S4 (JAM): {calls[0][1].numel()} spans of <= {jmx} "
              f"B; encode {jam['encode']:.3f} ms, decode {jam['decode']:.3f} "
              f"ms ({rows['lpx_walk']['jam_cycles_per_step']['encode']:.0f} /"
              f" {rows['lpx_walk']['jam_cycles_per_step']['decode']:.0f} "
              f"cycles a step); four-word records {jam_four['encode']:.3f} /"
              f" {jam_four['decode']:.3f} ms; bound "
              f"{rows['lpx_walk']['jam_bound_ms']:.3f} ms (held against the "
              "oracle: the plain walk would take minutes)")

        # ---- 17. the reference's default flags (-m0 -f1 -S4, JAM) and -m1
        # on 8 MiB of text, a tenth of it log records, through `cli d`
        msrc = os.path.join(tmp, "mixed8.bin")
        mixed = np.concatenate([textlike(BLOCK - BLOCK // 10, 3),
                                log_records(BLOCK // 10)])
        with open(msrc, "wb") as f:
            f.write(mixed.tobytes())
        k11, k11_launches, oracle_s = {}, {}, {}
        for label, flags in (("-m0", []), ("-m1", ["-m1"])):
            marc = os.path.join(tmp, f"mixed8{label}.jam")
            host_s = oracle_s[label] = oracle(msrc, marc, flags)
            nblk = count_blocks(framing, read(marc))
            m_s, m_launches = decode_cli(cli, dec_kernels + [lpx.KERNEL],
                                         marc, back)
            check(read(back) == mixed.tobytes(),
                  f"the {label} archive did not decode")
            words = span_words(framing, read(marc))
            check(m_launches[3] == 2 * nblk and m_launches[-1] == cli_batches(
                words, per, cards, lambda w: w > 0),
                  f"{label}: lz_parse {m_launches[3]}, lpx_walk "
                  f"{m_launches[-1]} launches for {nblk} blocks")
            with open(marc, "rb") as f:
                h, pay_m = framing.read_block(f)
            calls = []
            with caught(device_stages, "lz_parse", calls):
                dd.decode_block_device(pay_m, h.crc, h.blocksize, h.units,
                                       h.lanes, h.lpx_spans, dev)
            k11[label] = k11_parity(device_stages, calls[0], dev)
            k11_launches[label] = m_launches[3]
            if label == "-m1":
                k11_d = k11_sweep(device_stages, calls[0],
                                  device_stages.lz_parse(*calls[0]))
            print(f"default flags {label}: oracle {host_s:.1f} s; `cli d` "
                  f"{m_s:.3f} s, exact; lz_parse {m_launches[3]} launches "
                  f"(2 a block), lpx_walk {m_launches[-1]} (once a batch); "
                  f"the lz stage: "
                  f"{k11[label]['tokens']} tokens over "
                  f"{k11[label]['stream_bytes']} B, K11 "
                  f"{k11[label]['ms']:.4f} ms "
                  f"({k11[label]['cycles_per_token']:.0f} cycles a token, "
                  f"launch and status fetch included), plain "
                  f"{k11[label]['plain_ms']:.1f} ms")
        # the headline: the -m1 stage beside the -m1 decode's launches;
        # each other stage beside the launches of its own path's run
        rows["lz_parse"] = {
            **k11["-m1"], **k11_d,
            "m0": {**k11["-m0"], "path": "decode -m0 -f1 -S4 (JAM)",
                   "launches": k11_launches["-m0"]},
            "one_token": {**k11_one, "path": "decode (production JT3)",
                          "launches": dec_launches[3]}}

        # ---- 18. the host-LZ encode route: `cli c` with the reference's
        # default flags (-m0 -f1 -S4, JAM), -m1, -m2 and the -m0 JT3
        # stream on the same data, byte-identical to the oracle, decoded
        lz_launches, k6_jam = host_lz_route(
            cli, de, dd, encode_stages, all_kernels, dec_kernels, lpx, tmp,
            msrc, mixed, oracle_s, dev)
        for name, launches in lz_launches.items():
            rows[name]["host_lz_launches"] = launches
        rows["rank_encode"].update(k6_jam)

        # ---- 19. A9: a token-dense -m1 archive, written and read by the
        # port
        rows["lz_parse"]["token_dense"] = token_dense(
            cli, dd, device_stages, all_kernels, dec_kernels, lpx, tmp, dev)

        # ---- 20. the stage engines: native, hybrid, the per-stage gpu
        engine_launches = engines_phase(
            cli, engines, pipeline, dd, all_kernels, tmp, msrc, mixed, dev)
        for name, runs in engine_launches.items():
            rows[name]["engine_launches"] = runs

        # ---- 23. batched blocks, two workers on one card, the flagship
        # step, the dry run, the compute walls and the trace
        batch_launches, batch23 = batch_phase(
            cli, dd, de, device_stages, encode_stages, lpx, rans, rank,
            rans_encode, sharding, metrics, dryrun, all_kernels, tmp, src,
            arc, os.path.join(tmp, "textlike32.f1.host.jt3"), want, per,
            cards, dev)
        for name, runs in batch_launches.items():
            rows[name]["batch_launches"] = runs
        print("phase23 " + json.dumps(batch23))

    # ---- 21. golden fixtures: all eight archives
    import io

    fixtures = os.path.join(HERE, "tests", "fixtures")
    gold = read(os.path.join(fixtures, "golden_input.bin"))
    names = sorted(f for f in os.listdir(fixtures)
                   if f.startswith("golden_") and not f.endswith(".bin"))
    check(len(names) == 8, f"{len(names)} golden archives, not 8")
    for name in names:
        out = io.BytesIO()
        dd.decompress_stream_device(io.BytesIO(read(os.path.join(
            fixtures, name))), out, dev)
        check(out.getvalue() == gold, f"golden {name} decoded wrongly")
    print(f"golden: {', '.join(names)} -> {len(gold)} bytes each, exact")

    # ---- 22. K9: the block scatter of the DMA measuring tool
    rng = np.random.default_rng(0)
    k9 = {}
    for S in (1024, 4096, 16384):
        nb = min((8 << 20) // S, 8192)  # the tool's sizes
        src_t = torch.arange(nb * S, dtype=torch.int32, device=dev)
        offs = torch.from_numpy(rng.permutation(nb).astype(np.int32)).to(dev)
        offs_l = offs.long()
        (got,), row = parity(
            f"block_scatter S={S}",
            lambda: (block_scatter.block_scatter(src_t, offs, S),),
            lambda: (block_scatter.block_scatter_plain(src_t, offs, S),), 20,
            busy=True)
        check(torch.equal(got.view(nb, S)[offs_l], src_t.view(nb, S)),
              f"block_scatter S={S} misplaced a block")
        lib_out = torch.empty_like(src_t)
        lib_ms = cuda_ms(lambda: lib_out.view(nb, S).index_copy_(
            0, offs_l, src_t.view(nb, S)), 20, busy=True)
        k9[S] = {**row, "library_ms": lib_ms,
                 **bound(nbytes(src_t, offs, got), 0, 0, 0)}
        print(f"block_scatter S={S}: {nb} blocks, {nbytes(src_t) >> 20} MiB; "
              f"kernel {row['ms']:.4f} ms, index_copy_ {lib_ms:.4f} ms, "
              f"bound {k9[S]['bound_ms']:.4f} ms (bytes)")
    rows["block_scatter"] = {**k9[1024], "ms_by_S": {
        str(S): r["ms"] for S, r in k9.items()}}

    # ---- 24. the bench, in process, every launch count zeroed first
    bench_line = bench_phase(bench, rows)
    print("phase24 " + json.dumps(bench_line))

    # launches: each kernel's count on the path that runs it (decode, the
    # -f0 encode, the -f1 encode for K7, the -f2 encode for K8, the
    # -S4096 -Sa encode for K10, the -m1 decode for K11, whose other paths
    # are in its row); K9 is on no path
    paths = ["decode"] * 3 + ["encode -f0"] * 3 + [
        "encode -f1", "encode -f2", "encode -S4096 -Sa", "decode -m1 (JAM)",
        "tool"]
    path_launches = dec_launches[:3] + enc_launches + [
        f1_launches[6], f2_launches[7], sa_launches[k10],
        k11_launches["-m1"], 0]
    check("jampack_tpu" not in sys.modules, "the JAX package was imported")
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "path": p, "launches": c, **rows[k.name]}
        for k, p, c in zip(all_kernels, paths, path_launches)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
