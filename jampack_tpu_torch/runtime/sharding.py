"""Several blocks on several cards: the port's counterpart of
jampack_tpu/runtime/sharding.py.

The format is embarrassingly parallel (each framed block is
self-contained), so an archive spreads over the cards of a host block by
block.  The JAX package's mesh becomes a list of devices (make_mesh), and
shard_map becomes one host thread per mesh entry, each with a CUDA stream
of its own on its card: a window of blocks is read, cut into one run of
consecutive blocks per entry, each run goes through the batched block
chain on its card (device_decode.decode_blocks_device,
device_encode.encode_blocks_device), and the blocks are written in file
order as the window finishes.  An entry may repeat: ["cuda:0", "cuda:0"]
runs two workers on one card.  ["cpu", ...] runs the plain versions of
the kernels, for tests.

JAX's sharded_full_decode_step and sharded_full_encode_step have no
counterpart of their own: the per-entry worker (_decode_run, _encode_run)
is that step, and its batch of blocks replaces one block a chip.  The
psum of sharded_codec_step's metric is a sum on the host.  There is no
host engine on any branch: a block that JAX sends to compress_block_ex
(tiny tails, stragglers, the static-split Lpx corner) runs the card's
encode, and a block that JAX decodes on the host (a span split beyond its
static layout) runs the card's decode, which takes any split.

Multi-host: runtime/distributed.py divides blocks between processes; each
process drives its local cards through this module.
"""

import contextvars
import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve
from ..format import framing
from .device_decode import decode_blocks_device
from .device_encode import encode_block_device_ex, encode_blocks_device
from .metrics import span
from .options import LZ_MODE_STORE
from .sysinfo import available_memory, device_memory, gpu_devices

# The batch's peak device memory, as fixed + per_block * B bytes for B
# blocks, in units of the block size: the larger of the decode's and the
# encode's fits, rounded up, from torch.cuda.max_memory_allocated at 1 and
# 4 blocks of 8 MiB (chip_smoke.py phase 23 on an H100: 46.70 + 87.99 B).
# The batch beat one block at a time there (PERF.md), so batch_blocks takes
# the largest B within 80% of the card, the budget of
# sysinfo.fits_on_device, and at most MAX_BATCH: the largest batch that
# phase 23 runs on the card (32 blocks of 8 MiB decoded and encoded, bytes
# and the reserved peak checked), since the fit is not held to a larger one.
PEAK_FIXED_PER_BYTE = 47.0
PEAK_PER_BLOCK_PER_BYTE = 88.0
MAX_BATCH = 32
# Host bytes a window holds a block, in block sizes: the block read or its
# record, its output (payload or plaintext), and the batch's joined
# payloads and their upload copy.
HOST_BYTES_PER_BLOCK = 4


def make_mesh(n_devices=None) -> list:
    """The devices blocks are dealt to: every card of this host (None), the
    first n_devices of them (an int), or an explicit list such as
    ["cuda:0", "cuda:1"], ["cuda:0", "cuda:0"] (two workers on one card) or
    ["cpu"] * 3.  Without a card only an explicit list of "cpu" entries is
    a mesh."""
    if isinstance(n_devices, (list, tuple)):
        mesh = []
        for d in n_devices:
            dev = resolve(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
                raise ValueError(f"no CUDA device {dev} on this machine")
            mesh.append(dev)
    else:
        mesh = gpu_devices()
        if not mesh:
            raise RuntimeError(
                "no CUDA device: the sharded paths run on the GPU (pass an "
                "explicit list such as ['cpu'] to run the plain versions)")
        if n_devices is not None:
            mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def batch_blocks(blocksize: int, device, workers: int = 1) -> int:
    """Blocks of `blocksize` bytes in one batch on `device` for each of
    `workers` mesh entries that share it: as many as keep their batches'
    peak memory together within 80% of the card (host memory for the
    CPU), the payloads of a batch under 2^31 bytes (K1's and K10's int32
    offsets), and at most MAX_BATCH; at least 1."""
    dev = resolve(device)
    budget = 0.8 * (device_memory(dev) if dev.type == "cuda"
                    else available_memory()) / max(workers, 1)
    size = max(int(blocksize), 1)
    fit = (budget / size - PEAK_FIXED_PER_BYTE) // PEAK_PER_BLOCK_PER_BYTE
    offsets = (2**31 - 1) // (2 * size)
    return int(max(1, min(fit, offsets, MAX_BATCH)))


def _mesh_batch(mesh: list, blocksize: int) -> int:
    """The batch of every entry of `mesh`: batch_blocks' on the entry's
    device shared with the entries on the same one, the least over the
    mesh, and no more than keeps the window (HOST_BYTES_PER_BLOCK block
    sizes a block of every entry) within 80% of the host's available
    memory; at least 1."""
    host = 0.8 * available_memory() // (
        HOST_BYTES_PER_BLOCK * max(int(blocksize), 1) * len(mesh))
    return int(max(1, min(host, min(batch_blocks(blocksize, d, mesh.count(d))
                                    for d in mesh))))


class _Workers:
    """One host thread per CUDA mesh entry, which makes its card current
    and runs every job on a stream of its own; the CPU entries share one
    thread (the plain versions hold the interpreter lock between their
    small tensor ops, so threads of their own would only contend).  A job
    is fn(device, *args), run in a copy of the submitter's context, so that
    its spans belong to the submitter's op and span."""

    def __init__(self, mesh):
        with span("workers.start"):
            self.mesh = list(mesh)
            cpu = ThreadPoolExecutor(1)
            self.pools = [ThreadPoolExecutor(1) if d.type == "cuda" else cpu
                          for d in self.mesh]
            self.streams = [None] * len(self.mesh)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with span("workers.stop"):
            for pool in set(self.pools):
                pool.shutdown(wait=True)

    def submit(self, k: int, fn, *args):
        return self.pools[k].submit(contextvars.copy_context().run,
                                    self._run, k, fn, *args)

    def _run(self, k: int, fn, *args):
        dev = self.mesh[k]
        if dev.type != "cuda":
            return fn(dev, *args)
        with span("workers.start"):
            torch.cuda.set_device(dev)
            if self.streams[k] is None:
                self.streams[k] = torch.cuda.Stream(dev)
        with torch.cuda.stream(self.streams[k]):
            return fn(dev, *args)


def _runs(items: list, parts: int) -> list:
    """items cut into at most `parts` runs of consecutive items, as even as
    can be, each with the index of its first item."""
    per = -(-len(items) // parts)
    return [(i, items[i:i + per]) for i in range(0, len(items), per)]


# ---------------------------------------------------------------------------
# The flagship step (JAX's codec_block_step) and its data-parallel runs


def codec_block_step(block: torch.Tensor):
    """The full transform cycle on one block on its device: Lpx over 4
    equal spans (K10), the forward BWT (sa.sa_doubling_core and
    bwt_from_prev_sorted) with its anchors ISA[u * step] + 1 (bwt.cpp:
    44-48), then the inverses: the LF map (ibwt.combined_map) with the
    anchored chase (K3) and the Lpx decode.  Returns (reconstruction,
    bwt, metric), metric the uint32 sum of the BWT bytes, as JAX's
    codec_block_step does.  Lpx runs only where 4 divides n (n >= 4), and
    the chase takes 120 units where 120 divides n, else 1."""
    from ..kernels.ibwt import chase, combined_map
    from ..kernels.lpx import lpx_walk
    from ..kernels.sa import bwt_from_prev_sorted, sa_doubling_core

    n = block.numel()
    units = 120 if n % 120 == 0 else 1
    step = n // units

    def lpx(buf, decode):
        if n % 4 != 0 or n < 4:
            return buf
        starts = torch.arange(4, dtype=torch.int32, device=buf.device) * (
            n // 4)
        lens = torch.full((4,), n // 4, dtype=torch.int32, device=buf.device)
        return lpx_walk(buf.contiguous(), starts, lens, decode, n // 4)

    filtered = lpx(block, decode=False)
    _, isa, prev_sorted = sa_doubling_core(filtered, n)
    bwt = bwt_from_prev_sorted(prev_sorted, isa[0], n)
    anchors = (isa[: units * step: step] + 1).to(torch.int32)
    lf, sbyte = combined_map(bwt, anchors[0])
    recon = lpx(chase(lf, sbyte, anchors, units), decode=True)
    metric = bwt.to(torch.int64).sum() & 0xFFFFFFFF
    return recon, bwt, metric


def sharded_codec_step(mesh):
    """The data-parallel step over `mesh` (a make_mesh list): step(blocks)
    takes (B, L) uint8 blocks, B a multiple of the mesh size, gives each
    entry B / D consecutive rows, runs codec_block_step on each row on the
    entry's card, and returns (reconstruction (B, L), bwt (B, L), the
    uint32 sum of every row's metric), gathered in block order."""
    mesh = list(mesh)

    def run(dev, rows):
        got = []
        for row in rows:
            recon, bwt, metric = codec_block_step(
                torch.from_numpy(np.array(row, np.uint8)).to(dev))
            got.append((recon.cpu().numpy(), bwt.cpu().numpy(), int(metric)))
        return got

    def step(blocks):
        blocks = np.asarray(blocks, np.uint8)
        B, D = blocks.shape[0], len(mesh)
        if B % D:
            raise ValueError(f"{B} blocks do not divide over {D} devices")
        per = B // D
        with _Workers(mesh) as workers:
            futures = [workers.submit(k, run, blocks[k * per:(k + 1) * per])
                       for k in range(D)]
            rows = [r for f in futures for r in f.result()]
        recon = np.stack([r for r, _, _ in rows]).reshape(blocks.shape)
        bwt = np.stack([b for _, b, _ in rows]).reshape(blocks.shape)
        return recon, bwt, sum(m for _, _, m in rows) & 0xFFFFFFFF

    return step


def roundtrip_blocks(blocks: np.ndarray, mesh=None):
    """Host entry: blocks (B, L) uint8, B divisible by the mesh size.
    Returns (reconstruction, bwt, metric) gathered in block order."""
    mesh = make_mesh(mesh)
    recon, bwt, metric = sharded_codec_step(mesh)(blocks)
    return recon, bwt, int(metric)


# ---------------------------------------------------------------------------
# Archives across the mesh


def _decode_run(dev, recs, first: int):
    headers = [h for h, _ in recs]
    return decode_blocks_device(
        [p for _, p in recs], [h.crc for h in headers],
        max(h.blocksize for h in headers), headers[0].units,
        headers[0].lanes, [h.lpx_spans for h in headers], dev,
        _idx_map=range(first, first + len(recs)))


def decode_archive_to(inp, out, mesh=None, progress=None):
    """Decode the archive in file object `inp` across `mesh` (a make_mesh
    argument; None: every card) into file object `out`, one window of
    (mesh entries x _mesh_batch) blocks at a time: each entry decodes its
    run of the window's blocks in batches (decode_blocks_device: a batch a
    span-word group), each block is CRC-checked on the host, and the
    window is written in file order before the next is read.  A corrupt
    block raises ValueError
    naming its index in the archive.  progress(raw, comp) is called after
    each block is written.  Returns (raw bytes, compressed bytes)."""
    mesh = make_mesh(mesh)
    raw = comp = index = 0
    first = None
    with _Workers(mesh) as workers:
        while True:
            window = []
            limit = None
            with span("archive.read"):
                while limit is None or len(window) < limit:
                    rec = framing.read_block(inp)
                    if rec is None:
                        break
                    h = rec[0]
                    if first is None:
                        first = h
                    elif (h.units, h.lanes) != (first.units, first.lanes):
                        raise ValueError(
                            "mixed stream parameters in one archive")
                    window.append(rec)
                    if limit is None:
                        limit = _mesh_batch(mesh, h.blocksize) * len(mesh)
            if not window:
                break
            with span("archive.window", blocks=len(window)):
                runs = _runs(window, len(mesh))
                futures = [workers.submit(k, _decode_run, run, index + start)
                           for k, (start, run) in enumerate(runs)]
                for future, (_, run) in zip(futures, runs):
                    with span("archive.wait"):
                        done = future.result()
                    for data, (h, _) in zip(done, run):
                        with span("archive.write", bytes=data.size):
                            out.write(data.tobytes())
                            raw += data.size
                            comp += h.csize + framing.header_size(
                                h.units, h.lanes, h.lpx_spans)
                            if progress is not None:
                                progress(raw, comp)
            index += len(window)
    return raw, comp


def decode_archive_sharded(inp, mesh=None, progress=None) -> bytes:
    """Decode a whole archive (file object) across `mesh` and return the
    plaintext bytes in file order (the JAX function's contract):
    decode_archive_to into memory."""
    buf = io.BytesIO()
    decode_archive_to(inp, buf, mesh, progress)
    return buf.getvalue()


def _encode_run(dev, blocks, opt):
    if int(opt.match_finder) != LZ_MODE_STORE:
        # the host LZ finders of -m0/-m1/-m2 run block by block around the
        # card's front and back
        return [encode_block_device_ex(b, opt, dev) for b in blocks]
    got = [None] * len(blocks)
    by_len = {}
    for i, b in enumerate(blocks):
        by_len.setdefault(b.size, []).append(i)
    for idxs in by_len.values():
        for i, res in zip(idxs, encode_blocks_device(
                [blocks[i] for i in idxs], opt, dev)):
            got[i] = res
    return got


def encode_archive_sharded(inp, out, opt, mesh=None, engine=None,
                           progress=None):
    """Compress a whole stream from file object `inp` into `out` across
    `mesh`, one window of (mesh entries x _mesh_batch) raw blocks at a
    time: each entry encodes its run of the window's blocks on its card,
    -m3 in batches of same-length blocks (encode_blocks_device),
    -m0/-m1/-m2 one block at a time (encode_block_device_ex: the host
    finders around the card's front and back), and the framed blocks are
    written in file order.  Keeps the reference's feof rule (jampack.cpp:205-214): an input
    of K * blocksize bytes, K = 0 included, gets a trailing empty block.
    Archives are byte-identical to the native engine's.  `engine` is the
    JAX signature's host engine, which the port does not take: no block
    goes to a host engine.  Returns (raw bytes, compressed bytes)."""
    if engine is not None:
        raise ValueError("the sharded device encode runs no host engine")
    if int(opt.match_finder) not in (0, 1, 2, LZ_MODE_STORE) \
            or opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "device encode supports match_finder 0-3 + filters 0/1/2")
    mesh = make_mesh(mesh)
    per = _mesh_batch(mesh, opt.blocksize)
    raw = comp = 0
    pending_empty = True
    eof = False
    with _Workers(mesh) as workers:
        while not eof:
            window = []
            with span("archive.read"):
                while len(window) < per * len(mesh):
                    blob = inp.read(opt.blocksize)
                    if len(blob) == 0:
                        if pending_empty:
                            window.append(np.zeros(0, np.uint8))
                        eof = True
                        break
                    window.append(np.frombuffer(blob, dtype=np.uint8))
                    pending_empty = len(blob) == opt.blocksize
            if not window:
                break
            with span("archive.window", blocks=len(window)):
                runs = _runs(window, len(mesh))
                futures = [workers.submit(k, _encode_run, run, opt)
                           for k, (_, run) in enumerate(runs)]
                for future, (_, run) in zip(futures, runs):
                    with span("archive.wait"):
                        done = future.result()
                    for (crc, payload, spans), block in zip(done, run):
                        size = len(payload) + framing.header_size(
                            opt.anchor_units, opt.rans_lanes, spans)
                        with span("archive.write", bytes=size):
                            framing.write_block(out, crc, payload,
                                                opt.blocksize,
                                                opt.anchor_units,
                                                opt.rans_lanes, spans)
                            raw += block.size
                            comp += size
                            if progress is not None:
                                progress(raw, comp)
    return raw, comp
