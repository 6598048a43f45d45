"""Multi-host orchestration (SURVEY.md §5.8): the port's counterpart of
jampack_tpu/runtime/distributed.py.

The format is embarrassingly parallel: each framed block is self-contained
(magic+crc+csize+bsize, jampack.cpp:122-164), so multi-host scaling is
deterministic work division plus in-order stitching — no cross-host data
dependencies, nothing to broadcast at decode time (all model tables are
in-stream per chunk).

Scheme: host p of P owns blocks {i : i mod P == p}.  Each host streams its
blocks (others are skipped cheaply via the csize field without decoding),
writes `<out>.part<p>` plus a block-size manifest, and `stitch()`
concatenates parts in block order.  owner, decompress_stream_part,
compress_stream_part, stitch_archive and stitch are host code, copies of
the JAX package's line for line (tests/test_torch_standalone.py holds
them equal); a host drives its local cards through runtime/sharding.py.
initialize() is torch.distributed's rendezvous over gloo: the parts share
no data, so the processes need only meet, and NCCL would have nothing to
carry.
"""

import json
import os

from ..format import framing
from .pipeline import decompress_block


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """torch.distributed bring-up: a gloo process group that meets at
    coordinator_address ("host:port"); no-op when single-process (the
    common local case and the unit-test case)."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group initialize() joined; no-op when there is
    none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def owner(block_index: int, process_count: int) -> int:
    """Deterministic block -> host assignment (round robin)."""
    return block_index % max(process_count, 1)


def decompress_stream_part(inp, out_dir: str, process_id: int,
                           process_count: int, engine=None) -> dict:
    """Decode this host's blocks from a full archive stream.

    Writes `part<p>` and `manifest<p>.json` into out_dir; returns the
    manifest (block index -> decoded size) for this host.
    """
    os.makedirs(out_dir, exist_ok=True)
    part_path = os.path.join(out_dir, f"part{process_id}")
    sizes = {}
    with open(part_path, "wb") as out:
        index = 0
        while True:
            mine = owner(index, process_count) == process_id
            # skip non-owned payloads (seek, don't read): each host touches
            # only ~1/P of the archive bytes
            rec = framing.read_block(inp, want_payload=mine)
            if rec is None:
                break
            header, payload = rec
            if mine:
                data = decompress_block(payload, header.crc, engine,
                                        header.blocksize, header.units,
                                        header.lanes, header.lpx_spans)
                out.write(data.tobytes())
                sizes[index] = int(data.size)
            index += 1
    manifest = {"process_id": process_id, "sizes": sizes}
    with open(os.path.join(out_dir, f"manifest{process_id}.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def compress_stream_part(inp, total_size: int, out_dir: str,
                         process_id: int, process_count: int, opt,
                         engine=None) -> dict:
    """Compress this host's blocks of a seekable raw input.

    Host p owns raw blocks {i : i mod P == p}; each is read at its offset
    (other hosts' bytes are never touched), compressed, and written FRAMED
    to `apart<p>` — a stitched archive is just the framed blocks in block
    order, so the stitch is pure concatenation.  Replicates the feof-driven
    trailing-empty-block semantics (jampack.cpp:205-214): an input of
    exactly K*blocksize bytes (including K = 0) carries one extra EMPTY
    block, owned by whichever host the round robin lands on.
    Returns the manifest (block index -> framed byte count)."""
    from .pipeline import compress_block_ex

    os.makedirs(out_dir, exist_ok=True)
    bs = int(opt.blocksize)
    n_blocks = (total_size // bs) + 1 if total_size % bs == 0 \
        else -(-total_size // bs)
    part_path = os.path.join(out_dir, f"apart{process_id}")
    sizes = {}
    import numpy as np

    with open(part_path, "wb") as out:
        for index in range(n_blocks):
            if owner(index, process_count) != process_id:
                continue
            inp.seek(index * bs)
            blob = inp.read(min(bs, max(total_size - index * bs, 0)))
            data = np.frombuffer(blob, dtype=np.uint8)
            crc, payload, spans = compress_block_ex(data, opt, engine)
            pos0 = out.tell()
            framing.write_block(out, crc, payload, opt.blocksize,
                                opt.anchor_units, opt.rans_lanes,
                                spans)
            sizes[index] = out.tell() - pos0
    manifest = {"process_id": process_id, "sizes": sizes,
                "n_blocks": n_blocks}
    with open(os.path.join(out_dir, f"amanifest{process_id}.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def stitch_archive(out_dir: str, out_path: str, process_count: int) -> int:
    """Concatenate per-host FRAMED archive parts in block order; returns
    total archive bytes.  Raises on manifest gaps (a failed host or a
    mismatched process count) — the encode mirror of stitch()."""
    from contextlib import ExitStack

    manifests = []
    n_blocks = None
    for p in range(process_count):
        with open(os.path.join(out_dir, f"amanifest{p}.json")) as f:
            m = json.load(f)
        manifests.append({int(k): v for k, v in m["sizes"].items()})
        if n_blocks is None:
            n_blocks = m["n_blocks"]
        elif m["n_blocks"] != n_blocks:
            raise ValueError("hosts disagree on the block count")
    for index in range(n_blocks):
        if index not in manifests[owner(index, process_count)]:
            raise ValueError(
                f"manifest gap at block {index}: a host part is missing or "
                f"was produced with a different process count"
            )
    total = 0
    with ExitStack() as stack:
        readers = [
            stack.enter_context(
                open(os.path.join(out_dir, f"apart{p}"), "rb")
            )
            for p in range(process_count)
        ]
        out = stack.enter_context(open(out_path, "wb"))
        for index in range(n_blocks):
            p = owner(index, process_count)
            size = manifests[p][index]
            out.write(readers[p].read(size))
            total += size
    return total


def stitch(out_dir: str, out_path: str, process_count: int) -> int:
    """Concatenate per-host parts in block order; returns total bytes.

    Raises if the manifests do not cover a contiguous block range 0..N-1
    (a host failed or ran with a different process_count)."""
    from contextlib import ExitStack

    manifests = []
    for p in range(process_count):
        with open(os.path.join(out_dir, f"manifest{p}.json")) as f:
            m = json.load(f)
        manifests.append({int(k): v for k, v in m["sizes"].items()})
    n_blocks = sum(len(m) for m in manifests)
    for index in range(n_blocks):
        if index not in manifests[owner(index, process_count)]:
            raise ValueError(
                f"manifest gap at block {index}: a host part is missing or "
                f"was produced with a different process count"
            )
    total = 0
    with ExitStack() as stack:
        readers = [
            stack.enter_context(
                open(os.path.join(out_dir, f"part{p}"), "rb")
            )
            for p in range(process_count)
        ]
        out = stack.enter_context(open(out_path, "wb"))
        for index in range(n_blocks):
            p = owner(index, process_count)
            size = manifests[p][index]
            out.write(readers[p].read(size))
            total += size
    return total
