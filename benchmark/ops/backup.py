"""Backup: one raw corpus, written into an archive again and again.

Set-up makes archive_bytes of corpus from the seed (block_bytes blocks,
block i of the traffic's class i mod 4, as the restore mix does), writes it
to work/backup.raw, where it stays, and has the port write it once with
the configuration's flags, to work/backup (its size counts into
stored_pct).  The set-up encode is the window's own op on the same bytes
and cards, so it has warmed every shape; no other warm-up runs.

The port's encode is deterministic, so each op of the window,
`cli c backup.raw <sink>`, must write that archive byte for byte
(reference/compare.py compares as the bytes come).  Once the window has
closed (harness Context.after), that archive is judged against the raw
bytes twice:

  plain_blocks_bad     the plain decoder (reference/jam_decode.py): every
                       block's framing, entropy framing and header
                       checksum, and a full decode of `verify_per_class`
                       blocks of each class, drawn from the seed, and of
                       the trailing block, each of which must give back
                       its raw bytes exactly; the blocks that fail
  restore_bytes_wrong  the port's own restore of the whole archive
                       (`cli d`), every byte against the raw bytes: a
                       second witness, which sees a fault in any block

The window's op passes no flags (harness Context.do), so a configuration
with flags cannot run this op: set-up refuses it."""

import itertools
import os
import sys
import time

import numpy as np

from ..harness import Job
from ..reference import jam_decode


def sample(ctx, count: int) -> list:
    """The blocks decoded in full: verify_per_class of each class's
    blocks, drawn from the seed, and the trailing one (block `count`,
    empty under the end-of-file rule)."""
    per = int(ctx.traffic["verify_per_class"])
    kinds = len(ctx.traffic["classes"])
    rng = ctx.rng("verify")
    full = [count]
    for c in range(kinds):
        ids = np.arange(c, count, kinds)
        full += rng.choice(ids, min(per, ids.size), replace=False).tolist()
    return sorted(full)


def plain_check(ctx, archive: str, raw: str, count: int) -> dict:
    """plain_blocks_bad: the blocks of the archive the plain decoder finds
    at fault (every block where it cannot read the archive at all)."""
    block = int(ctx.config["block_bytes"])
    full = sample(ctx, count)
    start = time.perf_counter()
    try:
        got = jam_decode.verify(archive, raw, block, full,
                                workers=min(os.cpu_count() or 1, len(full)))
        bad = [(g["block"], g["error"] or g["wrong"]) for g in got
               if g["error"] or g["wrong"]]
    except jam_decode.CorruptArchive as e:
        got, bad = [], [(b, str(e)) for b in range(count + 1)]
    decoded = [g for g in got if g["full"]]
    print(f"after the window: the plain decoder checked {len(got)} blocks in "
          f"{time.perf_counter() - start:.3f} s: blocks {full} decoded in "
          f"full ({sum(g['bytes'] for g in decoded)} bytes), every block's "
          f"framing and checksum; at fault: {bad[:4]}", file=sys.stderr)
    return {"plain_blocks_bad": [len(bad), 0]}


def restore_check(ctx, archive: str, data: np.ndarray) -> dict:
    """restore_bytes_wrong: the bytes the port's restore of the archive
    gives back wrong, missing or extra (all of them where it fails)."""
    start = time.perf_counter()
    rec = ctx.do(Job("d", archive, data))
    wrong = rec.wrong if rec.ok else max(rec.wrong, data.size)
    print(f"after the window: the port's restore of the archive took "
          f"{time.perf_counter() - start:.3f} s, {wrong} bytes wrong",
          file=sys.stderr)
    return {"restore_bytes_wrong": [wrong, 0]}


def setup(ctx):
    flags = ctx.config["flags"]
    if flags:
        raise RuntimeError(f"the backup op runs no flags ({' '.join(flags)}"
                           f"): the window's cli c passes none")
    block = int(ctx.config["block_bytes"])
    count = int(ctx.config["archive_bytes"]) // block
    data = np.concatenate([ctx.block(i) for i in range(count)])
    raw, archive = ctx.path("backup.raw"), ctx.path("backup")
    with open(raw, "wb") as f:
        f.write(data.tobytes())
    if not ctx.cli("c", raw, archive):
        raise RuntimeError("set-up: cli c failed on the backup corpus")
    ctx.stored += os.path.getsize(archive)
    ctx.raw += data.size
    with open(archive, "rb") as f:
        answer = np.frombuffer(f.read(), np.uint8)
    ctx.after += [lambda: restore_check(ctx, archive, data),
                  lambda: plain_check(ctx, archive, raw, count)]
    return itertools.repeat(Job("c", raw, answer, archive))
