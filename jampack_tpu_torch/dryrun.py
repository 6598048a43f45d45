"""Entry points of the port for a one-block run of the flagship step and a
multi-device dry run (the counterparts of the JAX package's
__graft_entry__.py entry and dryrun_multichip).

    python -m jampack_tpu_torch.dryrun            # every card of the host
    python -m jampack_tpu_torch.dryrun cuda:0 cuda:0

The archives are made by the port's NativeEngine (the bytes the JAX dry
run's spec engine writes, in a fraction of its time).
"""

import io
import sys

import numpy as np
import torch

from .format import framing
from .runtime.engines import NativeEngine
from .runtime.options import Options
from .runtime.pipeline import compress_stream
from .runtime.sharding import (
    codec_block_step,
    decode_archive_sharded,
    encode_archive_sharded,
    make_mesh,
    roundtrip_blocks,
)


def entry(device="cuda"):
    """(fn, example_args): the flagship step, the full BWT codec cycle
    (Lpx, suffix sort, BWT emission, anchor planting, LF map, 120-chain
    inverse chase, Lpx inverse) on one block of 120 x 512 random bytes on
    `device`."""
    block = np.random.default_rng(0).integers(0, 256, 120 * 512,
                                              dtype=np.uint8)
    return codec_block_step, (torch.from_numpy(block).to(device),)


class _Chunked:
    """A reader whose read() returns the next part, whatever it is asked
    for: one framed block a part at a larger block size."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.i = 0

    def read(self, _size):
        if self.i >= len(self.parts):
            return b""
        part = self.parts[self.i]
        self.i += 1
        return part.tobytes()


def _host_archive(parts, opt) -> bytes:
    arc = io.BytesIO()
    compress_stream(_Chunked(parts), arc, opt, engine=NativeEngine())
    return arc.getvalue()


def dryrun_multichip(mesh=None) -> None:
    """Multi-device validation on real archive bytes across `mesh` (a
    make_mesh argument: None for every card, or a list such as
    ["cuda:0", "cuda:0"] or ["cpu", "cpu"]); raises AssertionError on a
    mismatch.  The JAX dry run's five checks: a multi-block -f2 -m0 -L4
    -c2 -u16 archive decoded across the mesh; the sharded -m3 -f1 -S8
    encode, byte-identical to the host engine and decoded back; a JT3
    -S96 archive of ragged blocks; 48 KiB -Sa blocks whose gate keeps Lpx
    on the records (span word 8) and drops it on random bytes (0), encoded
    and decoded across the mesh; a corrupt payload whose error names
    block 2.  Then roundtrip_blocks, the flagship step, a block a mesh
    entry."""
    mesh = make_mesh(mesh)
    D = len(mesh)
    rng = np.random.default_rng(1)

    # one block a device plus a ragged extra batch
    blocks = []
    for _ in range(D + max(2, D // 2)):
        n = int(rng.integers(1500, 4000))
        rec = np.frombuffer(
            b"".join(bytes([i % 256, (i * 3) % 256, 7]) for i in range(n // 6)),
            dtype=np.uint8)
        txt = np.frombuffer(
            (b"multichip decode " * (n // 17 + 1))[: n // 3], dtype=np.uint8)
        noise = rng.integers(0, 5, n // 4).astype(np.uint8)
        dupe = rec[:400].copy()  # repeats a chunk -> LZ dedupe tokens
        blocks.append(np.concatenate([rec, txt, noise, dupe]))
    plain = b"".join(x.tobytes() for x in blocks)
    opt = Options(blocksize=1 << 20, filters=2, match_finder=0, rans_lanes=4,
                  ans_chunk=2048, anchor_units=16)
    if decode_archive_sharded(io.BytesIO(_host_archive(blocks, opt)),
                              mesh) != plain:
        raise AssertionError("multichip device decode mismatch")

    # the sharded encode: byte-identical to the host engine, read back
    eopt = Options(blocksize=1 << 20, filters=1, match_finder=3,
                   rans_lanes=4, ans_chunk=2048, anchor_units=16,
                   lpx_spans=8)
    eplain = plain[: 4096 * (D + 1) + 1500]
    eparts = [np.frombuffer(eplain[i: i + 4096], dtype=np.uint8)
              for i in range(0, len(eplain), 4096)]
    earc = io.BytesIO()
    encode_archive_sharded(_Chunked(eparts), earc, eopt, mesh)
    if earc.getvalue() != _host_archive(eparts, eopt):
        raise AssertionError("multichip device encode archive mismatch")
    if decode_archive_sharded(io.BytesIO(earc.getvalue()), mesh) != eplain:
        raise AssertionError("multichip encode->decode roundtrip mismatch")

    # JT3 large-span stream with mixed block lengths
    jopt = Options(blocksize=1 << 20, filters=0, match_finder=0,
                   rans_lanes=4, ans_chunk=2048, anchor_units=16,
                   lpx_spans=96)
    jparts = [np.frombuffer(plain[a:b], dtype=np.uint8)
              for a, b in ((0, 3600), (3600, 7200), (7200, 8500))]
    jarc = _host_archive(jparts, jopt)
    if decode_archive_sharded(io.BytesIO(jarc), mesh) != plain[:8500]:
        raise AssertionError("multichip JT3 large-span decode mismatch")

    # the per-block Lpx gate across the mesh: records keep spans = 8,
    # random bytes drop to 0
    gopt = Options(blocksize=1 << 20, filters=0, match_finder=3,
                   rans_lanes=4, ans_chunk=2048, anchor_units=8,
                   lpx_spans=8, lpx_auto=True)
    gk = 48 << 10
    out = bytearray()
    i = 0
    while len(out) < gk:
        out += (b"ts=2026-08-20T09:%02d:%02d level=INFO module=core "
                b"id=%06d\n" % (i // 60 % 60, i % 60, i))
        i += 1
    rec_blk = np.frombuffer(bytes(out[:gk]), np.uint8)
    rnd_blk = np.random.default_rng(7).integers(0, 256, gk).astype(np.uint8)
    gparts = [rec_blk, rnd_blk] * max(1, D // 2)
    gplain = b"".join(p.tobytes() for p in gparts)
    garc = io.BytesIO()
    encode_archive_sharded(_Chunked(gparts), garc, gopt, mesh)
    if garc.getvalue() != _host_archive(gparts, gopt):
        raise AssertionError("mesh-parallel auto-gate archive mismatch")
    garc.seek(0)
    spans_seen = set()
    while (rec := framing.read_block(garc, want_payload=False)) is not None:
        spans_seen.add(rec[0].lpx_spans)
    if spans_seen != {0, 8}:
        raise AssertionError(
            f"the gate must keep Lpx on the records (spans 8) and drop it "
            f"on random bytes (spans 0); the archive carries "
            f"{sorted(spans_seen)}")
    if decode_archive_sharded(io.BytesIO(garc.getvalue()), mesh) != gplain:
        raise AssertionError("mesh-parallel auto-gate decode mismatch")

    # one corrupt payload: the error names its block
    bad = bytearray(jarc)
    bad[len(bad) - 700] ^= 0x20  # inside the last block's payload
    try:
        decode_archive_sharded(io.BytesIO(bytes(bad)), mesh)
    except ValueError as e:
        if "block 2" not in str(e):
            raise AssertionError(
                f"corrupt-block error must name block 2, got: {e}") from e
    else:
        raise AssertionError("corrupt block decoded without error")

    # the flagship step, a block a mesh entry
    tblocks = rng.integers(0, 256, (D, 120 * 16), dtype=np.uint8)
    recon, bwt, metric = roundtrip_blocks(tblocks, mesh)
    if not np.array_equal(recon, tblocks):
        raise AssertionError("multichip transform roundtrip mismatch")
    if metric != int(bwt.astype(np.uint64).sum()) & 0xFFFFFFFF:
        raise AssertionError("multichip transform metric mismatch")


if __name__ == "__main__":
    dryrun_multichip(sys.argv[1:] or None)
    print("dryrun_multichip: ok")
