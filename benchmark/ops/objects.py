"""Object reads: a store of small archives, read with Zipf popularity.

YCSB workload C (Cooper et al., SoCC 2010): 100% reads, request
popularity Zipfian with constant 0.99, keys scrambled so that popularity
does not follow key order.  Each object is stored as one archive the port
wrote in set-up, and each read is one `cli d` of one object's archive,
which must give back the object's bytes.

The work is the same for every seed: the object sizes lie on a fixed
log-uniform grid from min_bytes to max_bytes, object i takes class i mod
the traffic's classes, a permutation from layout_seed ranks them by
popularity, and a cycle of reads holds each object's share of `cycle`
reads (largest remainders, at least one).  In a cycle an object's k reads
fall one in each k-th of it, each at a place in its k-th drawn from the
seed (a jittered systematic order), so that every run of reads, and so a
window of any length, holds each object's share to within a read or two.
The seed gives the objects' bytes (a slice of their class's corpus block
at an offset from the seed) and the order of the reads.

Set-up warms one read a launch shape: the block runtime sizes a read's
buffers and grids by powers of two of its chunk count and payload
(runtime/device_decode.plan_shapes), and the kernels are built before any
read, so a class and a power-of-two bucket of the raw size stand for a
shape.  The largest object of each pair is read once, so that the
allocator holds blocks large enough for every other read of it."""

import numpy as np

from ..harness import Job


def sizes(traffic: dict) -> np.ndarray:
    n = int(traffic["objects"])
    lo, hi = int(traffic["min_bytes"]), int(traffic["max_bytes"])
    return np.rint(lo * (hi / lo) ** (np.arange(n) / max(n - 1, 1))).astype(
        np.int64)


def shares(traffic: dict) -> np.ndarray:
    """Reads of each object in one cycle, by object index."""
    n, cycle = int(traffic["objects"]), int(traffic["cycle"])
    p = 1.0 / np.arange(1, n + 1) ** float(traffic["zipf"])
    want = cycle * p / p.sum()
    count = np.floor(want).astype(np.int64)
    count[np.argsort(count - want)[:cycle - int(count.sum())]] += 1
    rank = np.random.default_rng(int(traffic["layout_seed"])).permutation(n)
    out = np.zeros(n, np.int64)
    out[rank] = np.maximum(count, 1)
    return out


def warm_set(traffic: dict) -> list:
    """The objects set-up reads: the largest of each class and
    power-of-two bucket of the size."""
    kinds = len(traffic["classes"])
    largest = {}
    for i, size in enumerate(sizes(traffic).tolist()):
        largest[i % kinds, (size - 1).bit_length()] = i
    return sorted(largest.values())


def setup(ctx):
    t = ctx.traffic
    kinds = len(t["classes"])
    blocks = [ctx.block(k) for k in range(kinds)]
    rng = ctx.rng("objects")
    jobs = []
    for i, size in enumerate(sizes(t).tolist()):
        block = blocks[i % kinds]
        at = int(rng.integers(0, block.size - size + 1))
        data = block[at:at + size]
        jobs.append(Job("d", ctx.encode(data, f"object{i:04d}"), data))
    for i in warm_set(t):
        ctx.warm(jobs[i])
    counts = shares(t)
    ids = np.repeat(np.arange(len(jobs)), counts)
    order = ctx.rng("reads")

    def reads():
        while True:
            at = np.concatenate([(np.arange(c) + order.random(c)) / c
                                 for c in counts.tolist()])
            for i in ids[np.argsort(at, kind="stable")].tolist():
                yield jobs[i]

    return reads()
