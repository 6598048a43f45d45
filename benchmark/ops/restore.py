"""Restore: one archive, restored again and again.

Set-up makes the archive's raw bytes from the seed (archive_bytes of the
configuration, block i of the traffic's class i mod 4), has the port write
it with the configuration's flags, and restores it once to warm up.  Each
op of the window is `cli d archive <sink>`, and must give back every raw
byte."""

import itertools

import numpy as np

from ..harness import Job


def setup(ctx):
    count = int(ctx.config["archive_bytes"]) // int(ctx.config["block_bytes"])
    data = np.concatenate([ctx.block(i) for i in range(count)])
    job = Job("d", ctx.encode(data, "archive"), data)
    ctx.warm(job)
    return itertools.repeat(job)
