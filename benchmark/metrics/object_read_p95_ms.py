"""object_read_p95_ms: the 95th percentile (nearest rank) of the latency
of every read in the window, each timed on the host clock from the call
of cli.run to its return.  The median and the count go to stderr."""

import math
import sys


def read(run, metric):
    ms = sorted((r.end - r.start) * 1e3 for r in run.records)
    p95 = ms[math.ceil(0.95 * len(ms)) - 1]
    print(f"object reads: {len(ms)}, median {ms[len(ms) // 2]:.3f} ms, "
          f"p95 {p95:.3f} ms", file=sys.stderr)
    return p95
