"""backup_mbps: the raw bytes every backup in the window read (the size of
its source file: a record's `raw` is the archive it had to write), 1e6
bytes a MB, over the window's whole time, first op's start to last op's
end (host clock).  File read, the encode and the write into the sink
count."""

import os


def read(run, metric):
    return (sum(os.path.getsize(r.source) for r in run.records) / 1e6
            / run.window_s)
