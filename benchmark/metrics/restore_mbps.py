"""restore_mbps: the raw bytes of every restore in the window (1e6 bytes a
MB) over the window's whole time, first op's start to last op's end (host
clock).  File read, the CRC check and the write into the sink count."""


def read(run, metric):
    return sum(r.raw for r in run.records) / 1e6 / run.window_s
