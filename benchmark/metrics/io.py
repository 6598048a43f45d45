"""io.<op>: time an op in file I/O (cli.py, runtime/sharding.py):
cli.open (opening the input and the output, which on a FIFO waits for its
reader), archive.read (the framed blocks read), archive.write (each
block's write into the output and the progress) and cli.close (closing
and flushing the files, the summary line), in the metric's unit (s or
ms)."""

from ._program import per_op

NAMES = ("cli.open", "archive.read", "archive.write", "cli.close")


def read(run, metric):
    return per_op(run, metric, lambda name: name in NAMES)
