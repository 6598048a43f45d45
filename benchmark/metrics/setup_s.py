"""setup_s: process start to the first timed op (host clock): starting
Python and torch, the kernel and native libraries (built on a checkout's
first run, loaded after), the corpus, the archives the port writes and the
warm-up ops."""


def read(run, metric):
    return run.setup_s
