"""The comparison that decides `correct` for ops that give bytes back.

A lossless restore has one right answer: the bytes the benchmark made from
the seed before the port ever saw them.  The port writes each op's output
into a FIFO; a thread of this module reads it as it comes and compares
every byte with that answer, so nothing of the output reaches a disk and
nothing of it is kept.  Plain NumPy; it takes nothing from the program
but the bytes it wrote."""

import fcntl
import os
import queue
import threading

import numpy as np

CHUNK = 1 << 20


class Sink:
    """A FIFO at `path` and the thread that checks what arrives there.

    expect(answer) before each op that writes to `path`; result() after it
    gives the bytes wrong, a byte missing or extra counting as wrong."""

    def __init__(self, path: str):
        os.mkfifo(path)
        self.path = path
        self._jobs = queue.Queue()
        self._done = queue.Queue()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="benchmark-sink")
        self._thread.start()

    def expect(self, answer: np.ndarray) -> None:
        self._jobs.put(np.asarray(answer, np.uint8).reshape(-1))

    def result(self, opened: bool = True, timeout: float = 120.0):
        """The bytes wrong of the op last expected.  opened=False: the op
        may have failed before it opened the FIFO, so the writer's end is
        opened and closed here, which ends the read."""
        for _ in range(int(timeout / 0.2) if not opened else 0):
            try:
                return self._done.get(timeout=0.2)
            except queue.Empty:
                pass
            try:  # ENXIO until the reader waits in open()
                os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
            except OSError:
                pass
        return self._done.get(timeout=timeout)

    def close(self) -> None:
        self._jobs.put(None)
        self._thread.join(timeout=10.0)
        os.unlink(self.path)

    def _serve(self) -> None:
        buf = bytearray(CHUNK)
        view = memoryview(buf)
        while (answer := self._jobs.get()) is not None:
            got = wrong = 0
            with open(self.path, "rb", buffering=0) as f:
                try:  # fewer hand-overs between the writer and this thread
                    fcntl.fcntl(f.fileno(), fcntl.F_SETPIPE_SZ, CHUNK)
                except OSError:
                    pass
                while k := f.readinto(buf):
                    want = answer[got:got + k]
                    part = np.frombuffer(view[:want.size], np.uint8)
                    wrong += int(np.count_nonzero(part != want))
                    wrong += k - want.size
                    got += k
            self._done.put(wrong + max(answer.size - got, 0))
