"""Inputs for the Lpx span walk (K10) and the LZ token parse (K11), shared
by the CPU tests (port against the JAX package) and the gpu tests (kernel
against its plain version).  Made with numpy from seeds and the port's own
token writer; nothing here imports jax or jampack_tpu."""

import numpy as np

from jampack_tpu_torch.format.varint import encode_leb128
from jampack_tpu_torch.stages.lz77 import write_token


def log_records(n: int) -> np.ndarray:
    """Log-like records (a copy of tests/test_lpx_skip.py::_records): field
    names repeat per line, so Lpx runs fire; ids vary."""
    out = bytearray()
    i = 0
    while len(out) < n:
        out += b"ts=2026-08-20T09:%02d:%02d level=INFO module=core id=%06d\n" \
            % (i // 60 % 60, i % 60, i)
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)


def lpx_inputs():
    """The seven inputs of tests/test_lpx_tpu.py (its lpx_inputs, from the
    same seed)."""
    rng = np.random.default_rng(77)
    yield np.zeros(0, dtype=np.uint8)
    yield rng.integers(0, 256, 3, dtype=np.uint8)           # degenerate < 4
    yield rng.integers(0, 256, 4001, dtype=np.uint8)        # uneven spans
    # strongly LPX-triggering: repeated records with a shared prefix byte
    rec = b"\x10ABCDEFGH" * 40
    yield np.frombuffer((rec + b"\x10ABCDxFGH" + rec) * 12, dtype=np.uint8)
    yield np.zeros(9000, dtype=np.uint8)                    # all-zero runs
    yield np.tile(np.arange(7, dtype=np.uint8), 3000)       # periodic
    yield np.frombuffer(b"the quick brown fox " * 800, dtype=np.uint8)


def span_bytes(kind: str, n: int, seed: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "random":
        return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    at = 61 * (seed % 61)  # a line is 61 bytes: start at another place
    return log_records(n + at)[at:]


def token_stream(tokens: int, seed: int, tail: int = 5, fill: int = None,
                 end: bool = True) -> np.ndarray:
    """A valid LZ77 token stream of `tokens` tokens before the end token,
    in the -m1 format: literal runs of 0-24 bytes (7 and more take the
    literal extension), matches of 4-80 bytes (35 and more take the match
    extension) at offsets that stay inside the output, then the end token
    and `tail` raw bytes.  fill: every literal byte is this one instead of
    a random one; end=False: no end token and no tail, the last literal run
    ends the stream."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    out_len = 0
    for _ in range(tokens):
        lit = max(int(rng.integers(0, 25)), 1 - out_len)
        match = int(rng.integers(4, 81))
        off = int(rng.integers(1, out_len + lit + 1))
        out += write_token(match, lit, off)
        lits = rng.integers(0, 256, lit, dtype=np.uint8)
        out += (bytes([fill]) * lit if fill is not None else lits.tobytes())
        out_len += lit + match
    if end:
        out += write_token(4, 4, 0)
        out += rng.integers(0, 256, tail, dtype=np.uint8).tobytes()
    return np.frombuffer(bytes(out), np.uint8)


def _wrapped_literal_stream() -> np.ndarray:
    """Token 0x07 (literal extension follows), offset 1, a 5-byte literal
    extension making lit = 2^31 - 1, then 64 zero bytes: the next token's
    position wraps int32 negative."""
    ext = encode_leb128(2**31 - 1 - 7)
    assert len(ext) == 5
    return np.frombuffer(bytes([0x07, 0x81]) + ext + bytes(64), np.uint8)


LZ_CASES = ["wrapped", "truncated", "max_tokens", "out_cap",
            "before_start", "many_tokens", "empty", "end_first",
            "bad_first", "ends_at_n", "bad_off_chain", "slots_exact"]
# the parse's bad flag on each case
LZ_BAD = {"wrapped": True, "truncated": True, "max_tokens": True,
          "out_cap": True, "before_start": True, "many_tokens": False,
          "empty": False, "end_first": False, "bad_first": True,
          "ends_at_n": True, "bad_off_chain": False, "slots_exact": False}


def lz_case(name: str):
    """(buf, n, max_tokens, out_cap) of one parse case; LZ_BAD says which
    set the parse's bad flag."""
    if name == "wrapped":
        buf = _wrapped_literal_stream()
        return buf, buf.size, 8, 1 << 20
    if name == "truncated":
        buf = token_stream(40, 1)
        cut = buf[:buf.size // 2].copy()
        return cut, cut.size, 64, 1 << 20
    if name == "max_tokens":
        buf = token_stream(40, 2)
        return buf, buf.size, 16, 1 << 20
    if name == "out_cap":
        buf = token_stream(40, 3)
        return buf, buf.size, 64, 300
    if name == "before_start":
        buf = np.frombuffer(write_token(10, 2, 50) + b"ab"
                            + write_token(4, 4, 0) + b"xyz", np.uint8)
        return buf, buf.size, 8, 1 << 20
    if name == "empty":  # n = 0 over a buffer that holds a stream
        return token_stream(3, 5), 0, 8, 1 << 20
    if name == "end_first":  # the end token at byte 0: one raw run
        buf = np.frombuffer(write_token(4, 4, 0) + bytes(range(40)),
                            np.uint8)
        return buf, buf.size, 8, 1 << 20
    if name == "bad_first":  # an offset of 2^31 reads as negative
        buf = np.frombuffer(write_token(9, 3, 2**31) + b"abc"
                            + bytes(token_stream(30, 6)), np.uint8)
        return buf, buf.size, 64, 1 << 20
    if name == "ends_at_n":  # no end token: the last run ends at n
        buf = token_stream(30, 7, end=False)
        return buf, buf.size, 64, 1 << 20
    if name == "bad_off_chain":
        # every literal byte 0x7F: a token read inside a run has an offset
        # and a literal run of 2^28 and more, past n, so most positions off
        # the chain hold a bad token
        buf = token_stream(60, 8, fill=0x7F)
        return buf, buf.size, 64, 1 << 20
    if name == "slots_exact":  # t = max_tokens + 1, every slot used
        buf = token_stream(40, 9)
        return buf, buf.size, 40, 1 << 20
    buf = token_stream(3000, 4)
    return buf, buf.size, 4096, 1 << 20


def short_lines(n: int) -> np.ndarray:
    """10-byte records ("%05d,1,OK\\n", a copy of chip_smoke.short_lines):
    at -m1 -f0 -S0 128 KiB of them hold 11,918 LZ tokens, one every 11
    bytes."""
    out = bytearray()
    i = 0
    while len(out) < n:
        out += b"%05d,1,OK\n" % (i % 100000)
        i += 1
    return np.frombuffer(bytes(out[:n]), np.uint8)
