"""Cases of the wide rANS chain decode (K1) that the one-warp-per-chain
layout has to get right, shared by the CPU and GPU tests.

Each case is (buf (n,) uint8, starts (L,) int32, rlens (L,) int32,
max_rlen, groups).  The chains are symbol chains encoded one by one with the
spec's encode_pairs, their payloads laid end to end."""

import numpy as np

from jampack_tpu.format.tables import EXPONENT, MODEL_ALPHABET
from jampack_tpu.stages.ans import encode_pairs

CASES = ["all_exponents", "rescales", "stretch", "garbage", "padding",
         "buffer_end", "truncated", "classic", "lanes16"]


def _symbols(rng, n, exps, p_top=0.0):
    """n symbols with exponents drawn from `exps`, mantissas uniform in
    their alphabet; with probability p_top the symbol is 256 instead (e = 7,
    mantissa 128, the last count of the widest quasi model)."""
    e = rng.choice(np.asarray(exps), n)
    m = (rng.random(n) * MODEL_ALPHABET[e]).astype(np.int64)
    s = EXPONENT[e] + m
    return np.where(rng.random(n) < p_top, 256, s).astype(np.uint16)


def _lay_out(chains, pad=64, cut=0):
    payloads = [encode_pairs(c) for c in chains]
    starts = np.cumsum([0] + [len(p) for p in payloads[:-1]]).astype(np.int32)
    buf = np.frombuffer(b"".join(payloads), np.uint8)
    buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    if cut:
        buf = buf[:-cut]
    rlens = np.asarray([len(c) for c in chains], np.int32)
    return buf, starts, rlens


def case(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name == "all_exponents":  # every exponent, symbol 256 included
        chains = [_symbols(rng, 1500, range(8), 0.02) for _ in range(4)]
        buf, starts, rlens = _lay_out(chains)
        return buf, starts, rlens, 1500, 1
    if name == "rescales":  # ~800 symbols a quasi model: 6 rescales each
        chains = [_symbols(rng, 5000, range(2, 8)) for _ in range(2)]
        buf, starts, rlens = _lay_out(chains)
        return buf, starts, rlens, 5000 + 3, 0
    if name == "stretch":
        # one quasi mantissa hammered (test_ans.py's heavy quasi rescale,
        # on one chain): the counts grow past 2^16 and the rescale's
        # stretch shift is > 0
        chains = [_symbols(rng, 9000, [7], 0.9) for _ in range(2)]
        buf, starts, rlens = _lay_out(chains)
        return buf, starts, rlens, 9000, 0
    if name == "garbage":  # random payload: arbitrary states and models
        buf = rng.integers(0, 256, 9000, dtype=np.uint8)
        starts = np.asarray([0, 2000, 4000, 6000], np.int32)
        return buf, starts, np.full(4, 2000, np.int32), 2000, 1
    if name == "padding":  # batch padding chains (rlens < 0)
        chains = [_symbols(rng, 800, range(8), 0.01) for _ in range(4)]
        buf, starts, rlens = _lay_out(chains)
        starts = np.concatenate([starts, np.zeros(4, np.int32)])
        rlens = np.concatenate([rlens, np.full(4, -1, np.int32)])
        return buf, starts, rlens, 800 + 7, 2
    if name in ("buffer_end", "truncated"):
        # the last chain ends at the buffer's end, or 3 bytes past it: its
        # last reads clamp to the last byte and read 0 beyond
        chains = [_symbols(rng, 700, range(8), 0.01) for _ in range(4)]
        buf, starts, rlens = _lay_out(chains, 0, 3 if name == "truncated" else 0)
        return buf, starts, rlens, 700, 1
    if name == "classic":  # lanes = 0: one chain a chunk, the flat layout
        chains = [_symbols(rng, n, range(8), 0.01) for n in (1200, 37, 0)]
        buf, starts, rlens = _lay_out(chains)
        return buf, starts, rlens, 1200, 0
    if name == "lanes16":  # 16 chains a chunk, two chunks
        chains = [_symbols(rng, 600 - (l % 16 == 15), range(8), 0.01)
                  for l in range(32)]
        buf, starts, rlens = _lay_out(chains)
        return buf, starts, rlens, 600, 2
    raise ValueError(name)
