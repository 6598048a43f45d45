"""Cases of the wide rANS chain encode, the model pass (K4) and the reverse
emission (K5), shared by the CPU and GPU tests.

pairs_case(name) gives (chains (L, max_rlen) uint16, rlens (L,) int32,
max_rlen, ok (L,) bool: the model pass's expected flags).  reverse_case
(name, pairs) gives (lows, fqs (L, 2*max_rlen) uint16, rlens, max_rlen):
for a PAIRS case the op pairs come from `pairs` (chains, rlens, max_rlen)
-> (lows, fqs), the JAX pass on the CPU or K4 on the card; the other cases
are garbage pairs that no model pass makes.  division_edges(fq) gives the
x edges at which K5's division is checked."""

import numpy as np

from jampack_tpu.format.tables import EXPONENT, MODEL_ALPHABET

PAIRS_CASES = ["empty", "full", "low_exponents", "rescales", "model5_edges"]
REVERSE_CASES = PAIRS_CASES + ["garbage", "fq_edges"]

# a 16 KiB chunk dealt over 4 chains: the longest chain of an 8 MiB block
LONGEST = 4095


def _symbols(rng, n, exps):
    """n valid symbols with exponents drawn from `exps`, mantissas uniform
    in their alphabet."""
    e = rng.choice(np.asarray(exps), n)
    m = (rng.random(n) * MODEL_ALPHABET[e]).astype(np.int64)
    return (EXPONENT[e] + m).astype(np.uint16)


def _rows(chains, max_rlen):
    out = np.zeros((len(chains), max_rlen), np.uint16)
    for l, c in enumerate(chains):
        out[l, :len(c)] = c
    return out


def pairs_case(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name == "empty":  # empty chains (and a padding one) beside a short one
        mr = 64
        chains = _rows([[], _symbols(rng, 5, range(8)), [], []], mr)
        return chains, np.asarray([0, 5, -1, 0], np.int32), mr, [True] * 4
    if name == "full":  # chains of exactly max_rlen and one short of it
        mr = 700
        chains = [_symbols(rng, n, range(8)) for n in (700, 700, 699, 350)]
        rlens = np.asarray([len(c) for c in chains], np.int32)
        return _rows(chains, mr), rlens, mr, [True] * 4
    if name == "low_exponents":  # only e < 2: the adaptive models alone
        mr = 900
        chains = [_symbols(rng, n, [0, 1]) for n in (900, 613, 1)]
        rlens = np.asarray([len(c) for c in chains], np.int32)
        return _rows(chains, mr), rlens, mr, [True] * 3
    if name == "rescales":
        # one chain a quasi model, every symbol of it: 4,095 symbols reach
        # the rescales of periods 8 .. 1024 (the ninth would need 4,097)
        chains = [_symbols(rng, LONGEST, [e]) for e in range(2, 8)]
        rlens = np.full(6, LONGEST, np.int32)
        return _rows(chains, LONGEST), rlens, LONGEST, [True] * 6
    if name == "model5_edges":
        # e = 7 (quasi model 5, alphabet 129): m = 127 and 128 (the count
        # with no lane, kept in the spare register) hammered; the last chain
        # also holds invalid symbols, m = 129 and past it (ok False)
        mr = 1500
        chains = []
        for k in range(3):
            s = _symbols(rng, mr, [7])
            pick = rng.random(mr)
            s = np.where(pick < 0.3, 255, np.where(pick < 0.6, 256, s))
            if k == 2:  # half of them m = 129, the first past the alphabet
                bad = rng.random(mr) < 0.02
                past = np.where(rng.random(mr) < 0.5, 257,
                                rng.integers(258, 400, mr))
                s = np.where(bad, past, s)
            chains.append(s.astype(np.uint16))
        rlens = np.full(3, mr, np.int32)
        return _rows(chains, mr), rlens, mr, [True, True, False]
    raise ValueError(name)


def reverse_case(name: str, pairs, seed: int = 0):
    if name in PAIRS_CASES:
        chains, rlens, mr, _ = pairs_case(name, seed)
        lows, fqs = pairs(chains, rlens, mr)
        return (np.asarray(lows, np.uint16), np.asarray(fqs, np.uint16),
                rlens, mr)
    rng = np.random.default_rng(seed)
    mr = 600
    rlens = np.asarray([mr, 0, 301, mr, 1], np.int32)
    shape = (rlens.size, 2 * mr)
    if name == "garbage":  # uniform pairs: lo + fq > 2^16 half the time
        lows = rng.integers(0, 1 << 16, shape)
        fqs = rng.integers(0, 1 << 16, shape)
        fqs = np.where(rng.random(shape) < 0.1, rng.integers(0, 2, shape), fqs)
    elif name == "fq_edges":
        # fq 0 (read as 1), 1 and 65535; lows 0, 65535 or uniform: states
        # past 2^31 that two emissions do not bring below x_max
        fqs = rng.choice(np.asarray([0, 1, 65535]), shape)
        lows = rng.choice(np.asarray([0, 65535, -1]), shape)
        lows = np.where(lows < 0, rng.integers(0, 1 << 16, shape), lows)
    else:
        raise ValueError(name)
    return lows.astype(np.uint16), fqs.astype(np.uint16), rlens, mr


def division_edges(fq):
    """(x, fq) int64: x = 0, fq - 1, fq, 2^15 fq - 1, 2^31 - 1, 2^31,
    2^31 + 1 and 2^32 - 1 beside each fq."""
    fq = np.asarray(fq, np.int64)
    xs = [np.zeros_like(fq), fq - 1, fq, (fq << 15) - 1] + [
        np.full_like(fq, v) for v in (2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1)]
    return np.concatenate(xs), np.tile(fq, len(xs))
