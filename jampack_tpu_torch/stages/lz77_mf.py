"""Spec-engine m1/m2 LZ77 match finders + the CHHM token filter.

Pure-Python executable spec of the lazy hash-chain finder (m1,
lz77.cpp:278-441), the suffix-array anti-context finder (m2,
lz77.cpp:134-274) and the cyclic hashed history model (cyclichhm.cpp) —
bit-exact with the native engine (jn_lz.cpp): identical archives for every
Options across engines.  Parsing decisions replicate the reference's
quirks on purpose (they are format-visible behavior):

  * the dead-PreviousValue XOR (cyclichhm.cpp:63) — the "delta" is the raw
    value;
  * both CHHM peak tests consult the OFFSET model (lz77.cpp:421);
  * m1 hashes at `pos` for every lazy offset k (lz77.cpp:321), so all four
    lazy iterations walk the same chain;
  * ratio comparisons in C `float` (replicated with np.float32).

The m2 candidate scan is vectorized: match lengths come from a running min
over the LCP array outward from the ISA pointer (equivalent to the
reference's per-candidate byte scan), and the sequential best-candidate
update rule is replayed exactly via its event structure (updates happen at
long-match events and at running-maximum ratios between them).
"""

import numpy as np

from ..format.constants import (
    GOLDEN_PRIME,
    LZ_DUPE_MATCH,
    LZ_HASH_BITS,
    LZ_MIN_MATCH,
)
from .bwt import suffix_array
from .lz77 import write_token
from ..format.varint import size_of_value

_M32 = 0xFFFFFFFF
_TOKEN_BUF = 1 << 16
_CHHM_BITS = 16
_CHHM_SIZE = 1 << _CHHM_BITS


def _ratio(match: int, literal: int, offset: int) -> np.float32:
    """compressible() in C float semantics (lz77.cpp:107-119)."""
    cost = 1 + size_of_value(offset)
    if (match - LZ_MIN_MATCH) >= 31:
        cost += size_of_value(match - LZ_MIN_MATCH - 31)
    if literal >= 7:
        cost += size_of_value(literal - 7)
    if match < LZ_MIN_MATCH or match <= cost:
        return np.float32(0.0)
    return np.float32(np.float32(match) / np.float32(cost))


class Chhm:
    """Cyclic hashed history model (cyclichhm.cpp semantics)."""

    def __init__(self, size: int = _TOKEN_BUF):
        self.ring = np.zeros(size, dtype=np.uint16)
        self.hist = np.zeros(_CHHM_SIZE, dtype=np.int64)
        self.mod = np.zeros(_CHHM_SIZE, dtype=np.int64)
        self.ring_size = size
        self.pos = 0
        self.avg = 0
        self.uniques = 0
        self.width = 1

    @staticmethod
    def _hash(v: int) -> int:
        return ((v * GOLDEN_PRIME) & _M32) >> (32 - _CHHM_BITS)

    def update(self, value: int) -> None:
        h = self._hash(value & _M32)
        slot = self.pos % self.ring_size
        old = int(self.ring[slot])
        self.ring[slot] = h
        self.hist[h] += 1
        if self.pos >= self.ring_size:
            self.hist[old] -= 1
        # cyclichhm.cpp:63's PreviousValue is never assigned after
        # construction, so the "XOR delta" is the raw value
        self.mod[(value & _M32) % _CHHM_SIZE] += 1
        self.pos += 1

    def build(self) -> None:
        total = int(self.mod.sum())
        zeros = int(np.count_nonzero(self.mod == 0))
        nonzeros = _CHHM_SIZE - zeros
        self.avg = (total // nonzeros) & _M32 if nonzeros > 0 else 0
        self.uniques = nonzeros
        bsym = int(np.argmax(self.mod))  # first index of the max, like the scan
        self.width = 1 if bsym == 0 else bsym

    def peaks(self, value: int) -> bool:
        k = int(value)
        reduce = 2 if self.width <= 1 else int(self.width)
        while k:
            div = 1 if self.avg == 0 else self.avg
            # u32 arithmetic: div*div wraps; a zero divisor is the
            # reference's own division-by-zero crash regime
            thresh = self.uniques // ((div * div) & _M32)
            if int(self.mod[(k & _M32) % _CHHM_SIZE]) > thresh:
                return True
            k //= reduce
        return False

    def clean(self) -> None:
        self.avg = 0
        self.mod[:] = 0
        self.width = 1


def _emit_tokens(b: bytes, toks, chhm_off: Chhm, chhm_match: Chhm,
                 out: bytearray, bbpos: int) -> int:
    """Model a token chunk through the CHHMs and keep only structured or
    very long matches (lz77.cpp:398-425).  Returns the new bbpos."""
    for off, match, _pos in toks:
        chhm_off.update(off)
        chhm_match.update(match)
    chhm_off.build()
    chhm_match.build()
    for off, match, position in toks:
        # both peak tests consult the OFFSET model (lz77.cpp:421); ChhmMatch
        # is built but never read
        if (chhm_off.peaks(off) or chhm_off.peaks(match)
                or match > LZ_DUPE_MATCH):
            literal = position - bbpos
            out += write_token(match, literal, off)
            out += b[position - literal: position]
            bbpos = position + match
    chhm_off.clean()
    chhm_match.clean()
    return bbpos


def _common_fwd(arr: np.ndarray, p: int, c: int, limit: int) -> int:
    """Length of the common run arr[p+i] == arr[c+i] for i < limit,
    chunked numpy comparison (replaces the per-byte C scan)."""
    m = 0
    chunk = 64
    while m < limit:
        span = min(chunk, limit - m)
        eq = arr[p + m: p + m + span] == arr[c + m: c + m + span]
        bad = np.argmin(eq) if not eq.all() else span
        m += int(bad)
        if bad < span:
            return m
        chunk = min(chunk * 4, 1 << 20)
    return m


def _common_bwd(arr: np.ndarray, p: int, c: int, lit: int) -> int:
    """mb: arr[p-mb-1] == arr[c-mb-1] while (p-mb-1) > 0 and mb < lit."""
    mb = 0
    while (p - mb - 1) > 0 and mb < lit and arr[p - mb - 1] == arr[c - mb - 1]:
        mb += 1
    return mb


def lz77_m1_encode(data: np.ndarray) -> np.ndarray:
    """m1 lazy hash-chain finder (lz77.cpp:278-441 / jn_lz.cpp m1)."""
    t = np.asarray(data, dtype=np.uint8)
    n = int(t.size)
    pad = np.zeros(n + LZ_MIN_MATCH + 8, dtype=np.uint8)
    pad[:n] = t
    b = pad.tobytes()
    window = n if n > 0 else 1
    chain = np.zeros(window, dtype=np.int64)
    table = np.zeros(1 << LZ_HASH_BITS, dtype=np.int64)

    # big-endian 4-byte load + golden-prime hash at every position
    def h32(p):
        v = (int(pad[p]) << 24) | (int(pad[p + 1]) << 16) \
            | (int(pad[p + 2]) << 8) | int(pad[p + 3])
        return ((v * GOLDEN_PRIME) & _M32) >> (32 - LZ_HASH_BITS)

    def load32(p):
        return (int(pad[p]) << 24) | (int(pad[p + 1]) << 16) \
            | (int(pad[p + 2]) << 8) | int(pad[p + 3])

    chhm_off, chhm_match = Chhm(), Chhm()
    out = bytearray()
    toks = []
    pos = lit = bbpos = 0
    while pos < n:
        while pos < n and len(toks) < _TOKEN_BUF:
            back = forward = length = off = 0
            lowest = np.float32(1.0)
            for k in range(LZ_MIN_MATCH):
                # the reference hashes at `pos` for every lazy offset k
                # (lz77.cpp:321): all k walk the same chain, compare at pos+k
                h = h32(pos)
                if table[h] > 0 and (pos + k) < n:
                    cpos = pos + k
                    ppos = int(table[h])
                    chain_len, miss = 32, 0
                    while ppos > 0:
                        distance = cpos - ppos
                        if load32(ppos) == load32(cpos):
                            mb = _common_bwd(pad, ppos, cpos, lit)
                            cap = n - LZ_MIN_MATCH - cpos
                            mf = _common_fwd(pad, ppos, cpos, cap) \
                                if cap > 0 else 0
                            r = _ratio(mf + mb, lit + (mb - k), distance)
                            if r > lowest or (mf + mb) >= LZ_DUPE_MATCH:
                                lowest = r
                                length, back, off, forward = mf, mb, distance, k
                            if mf > LZ_DUPE_MATCH:
                                break
                            miss = 0
                        else:
                            miss += 1
                        chain_len -= 1
                        if chain_len == 0 or (chain_len >> miss) == 0:
                            break
                        ppos = int(chain[ppos % window])
            if lowest > np.float32(1.0) or (length + back) > LZ_DUPE_MATCH:
                length += back
                pos -= back - forward
                toks.append((off, length, pos))
                for i in range(length):
                    h = h32(pos + i)
                    chain[(pos + i) % window] = table[h]
                    table[h] = pos + i
                pos += length
                lit = 0
            h = h32(pos)
            chain[pos % window] = table[h]
            table[h] = pos
            pos += 1
            lit += 1
        bbpos = _emit_tokens(b, toks, chhm_off, chhm_match, out, bbpos)
        toks = []
    remainder = pos - bbpos
    out += write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0)
    out += b[n - remainder: n]
    return np.frombuffer(bytes(out), dtype=np.uint8)


def _lcp_array(t: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai LCP: lcp[i] = LCP(suffix sa[i-1], suffix sa[i]); lcp[0] = 0."""
    n = t.size
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int64)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = int(sa[r - 1])
            while i + h < n and j + h < n and t[i + h] == t[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def lz77_m2_encode(data: np.ndarray) -> np.ndarray:
    """m2 suffix-array neighborhood anti-context finder (lz77.cpp:134-274).

    The reference evaluates up to 8193 SA-neighborhood candidates per lazy
    position in ascending SA order with the sequential update rule
        if ratio > lowest or match >= 256: take candidate (and set
        lowest = ratio)
    This replays those exact decisions from the event structure: every
    match>=256 candidate updates unconditionally; between such events only
    a new running-maximum ratio updates, so the final state after a span is
    the first occurrence of the span's max ratio when it beats the carried
    `lowest`.
    """
    t = np.asarray(data, dtype=np.uint8)
    n = int(t.size)
    pad = np.zeros(n + LZ_MIN_MATCH + 8, dtype=np.uint8)
    pad[:n] = t
    b = pad.tobytes()
    if n == 0:
        return np.frombuffer(
            bytes(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0)), dtype=np.uint8
        )
    sa = suffix_array(t).astype(np.int64)
    isa = np.empty(n, dtype=np.int64)
    isa[sa] = np.arange(n)
    lcp = _lcp_array(t, sa)
    bucket = 1 << 12

    # precompute token-cost table pieces for the vectorized ratio
    def ratios(match, literal, offset):
        """Vectorized compressible() in C float semantics."""
        cost = np.ones_like(match)
        mm = match - LZ_MIN_MATCH
        ext = mm >= 31
        if ext.any():
            cost[ext] += _vec_var_size(mm[ext] - 31)
        le = literal >= 7
        if le.any():
            cost[le] += _vec_var_size(literal[le] - 7)
        cost += _vec_var_size(offset)
        r = (match.astype(np.float32) / cost.astype(np.float32))
        bad = (match < LZ_MIN_MATCH) | (match <= cost)
        r[bad] = np.float32(0.0)
        return r

    chhm_off, chhm_match = Chhm(), Chhm()
    out = bytearray()
    toks = []
    pos = lit = bbpos = 0
    while pos < n:
        while pos < n and len(toks) < _TOKEN_BUF:
            forward = length = off = 0
            lowest = np.float32(1.0)
            for k in range(LZ_MIN_MATCH):
                cpos = pos + k
                if cpos >= n:
                    break
                ptr = int(isa[cpos])
                lo = max(ptr - bucket, 0)
                hi = min(ptr + bucket, n - 1)  # inclusive; itr < n
                idx = np.arange(lo, hi + 1)
                ppos = sa[lo: hi + 1]
                # match length = running min of lcp outward from ptr,
                # capped at the reference's scan bound n - 4 - cpos
                m = np.empty(idx.size, dtype=np.int64)
                at = ptr - lo
                m[at] = n - cpos  # self (filtered out by ppos < cpos)
                if at > 0:
                    m[at - 1::-1] = np.minimum.accumulate(lcp[lo + 1: ptr + 1][::-1])
                if at < idx.size - 1:
                    m[at + 1:] = np.minimum.accumulate(lcp[ptr + 1: hi + 1])
                cap = n - LZ_MIN_MATCH - cpos
                np.minimum(m, max(cap, 0), out=m)
                valid = ppos < cpos
                if not valid.any():
                    continue
                vm = m[valid]
                voff = cpos - ppos[valid]
                vr = ratios(vm, np.full(vm.size, lit - k, dtype=np.int64), voff)
                events = np.flatnonzero(vm >= LZ_DUPE_MATCH)
                spans = []
                start = 0
                for e in events:
                    spans.append((start, int(e), True))
                    start = int(e) + 1
                spans.append((start, vm.size, False))
                for s, e, is_event in spans:
                    if e > s:
                        mx = vr[s:e].max()
                        if mx > lowest:
                            i = s + int(np.argmax(vr[s:e] == mx))
                            lowest = mx
                            length, off, forward = int(vm[i]), int(voff[i]), k
                    if is_event:
                        lowest = vr[e]
                        length, off, forward = int(vm[e]), int(voff[e]), k
            if lowest > np.float32(1.0) or length > LZ_DUPE_MATCH:
                pos += forward
                toks.append((off, length, pos))
                pos += length
                lit = 0
            pos += 1
            lit += 1
        bbpos = _emit_tokens(b, toks, chhm_off, chhm_match, out, bbpos)
        toks = []
    remainder = pos - bbpos
    out += write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0)
    out += b[n - remainder: n]
    return np.frombuffer(bytes(out), dtype=np.uint8)


def _vec_var_size(v: np.ndarray) -> np.ndarray:
    """Vectorized size_of_value over the nonstandard biased varint ranges."""
    from ..format.varint import CONSTANTS

    out = np.full(v.shape, len(CONSTANTS) + 1, dtype=np.int64)
    for i in range(len(CONSTANTS) - 1, -1, -1):
        out[v < CONSTANTS[i]] = i + 1
    return out
