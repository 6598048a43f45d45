"""Burrows-Wheeler transform with parallel-decode anchor planting.

Forward: the trailing `len % 120` bytes are copied raw; the rest is
suffix-sorted and the BWT emitted with the primary-index row dropped
(Bwt[0] = T[nlen-1], remaining rows shifted around the primary index).  The
SA positions of the 120 equally spaced suffixes are appended as little-endian
int32 anchors (+1 biased), which is what turns the inherently serial inverse
permutation walk into 120 independent chains.

Inverse: build the LF map (stable counting sort of BWT positions by symbol,
with the +1 / primary-index adjustment), then chase each anchor for
nlen/units steps.

This numpy version is the executable spec; kernels/ibwt.py is the TPU path
and native/ the host C++ path.

Reference behavior: bwt.cpp:22-65 (forward), bwt.cpp:72-282 (inverse),
anchor rationale bwt.cpp:67-71.
"""

import numpy as np

from ..format.constants import BWT_UNITS


def suffix_array(t: np.ndarray) -> np.ndarray:
    """Lexicographic suffix array via prefix doubling (O(n log^2 n))."""
    t = np.asarray(t, dtype=np.uint8)
    n = t.size
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    rank = t.astype(np.int64)
    mult = max(n, 256) + 1  # ranks start as raw bytes (may exceed n)
    k = 1
    while True:
        # key2: rank of suffix i+k, or -1 past the end (shorter sorts first)
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        combined = rank[order] * mult + (key2[order] + 1)
        new_rank = np.empty(n, dtype=np.int64)
        boundaries = np.empty(n, dtype=bool)
        boundaries[0] = True
        boundaries[1:] = combined[1:] != combined[:-1]
        new_rank[order] = np.cumsum(boundaries) - 1
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int32)
        k <<= 1


def forward_bwt(data: np.ndarray, units: int = BWT_UNITS):
    """Returns the BWT output buffer: bwt[len] + raw tail + units anchors."""
    t = np.asarray(data, dtype=np.uint8)
    n = t.size
    out = np.empty(n + units * 4, dtype=np.uint8)
    remainder = n % units
    nlen = n - remainder
    out[nlen:n] = t[nlen:n]
    if nlen > 0:
        sa = suffix_array(t[:nlen])
        step = nlen // units
        anchors = np.zeros(units, dtype=np.int32)
        sa_pos = np.flatnonzero((sa % step) == 0)
        anchors[sa[sa_pos] // step] = sa_pos
        idx = int(anchors[0])  # position of suffix 0 in SA

        prev = t[(sa.astype(np.int64) - 1) % nlen]
        out[0] = t[nlen - 1]
        out[1 : idx + 1] = prev[:idx]
        out[idx + 1 : nlen] = prev[idx + 1 :]
        anchors += 1
        out[n:] = (anchors.astype("<i4")).view(np.uint8)
    else:
        out[n:] = 0  # reference leaves Indicies zeroed when nlen == 0
    return out


def build_lf_map(bwt: np.ndarray, idx: int) -> np.ndarray:
    """LF mapping with the reference's +1 / primary-index adjustment."""
    nlen = bwt.size
    positions = np.arange(nlen, dtype=np.int32)
    positions[idx:] += 1
    # stable counting sort of positions by bwt symbol (bwt.cpp:141-174)
    order = np.argsort(bwt, kind="stable")
    return positions[order]


def inverse_bwt(buf: np.ndarray, units: int = BWT_UNITS) -> np.ndarray:
    """Inverts forward_bwt's output buffer back to the original bytes."""
    buf = np.asarray(buf, dtype=np.uint8)
    n = buf.size - units * 4
    anchors = buf[n:].view("<i4").astype(np.int64)
    remainder = n % units
    nlen = n - remainder
    out = np.empty(n, dtype=np.uint8)
    out[nlen:n] = buf[nlen:n]
    if nlen > 0:
        bwt = buf[:nlen]
        idx = int(anchors[0])
        lf = build_lf_map(bwt, idx).astype(np.int64)
        step = nlen // units
        p = anchors.copy()
        chunks = np.empty((units, step), dtype=np.uint8)
        for i in range(step):
            p = lf[p - 1]
            chunks[:, i] = bwt[p - (p >= idx)]
        out[:nlen] = chunks.reshape(-1)
    return out
