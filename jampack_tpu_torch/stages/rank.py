"""SRC — sorted rank coding.

Move-to-front transform with a bucketed (non-sequential) output layout: the
rank of each symbol occurrence is stored into a per-symbol bucket, and the
buckets are laid out in descending frequency order.  Decoding jumps from
bucket to bucket: the rank at the current bucket cursor implies the next
symbol, which implies the next bucket.  Requires the 256-entry frequency
table (transmitted in the ANS chunk header).

Reference behavior: rank.cpp:15-151.
"""

import numpy as np


def generate_sorted_map(freq):
    """Symbols sorted by descending frequency (ties: lowest symbol first),
    truncated to symbols with nonzero frequency.  rank.cpp:15-39."""
    freq = list(freq)
    out = []
    for _ in range(256):
        mx = 0
        bsym = 0
        for i in range(256):
            if freq[i] > mx:
                bsym = i
                mx = freq[i]
        if mx == 0:
            break
        out.append(bsym)
        freq[bsym] = 0
    return out


def rank_encode(data: np.ndarray):
    """Returns (rank_array uint8, freq list[256])."""
    t = np.asarray(data, dtype=np.uint8)
    n = t.size
    freq = np.bincount(t, minlength=256).astype(np.int64).tolist()

    # MTF alphabet initialised by first-appearance order.
    s2r = [0] * 256
    r2s = [0] * 256
    seen = [False] * 256
    unique = 0
    for v in t.tolist():
        if not seen[v]:
            seen[v] = True
            r2s[unique] = v
            s2r[v] = unique
            unique += 1
    sorted_map = generate_sorted_map(freq)

    bucket = [0] * 256
    pos = 0
    for sym in sorted_map:
        bucket[sym] = pos
        pos += freq[sym]

    out = np.empty(n, dtype=np.uint8)
    for sym in t.tolist():
        rank = s2r[sym]
        out[bucket[sym]] = rank
        bucket[sym] += 1
        if rank > 0:
            # move-to-front
            while rank > 0:
                moved = r2s[rank - 1]
                r2s[rank] = moved
                s2r[moved] = rank
                rank -= 1
            r2s[0] = sym
            s2r[sym] = 0
    return out, freq


def rank_decode(rank_array: np.ndarray, freq) -> np.ndarray:
    ranks = np.asarray(rank_array, dtype=np.uint8)
    n = ranks.size
    total = sum(freq)
    if total != n:
        raise ValueError("invalid decoder frequencies")

    unique = sum(1 for f in freq if f > 0)
    sorted_map = generate_sorted_map(freq)

    bucket = [0] * 256
    bucket_end = [0] * 256
    r2s = [0] * 256
    pos = 0
    for sym in sorted_map:
        r2s[ranks[pos]] = sym
        bucket[sym] = pos + 1
        pos += freq[sym]
        bucket_end[sym] = pos

    out = np.empty(n, dtype=np.uint8)
    ranks_l = ranks.tolist()
    sym = r2s[0]
    for i in range(n):
        out[i] = sym
        if bucket[sym] < bucket_end[sym]:
            rank = ranks_l[bucket[sym]]
            bucket[sym] += 1
            if rank > 0:
                for s in range(rank):
                    r2s[s] = r2s[s + 1]
                r2s[rank] = sym
                sym = r2s[0]
        else:
            if unique > 0:
                unique -= 1
                # reference uses a do-while: at least one shift even when the
                # remaining unique count is zero (rank.cpp:140-147)
                for s in range(max(1, unique)):
                    r2s[s] = r2s[s + 1]
                sym = r2s[0]
    return out
