"""RLE0: zero-run elimination, 8-bit symbols to 16-bit symbols.

Runs of the symbol 0 are coded as the binary expansion of (run+1) minus its
leading 1-bit, using symbols {0,1}; every nonzero symbol s becomes s+1.  The
output alphabet is therefore 0..256 (257 symbols).

Reference behavior: rle.cpp:22-74.
"""

import numpy as np


def rle0_encode(data: np.ndarray) -> np.ndarray:
    """uint8 array -> uint16 array."""
    inp = np.asarray(data, dtype=np.uint8)
    out = []
    n = inp.size
    i = 0
    while i < n:
        if inp[i] == 0:
            run = 1
            # reference scans while in[i] == in[i+run] && (i+run) < n
            while (i + run) < n and inp[i + run] == 0:
                run += 1
            i += run
            L = run + 1
            msb = L.bit_length() - 1
            for k in range(msb - 1, -1, -1):
                out.append((L >> k) & 1)
        else:
            out.append(int(inp[i]) + 1)
            i += 1
    return np.array(out, dtype=np.uint16)


def rle0_decode(syms: np.ndarray, real_len: int) -> np.ndarray:
    """uint16 array -> uint8 array of length real_len."""
    inp = np.asarray(syms, dtype=np.uint16)
    out = np.empty(real_len, dtype=np.uint8)
    n = inp.size
    i = 0
    p = 0
    while i < n:
        v = int(inp[i])
        if v > 1:
            out[p] = v - 1
            p += 1
            i += 1
        else:
            rle = 1
            while i < n and inp[i] <= 1:
                rle = (rle << 1) | int(inp[i])
                i += 1
            rle -= 1
            out[p : p + rle] = 0
            p += rle
    if p != real_len:
        raise ValueError("rle mismatch!")
    return out
