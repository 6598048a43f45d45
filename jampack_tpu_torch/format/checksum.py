"""Per-block integrity checksum.

Four independent 32-bit lanes, each folding one big-endian 4-byte word per
16-byte stride with a data-dependent shift, XOR-merged at the end.  The value
is stored in the block header and verified after decode; format-visible.

Reference behavior: checksum.cpp:12-36.
"""

import numpy as np

from .constants import GOLDEN_PRIME

_M32 = 0xFFFFFFFF


def integrity_check(data) -> int:
    """Compute the 32-bit block checksum of a bytes-like / uint8 array."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    size = buf.size
    s = [3, 0, 0, 0]

    # Number of full 16-byte strides processed by the vector loop: the loop
    # runs while (j + 16) < size, i.e. the final (possibly full) 16-byte
    # group is always left to the scalar tail.
    n = max(0, (size - 1) // 16)  # strides with j+16 < size  <=>  j < size-16
    if n > 0:
        words = buf[: n * 16].reshape(n, 4, 4).astype(np.uint32)
        # big-endian load of each 4-byte group
        w = (words[:, :, 0] << 24) | (words[:, :, 1] << 16) | (words[:, :, 2] << 8) | words[:, :, 3]
        w_cols = [w[:, k] for k in range(4)]
        for k in range(4):
            acc = s[k]
            col = w_cols[k]
            # serial dependency on acc through the data-dependent shift
            for v in col.tolist():
                acc ^= ((v + (1 << (acc & 7))) * GOLDEN_PRIME) & _M32
            s[k] = acc

    j = n * 16
    acc = s[0]
    for b in buf[j:].tolist():
        acc ^= ((b + (1 << (acc & 7))) * GOLDEN_PRIME) & _M32
    s[0] = acc

    return s[0] ^ s[1] ^ s[2] ^ s[3]
