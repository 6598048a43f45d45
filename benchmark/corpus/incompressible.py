"""Already-compressed content: seeded uniform random bytes.

Real backups carry media, archives and encrypted files that no codec
shrinks; on them the codec has to cost little and store about as much as
it read."""

import numpy as np


def generate(n: int, rng: np.random.Generator,
             layout: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 256, n, dtype=np.uint8)
