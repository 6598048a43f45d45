"""Edge cases of the SRC rank walks (K2, K6) that the one-warp-per-chunk
layout of the MTF list has to get right, shared by the CPU and GPU tests.

Each case is (chunks (L, W) uint8, olens (L,) int32); rank_rows gives the
spec's rank rows and frequency tables of the same chunks."""

import numpy as np

from jampack_tpu.stages.rank import rank_encode

PERIODS = (8, 9, 16, 17, 32, 33, 256)
CASES = [f"period{p}" for p in PERIODS] + ["one_symbol", "ragged", "ties"]


def periodic(p: int, L: int, W: int, seed: int):
    """L rows, each a seeded choice of p distinct bytes repeated: after the
    first cycle every MTF step has rank p - 1, which crosses lane
    boundaries of the list (8 entries a lane); p = 256 reaches rank 255."""
    rng = np.random.default_rng(seed)
    rows = [rng.permutation(256)[:p].astype(np.uint8)[np.arange(W) % p]
            for _ in range(L)]
    return np.stack(rows)


def edge_chunks(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if case.startswith("period"):
        W = 1024
        return periodic(int(case[6:]), 2, W, seed), np.asarray([W, 1000],
                                                               np.int32)
    if case == "one_symbol":  # a chunk of one repeated byte, and of one byte
        chunks = np.zeros((2, 1024), np.uint8)
        chunks[0] = 7
        chunks[1, 0] = 200
        return chunks, np.asarray([1024, 1], np.int32)
    if case == "ragged":  # a width that is not a multiple of 16
        W = 1000
        chunks = rng.integers(0, 256, (4, W), dtype=np.uint8)
        chunks[0] %= 23
        return chunks, np.asarray([997, 1000, 0, -1], np.int32)
    if case == "ties":  # all 256 bytes present, frequencies tied
        all4 = rng.permutation(np.repeat(np.arange(256), 4))
        two = rng.permutation(np.concatenate([np.repeat(np.arange(128), 5),
                                              np.repeat(np.arange(128, 256),
                                                        3)]))
        return np.stack([all4, two]).astype(np.uint8), np.asarray(
            [1024, 1024], np.int32)
    raise ValueError(case)


def rank_rows(chunks, olens):
    """The spec's (ranks (L, W) uint8, freqs (L, 256) int32) of each row's
    first olen bytes; zero rows where olen <= 0."""
    ranks = np.zeros_like(chunks)
    freqs = np.zeros((chunks.shape[0], 256), np.int32)
    for l, n in enumerate(olens):
        if n > 0:
            ranks[l, :n], freqs[l] = rank_encode(chunks[l, :n])
    return ranks, freqs
