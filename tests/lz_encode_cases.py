"""Blocks for the host-LZ encode route's CPU tests (tests/test_torch_lz_
encode*.py): made with numpy from seeds; nothing here imports jax or
jampack_tpu."""

import numpy as np

from lpx_cases import log_records


def mixed(n: int, seed: int) -> np.ndarray:
    """Small-alphabet noise, text and a repeat of both (the lz cases of
    tests/test_torch_stages.py::_lz_case), cut to n."""
    rng = np.random.default_rng(seed)
    k = n // 4 + 1
    base = rng.integers(0, 5, k).astype(np.uint8)
    text = np.frombuffer(b"the lz stage copies earlier bytes. " * (k // 35 + 1),
                         np.uint8)[:k]
    return np.concatenate([base, text, base[: k // 2], text, base])[:n]


def sines(n: int, seed: int) -> np.ndarray:
    """Two interleaved int16 channels of sines with noise: -f1 and -f2
    pick filters on them."""
    rng = np.random.default_rng(seed)
    t = np.arange(-(-n // 4))
    x = np.stack([3000 * np.sin(t / 40.0), 5000 * np.cos(t / 95.0)], 1)
    x = x + rng.normal(0, 2, x.shape)
    return x.astype(np.int16).view(np.uint8).reshape(-1)[:n]


def block(n: int, seed: int) -> np.ndarray:
    """A block of log records, mixed bytes and sampled channels."""
    third = n // 3
    return np.concatenate([log_records(third), mixed(third, seed),
                           sines(n - 2 * third, seed)])
