"""The port's block scatter (K9's plain version) equals the Pallas kernel of
tools/pallas_dma_bench.py, run in interpret mode on the CPU.

int32 blocks copied to permuted block slots: exact equality."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu_torch.kernels.block_scatter import (
    block_scatter,
    block_scatter_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "pallas_dma_bench", os.path.join(REPO, "tools", "pallas_dma_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(S, nb, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(-2**31, 2**31, nb * S, dtype=np.int64).astype(np.int32)
    return src, rng.permutation(nb).astype(np.int32)


def test_plain_matches_the_pallas_tool():
    S, nb = 1024, 8  # the tool's smallest legal block (1024 elements)
    src, offs = _case(S, nb, 0)
    scatter = _tool().build(S, nb, interpret=True)
    want = np.asarray(scatter(jnp.asarray(src), jnp.asarray(offs)))
    got = block_scatter(torch.from_numpy(src), torch.from_numpy(offs), S)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,nb", [(1, 5), (3, 7), (1024, 8), (4096, 3)])
def test_plain_places_each_block(S, nb):
    src, offs = _case(S, nb, S)
    got = block_scatter_plain(torch.from_numpy(src), torch.from_numpy(offs), S)
    want = np.empty_like(src)
    for i, p in enumerate(offs):
        want[p * S:(p + 1) * S] = src[i * S:(i + 1) * S]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("src,offs,S", [
    (torch.zeros(8, dtype=torch.int64), torch.zeros(2, dtype=torch.int32), 4),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 3),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), 4),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int64), 4)])
def test_refuses_bad_shapes(src, offs, S):
    with pytest.raises(ValueError):
        block_scatter(src, offs, S)
