"""K11's decomposition on the CPU: device_stages.lz_parse_jump_plain (the
serial head, the candidate token at every position, the jump table of
depth D by squaring, the hop walk, the sub-chains and the scan, in tensor
ops) against the JAX package's lz_parse_core, on every parse case of
tests/lpx_cases.py, at D in {2, 8, 32}, with no head (the chain phases
from byte 0) and with K11's.  Every output must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels import device_stages as jds
from jampack_tpu_torch.kernels import device_stages as tds

from lpx_cases import LZ_BAD, LZ_CASES, lz_case

_JAX = {}


def _jax(name):
    if name not in _JAX:
        buf, n, max_tokens, out_cap = lz_case(name)
        out = jds.lz_parse_core(jnp.asarray(buf), n, max_tokens, out_cap)
        _JAX[name] = [np.asarray(a) for a in out]
    return _JAX[name]


@pytest.mark.parametrize("depth", [2, 8, 32])
@pytest.mark.parametrize("name", LZ_CASES)
def test_jump_decomposition_matches_lz_parse_core(name, depth):
    buf, n, max_tokens, out_cap = lz_case(name)
    want = _jax(name)
    for head in (0, tds.LZ_HEAD):
        got = tds.lz_parse_jump_plain(torch.from_numpy(buf.copy()), n,
                                      max_tokens, out_cap, depth, head)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), w), head
        assert got[7] == LZ_BAD[name]
