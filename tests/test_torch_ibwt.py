"""The port's inverse BWT equals device_stages.ibwt_dyn_core.

On the CPU the chase runs its plain PyTorch version.  Exact equality of the
output, its length and the ok flag."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels.device_stages import ibwt_dyn_core
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu_torch.kernels import ibwt
from jampack_tpu_torch.kernels.device_stages import ibwt_dyn
from ibwt_cases import CASES, chase_inputs, source, stage

CAP = 1 << 16
_JAX = {}


def _jax(buf, total, units):
    fn = _JAX.get(units)
    if fn is None:
        fn = _JAX[units] = jax.jit(partial(ibwt_dyn_core, units=units,
                                           out_cap=CAP))
    padded = np.zeros(CAP, np.uint8)
    padded[:buf.size] = buf
    out, n, ok = fn(jnp.asarray(padded), total)
    n = int(n)
    return np.asarray(out)[:n], n, bool(ok)


def _port(buf, units):
    out, n, ok = ibwt_dyn(torch.from_numpy(buf.copy()), buf.size, units)
    return out.numpy(), n, bool(ok)


def _text(n, seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", np.uint8)
    return alpha[rng.integers(0, alpha.size, n)]


@pytest.mark.parametrize("units,data", [
    (8, _text(30000, 1)),
    (120, _text(40000, 2)),
    (960, _text(50000, 3)),
    (120, np.tile(np.frombuffer(b"abcab", np.uint8), 5000)),   # periodic
    (960, _text(960 * 7 + 500, 4)),                            # tail < units
    (120, _text(77, 5)),                                       # n < units
])
def test_plain_matches_jax(units, data):
    buf = np.asarray(NativeEngine().bwt_forward(data, units), np.uint8)
    got = _port(buf, units)
    want = _jax(buf, buf.size, units)
    assert got[1:] == want[1:] == (data.size, True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], data)


def test_corrupt_anchors_flag_not_ok():
    data = _text(20000, 6)
    buf = np.asarray(NativeEngine().bwt_forward(data, 120), np.uint8).copy()
    n = buf.size - 4 * 120
    buf[n + 4 * 7 + 3] = 0x7F  # anchor 7 far past the body
    got, want = _port(buf, 120), _jax(buf, buf.size, 120)
    assert got[2] is False and want[2] is False
    assert got[1] == want[1]
    assert np.array_equal(got[0], want[0])


def test_stage_past_2_23_bytes():
    """A body over 2^23 entries: the JAX map packs (lf << 8 | byte) in
    uint32 and must split past 2^24; the port keeps lf in int32 beside the
    bytes (test_kernels.py's 2^23-boundary case, on the port)."""
    n = (1 << 23) + 240
    data = _text(n, 9)
    buf = np.asarray(NativeEngine().bwt_forward(data, 960), np.uint8)
    out, m, ok = _port(buf, 960)
    assert ok and m == n
    assert np.array_equal(out, data)


@pytest.mark.parametrize("name", CASES)
def test_jump_decomposition_matches_chase_and_jax(name):
    """K3's three phases in tensor ops (chase_jump_plain) at every depth
    chip_smoke.py measures, against the step-by-step chase and, for the
    stages of a real BWT small enough for its jit, ibwt_dyn_core."""
    lf, sbyte, anchors, units = chase_inputs(name)
    want = ibwt.chase_plain(lf, sbyte, anchors, units)
    for depth in (16, 32, 64, 128):
        got = ibwt.chase_jump_plain(lf, sbyte, anchors, units, depth)
        assert torch.equal(got, want), depth
    st = stage(name)
    if st is None:
        return
    buf, units = st
    nlen = want.numel()
    if buf.size <= CAP:
        out, n, ok = _jax(buf, buf.size, units)
        assert np.array_equal(want.numpy(), out[:nlen])
        assert ok == (name != "corrupt_anchors")
    if name != "corrupt_anchors":
        assert np.array_equal(want.numpy(), source(name)[0][:nlen])
