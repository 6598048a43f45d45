"""The port's wide rANS decode equals the JAX spec and the Pallas kernel.

On the CPU, decode_lanes_wide runs its plain PyTorch version; the JAX side
runs rans_wide.decode_lanes_wide and decode_lanes_wide_pallas in interpret
mode, as tests/test_rans_pallas.py does.  Integer codec: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels.rans_pallas import decode_lanes_wide_pallas
from jampack_tpu.format.tables import LOG
from jampack_tpu.kernels.rans_wide import decode_lanes_wide as jax_wide
from jampack_tpu.stages.ans import (
    ans_encode_chunk,
    lane_rlen,
    read_chunk_header,
    read_lane_table,
)
from jampack_tpu_torch.kernels import rans_common
from jampack_tpu_torch.kernels.rans import decode_lanes_wide
from rans_cases import CASES, case


def _chunk_case(n, lanes, seed, hi=60):
    rng = np.random.default_rng(seed)
    data = np.repeat(rng.integers(0, hi, n, dtype=np.uint8),
                     rng.integers(1, 20, n)).astype(np.uint8)[:n]
    blob = ans_encode_chunk(data, lanes)
    view = memoryview(blob)
    freqs, olen, clen, rlen, pos = read_chunk_header(view, 0)
    if lanes >= 2:
        lane_clens, p = read_lane_table(view, pos, rlen, lanes)
        starts = np.cumsum([p] + lane_clens[:-1]).astype(np.int32)
        rlens = np.asarray([lane_rlen(rlen, lanes, l) for l in range(lanes)],
                           np.int32)
    else:  # the classic stream: one 4-state chain per chunk
        starts = np.asarray([pos], np.int32)
        rlens = np.asarray([rlen], np.int32)
    buf = np.zeros(len(blob) + 64, np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, np.uint8)
    return buf, starts, rlens


def _mr(rlens):
    return max(1 << int(max(int(np.max(rlens)), 1) - 1).bit_length(), 2)


def _all_three(buf, starts, rlens, mr, groups=0, pallas=True):
    got, gok = decode_lanes_wide(torch.from_numpy(buf),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(rlens), mr, groups=groups)
    got, gok = got.numpy(), gok.numpy()
    args = (jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(rlens), mr)
    a, aok = jax_wide(*args, groups=groups)
    assert np.array_equal(got, np.asarray(a))
    assert np.array_equal(gok, np.asarray(aok))
    if pallas:
        b, bok = decode_lanes_wide_pallas(*args, groups=groups,
                                          interpret=True)
        assert np.array_equal(got, np.asarray(b))
        assert np.array_equal(gok, np.asarray(bok))
    return got, gok


@pytest.mark.parametrize("n,lanes,seed", [
    (3000, 4, 1), (6000, 8, 2), (900, 2, 3), (20000, 16, 4)])
def test_plain_matches_jax_and_pallas(n, lanes, seed):
    buf, starts, rlens = _chunk_case(n, lanes, seed)
    _, ok = _all_three(buf, starts, rlens, _mr(rlens))
    assert ok.all()


def test_grouped_slab_and_padding_lanes():
    buf, starts, rlens = _chunk_case(4000, 4, 9)
    # batch-pad to 8 chains (rlens = -1): slab layout with 2 groups
    starts = np.concatenate([starts, np.zeros(4, np.int32)])
    rlens = np.concatenate([rlens, np.full(4, -1, np.int32)])
    got, ok = _all_three(buf, starts, rlens, _mr(rlens), groups=2)
    assert ok.all()
    assert got.shape == (2, _mr(rlens) * 4)
    assert not got[1].any()


def test_classic_stream_lanes_0():
    buf, starts, rlens = _chunk_case(2500, 0, 5)
    _, ok = _all_three(buf, starts, rlens, _mr(rlens), pallas=False)
    assert ok.all()


def test_flipped_payload_byte_gives_equal_ok():
    buf, starts, rlens = _chunk_case(5000, 4, 21)
    bad = buf.copy()
    bad[int(starts[1]) + 40] ^= 0x5A
    _, ok = _all_three(bad, starts, rlens, _mr(rlens))
    assert not ok.all()


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_and_pallas_on_warp_layout_cases(name):
    """The cases K1's one-warp-per-chain layout could get wrong
    (tests/rans_cases.py): every exponent and mantissa 128 of e = 7, many
    rescales of every quasi model, the stretched rescale, garbage, padding
    chains, the buffer's end, lanes = 0 and 16."""
    buf, starts, rlens, mr, groups = case(name)
    got, ok = _all_three(buf, starts, rlens, mr, groups=groups)
    if name == "all_exponents":
        assert set(LOG[got.reshape(-1)].tolist()) == set(range(8))
        assert (got == 256).any()
    assert ok.all() == (name not in ("garbage", "truncated"))


def test_warp_layout_rules_hold_on_the_tables():
    """K1 lays quasi model k's entries and counts out by their index j in
    the model: slot j // 32 of the model's slot group on lane j % 32, with
    1, 1, 1, 1, 2 and 4 slots for widths 3, 7, 15, 31, 63 and 128, and the
    one count with no slot, j = 128 of model 5, in a spare register
    (csrc/rans_warp_model.cuh q_width / q_slots): the tables must have
    those widths, and the 253 counts must fit."""
    boff = [int(b) for b in rans_common.BOFF]
    widths = [boff[4 + k] - boff[3 + k] for k in range(rans_common.NQ)]
    assert widths == [3, 7, 15, 31, 63, 128]
    assert boff[3] == 7 + 2  # the exponent model, then two adaptive entries
    slots = [1, 1, 1, 1, 2, 4]
    assert all(w + 1 <= 32 * n for w, n in zip(widths[:5], slots[:5]))
    assert widths[5] + 1 == 32 * slots[5] + 1  # the spare
    assert sum(w + 1 for w in widths) == int(rans_common.QOFF[-1]) == 253
