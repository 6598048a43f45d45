"""The port's -f1/-f2 filter search and the filter stage of its block
encode, on the CPU, held against the JAX package and the float64 spec.

The same seeded numpy inputs go through each JAX function and its port
(the port on the CPU runs the plain versions of K7, the joint histogram,
and K8, the LPC recurrence).  Integer outputs must be equal; the f32
device scores must be within 1e-4 bits/symbol of the float64 spec, far
below the 1e-3 margin inside which the search re-scores in float64."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from jampack_tpu.kernels import filters_search as jfs
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Options, compress_block_ex
from jampack_tpu.stages import filters as spec
from jampack_tpu_torch.kernels import filters_search as fs
from jampack_tpu_torch.kernels.encode_stages import END_TOKEN
from jampack_tpu_torch.kernels.hist import joint_hist, joint_hist_plain
from jampack_tpu_torch.kernels.lpc import encode_step, lpc
from jampack_tpu_torch.runtime.device_decode import decode_block_device
from jampack_tpu_torch.runtime.device_encode import (
    encode_block_device_ex,
    filter_configs,
)

FBS = 1 << 16
TOL = 1e-4


def _rows(lens, seed):
    """(B, FBS) uint8 rows, zero past each length, and the int32 lengths."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(lens), FBS), np.uint8)
    for b, n in enumerate(lens):
        if b % 2:
            rows[b, :n] = rng.integers(0, 256, n)
        else:  # few symbols, long runs: repeated pairs
            rows[b, :n] = np.repeat(rng.integers(0, 9, n // 7 + 1), 7)[:n]
    return rows, np.asarray(lens, np.int32)


# interleaved int16 sines (LPC), correlated 3-channel walks (inline delta),
# 4-byte records (delta), a uint8 sine (LPC at width 1): one 64 KiB regime
# each, the last chunk ragged
def _structured(seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(FBS // 4)
    sines = np.stack([(8000 * np.sin(t / 300.0)).astype(np.int16),
                      (6000 * np.cos(t / 410.0)).astype(np.int16)], 1)
    v = np.cumsum(rng.integers(-8, 9, FBS // 3 + 1))
    walks = np.stack([v * (k + 1) + 40 * k for k in range(3)], 1)
    i = np.arange(FBS // 4)
    recs = np.stack([i % 256, (i * 3) % 256, np.full_like(i, 7),
                     (i // 5) % 256], 1).astype(np.uint8).reshape(-1)
    recs[rng.integers(0, FBS, 300)] = rng.integers(0, 256, 300)
    audio = (np.sin(np.arange(9000) / 25) * 90 + 128).astype(np.uint8)
    return np.concatenate([sines.view(np.uint8).reshape(-1),
                           walks.astype(np.uint8).reshape(-1)[:FBS], recs,
                           audio])


# ---------------------------------------------------------------------------
# K7: the joint histogram


def test_joint_hist_matches_jax():
    rows, lens = _rows([0, 1, 2, 517, FBS, 40001], 1)
    want = np.asarray(jfs._group_joint_xla(jnp.asarray(rows.astype(np.int32)),
                                           jnp.asarray(lens)))
    t, l = torch.from_numpy(rows), torch.from_numpy(lens)
    got = joint_hist_plain(t, l)
    assert got.dtype == torch.int32 and got.shape == (6, 256, 256)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert torch.equal(joint_hist(t, l), got)
    assert int(got[0].sum()) == 0 and int(got[1, 0].sum()) == 1
    assert got.sum((1, 2)).tolist() == [min(n, FBS) for n in lens]


def test_joint_hist_counts_one_repeated_pair():
    """The largest cell: a full lane of zeros is 65,536 (0, 0) pairs."""
    rows = torch.zeros(1, FBS, dtype=torch.uint8)
    got = joint_hist(rows, torch.tensor([FBS], dtype=torch.int32))
    assert int(got[0, 0, 0]) == FBS and int(got.sum()) == FBS


# ---------------------------------------------------------------------------
# K8: the LPC recurrence


def test_lpc_matches_jax_and_inverts():
    rows, lens = _rows([0, 1, 17, 3000, FBS, 40001], 2)
    want = np.asarray(jfs._lpc_all(jnp.asarray(rows.astype(np.int32)),
                                   jnp.asarray(lens)))
    t, l = torch.from_numpy(rows), torch.from_numpy(lens)
    enc = lpc(t, l, decode=False)
    assert enc.dtype == torch.uint8
    assert np.array_equal(enc.numpy(), want.astype(np.uint8))
    dec = lpc(enc, l, decode=True)
    j = np.arange(FBS)[None, :]
    assert np.array_equal(dec.numpy(), np.where(j < lens[:, None], rows, 0))


def test_lpc_three_op_step_matches_spec_step():
    """K8's encode step (add, shift, multiply-add on the weight's chain)
    against _lpc_all's five-op step, run in jnp, for every weight in
    [0, 255] (the weight's range) and every b = (2 p1 - p2 - cur) & 0xFF:
    here p1 = p2 = b and cur = 0."""
    w, b = np.divmod(np.arange(1 << 16, dtype=np.int32), 256)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    p1 = p2 = jb
    cur = jnp.zeros_like(jb)
    err = (jw + (((p1 - p2) + p1) - cur)) & 0xFF  # filters_search.py:133-134
    nw = jw + ((err - jw) >> 6)
    got_err, got_w = encode_step(torch.from_numpy(w), torch.from_numpy(b))
    assert np.array_equal(got_err.numpy(), np.asarray(err))
    assert np.array_equal(got_w.numpy(), np.asarray(nw))
    assert int(got_w.min()) >= 0 and int(got_w.max()) <= 255


def test_lpc_two_op_chains_match_spec():
    """The two-op chains csrc/lpc.cu walks, in NumPy int32, against the
    spec: decode's w' = (63 w + e) >> 6 for every (w, e) in [0, 255]^2;
    encode's S' = (S + k) - 4 (S >> 8) (S = w + b, k = b' - b + (b >> 6))
    against _lpc_all run in jnp, and decode's double prefix sum of w - e
    giving the bytes back, on wrap-heavy random and smooth rows."""
    w, e = np.divmod(np.arange(1 << 16, dtype=np.int32), 256)
    jw = jnp.asarray(w)
    spec_w = np.asarray(jw + ((jnp.asarray(e) - jw) >> 6))
    assert np.array_equal((63 * w + e) >> 6, spec_w)

    n = 3000
    rng = np.random.default_rng(11)
    rows = np.zeros((3, FBS), np.int32)
    rows[0, :n] = rng.integers(0, 256, n)
    rows[1, :n] = (np.sin(np.arange(n) / 9) * 100 + 128).astype(np.int32)
    rows[2, :n] = rng.integers(0, 2, n) * 255
    lens = np.full(3, n, np.int32)
    want = np.asarray(jfs._lpc_all(jnp.asarray(rows), jnp.asarray(lens)))
    x = rows[:, :n]
    p1 = np.pad(x, ((0, 0), (1, 0)))[:, :n]
    p2 = np.pad(x, ((0, 0), (2, 0)))[:, :n]
    b = (2 * p1 - p2 - x) & 0xFF
    b_prev = np.pad(b, ((0, 0), (1, 0)))[:, :n]
    k = b - b_prev + (b_prev >> 6)
    S = np.zeros(3, np.int32)
    err = np.zeros_like(x)
    for i in range(n):
        S = (S + k[:, i]) - 4 * (S >> 8)
        err[:, i] = S & 0xFF
    assert np.array_equal(err, want[:, :n])

    wt = np.zeros(3, np.int32)
    u1 = np.zeros(3, np.uint32)
    u2 = np.zeros(3, np.uint32)
    back = np.zeros_like(x)
    for i in range(n):
        u = 2 * u1 + ((wt - err[:, i]).astype(np.uint32) - u2)
        wt = (63 * wt + err[:, i]) >> 6
        back[:, i] = u & 0xFF
        u2, u1 = u1, u
    assert np.array_equal(back, x)


@pytest.mark.parametrize("n", [1, 2, 5000])
def test_lpc_matches_spec_on_single_rows(n):
    rng = np.random.default_rng(n)
    x = (np.sin(np.arange(n) / 9) * 100 + 128 + rng.integers(-2, 3, n)
         ).astype(np.uint8)
    row = np.zeros((1, FBS), np.uint8)
    row[0, :n] = x
    l = torch.tensor([n], dtype=torch.int32)
    enc = lpc(torch.from_numpy(row), l, decode=False)
    assert np.array_equal(enc[0, :n].numpy(), spec.lpc_encode(x))
    res = spec.lpc_encode(x)
    row[0, :n] = res
    dec = lpc(torch.from_numpy(row), l, decode=True)
    assert np.array_equal(dec[0, :n].numpy(), spec.lpc_decode(res))
    assert np.array_equal(dec[0, :n].numpy(), x)


# ---------------------------------------------------------------------------
# scores, detectors and picks


def test_score_all_configs_matches_spec():
    """Every (type, width) of one short ragged chunk against the f64
    mixed entropy of the spec transform."""
    data = _structured()[FBS - 700:FBS + 2300]
    got = fs.score_all_configs(torch.from_numpy(data)).numpy()
    assert got.shape == (1, 3, 33)
    assert abs(got[0, 0, 0] - spec.mixed_entropy(data)) < TOL
    for t in range(3):
        assert np.isinf(got[0, t, 0]) == (t > 0)
        for w in range(1, 33):
            want = spec.mixed_entropy(spec._apply(data, t, w))
            assert abs(got[0, t, w] - want) < TOL, (t, w)


def test_sorted_entropy_scores_on_ragged_lanes():
    """The JAX regression's cases: prev[0] is the lane's last real byte."""
    rng = np.random.default_rng(9)
    lens = [2, 1, 3, 100, 517, FBS]
    rows = np.zeros((len(lens), FBS), np.uint8)
    want = []
    for b, n in enumerate(lens):
        rows[b, :n] = rng.integers(0, 256, n)
        want.append(spec.sorted_entropy(rows[b, :n]))
    got = fs.sorted_entropy_scores(torch.from_numpy(rows),
                                   torch.tensor(lens, dtype=torch.int32))
    assert np.allclose(got.numpy(), want, atol=TOL)


def test_find_stride_projection_match_jax():
    data = _structured()
    golden = np.fromfile("tests/fixtures/golden_input.bin", np.uint8)
    bufs = [data[k * FBS:(k + 1) * FBS] for k in range(4)] + [
        golden[:FBS], golden[-5000:], data[:3], data[:1]]
    rows = np.zeros((len(bufs), FBS), np.uint8)
    for b, x in enumerate(bufs):
        rows[b, :x.size] = x
    lens = torch.tensor([x.size for x in bufs], dtype=torch.int32)
    strides, projs = fs.find_stride_projection_fast(torch.from_numpy(rows),
                                                    lens)
    assert strides.tolist() == [jfs.find_stride_fast(x) for x in bufs]
    assert projs.tolist() == [jfs.find_projection_fast(x) for x in bufs]
    assert strides.tolist()[:3] == [spec.find_stride(x) for x in bufs[:3]]


def test_f1_filter_bytes_match_spec_and_jax():
    audio = (np.sin(np.arange(120000) / 25) * 90 + 128).astype(np.uint8)
    got = fs.filters_encode_f1_device(torch.from_numpy(audio)).numpy()
    assert np.array_equal(got, spec.filters_encode(audio, 1))
    assert np.array_equal(got, jfs.filters_encode_f1_device(audio))


def test_f1_previous_lpc_pick_is_made_on_the_device(monkeypatch):
    """Chunk 0 picks LPC at width 1; chunk 1 (text) has raw as its only
    candidate, so the carried pick is applied to it through the port's
    filters_apply_rows (K8), never the host's LPC loop."""
    from jampack_tpu_torch.stages import filters as port_spec

    def refuse(*args):
        raise AssertionError("the host LPC loop ran")

    monkeypatch.setattr(port_spec, "lpc_encode", refuse)
    monkeypatch.setattr(port_spec, "_apply", refuse)
    audio = (np.sin(np.arange(FBS) / 25) * 90 + 128).astype(np.uint8)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", np.uint8)
    text = alpha[np.random.default_rng(5).integers(0, 30, 3000)]
    data = np.concatenate([audio, text])
    rows, lens, _ = fs.filter_rows(torch.from_numpy(data))
    cand_sets = fs.f1_candidates(rows, lens)[0]
    picks = fs.pick_f1_configs(torch.from_numpy(data))
    assert picks[0] == (1, 1) and cand_sets[1] == [(0, 0)]
    assert picks == [(1, 1), (1, 1)]
    got = fs.filter_stage(torch.from_numpy(data), picks).numpy()
    assert np.array_equal(got, spec.filters_encode(data, 1))


def _records(n=140000):
    rng = np.random.default_rng(55)
    data = np.frombuffer(
        b"".join(bytes([i % 256, (i * 3) % 256, 7, (i // 5) % 256])
                 for i in range(n // 4 + 1)), dtype=np.uint8)[:n].copy()
    data[rng.integers(0, n, 1500)] = rng.integers(0, 256, 1500)
    return data


def test_f2_filter_bytes_match_spec():
    data = _records()
    got = fs.filters_encode_f2_device(torch.from_numpy(data)).numpy()
    assert np.array_equal(got, spec.filters_encode(data, 2))


def test_f2_filter_bytes_match_jax():
    data = _records()[:30000]
    got = fs.filters_encode_f2_device(torch.from_numpy(data)).numpy()
    assert np.array_equal(got, jfs.filters_encode_f2_device(data))


# ---------------------------------------------------------------------------
# the block encode with -f1 and -f2


@pytest.mark.parametrize("filters", [1, 2])
def test_block_encode_matches_native_and_round_trips(filters):
    data = _structured()
    opt = Options(blocksize=1 << 20, match_finder=3, filters=filters,
                  rans_lanes=4, ans_chunk=4 << 10, anchor_units=960,
                  lpx_spans=0)
    s1 = torch.from_numpy(np.concatenate([END_TOKEN, data]))
    picks = filter_configs(s1, filters)
    assert picks.shape == (4, 2) and (s1.numel() % FBS) != 0
    # delta, LPC and inline delta all picked, LPC on the ragged chunk
    assert {int(t) for t, w in picks if w > 0} == {0, 1, 2}
    assert tuple(picks[-1]) == (1, 1)
    times = {}
    got = encode_block_device_ex(data, opt, "cpu", times)
    assert got == compress_block_ex(data, opt, NativeEngine())
    assert {"search", "filters", "bwt"} <= set(times)
    crc, payload, spans = got
    back = decode_block_device(payload, crc, opt.blocksize, 960, 4, spans,
                               device="cpu")
    assert np.array_equal(back, data)
