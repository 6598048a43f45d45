"""The port's Lpx stage and LZ token parse on the CPU, held against the JAX
package: the plain version of K10 (lpx_walk_plain) against the JAX span walk
in both its record layouts, the stage (lpx_dyn) against lpx_dyn_core and,
on the shapes JAX sends to the host, against the spec; the -Sa gate
against pipeline._lpx_gain_gate; the plain version of K11 against
lz_parse_core.  Every comparison is exact.  The encodes with Lpx are in
tests/test_torch_lpx_encode.py."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels import device_stages as jds
from jampack_tpu.kernels.lpx_tpu import _code_span_packed, _code_span_wide
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import _lpx_gain_gate
from jampack_tpu.stages.lpx import lpx_decode, lpx_encode
from jampack_tpu_torch.kernels import device_stages as tds
from jampack_tpu_torch.kernels.lpx import lpx_dyn, lpx_walk_plain
from jampack_tpu_torch.runtime.pipeline import gain_gate

from lpx_cases import LZ_BAD, LZ_CASES, log_records, lpx_inputs, lz_case

SPAN = 4096  # the plain walk steps once a byte: a few KiB a span


def _spans():
    """The seven inputs of tests/test_lpx_tpu.py, each cut to SPAN bytes,
    as the spans of one flat buffer."""
    parts = [d[:SPAN] for d in lpx_inputs()]
    lens = np.asarray([p.size for p in parts], np.int32)
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    return parts, np.concatenate(parts), starts, lens


@pytest.mark.parametrize("decode", [False, True])
def test_plain_walk_matches_jax_span_walk_in_both_layouts(decode):
    parts, flat, starts, lens = _spans()
    if decode:  # decode the spec's coding of each span
        parts = [lpx_encode(p, 1) for p in parts]
        flat = np.concatenate(parts)
    got = lpx_walk_plain(torch.from_numpy(flat.copy()),
                         torch.from_numpy(starts), torch.from_numpy(lens),
                         decode).numpy()
    pad = np.zeros((len(parts), SPAN), np.uint8)
    for k, p in enumerate(parts):
        pad[k, :p.size] = p
    for walk in (_code_span_packed, _code_span_wide):
        want = np.asarray(jax.jit(jax.vmap(
            lambda s, n: walk(s, n, SPAN, decode)))(jnp.asarray(pad),
                                                    jnp.asarray(lens)))
        for k, (s, n) in enumerate(zip(starts, lens)):
            assert np.array_equal(got[s:s + n], want[k, :n]), (walk, k)


@pytest.mark.parametrize("n,spans", [(4001, 4), (4001, 16), (6000, 8)])
@pytest.mark.parametrize("decode", [False, True])
def test_stage_matches_lpx_dyn_core(n, spans, decode):
    data = np.concatenate([log_records(n - n // 3),
                           np.random.default_rng(n).integers(
                               0, 256, n // 3, dtype=np.uint8)])
    if decode:
        data = lpx_encode(data, spans)
    out_cap = 1 << 13
    buf = np.zeros(out_cap, np.uint8)
    buf[:n] = data
    want, sup = jax.jit(partial(jds.lpx_dyn_core, out_cap=out_cap,
                                decode=decode, spans=spans))(
        jnp.asarray(buf), jnp.int32(n))
    assert bool(sup)
    got = lpx_dyn(torch.from_numpy(data.copy()), n, spans, decode)
    assert np.array_equal(got.numpy(), np.asarray(want)[:n])


@pytest.mark.parametrize("n,spans", [(30, 16), (3, 4), (0, 4), (200, 64),
                                     (1, 1)])
def test_stage_matches_spec_where_jax_goes_to_the_host(n, spans):
    """n < spans^2 with n % spans > n // spans (more than spans + 1
    pieces), b == 0 (one span of n < spans bytes) and n == 0: the port
    walks them like any other split."""
    data = np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8)
    enc = lpx_dyn(torch.from_numpy(data.copy()), n, spans, False).numpy()
    assert np.array_equal(enc, lpx_encode(data, spans))
    dec = lpx_dyn(torch.from_numpy(enc.copy()), n, spans, True).numpy()
    assert np.array_equal(dec, lpx_decode(enc, spans))
    assert np.array_equal(dec, data)


def test_jax_span_walk_departs_from_native_past_2_31():
    """ROADMAP C6: the JAX walk compares miss > thr * thr * order with the
    product wrapped to a signed int32; the native engine (and lpx.cpp)
    wrap it unsigned, and the spec does not wrap.  On the first 880,000
    bytes of the -f1 stage of 8 MiB of log records, walked as one span (a
    prefix of the first 2 MiB span of -S4), a threshold of 205,862 at order
    2 makes the product 2^31 or more from byte 877,033 on: JAX's output
    departs there, the spec's equals the native engine's.  The port follows
    the native engine; K10 is held to it on the whole 8 MiB by the gpu
    tests and chip_smoke.py, where the plain walk would take minutes."""
    eng = NativeEngine()
    stage = np.asarray(eng.filters_encode(
        eng.lz_encode(log_records(8 << 20), 3), 1), np.uint8)
    n = 880_000
    x = stage[:n]
    native = np.asarray(eng.lpx_encode(x, 1), np.uint8)
    assert np.array_equal(lpx_encode(x, 1), native)
    got = np.asarray(jax.jit(lambda a: _code_span_wide(
        a, jnp.int32(n), n, False))(jnp.asarray(x)))
    assert np.nonzero(got != native)[0][0] == 877_036


@pytest.mark.parametrize("kind", ["records", "periodic", "random", "zeros",
                                  "empty"])
def test_gate_matches_pipeline_gate(kind):
    rng = np.random.default_rng(5)
    data = {"records": log_records(12000),
            "periodic": np.tile(np.arange(7, dtype=np.uint8), 700),
            "random": rng.integers(0, 256, 5000, dtype=np.uint8),
            "zeros": np.zeros(3000, np.uint8),
            "empty": np.zeros(0, np.uint8)}[kind]
    n = data.size
    kept = []
    for spans in (2, 8):
        after = lpx_dyn(torch.from_numpy(data.copy()), n, spans, False).numpy()
        kept.append(gain_gate(int((data == 0).sum()), int((after == 0).sum()),
                              n))
        assert kept[-1] == _lpx_gain_gate(data, after), spans
    assert any(kept) == (kind in ("records", "periodic"))


@pytest.mark.parametrize("name", LZ_CASES)
def test_plain_parse_matches_lz_parse_core(name):
    buf, n, max_tokens, out_cap = lz_case(name)
    want = jds.lz_parse_core(jnp.asarray(buf), n, max_tokens, out_cap)
    got = tds.lz_parse(torch.from_numpy(buf.copy()), n, max_tokens, out_cap)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert got[7] == LZ_BAD[name]
