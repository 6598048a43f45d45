"""The port's host engines and the pieces around them, on the CPU, held
against the JAX package: the native engine's binding and each of its
stages, compress_stream with it on the six golden JAM flag sets, the numpy
spec engine on small inputs, the hybrid engine (its BWT on the CPU's
plain versions, and its gate), the per-stage GPU engine's Lpx past the C6
bound against the native engine, sysinfo and the metrics.  Every
comparison is exact."""

import io

import numpy as np
import pytest
import torch

from jampack_tpu import native as jnative
from jampack_tpu.runtime import pipeline as jpipeline
from jampack_tpu.runtime.engines import NativeEngine as JaxNative
from jampack_tpu_torch import native
from jampack_tpu_torch.runtime import engines, pipeline, sysinfo
from jampack_tpu_torch.runtime.metrics import InstrumentedEngine

from golden_cases import GOLDEN_OPTIONS, _read, one_thread
from lpx_cases import log_records
from lz_encode_cases import block, mixed

JN = JaxNative()


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_binding_matches_the_jax_package():
    data = block(40000, 3)
    assert native.checksum(data) == jnative.checksum(data)
    _eq(native.sais(data), jnative.sais(data))
    for units in (1, 120, 960):
        fwd = native.bwt_forward(data, units)
        _eq(fwd, jnative.bwt_forward(data, units))
        _eq(native.bwt_inverse(fwd, 2, units), jnative.bwt_inverse(fwd, 2, units))
    for chunk, lanes in ((0, 0), (4096, 4), (2048, 16)):
        enc = native.ans_encode(data, chunk, lanes)
        _eq(enc, jnative.ans_encode(data, chunk, lanes))
        _eq(native.ans_decode(enc, 1 << 17, 2, lanes),
            jnative.ans_decode(enc, 1 << 17, 2, lanes))
    for spans in (4, 16):
        enc = native.lpx_encode(data, 2, spans)
        _eq(enc, jnative.lpx_encode(data, 2, spans))
        _eq(native.lpx_decode(enc, 2, spans), jnative.lpx_decode(enc, 2, spans))
    for mode in (0, 1, 2, 3):
        enc = native.filters_encode(data, mode, 2)
        _eq(enc, jnative.filters_encode(data, mode, 2))
        _eq(native.filters_decode(enc), jnative.filters_decode(enc))
    for mode in (0, 1, 2):
        enc = native.lz_encode(data, mode)
        _eq(enc, jnative.lz_encode(data, mode))
        _eq(native.lz_decode(enc, 1 << 17), jnative.lz_decode(enc, 1 << 17))


def test_binding_errors_match():
    bad = np.frombuffer(b"\x01\x02\x03" * 50, np.uint8)
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.ans_decode(bad, 1 << 12)
        with pytest.raises(ValueError):
            mod.filters_decode(np.frombuffer(b"\x07\x00abc", np.uint8))


@pytest.mark.parametrize("stage", ["lz_encode", "filters", "lpx", "bwt",
                                   "ans", "lz_decode", "checksum"])
def test_native_engine_stages(stage):
    mine, ref = engines.NativeEngine(threads=2), JaxNative(threads=2)
    data = block(50000, 5)
    if stage == "lz_encode":
        for mode in (0, 1, 2, 3):
            _eq(mine.lz_encode(data, mode), ref.lz_encode(data, mode))
    elif stage == "lz_decode":
        for mode in (0, 1, 3):
            s = ref.lz_encode(data, mode)
            _eq(mine.lz_decode(s), ref.lz_decode(s))
            _eq(mine.lz_decode(s, cap=data.size), data)
    elif stage == "filters":
        for mode in (0, 1, 2):
            enc = mine.filters_encode(data, mode)
            _eq(enc, ref.filters_encode(data, mode))
            _eq(mine.filters_decode(enc), data)
    elif stage == "lpx":
        for spans in (1, 4, 4096):
            enc = mine.lpx_encode(data, spans)
            _eq(enc, ref.lpx_encode(data, spans))
            _eq(mine.lpx_decode(enc, spans), data)
    elif stage == "bwt":
        for units in (120, 960):
            enc = mine.bwt_forward(data, units)
            _eq(enc, ref.bwt_forward(data, units))
            _eq(mine.bwt_inverse(enc, units), data)
    elif stage == "ans":
        for chunk, lanes in ((1 << 20, 0), (16384, 4)):
            enc = mine.ans_encode(data, chunk, lanes)
            _eq(enc, ref.ans_encode(data, chunk, lanes))
            _eq(mine.ans_decode(enc, lanes=lanes), data)
    else:
        assert mine.checksum(data) == ref.checksum(data)


@pytest.mark.parametrize("name", sorted(GOLDEN_OPTIONS))
def test_compress_stream_native_writes_the_golden_archives(name):
    data = _read("golden_input.bin")
    out = io.BytesIO()
    raw, comp = pipeline.compress_stream(
        io.BytesIO(data), out, pipeline.Options(**GOLDEN_OPTIONS[name]),
        engines.NativeEngine())
    assert out.getvalue() == _read(name)
    assert raw == len(data)


@pytest.mark.parametrize("kw", [{}, {"filters": 2, "match_finder": 1},
                                {"match_finder": 2, "lpx_spans": 16},
                                {"anchor_units": 24, "rans_lanes": 4,
                                 "ans_chunk": 2048, "lpx_spans": 0},
                                {"lpx_spans": 64, "lpx_auto": True}])
def test_numpy_engine_matches_the_jax_spec_engine(kw):
    """The spec engine (Python loops: 8 KiB) writes the JAX spec engine's
    archive and the native engine's, and reads it back."""
    data = block(8 << 10, 9).tobytes()
    want = io.BytesIO()
    jpipeline.compress_stream(io.BytesIO(data), want,
                              jpipeline.Options(**kw), jpipeline.Engine())
    got, nat = io.BytesIO(), io.BytesIO()
    pipeline.compress_stream(io.BytesIO(data), got, pipeline.Options(**kw),
                             pipeline.Engine())
    pipeline.compress_stream(io.BytesIO(data), nat, pipeline.Options(**kw),
                             engines.NativeEngine())
    assert got.getvalue() == want.getvalue() == nat.getvalue()
    back = io.BytesIO()
    pipeline.decompress_stream(io.BytesIO(got.getvalue()), back,
                               pipeline.Engine())
    assert back.getvalue() == data


@pytest.mark.parametrize("kw", [{}, {"match_finder": 1, "filters": 2},
                                {"anchor_units": 960, "rans_lanes": 4,
                                 "ans_chunk": 16384, "lpx_spans": 4096,
                                 "lpx_auto": True}])
def test_hybrid_engine_writes_the_native_archive(kw):
    data = np.concatenate([block(40000, 2), mixed(30000, 3)]).tobytes()
    opt = pipeline.Options(**kw)
    want, got = io.BytesIO(), io.BytesIO()
    pipeline.compress_stream(io.BytesIO(data), want, opt,
                             engines.NativeEngine())
    hyb = engines.HybridEngine(device="cpu")
    with one_thread():
        pipeline.compress_stream(io.BytesIO(data), got, opt, hyb)
        back = io.BytesIO()
        pipeline.decompress_stream(io.BytesIO(got.getvalue()), back, hyb)
    assert got.getvalue() == want.getvalue()
    assert back.getvalue() == data
    assert hyb.routes == {"device": 2}


def test_hybrid_engine_gate_takes_the_native_bwt(monkeypatch):
    """A block the gate refuses takes the native BWT (the reference's -g
    semantics, bwt.cpp:102-114)."""
    hyb = engines.HybridEngine(device="cpu")
    monkeypatch.setattr(hyb, "_device_fits", lambda nbytes: False)
    data = block(20000, 4)
    fwd = hyb.bwt_forward(data, 120)
    _eq(fwd, JN.bwt_forward(data, 120))
    _eq(hyb.bwt_inverse(fwd, 120), data)
    assert hyb.routes == {"host": 2}


def test_cuda_engines_and_the_gate_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for make in (engines.HybridEngine, engines.GpuEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sysinfo.fits_on_device(8 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sysinfo.device_memory()


def test_sysinfo_host_half():
    from jampack_tpu.runtime import sysinfo as jsysinfo

    assert sysinfo.core_count() == jsysinfo.core_count()
    assert sysinfo.available_memory() > 0
    with pytest.raises(ValueError):
        sysinfo.device_memory("cpu")


def test_gpu_engine_lpx_past_the_c6_bound_follows_native():
    """One span of 28 KiB, past the 26.7 KiB where the JAX walk may depart
    from the native engine (ROADMAP C6): the port is held to native."""
    s2 = JN.filters_encode(JN.lz_encode(log_records(28 << 10), 0), 1)
    gpu = engines.GpuEngine("cpu")
    with one_thread():
        enc = gpu.lpx_encode(s2, 1)
        _eq(enc, JN.lpx_encode(s2, 1))
        _eq(gpu.lpx_decode(enc, 1), s2)


def test_instrumented_engine_times_every_stage():
    eng = InstrumentedEngine(engines.NativeEngine())
    assert eng.name == "native+metrics"
    data = block(30000, 1)
    crc, payload, _ = pipeline.compress_block_ex(data, pipeline.Options(),
                                                 eng)
    pipeline.decompress_block(payload, crc, eng)
    rows = eng.metrics.summary()
    assert set(rows) == {"checksum", "lz_encode", "filters_encode",
                         "lpx_encode", "bwt_forward", "ans_encode",
                         "ans_decode", "bwt_inverse", "lz_decode",
                         "lpx_decode", "filters_decode"}
    assert rows["lz_encode"]["calls"] == 2 and rows["checksum"]["calls"] == 2
    assert all(k in eng.metrics.report() for k in rows)


def test_hybrid_routes_count_every_call_on_threads():
    """Sixteen threads, more than the cores, bump the route counts with a
    short switch interval: none of the 8,000 calls is lost."""
    import sys
    import threading

    hyb = engines.HybridEngine(device="cpu")

    def work():
        for _ in range(500):
            hyb._route(10)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert hyb.routes == {"device": 16 * 500}
