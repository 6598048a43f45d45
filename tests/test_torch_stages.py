"""RLE0, LZ77 and filter decode of the port equal their JAX counterparts
(device_stages.rle0_decode_core, lz_decode_dyn_core,
filters_decode_dyn_core) and the numpy spec.  Exact equality."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.format.constants import FILTER_BLOCK_SIZE
from jampack_tpu.kernels import device_stages as jds
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Engine
from jampack_tpu.stages.filters import _apply, filters_decode
from jampack_tpu.stages.lz77 import lz77_decode
from jampack_tpu.stages.rle0 import rle0_encode
from jampack_tpu_torch.kernels import device_stages as tds

RNG = np.random.default_rng(5)


# ---------------------------------------------------------------------------
# RLE0


def _rle_rows(chunks, S):
    syms = np.zeros((len(chunks), S), np.uint16)
    rlens = np.zeros(len(chunks), np.int32)
    for c, s in enumerate(chunks):
        syms[c, :s.size] = s
        rlens[c] = s.size
    return syms, rlens


def _rle_both(syms, rlens, olens, ocap):
    fn = jax.jit(jax.vmap(partial(jds.rle0_decode_core, out_cap=ocap)))
    a, aok = fn(jnp.asarray(syms), jnp.asarray(rlens), jnp.asarray(olens))
    b, bok = tds.rle0_decode(torch.from_numpy(syms.astype(np.int32)),
                             torch.from_numpy(rlens), torch.from_numpy(olens),
                             ocap)
    return (np.asarray(a), np.asarray(aok)), (b.numpy(), bok.numpy())


def test_rle0_matches_jax():
    datas = [(RNG.integers(0, 4, 3000) * (RNG.random(3000) < 0.3)).astype(np.uint8),
             np.zeros(2500, np.uint8),
             RNG.integers(0, 256, 1800).astype(np.uint8),
             np.zeros(0, np.uint8)]
    chunks = [rle0_encode(d) for d in datas]
    syms, rlens = _rle_rows(chunks, max(c.size for c in chunks) + 5)
    olens = np.asarray([d.size for d in datas], np.int32)
    (a, aok), (b, bok) = _rle_both(syms, rlens, olens, 3000)
    assert np.array_equal(a, b) and np.array_equal(aok, bok) and bok.all()
    for c, d in enumerate(datas):
        assert np.array_equal(b[c, :d.size], d)


def test_rle0_run_over_30_bits_is_not_ok():
    long_run = np.concatenate([np.ones(31, np.uint16), [5, 7]]).astype(np.uint16)
    good = rle0_encode(np.asarray([3, 0, 0, 9], np.uint8))
    syms, rlens = _rle_rows([long_run, good], 40)
    olens = np.asarray([64, 4], np.int32)
    (a, aok), (b, bok) = _rle_both(syms, rlens, olens, 64)
    assert np.array_equal(aok, bok) and bok.tolist() == [False, True]
    assert np.array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# LZ77


def _lz_case(mode, n, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 5, n).astype(np.uint8)
    text = np.frombuffer(b"the lz stage copies earlier bytes. " * (n // 35 + 1),
                         np.uint8)[:n]
    data = np.concatenate([base, text, base[: n // 2], text, base])
    return data, np.asarray(Engine().lz_encode(data, mode), np.uint8)


@pytest.mark.parametrize("mode", [0, 1, 2, 3], ids=["m0", "m1", "m2", "store"])
def test_lz_matches_jax(mode):
    data, enc = _lz_case(mode, 3000, mode)
    cap, mt = 1 << 15, 512
    padded = np.zeros(cap, np.uint8)
    padded[:enc.size] = enc
    a, alen, aok = jax.jit(partial(jds.lz_decode_dyn_core, max_tokens=mt,
                                   out_cap=cap))(jnp.asarray(padded), enc.size)
    b, blen, bok = tds.lz_decode_dyn(torch.from_numpy(enc.copy()), enc.size,
                                     mt, cap)
    assert (blen, bok) == (int(alen), bool(aok)) == (data.size, True)
    assert np.array_equal(b.numpy(), np.asarray(a)[:blen])
    assert np.array_equal(b.numpy(), lz77_decode(enc))


def test_lz_truncated_stream_is_not_ok():
    _, enc = _lz_case(1, 2000, 7)
    cut = enc[: enc.size // 2].copy()
    cap = 1 << 14
    padded = np.zeros(cap, np.uint8)
    padded[:cut.size] = cut
    _, alen, aok = jax.jit(partial(jds.lz_decode_dyn_core, max_tokens=256,
                                   out_cap=cap))(jnp.asarray(padded), cut.size)
    _, blen, bok = tds.lz_decode_dyn(torch.from_numpy(cut), cut.size, 256, cap)
    assert bok is False and bool(aok) is False
    assert blen == int(alen)


def _wrapped_literal_stream():
    """Token 0x07 (literal extension follows), offset 1, a 5-byte literal
    extension making lit = 2^31 - 1, then 64 zero bytes: the next token's
    position wraps int32 negative."""
    from jampack_tpu_torch.format.varint import encode_leb128

    ext = encode_leb128(2**31 - 1 - 7)
    assert len(ext) == 5
    return np.frombuffer(bytes([0x07, 0x81]) + ext + bytes(64), np.uint8)


@pytest.mark.parametrize("case", ["wrapped", "cut", "short_store"])
def test_lz_parse_matches_jax_on_odd_windows(case):
    """Token windows that start below 0 (a wrapped literal run) or run past
    the buffer: every output of the parse equals lz_parse_core's."""
    if case == "short_store":
        buf = np.asarray(Engine().lz_encode(np.arange(5, dtype=np.uint8), 3),
                         np.uint8)
    else:
        buf = _wrapped_literal_stream()
        if case == "cut":
            buf = buf[:7].copy()
    args = (buf.size, 8, 1 << 20)
    want = jds.lz_parse_core(jnp.asarray(buf), *args)
    got = tds.lz_parse(torch.from_numpy(buf.copy()), *args)
    names = ("dst", "src", "lit", "off", "match", "t", "out_len", "bad")
    for name, g, w in zip(names, got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name
    if case == "wrapped":
        assert int(got[5]) == 2 and bool(got[7])


# ---------------------------------------------------------------------------
# Filters


def _handmade_stream(rng):
    """Four chunks with chosen configs: LPC width 3, inline delta width 4,
    delta width 2, and a short raw tail."""
    out = bytearray()
    for ftype, width, n in ((1, 3, FILTER_BLOCK_SIZE), (2, 4, FILTER_BLOCK_SIZE),
                            (0, 2, FILTER_BLOCK_SIZE), (0, 0, 999)):
        chunk = (np.arange(n) // 7 + rng.integers(0, 3, n)).astype(np.uint8)
        out += bytes([ftype, width]) + _apply(chunk, ftype, width).tobytes()
    return np.frombuffer(bytes(out), np.uint8)


def _structured(n):
    i = np.arange(n)
    return np.stack([i % 256, (i * 3) % 256, np.full(n, 7), (i // 7) % 256],
                    1).reshape(-1)[:n].astype(np.uint8)


@pytest.mark.parametrize("case", ["f0", "f1", "f2", "lpc+inline"])
def test_filters_match_jax(case):
    if case == "lpc+inline":
        enc = _handmade_stream(np.random.default_rng(3))
    else:
        enc = np.asarray(NativeEngine().filters_encode(
            _structured(90000), int(case[1])), np.uint8)
    cap = 1 << 18
    padded = np.zeros(cap, np.uint8)
    padded[:enc.size] = enc
    a, alen, aok = jax.jit(partial(jds.filters_decode_dyn_core, out_cap=cap))(
        jnp.asarray(padded), enc.size)
    b, blen, bok = tds.filters_decode_dyn(torch.from_numpy(enc.copy()),
                                          enc.size, cap)
    assert (blen, bool(bok)) == (int(alen), bool(aok))
    assert bool(bok)
    assert np.array_equal(b.numpy(), np.asarray(a)[:blen])
    assert np.array_equal(b.numpy(), filters_decode(enc))


def test_filters_bad_header_is_not_ok():
    enc = _handmade_stream(np.random.default_rng(4)).copy()
    enc[FILTER_BLOCK_SIZE + 2] = 5  # chunk 1 claims filter type 5
    cap = 1 << 18
    padded = np.zeros(cap, np.uint8)
    padded[:enc.size] = enc
    _, alen, aok = jax.jit(partial(jds.filters_decode_dyn_core, out_cap=cap))(
        jnp.asarray(padded), enc.size)
    _, blen, bok = tds.filters_decode_dyn(torch.from_numpy(enc), enc.size, cap)
    assert bool(bok) is False and bool(aok) is False
    assert blen == int(alen)
