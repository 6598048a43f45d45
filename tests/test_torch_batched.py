"""The port's batched block chains against the JAX package's, exactly:
decode_blocks_device (a batch a span-word group, the corrupt block named
by the caller's index) and encode_blocks_device (-m3, byte-identical to
JAX's and to the native engine), on blocks of 4-12 KiB at -b1, on the
CPU (the plain versions of the kernels).  A batch runs each batched
stage once: the wrappers of K1, K2 and K10 are called once a span-word
group (the launch counts themselves are held on the card by
tests/test_torch_gpu.py)."""

import contextlib

import numpy as np
import pytest

from golden_cases import one_thread
from jampack_tpu.runtime import device_decode as jdd
from jampack_tpu.runtime import device_encode as jde
from jampack_tpu.runtime.pipeline import Options as JOptions
from jampack_tpu_torch.kernels import device_stages, encode_stages
from jampack_tpu_torch.runtime import device_decode as dd
from jampack_tpu_torch.runtime import device_encode as de
from jampack_tpu_torch.runtime.engines import NativeEngine
from jampack_tpu_torch.runtime.options import Options
from jampack_tpu_torch.runtime.pipeline import compress_block_ex

RNG = np.random.default_rng(77)
DEC = dict(blocksize=1 << 20, filters=1, match_finder=0, rans_lanes=4,
           ans_chunk=2048, anchor_units=16)


def _corpus(n: int) -> np.ndarray:
    """tests/test_device_pipeline.py's blocks: records, text, small noise
    and a repeated run for the dedupe LZ."""
    rec = np.frombuffer(
        b"".join(bytes([i % 256, (i * 3) % 256, 7]) for i in range(n // 6)),
        dtype=np.uint8)
    txt = np.frombuffer(
        (b"device resident decode " * (n // 23 + 1))[: n // 3], dtype=np.uint8)
    noise = RNG.integers(0, 5, n // 4).astype(np.uint8)
    return np.concatenate([rec, txt, noise, rec[:400].copy()])


def _framed(spans_per_block, sizes):
    """Blocks and their (crc, payload) from the native engine, each at its
    span word."""
    blocks = [_corpus(n) for n in sizes]
    crcs, payloads = [], []
    for b, s in zip(blocks, spans_per_block):
        crc, payload, _ = compress_block_ex(b, Options(**DEC, lpx_spans=s),
                                            NativeEngine())
        crcs.append(crc)
        payloads.append(payload)
    return blocks, crcs, payloads


@contextlib.contextmanager
def _calls(module, names):
    """Counts the calls of module.<name> for each name while active."""
    counts = dict.fromkeys(names, 0)
    real = {name: getattr(module, name) for name in names}

    def spy(name):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return wrapped

    for name in names:
        setattr(module, name, spy(name))
    try:
        yield counts
    finally:
        for name in names:
            setattr(module, name, real[name])


BATCHED = ("decode_lanes_wide", "rank_decode", "lpx_blocks")


def test_decode_blocks_one_batch():
    """Four -S8 blocks: the plaintext back, JAX's output, and one call of
    each batched stage for the four."""
    sizes = [int(RNG.integers(4000, 12000)) for _ in range(4)]
    blocks, crcs, payloads = _framed([8] * 4, sizes)
    with one_thread(), _calls(device_stages, BATCHED) as counts:
        outs = dd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, 8,
                                       "cpu")
    assert counts == dict.fromkeys(BATCHED, 1)
    want = jdd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, 8)
    for got, jax_got, block in zip(outs, want, blocks):
        assert np.array_equal(got, block)
        assert np.array_equal(got, np.asarray(jax_got))


def test_decode_blocks_mixed_spans():
    """-Sa archives mix span words: [8, 0, 8, 0] runs as two batches, in
    block order, equal to JAX's."""
    spans = [8, 0, 8, 0]
    blocks, crcs, payloads = _framed(
        spans, [int(RNG.integers(4000, 12000)) for _ in spans])
    with one_thread(), _calls(device_stages, BATCHED) as counts:
        outs = dd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, spans,
                                       "cpu")
    assert counts == {"decode_lanes_wide": 2, "rank_decode": 2,
                      "lpx_blocks": 1}
    want = jdd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, spans)
    for got, jax_got, block in zip(outs, want, blocks):
        assert np.array_equal(got, block)
        assert np.array_equal(got, np.asarray(jax_got))


@pytest.mark.parametrize("spans,bad", [(8, 1), ([8, 0, 8], 2)])
def test_decode_blocks_corrupt_names_callers_block(spans, bad):
    """A corrupt payload raises naming the caller's index of the block,
    also after span grouping reorders the batches, as JAX's does
    (tests/test_device_pipeline.py holds JAX's to it)."""
    words = [spans] * 3 if np.ndim(spans) == 0 else spans
    _, crcs, payloads = _framed(words, [6000] * 3)
    broken = bytearray(payloads[bad])
    broken[len(broken) // 2] ^= 0x40
    payloads[bad] = bytes(broken)
    with one_thread(), pytest.raises(ValueError, match=f"block {bad}"):
        dd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, spans, "cpu")


@pytest.mark.parametrize("spans,bad", [(8, 2), ([8, 0, 8], 0)])
def test_decode_blocks_wrong_crc_names_callers_block(monkeypatch, spans, bad):
    """A stored CRC off by one raises "detected corrupt block i" with the
    caller's index.  The check goes through the module's integrity_check
    (the benchmark's crc.* wraps that name), once a block: every block of
    a clean batch, and every block up to the bad one."""
    words = [spans] * 3 if np.ndim(spans) == 0 else spans
    blocks, crcs, payloads = _framed(words, [6000] * 3)
    checked = []
    real = dd.integrity_check

    def spy(data):
        checked.append(bytes(data))
        return real(data)

    monkeypatch.setattr(dd, "integrity_check", spy)
    with one_thread():
        outs = dd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, spans,
                                       "cpu")
        assert sorted(checked) == sorted(b.tobytes() for b in blocks)
        assert all(np.array_equal(o, b) for o, b in zip(outs, blocks))
        checked.clear()
        crcs[bad] = (crcs[bad] + 1) & 0xFFFFFFFF
        with pytest.raises(ValueError,
                           match=f"^detected corrupt block {bad}$"):
            dd.decode_blocks_device(payloads, crcs, 1 << 20, 16, 4, spans,
                                    "cpu")
    assert checked[-1] == blocks[bad].tobytes()
    assert len(checked) == len(set(checked))


def test_decode_blocks_core_equals_block_core():
    """decode_block_core is decode_blocks_core on one block: the batch
    gives each block what its batch of one gives."""
    import torch

    blocks, _, payloads = _framed([0, 0, 0], [4100, 9000, 6200])
    metas = [dd.block_meta(p, 4) for p in payloads]
    pays = [torch.from_numpy(np.frombuffer(p, np.uint8).copy())
            for p in payloads]
    offsets = np.cumsum([0] + [len(p) for p in payloads])
    with one_thread():
        outs, ns, oks = device_stages.decode_blocks_core(
            torch.cat(pays), offsets, metas, 4, 16, 1 << 20, 1 << 16, 0)
        for pay, meta, out, n, ok, block in zip(pays, metas, outs, ns, oks,
                                                blocks):
            one = device_stages.decode_block_core(pay, meta, 4, 16, 1 << 20,
                                                  1 << 16, 0)
            assert (n, ok) == (one[1], one[2]) == (block.size, True)
            assert torch.equal(out, one[0])


@pytest.mark.parametrize("filters", [0, 1])
def test_encode_blocks_matches_jax_and_native(filters):
    """Three same-length blocks at -m3 -L4 -c2 -u8 -S16: one call of each
    batched encode stage, payloads equal to JAX's encode_blocks_device and
    to the native engine's compress_block_ex."""
    blocks = [_corpus(6000) for _ in range(3)]
    kw = dict(blocksize=1 << 20, match_finder=3, filters=filters,
              rans_lanes=4, ans_chunk=2048, anchor_units=8, lpx_spans=16)
    names = ("rank_encode", "model_pairs_wide", "rans_reverse_encode_wide",
             "lpx_blocks")
    with one_thread(), _calls(encode_stages, names) as counts:
        got = de.encode_blocks_device(blocks, Options(**kw), "cpu")
    assert counts == dict.fromkeys(names, 1)
    want = jde.encode_blocks_device(blocks, JOptions(**kw))
    assert [g[:2] for g in got] == [tuple(w[:2]) for w in want]
    for g, w, block in zip(got, want, blocks):
        assert g[2] == w[2] == 16
        assert g == compress_block_ex(block, Options(**kw), NativeEngine())


def test_encode_blocks_refuses_what_jax_refuses():
    opt = Options(blocksize=1 << 20, match_finder=1, filters=0)
    with pytest.raises(NotImplementedError):
        de.encode_blocks_device([_corpus(5000)], opt, "cpu")
    with pytest.raises(NotImplementedError):
        jde.encode_blocks_device([_corpus(5000)], JOptions(
            blocksize=1 << 20, match_finder=1, filters=0))
    with pytest.raises(NotImplementedError):
        de.encode_blocks_device([_corpus(5000), _corpus(6000)],
                                Options(blocksize=1 << 20, match_finder=3),
                                "cpu")
