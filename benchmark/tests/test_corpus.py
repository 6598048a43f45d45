"""Each corpus class: the same bytes from the same seed, other bytes from
another, and the statistics its file states."""

import re
import zlib

import numpy as np
import pytest

from benchmark import registry

SPECS = {s["class"]: s["params"]
         for s in registry.traffic("restore")["classes"]}
N = 1 << 18


def make(cls, seed, n=N, layout=0):
    return registry.corpus(cls).generate(n, np.random.default_rng(seed),
                                         np.random.default_rng(layout),
                                         **SPECS[cls])


@pytest.mark.parametrize("cls", sorted(SPECS))
def test_deterministic_by_seed(cls):
    a, b, c = make(cls, 7), make(cls, 7), make(cls, 8)
    assert a.dtype == np.uint8 and a.size == N
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("cls", ["text_zipf", "log_records"])
def test_layout_is_the_seeds_work(cls):
    """Another seed draws other bytes of the same make: its compressed
    size within 3% (the layout fixes the vocabulary or templates); another
    layout makes another corpus."""
    a, b = ratio(make(cls, 7)), ratio(make(cls, 8))
    assert abs(a - b) < 0.03 * a
    assert not np.array_equal(make(cls, 7), make(cls, 7, layout=1))


@pytest.mark.parametrize("cls", sorted(SPECS))
def test_any_length(cls):
    for n in (1, 17, 4099):
        assert make(cls, 3, n).size == n


def ratio(a):
    return len(zlib.compress(a.tobytes(), 6)) / a.size


def test_text_zipf():
    a = make("text_zipf", 1)
    words = re.findall(rb"[a-z]+", a.tobytes())
    _, counts = np.unique(words, return_counts=True)
    top = np.sort(counts)[::-1]
    # Zipf with exponent 1: the r-th word about 1/r as frequent as the first
    assert 1.4 < top[0] / top[1] < 2.8 and 6 < top[0] / top[9] < 16
    assert set(a.tolist()) <= set(b" ,.\n".join(
        bytes([c]) for c in range(97, 123)))
    assert 0.35 < ratio(a) < 0.65


def test_log_records():
    a = make("log_records", 2)
    lines = a.tobytes().split(b"\n")[:-1]
    stamps = [ln[:23] for ln in lines]
    assert all(re.fullmatch(rb"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}", s)
               for s in stamps)
    assert stamps == sorted(stamps)
    levels = [ln.split(b" ")[2] for ln in lines]
    assert levels.count(b"INFO") > levels.count(b"WARN") > 0
    lens = np.array([len(ln) for ln in lines])
    assert lens.std() > 10 and ratio(a) < 0.25


def test_int16_signal():
    a = make("int16_signal", 3).view("<i2").astype(np.float64)
    ch = a.reshape(-1, SPECS["int16_signal"]["channels"])
    lag1 = [np.corrcoef(c[1:], c[:-1])[0, 1] for c in ch.T]
    assert min(lag1) > 0.95 and np.abs(a).max() <= 32767
    assert ratio(make("int16_signal", 3)) > 0.8


def test_incompressible():
    a = make("incompressible", 4)
    hist = np.bincount(a, minlength=256)
    assert hist.min() > 0.8 * N / 256 and ratio(a) > 0.99
