"""The port's fused block encode on the CPU, held against the JAX package.

The same seeded numpy inputs go through each JAX function and its port
(the port on device "cpu", which runs the plain PyTorch versions of the
kernels K4, K5 and K6); every comparison is exact.  The block encode is
also held against the native host engine, whose archives are the byte
contract."""

import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels import sa as jax_sa
from jampack_tpu.kernels.encode_stages import rank_encode_core, rle0_encode_core
from jampack_tpu.kernels.rans_encode import rans_reverse_encode_wide as jax_reverse
from jampack_tpu.kernels.rans_pallas import model_pairs_wide_pallas
from jampack_tpu.kernels.rans_wide import model_pairs_wide as jax_pairs
from jampack_tpu.runtime.device_encode import encode_block_device as jax_encode
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Options, compress_block_ex, compress_stream
from jampack_tpu_torch.kernels import encode_stages, rans_encode, sa
from jampack_tpu_torch.runtime.device_decode import decompress_stream_device
from jampack_tpu_torch.runtime.device_encode import (
    compress_stream_device,
    encode_block_device,
    encode_block_device_ex,
)

from golden_cases import one_thread
from rank_cases import CASES, edge_chunks, rank_rows
from rans_encode_cases import (
    PAIRS_CASES,
    REVERSE_CASES,
    division_edges,
    pairs_case,
    reverse_case,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    rec = np.frombuffer(b"".join(bytes([i % 256, (i * 3) % 256, 7])
                                 for i in range(n // 6)), np.uint8)
    txt = np.frombuffer((b"device resident encode " * (n // 23 + 1))[: n // 3],
                        np.uint8)
    noise = rng.integers(0, 5, n // 4).astype(np.uint8)
    return np.concatenate([rec, txt, noise, rec[:400]])[:n]


def _opt(lanes=4, chunk=16 << 10, units=960, **kw):
    return Options(blocksize=1 << 20, match_finder=3, filters=0,
                   rans_lanes=lanes, ans_chunk=chunk, anchor_units=units,
                   lpx_spans=0, **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# forward BWT


def _bwt_input(kind, n, rng):
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "periodic":
        return np.frombuffer((b"ab" * n)[:n], np.uint8)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return _corpus(n, 2)


@pytest.mark.parametrize("kind,n,units", [
    ("zeros", 3000, 120), ("periodic", 4001, 16), ("random", 5000, 24),
    ("text", 6007, 120), ("text", 100, 120), ("periodic", 959, 960)])
def test_forward_bwt_matches_jax(kind, n, units):
    data = _bwt_input(kind, n, np.random.default_rng(n))
    got = sa.forward_bwt(_t(data), units).numpy()
    assert np.array_equal(got, jax_sa.forward_bwt_tpu(data, units))


# ---------------------------------------------------------------------------
# RLE0 and SRC rank encode


def test_rle0_encode_matches_jax():
    rng = np.random.default_rng(5)
    W = 3000
    rows = np.zeros((4, W), np.uint8)
    olens = np.asarray([2500, W, 0, 1700], np.int32)
    rows[0] = (rng.integers(0, 4, W) * (rng.random(W) < 0.4)).astype(np.uint8)
    rows[1] = 0
    rows[2] = rng.integers(0, 256, W, dtype=np.uint8)
    rows[3] = rng.integers(1, 256, W, dtype=np.uint8)
    syms, rlens = encode_stages.rle0_encode(_t(rows), _t(olens))
    assert syms.dtype == torch.uint16
    for c in range(4):
        want, rlen = rle0_encode_core(jnp.asarray(rows[c]), int(olens[c]), W)
        assert int(rlens[c]) == int(rlen)
        assert np.array_equal(syms[c].int().numpy(), np.asarray(want, np.int32))


def test_rank_encode_matches_jax():
    rng = np.random.default_rng(7)
    L, W = 5, 2048
    chunks = np.zeros((L, W), np.uint8)
    olens = np.asarray([W, 1500, 0, 900, -1], np.int32)
    for l in range(L):
        n = max(int(olens[l]), 0)
        chunks[l, :n] = (_corpus(n + 8, l)[:n] if l % 2 == 0
                         else rng.integers(0, 256, n, dtype=np.uint8))
    chunks[4] = rng.integers(0, 256, W, dtype=np.uint8)  # padding lane
    ranks, freqs = encode_stages.rank_encode(_t(chunks), _t(olens))
    want_r, want_f = rank_encode_core(jnp.asarray(chunks), jnp.asarray(olens))
    assert np.array_equal(ranks.numpy(), np.asarray(want_r))
    assert np.array_equal(freqs.numpy(), np.asarray(want_f))
    assert not ranks[2].any() and not freqs[4].any()


@pytest.mark.parametrize("case", CASES)
def test_rank_encode_plain_matches_jax_on_lane_layout_edge_cases(case):
    """Periods that cross the warp kernel's lane boundaries (8 list entries
    a lane), one-symbol chunks, a ragged width, all 256 symbols tied."""
    chunks, olens = edge_chunks(case)
    ranks, freqs = encode_stages.rank_encode_plain(_t(chunks), _t(olens))
    want_r, want_f = rank_encode_core(jnp.asarray(chunks), jnp.asarray(olens))
    assert np.array_equal(ranks.numpy(), np.asarray(want_r))
    assert np.array_equal(freqs.numpy(), np.asarray(want_f))
    spec_r, spec_f = rank_rows(chunks, olens)
    assert np.array_equal(ranks.numpy(), spec_r)
    assert np.array_equal(freqs.numpy(), spec_f)


# ---------------------------------------------------------------------------
# model pass (K4) and reverse rANS (K5)


def _pairs_case(L, max_rlen, seed, hi=257):
    rng = np.random.default_rng(seed)
    chains = np.zeros((L, max_rlen), np.uint16)
    rlens = rng.integers(0, max_rlen + 1, L).astype(np.int32)
    rlens[0] = max_rlen
    for l in range(L):
        v = rng.integers(0, hi, rlens[l])
        v = np.where(rng.random(rlens[l]) < 0.5, rng.integers(0, 3, rlens[l]), v)
        chains[l, :rlens[l]] = v
    return chains, rlens


def _assert_live_pairs(got, want, rlens):
    """ok flags and the live op slots equal; the port's slots past 2*rlen
    are zero (the JAX pass leaves step values of padding there)."""
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    for l, rl in enumerate(rlens):
        k = 2 * max(int(rl), 0)
        for g, w in zip(got[:2], want[:2]):
            assert np.array_equal(g[l, :k].int().numpy(),
                                  np.asarray(w)[l, :k].astype(np.int32)), l
            assert not g[l, k:].int().any()


@pytest.mark.parametrize("L,mr,seed", [(4, 64, 0), (8, 700, 1), (16, 300, 2)])
def test_model_pairs_matches_jax(L, mr, seed):
    chains, rlens = _pairs_case(L, mr, seed)
    got = rans_encode.model_pairs_wide(_t(chains), _t(rlens), mr)
    assert got[0].dtype == got[1].dtype == torch.uint16
    want = jax_pairs(jnp.asarray(chains), jnp.asarray(rlens), mr)
    _assert_live_pairs(got, want, rlens)
    assert bool(got[2].all())


@pytest.mark.parametrize("wrap", [False, True])
def test_model_pairs_matches_pallas_interpret(wrap):
    """The TPU kernel itself, in interpret mode, at one tiny shape; the
    wrap case hammers invalid quasi symbols into the zero-frequency regime,
    where ok is False in every version."""
    L, mr = 4, 96
    if wrap:
        chains = np.random.default_rng(3).integers(
            16000, 16200, (L, mr)).astype(np.uint16)
        rlens = np.full(L, mr, np.int32)
    else:
        chains, rlens = _pairs_case(L, mr, 4)
    got = rans_encode.model_pairs_wide(_t(chains), _t(rlens), mr)
    want = model_pairs_wide_pallas(jnp.asarray(chains), jnp.asarray(rlens), mr,
                                   interpret=True)
    _assert_live_pairs(got, want, rlens)
    _assert_live_pairs(got, jax_pairs(jnp.asarray(chains), jnp.asarray(rlens),
                                      mr), rlens)
    assert bool(got[2].all()) != wrap


@pytest.mark.parametrize("L,mr,seed", [(4, 64, 5), (9, 500, 6)])
def test_reverse_encode_matches_jax(L, mr, seed):
    chains, rlens = _pairs_case(L, mr, seed)
    rlens[-1] = 0  # an empty chain still flushes its 4 states
    lows, fqs, _ = jax_pairs(jnp.asarray(chains), jnp.asarray(rlens), mr)
    lows, fqs = np.asarray(lows), np.asarray(fqs)
    bufs, ptrs = rans_encode.rans_reverse_encode_wide(
        _t(lows.astype(np.int32)).to(torch.uint16),
        _t(fqs.astype(np.int32)).to(torch.uint16), _t(rlens), mr)
    wb, wp = jax_reverse(jnp.asarray(lows), jnp.asarray(fqs),
                         jnp.asarray(rlens), mr)
    wb, wp = np.asarray(wb), np.asarray(wp)
    assert np.array_equal(ptrs.numpy(), wp)
    for l in range(L):
        assert np.array_equal(bufs[l, int(wp[l]):].numpy(), wb[l, int(wp[l]):]), l
    assert np.array_equal(bufs.numpy(), wb)


def _jax_pairs_np(chains, rlens, mr):
    lows, fqs, _ = jax_pairs(jnp.asarray(chains), jnp.asarray(rlens), mr)
    return np.asarray(lows), np.asarray(fqs)


@pytest.mark.parametrize("name", PAIRS_CASES)
def test_model_pairs_plain_matches_jax_on_encode_cases(name):
    """K4's plain version on the encode cases (tests/rans_encode_cases.py):
    empty and full chains, e < 2 only, every quasi model's rescales up to
    period 1024, model 5's spare count and invalid mantissas."""
    chains, rlens, mr, ok = pairs_case(name)
    got = rans_encode.model_pairs_wide_plain(_t(chains), _t(rlens), mr)
    want = jax_pairs(jnp.asarray(chains), jnp.asarray(rlens), mr)
    _assert_live_pairs(got, want, rlens)
    assert got[2].tolist() == ok


@pytest.mark.parametrize("name", REVERSE_CASES)
def test_reverse_encode_plain_matches_jax_on_encode_cases(name):
    """K5's plain version on the pairs of the encode cases and on garbage
    pairs (fq 0, 1 and 65535; lo + fq > 2^16), every byte and ptr."""
    lows, fqs, rlens, mr = reverse_case(name, _jax_pairs_np)
    got = rans_encode.rans_reverse_encode_wide_plain(
        _t(lows.astype(np.int32)).to(torch.uint16),
        _t(fqs.astype(np.int32)).to(torch.uint16), _t(rlens), mr)
    wb, wp = jax_reverse(jnp.asarray(lows), jnp.asarray(fqs),
                         jnp.asarray(rlens), mr)
    assert np.array_equal(got[1].numpy(), np.asarray(wp))
    assert np.array_equal(got[0].numpy(), np.asarray(wb))


def test_division_plain_at_the_edges():
    """_divmod's plain path (what the gpu test holds K5's division to) at
    the x edges of every 64th fq."""
    fq = np.arange(1, 1 << 16, 64, dtype=np.int64)
    x, f = division_edges(fq)
    q, r = rans_encode._divmod(_t(x), _t(f))
    assert np.array_equal(q.numpy(), x // f) and np.array_equal(r.numpy(), x % f)
    assert (x >= 0).all() and (x < 1 << 32).all()



# ---------------------------------------------------------------------------
# the fused block encode


# the JAX chain compiles once per shape: hold it to three of the cases
_JAX_CASES = {(0, 4096, 120), (4, 2048, 16), (16, 2048, 24)}


@pytest.mark.parametrize("lanes,chunk,units,n", [
    (0, 4096, 120, 12000), (4, 2048, 16, 9000), (16, 2048, 24, 20000),
    (4, 4096, 24, 40000), (0, 2048, 16, 15000), (16, 4096, 120, 30000)])
def test_block_encode_matches_native_and_jax(lanes, chunk, units, n):
    data = _corpus(n, n)
    opt = _opt(lanes, chunk, units)
    got = encode_block_device(data, opt, device="cpu")
    crc, payload, spans = compress_block_ex(data, opt, NativeEngine())
    assert spans == 0 and got == (crc, payload)
    if (lanes, chunk, units) in _JAX_CASES:
        assert got == jax_encode(data, opt)


@pytest.mark.parametrize("n", [0, 1, 959, 960, 4 * 960 - 1, 1023])
def test_block_lengths_match_native(n):
    """Every length, the ones the JAX package sends to the host included,
    encodes on the device path at the slice configuration."""
    data = _corpus(max(n, 8), 9)[:n]
    opt = _opt()
    times = {}
    got = encode_block_device_ex(data, opt, "cpu", times)
    assert got == compress_block_ex(data, opt, NativeEngine())
    assert {"host_crc", "h2d", "bwt", "rank", "model", "rans", "d2h",
            "splice"} <= set(times)


@pytest.mark.parametrize("total", [1 << 20, (1 << 20) + 700])
def test_archive_round_trip(total):
    """A multiple of the block size (1 MiB, the smallest the framing takes)
    gets the trailing empty block; a ragged tail does not.  The port's
    decode gives the input back."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 40, total, dtype=np.uint8).tobytes()
    opt = _opt(16, 2048, 120)
    want = io.BytesIO()
    raw_w, _ = compress_stream(io.BytesIO(data), want, opt, NativeEngine())
    got = io.BytesIO()
    back = io.BytesIO()
    # one torch thread: the plain walks beside other test workers
    with one_thread():
        raw, comp = compress_stream_device(io.BytesIO(data), got, opt, "cpu")
        decompress_stream_device(io.BytesIO(got.getvalue()), back, "cpu")
    assert got.getvalue() == want.getvalue()
    assert raw == raw_w == total and comp == len(got.getvalue())
    assert back.getvalue() == data


@pytest.mark.parametrize("kw", [{"filters": 3},
                                {"match_finder": 0, "filters": 3}])
def test_unported_configurations_raise(kw):
    opt = _opt(4, 2048, 24)
    for k, v in kw.items():
        setattr(opt, k, v)
    with pytest.raises(NotImplementedError):
        encode_block_device(_corpus(5000, 1), opt, device="cpu")


def test_encode_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        encode_block_device(_corpus(5000, 1), _opt(4, 2048, 24))


def test_cpu_encode_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from jampack_tpu.runtime.engines import NativeEngine\n"
        "from jampack_tpu.runtime.pipeline import Options, compress_block_ex\n"
        "from jampack_tpu_torch.runtime.device_encode import encode_block_device_ex\n"
        "data = np.frombuffer(b'no jax on the encode path ' * 300, np.uint8)\n"
        "opt = Options(blocksize=1 << 20, match_finder=3, filters=0,\n"
        "              rans_lanes=4, ans_chunk=2048, anchor_units=24, lpx_spans=0)\n"
        "got = encode_block_device_ex(data, opt, 'cpu')\n"
        "assert got == compress_block_ex(data, opt, NativeEngine())\n"
        "assert sys.modules['jax'] is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _cli(*args, pkg="jampack_tpu_torch"):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli",
                           *map(str, args)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_cli_fused_encode_matches_host(tmp_path):
    """The port's c (the device encode, --engine fused by default) against
    the JAX package's c (the native host engine)."""
    src = tmp_path / "in.bin"
    src.write_bytes(_corpus(30000, 13).tobytes())
    flags = ["-m3", "-f0", "-c4", "-L4", "-u24", "-S0"]
    host, dev, dflt = (tmp_path / f"{k}.jt3" for k in ("host", "dev", "dflt"))
    res = _cli("c", src, host, *flags, pkg="jampack_tpu")
    assert res.returncode == 0, res.stderr
    res = _cli("c", src, dev, *flags, "--engine", "fused", "--device", "cpu")
    assert res.returncode == 0, res.stderr
    assert "[fused x1: cpu]" in res.stdout
    assert dev.read_bytes() == host.read_bytes()
    res = _cli("c", src, dflt, *flags, "--device=cpu")
    assert res.returncode == 0, res.stderr
    assert dflt.read_bytes() == host.read_bytes()
    nat = tmp_path / "native.jt3"
    res = _cli("c", src, nat, *flags, "--engine", "native")
    assert res.returncode == 0, res.stderr
    assert "[native]" in res.stdout
    assert nat.read_bytes() == host.read_bytes()


@pytest.mark.parametrize("flags,word", [
    (["-m0", "-f3", "-S0"], "filter search"),
    (["-m3", "-f3", "-S0"], "filter search")])
def test_cli_fused_refuses_unported(tmp_path, flags, word):
    src = tmp_path / "in.bin"
    src.write_bytes(b"x" * 100)
    res = _cli("c", src, tmp_path / "out.jt3", *flags, "--engine=fused",
               "--device", "cpu")
    assert res.returncode != 0 and word in res.stderr
    assert "--engine gpu" in res.stderr
    assert not (tmp_path / "out.jt3").exists()
