"""The port's SRC rank decode equals rank_decode_core and the Pallas kernel.

On the CPU, rank_decode runs its plain PyTorch version; the JAX side runs
device_stages.rank_decode_core and rank_pallas.rank_decode_pallas in
interpret mode.  Integer codec: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels.device_stages import rank_decode_core, rank_setup_core
from jampack_tpu.kernels.rank_pallas import rank_decode_pallas
from jampack_tpu.stages.rank import rank_decode as spec_decode
from jampack_tpu.stages.rank import rank_encode
from jampack_tpu_torch.kernels.rank import (
    rank_decode,
    rank_decode_plain,
    rank_setup,
)
from rank_cases import CASES, edge_chunks, rank_rows


def _rows(sizes, seed, ocap):
    """Rank rows of chunks of the given sizes (<= 0: a padding lane)."""
    rng = np.random.default_rng(seed)
    L = len(sizes)
    ranks = np.zeros((L, ocap), np.uint8)
    freqs = np.zeros((L, 256), np.int32)
    olens = np.asarray(sizes, np.int32)
    want = []
    for l, n in enumerate(sizes):
        if n <= 0:
            want.append(None)
            continue
        alpha = 256 if l % 3 == 0 else int(rng.integers(2, 12))
        data = rng.integers(0, alpha, n).astype(np.uint8)
        if l % 3 == 1:  # long runs: buckets exhaust early and retire
            data = np.repeat(data[: n // 50 + 1], 50)[:n]
        r, f = rank_encode(data)
        ranks[l, :n] = r
        freqs[l] = f
        want.append(data)
    return ranks, freqs, olens, want


def _port(ranks, freqs, olens, ocap):
    out, ok = rank_decode(torch.from_numpy(ranks), torch.from_numpy(freqs),
                          torch.from_numpy(olens), ocap)
    return out.numpy(), ok.numpy()


def test_plain_matches_jax_and_pallas_with_padding_lanes():
    ocap = 2048
    ranks, freqs, olens, want = _rows([1500, 2048, 0, 700, -3, 1], 3, ocap)
    got, ok = _port(ranks, freqs, olens, ocap)
    args = (jnp.asarray(ranks), jnp.asarray(freqs), jnp.asarray(olens), ocap)
    a, aok = rank_decode_core(*args)
    b, bok = rank_decode_pallas(*args, interpret=True)
    assert np.array_equal(got, np.asarray(a)) and np.array_equal(ok, np.asarray(aok))
    assert np.array_equal(got, np.asarray(b)) and np.array_equal(ok, np.asarray(bok))
    assert ok.all()
    for l, data in enumerate(want):
        if data is not None:
            assert np.array_equal(got[l, :data.size], data)
            assert not got[l, data.size:].any()


def test_chunk_longer_than_packed_cursor_limit():
    """ocap > 0x7FFF: the TPU kernel's packed cur|end<<16 word cannot hold
    it; the port keeps two arrays."""
    ocap = 0x8000 + 1000
    ranks, freqs, olens, want = _rows([ocap, 20000], 8, ocap)
    got, ok = _port(ranks, freqs, olens, ocap)
    a, aok = rank_decode_core(jnp.asarray(ranks), jnp.asarray(freqs),
                              jnp.asarray(olens), ocap)
    assert np.array_equal(got, np.asarray(a))
    assert np.array_equal(ok, np.asarray(aok)) and ok.all()
    assert np.array_equal(got[0], spec_decode(ranks[0], freqs[0]))


def test_corrupt_freq_table_flags_lane():
    ocap = 512
    ranks, freqs, olens, _ = _rows([512, 300, 400], 5, ocap)
    freqs[1, 7] += 3  # totals no longer match olen
    # buckets run dry before olen: the walk goes on past the last retire
    freqs[2, np.flatnonzero(freqs[2])[:2]] = 0
    got, ok = _port(ranks, freqs, olens, ocap)
    a, aok = rank_decode_core(jnp.asarray(ranks), jnp.asarray(freqs),
                              jnp.asarray(olens), ocap)
    assert np.array_equal(ok, np.asarray(aok))
    assert ok.tolist() == [True, False, False]
    assert np.array_equal(got, np.asarray(a))


def test_setup_matches_jax():
    ranks, freqs, _, _ = _rows([900, 64, 1], 11, 1024)
    freqs[2, 5] = freqs[2, 9] = 4  # frequency ties go to the lowest symbol
    mine = rank_setup(torch.from_numpy(ranks), torch.from_numpy(freqs))
    ref = rank_setup_core(jnp.asarray(ranks), jnp.asarray(freqs))
    for m, r in zip(mine, ref):
        assert np.array_equal(m.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_on_lane_layout_edge_cases(case):
    """Periods that cross the warp kernel's lane boundaries (8 list entries
    a lane), one-symbol chunks, a ragged width, all 256 symbols tied."""
    chunks, olens = edge_chunks(case)
    ranks, freqs = rank_rows(chunks, olens)
    ocap = chunks.shape[1]
    out, ok = rank_decode_plain(torch.from_numpy(ranks),
                                torch.from_numpy(freqs),
                                torch.from_numpy(olens), ocap)
    a, aok = rank_decode_core(jnp.asarray(ranks), jnp.asarray(freqs),
                              jnp.asarray(olens), ocap)
    assert np.array_equal(out.numpy(), np.asarray(a))
    assert np.array_equal(ok.numpy(), np.asarray(aok)) and ok.all()
    j = np.arange(ocap)[None, :]
    assert np.array_equal(out.numpy(), np.where(j < olens[:, None], chunks, 0))


def test_chip_smoke_worst_case_ranks_are_the_spec():
    """chip_smoke.period256 writes the rank rows of its period-256 chunks
    from the period alone; they must be the spec's."""
    import chip_smoke

    rows, ranks, freqs = chip_smoke.period256(3, 1024, 5)
    want_r, want_f = rank_rows(rows, np.full(3, 1024, np.int32))
    assert np.array_equal(ranks, want_r) and np.array_equal(freqs, want_f)
    assert (want_r == 255).sum() == 3 * (1024 - 255)  # steps 255 onwards
