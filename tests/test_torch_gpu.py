"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked gpu; each test skips where there is no CUDA device.

On a machine with a card (and no JAX, which tests/conftest.py imports):

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider

Integer codec: every comparison is exact."""

import io
import os

import numpy as np
import pytest
import torch

from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Options, compress_block_ex
from jampack_tpu.stages.ans import (
    ans_encode_chunk,
    lane_rlen,
    read_chunk_header,
    read_lane_table,
)
from jampack_tpu.stages.rank import rank_decode as spec_rank_decode
from jampack_tpu.stages.rank import rank_encode
from jampack_tpu_torch.kernels import (
    block_scatter,
    device_stages,
    encode_stages,
    hist,
    ibwt,
    lpc,
    lpx,
    rank,
    rans,
    rans_encode,
)
from jampack_tpu_torch.format import framing as framing
from jampack_tpu_torch.runtime.device_decode import (
    decode_block_device,
    decompress_stream_device,
)
from jampack_tpu_torch.runtime.device_encode import (
    encode_block_device,
    encode_block_device_ex,
)
from jampack_tpu_torch.runtime.options import Options as PortOptions
from ibwt_cases import CASES as CHASE_CASES
from ibwt_cases import chase_inputs
from lpx_cases import LZ_BAD, LZ_CASES, log_records, lz_case, span_bytes
from rank_cases import CASES, edge_chunks, periodic, rank_rows
from rans_cases import CASES as RANS_CASES
from rans_cases import case as rans_case
from rans_encode_cases import (
    PAIRS_CASES,
    REVERSE_CASES,
    division_edges,
    pairs_case,
    reverse_case,
)

pytestmark = pytest.mark.gpu

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk_chains(n, lanes, seed):
    rng = np.random.default_rng(seed)
    data = np.repeat(rng.integers(0, 60, n, dtype=np.uint8),
                     rng.integers(1, 20, n)).astype(np.uint8)[:n]
    blob = ans_encode_chunk(data, lanes)
    view = memoryview(blob)
    _, _, _, rlen, pos = read_chunk_header(view, 0)
    if lanes >= 2:
        clens, p = read_lane_table(view, pos, rlen, lanes)
        starts = np.cumsum([p] + clens[:-1]).astype(np.int32)
        rlens = np.asarray([lane_rlen(rlen, lanes, l) for l in range(lanes)],
                           np.int32)
    else:
        starts, rlens = np.asarray([pos], np.int32), np.asarray([rlen], np.int32)
    return np.frombuffer(blob, np.uint8).copy(), starts, rlens


def _same(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("n,lanes,seed,pad", [
    (3000, 4, 1, 0), (20000, 16, 4, 0), (2500, 0, 5, 0), (4000, 4, 9, 4)])
def test_rans_kernel_matches_plain(cuda, n, lanes, seed, pad):
    buf, starts, rlens = _chunk_chains(n, lanes, seed)
    starts = np.concatenate([starts, np.zeros(pad, np.int32)])
    rlens = np.concatenate([rlens, np.full(pad, -1, np.int32)])
    groups = 2 if pad else 0
    args = [torch.from_numpy(a).to(cuda) for a in (buf, starts, rlens)]
    mr = int(rlens.max()) + 3
    before = rans.KERNEL.launches
    got = rans.decode_lanes_wide(*args, mr, groups=groups)
    assert rans.KERNEL.launches == before + 1
    want = rans.decode_lanes_wide_plain(*args, mr, groups=groups)
    _same(got, want)
    assert bool(got[1].all())


def test_rans_kernel_flags_corrupt_chain(cuda):
    buf, starts, rlens = _chunk_chains(5000, 4, 21)
    buf[int(starts[2]) + 30] ^= 0x5A
    args = [torch.from_numpy(a).to(cuda) for a in (buf, starts, rlens)]
    got = rans.decode_lanes_wide(*args, int(rlens.max()))
    _same(got, rans.decode_lanes_wide_plain(*args, int(rlens.max())))
    assert not bool(got[1].all())


@pytest.mark.parametrize("name", RANS_CASES)
def test_rans_kernel_matches_plain_on_warp_layout_cases(cuda, name):
    buf, starts, rlens, mr, groups = rans_case(name)
    args = [torch.from_numpy(a).to(cuda) for a in (buf, starts, rlens)]
    before = rans.KERNEL.launches
    got = rans.decode_lanes_wide(*args, mr, groups=groups)
    assert rans.KERNEL.launches == before + 1
    _same(got, rans.decode_lanes_wide_plain(*args, mr, groups=groups))


@pytest.mark.parametrize("name", CHASE_CASES)
def test_chase_kernel_matches_plain_on_jump_cases(cuda, name):
    """K3 at its depth and at every depth chip_smoke.py measures; the
    past_2_23 case is the production shape, 960 chains x 8,738 steps."""
    lf, sbyte, anchors, units = (x.to(cuda) if torch.is_tensor(x) else x
                                 for x in chase_inputs(name))
    want = ibwt.chase_plain(lf, sbyte, anchors, units)
    before = ibwt.KERNEL.launches
    assert torch.equal(ibwt.chase(lf, sbyte, anchors, units), want)
    assert ibwt.KERNEL.launches == before + 1
    for depth in (16, 32, 64, 128):
        assert torch.equal(ibwt._chase_at(lf, sbyte, anchors, units, depth),
                           want), depth


def _rank_rows(sizes, seed, ocap):
    rng = np.random.default_rng(seed)
    ranks = np.zeros((len(sizes), ocap), np.uint8)
    freqs = np.zeros((len(sizes), 256), np.int32)
    for l, n in enumerate(sizes):
        if n > 0:
            data = rng.integers(0, 256 if l % 2 else 7, n).astype(np.uint8)
            ranks[l, :n], freqs[l] = rank_encode(data)
    return ranks, freqs, np.asarray(sizes, np.int32)


def test_rank_kernel_matches_plain(cuda):
    ocap = 16384  # the production stream's chunk
    ranks, freqs, olens = _rank_rows([16384, 1000, 0, -2, 3000, 1, 500], 3,
                                     ocap)
    # last lane: its buckets run dry before olen, so the walk goes on past
    # the final retire (a corrupt table; kernel and plain must still agree)
    freqs[6, np.flatnonzero(freqs[6])[:2]] = 0
    args = [torch.from_numpy(a).to(cuda) for a in (ranks, freqs, olens)]
    got = rank.rank_decode(*args, ocap)
    _same(got, rank.rank_decode_plain(*args, ocap))
    assert got[1].tolist() == [True] * 6 + [False]


def test_rank_kernel_on_a_1mib_chunk(cuda):
    """A JAM-size chunk: past the TPU kernel's 0x7FFF packed-cursor limit."""
    n = 1 << 20
    rng = np.random.default_rng(8)
    data = np.repeat(rng.integers(0, 40, n // 8), 8).astype(np.uint8)
    r, f = rank_encode(data)
    f = np.asarray(f, np.int32)
    assert rank.rank_decode_path(n) == "direct"
    got, ok = rank.rank_decode(torch.from_numpy(r[None]).to(cuda),
                               torch.from_numpy(f[None]).to(cuda),
                               torch.tensor([n], dtype=torch.int32, device=cuda), n)
    assert bool(ok.all())
    assert np.array_equal(got[0].cpu().numpy(), spec_rank_decode(r, f))
    assert np.array_equal(got[0].cpu().numpy(), data)


@pytest.mark.parametrize("units,n", [(8, 30000), (120, 40000), (960, 50000),
                                     (960, (1 << 23) + 240)])
def test_chase_kernel_matches_plain(cuda, units, n):
    rng = np.random.default_rng(units)
    alpha = np.frombuffer(b" etaoinshrdlu.,\n", np.uint8)
    data = alpha[rng.integers(0, alpha.size, n)]
    buf = torch.from_numpy(np.asarray(NativeEngine().bwt_forward(data, units),
                                      np.uint8).copy()).to(cuda)
    m = buf.numel() - 4 * units
    nlen = m - m % units
    anchors = device_stages.read_anchors(buf, m, units)
    lf, sbyte = ibwt.combined_map(buf[:nlen], anchors[0])
    got = ibwt.chase(lf, sbyte, anchors, units)
    if n < (1 << 20):
        assert torch.equal(got, ibwt.chase_plain(lf, sbyte, anchors, units))
    out, size, ok = device_stages.ibwt_dyn(buf, buf.numel(), units)
    assert bool(ok) and size == n
    assert np.array_equal(out.cpu().numpy(), data)


@pytest.mark.parametrize("filters,lanes,units", [(1, 4, 960), (2, 0, 24),
                                                 (0, 8, 120)])
def test_block_decode_on_cuda_matches_cpu(cuda, filters, lanes, units):
    rng = np.random.default_rng(filters)
    data = np.concatenate([
        np.frombuffer(b"block decode on the card " * 800, np.uint8),
        rng.integers(0, 6, 30000).astype(np.uint8)])
    opt = Options(blocksize=1 << 20, filters=filters, anchor_units=units,
                  rans_lanes=lanes, ans_chunk=16 << 10, lpx_spans=0)
    crc, payload, spans = compress_block_ex(data, opt, NativeEngine())
    launches = [k.KERNEL.launches for k in (rans, rank, ibwt)]
    got = decode_block_device(payload, crc, opt.blocksize, units, lanes,
                              spans, device=cuda)
    assert all(k.KERNEL.launches > c
               for k, c in zip((rans, rank, ibwt), launches))
    assert np.array_equal(got, data)
    assert np.array_equal(got, decode_block_device(
        payload, crc, opt.blocksize, units, lanes, spans, device="cpu"))


# ---------------------------------------------------------------------------
# the encode kernels K4, K5, K6 and the fused block encode


def _pairs_case(L, max_rlen, seed):
    rng = np.random.default_rng(seed)
    chains = np.zeros((L, max_rlen), np.uint16)
    rlens = rng.integers(0, max_rlen + 1, L).astype(np.int32)
    rlens[0] = max_rlen
    rlens[1] = 0
    for l in range(L):
        v = rng.integers(0, 257, rlens[l])
        v = np.where(rng.random(rlens[l]) < 0.5, rng.integers(0, 3, rlens[l]), v)
        chains[l, :rlens[l]] = v
    return chains, rlens


@pytest.mark.parametrize("L,mr,seed,wrap", [
    (37, 700, 1, False), (70, 4096, 2, False), (5, 600, 3, True)])
def test_model_pairs_kernel_matches_plain(cuda, L, mr, seed, wrap):
    chains, rlens = _pairs_case(L, mr, seed)
    if wrap:  # invalid quasi symbols: the zero-frequency regime
        chains[:] = np.random.default_rng(seed).integers(16000, 16200, (L, mr))
        rlens[:] = mr
    args = [torch.from_numpy(a).to(cuda) for a in (chains, rlens)]
    before = rans_encode.PAIRS_KERNEL.launches
    got = rans_encode.model_pairs_wide(*args, mr)
    assert rans_encode.PAIRS_KERNEL.launches == before + 1
    want = rans_encode.model_pairs_wide_plain(*args, mr)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu().int(), w.cpu().int())
    assert bool(got[2].all()) != wrap


@pytest.mark.parametrize("L,mr,seed", [(37, 700, 4), (70, 4096, 5)])
def test_reverse_encode_kernel_matches_plain(cuda, L, mr, seed):
    chains, rlens = _pairs_case(L, mr, seed)
    rl = torch.from_numpy(rlens).to(cuda)
    lows, fqs, _ = rans_encode.model_pairs_wide(
        torch.from_numpy(chains).to(cuda), rl, mr)
    before = rans_encode.REVERSE_KERNEL.launches
    got = rans_encode.rans_reverse_encode_wide(lows, fqs, rl, mr)
    assert rans_encode.REVERSE_KERNEL.launches == before + 1
    _same(got, rans_encode.rans_reverse_encode_wide_plain(lows, fqs, rl, mr))


@pytest.mark.parametrize("name", PAIRS_CASES)
def test_model_pairs_kernel_matches_plain_on_encode_cases(cuda, name):
    chains, rlens, mr, ok = pairs_case(name)
    args = [torch.from_numpy(a).to(cuda) for a in (chains, rlens)]
    before = rans_encode.PAIRS_KERNEL.launches
    got = rans_encode.model_pairs_wide(*args, mr)
    assert rans_encode.PAIRS_KERNEL.launches == before + 1
    want = rans_encode.model_pairs_wide_plain(*args, mr)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu().int(), w.cpu().int())
    assert got[2].tolist() == ok


@pytest.mark.parametrize("name", REVERSE_CASES)
def test_reverse_encode_kernel_matches_plain_on_encode_cases(cuda, name):
    def pairs(chains, rlens, mr):  # K4 on the card
        lows, fqs, _ = rans_encode.model_pairs_wide(
            torch.from_numpy(chains).to(cuda), torch.from_numpy(rlens).to(cuda),
            mr)
        return lows.cpu().int().numpy(), fqs.cpu().int().numpy()

    lows, fqs, rlens, mr = reverse_case(name, pairs)
    lo, fq = (torch.from_numpy(a.astype(np.int32)).to(torch.uint16).to(cuda)
              for a in (lows, fqs))
    rl = torch.from_numpy(rlens).to(cuda)
    before = rans_encode.REVERSE_KERNEL.launches
    got = rans_encode.rans_reverse_encode_wide(lo, fq, rl, mr)
    assert rans_encode.REVERSE_KERNEL.launches == before + 1
    _same(got, rans_encode.rans_reverse_encode_wide_plain(lo, fq, rl, mr))
    for lanes in (8, 16, 32):  # every packing chip_smoke.py measures
        _same(rans_encode._encode_at(lo, fq, rl, mr, lanes), got)


def test_reverse_encode_division_is_exact_for_every_fq(cuda):
    """K5's division against / and % for every fq in 1..65535 at x = 0,
    fq - 1, fq, 2^15 fq - 1, 2^31 - 1, 2^31, 2^31 + 1 and 2^32 - 1, and at
    a million random x."""
    x, f = division_edges(np.arange(1, 1 << 16))
    rng = np.random.default_rng(0)
    x = np.concatenate([x, rng.integers(0, 1 << 32, 1 << 20)])
    f = np.concatenate([f, rng.integers(1, 1 << 16, 1 << 20)])
    q, r = rans_encode._divmod(torch.from_numpy(x).to(cuda),
                               torch.from_numpy(f).to(cuda))
    assert np.array_equal(q.cpu().numpy(), x // f)
    assert np.array_equal(r.cpu().numpy(), x % f)


def test_rank_encode_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    W = 16384
    sizes = [16384, 1000, 0, -2, 3000, 1, 500]
    chunks = rng.integers(0, 256, (len(sizes), W), dtype=np.uint8)
    chunks[::2] %= 7
    args = [torch.from_numpy(a).to(cuda)
            for a in (chunks, np.asarray(sizes, np.int32))]
    before = encode_stages.RANK_KERNEL.launches
    got = encode_stages.rank_encode(*args)
    assert encode_stages.RANK_KERNEL.launches == before + 1
    _same(got, encode_stages.rank_encode_plain(*args))
    r, f = rank_encode(chunks[0])
    assert np.array_equal(got[0][0].cpu().numpy(), r)
    assert np.array_equal(got[1][0].cpu().numpy(), np.asarray(f, np.int32))


def test_rank_encode_kernel_on_a_1mib_chunk(cuda):
    """A JAM-size chunk, past the TPU path's 0x7FFF packed-cursor limit."""
    n = 1 << 20
    rng = np.random.default_rng(8)
    data = np.repeat(rng.integers(0, 40, n // 8), 8).astype(np.uint8)
    assert encode_stages.rank_encode_path(n) == "direct"
    ranks, freqs = encode_stages.rank_encode(
        torch.from_numpy(data[None]).to(cuda),
        torch.tensor([n], dtype=torch.int32, device=cuda))
    r, f = rank_encode(data)
    assert np.array_equal(ranks[0].cpu().numpy(), r)
    assert np.array_equal(freqs[0].cpu().numpy(), np.asarray(f, np.int32))
    assert np.array_equal(spec_rank_decode(r, f), data)


@pytest.mark.parametrize("case", CASES)
def test_rank_kernels_match_plain_on_lane_layout_edge_cases(cuda, case):
    chunks, olens = edge_chunks(case)
    ranks, freqs = rank_rows(chunks, olens)
    W = chunks.shape[1]
    c, ol, r, f = (torch.from_numpy(a).to(cuda)
                   for a in (chunks, olens, ranks, freqs))
    before = (encode_stages.RANK_KERNEL.launches, rank.KERNEL.launches)
    got_e = encode_stages.rank_encode(c, ol)
    got_d = rank.rank_decode(r, f, ol, W)
    assert (encode_stages.RANK_KERNEL.launches,
            rank.KERNEL.launches) == (before[0] + 1, before[1] + 1)
    _same(got_e, encode_stages.rank_encode_plain(c, ol))
    _same(got_d, rank.rank_decode_plain(r, f, ol, W))
    assert np.array_equal(got_e[0].cpu().numpy(), ranks)
    j = np.arange(W)[None, :]
    assert np.array_equal(got_d[0].cpu().numpy(),
                          np.where(j < olens[:, None], chunks, 0))


def test_rank_kernels_at_the_production_width_with_period_256(cuda):
    """16,384-byte chunks in which every step after the first 256 has rank
    255: the staged path at its worst case."""
    W = 16384
    chunks = periodic(256, 5, W, 12)
    olens = np.asarray([W, W, 9000, 0, 300], np.int32)
    c, ol = torch.from_numpy(chunks).to(cuda), torch.from_numpy(olens).to(cuda)
    assert encode_stages.rank_encode_path(W) == "staged"
    assert rank.rank_decode_path(W) == "staged"
    ranks, freqs = encode_stages.rank_encode(c, ol)
    _same((ranks, freqs), encode_stages.rank_encode_plain(c, ol))
    got = rank.rank_decode(ranks, freqs, ol, W)
    _same(got, rank.rank_decode_plain(ranks, freqs, ol, W))
    j = np.arange(W)[None, :]
    assert np.array_equal(got[0].cpu().numpy(),
                          np.where(j < olens[:, None], chunks, 0))
    assert bool(got[1].all())


@pytest.mark.parametrize("S,nb", [(1024, 300), (4096, 70), (16384, 20),
                                  (3, 50)])
def test_block_scatter_kernel_matches_plain(cuda, S, nb):
    rng = np.random.default_rng(S)
    src = torch.from_numpy(rng.integers(-2**31, 2**31, S * nb,
                                        dtype=np.int64).astype(np.int32))
    offs = torch.from_numpy(rng.permutation(nb).astype(np.int32))
    src, offs = src.to(cuda), offs.to(cuda)
    before = block_scatter.KERNEL.launches
    got = block_scatter.block_scatter(src, offs, S)
    assert block_scatter.KERNEL.launches == before + 1
    assert torch.equal(got, block_scatter.block_scatter_plain(src, offs, S))
    assert torch.equal(got.view(nb, S)[offs.long()], src.view(nb, S))


@pytest.mark.parametrize("lanes,chunk,units,n", [
    (4, 16 << 10, 960, 70000), (0, 4096, 120, 30000), (16, 2048, 24, 20000),
    (4, 16 << 10, 960, 0)])
def test_block_encode_on_cuda_matches_cpu(cuda, lanes, chunk, units, n):
    rng = np.random.default_rng(n)
    data = np.concatenate([
        np.frombuffer(b"block encode on the card " * (n // 50 + 1), np.uint8),
        rng.integers(0, 6, n)]).astype(np.uint8)[:n]
    opt = Options(blocksize=1 << 20, match_finder=3, filters=0,
                  anchor_units=units, rans_lanes=lanes, ans_chunk=chunk,
                  lpx_spans=0)
    kernels = (rans_encode.PAIRS_KERNEL, rans_encode.REVERSE_KERNEL,
               encode_stages.RANK_KERNEL)
    launches = [k.launches for k in kernels]
    got = encode_block_device(data, opt, device=cuda)
    assert all(k.launches > c for k, c in zip(kernels, launches))
    assert got == encode_block_device(data, opt, device="cpu")
    assert got == compress_block_ex(data, opt, NativeEngine())[:2]


def test_device_encode_then_decode_of_an_8mib_block(cuda):
    """The production block size: device encode, device decode, input back."""
    n = 8 << 20
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", np.uint8)
    data = alpha[rng.integers(0, alpha.size, n)]
    opt = Options(blocksize=n, match_finder=3, filters=0, anchor_units=960,
                  rans_lanes=4, ans_chunk=16 << 10, lpx_spans=0)
    crc, payload = encode_block_device(data, opt, device=cuda)
    got = decode_block_device(payload, crc, opt.blocksize, 960, 4, 0,
                              device=cuda)
    assert np.array_equal(got, data)


# ---------------------------------------------------------------------------
# the filter-search kernels K7 (joint histogram) and K8 (LPC), and the
# -f1/-f2 block encode

FBS = 1 << 16


def _lanes(lens, seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(lens), FBS), np.uint8)
    for b, n in enumerate(lens):
        rows[b, :n] = (rng.integers(0, 256, n) if b % 2 else
                       np.repeat(rng.integers(0, 9, n // 7 + 1), 7)[:n])
    return rows, np.asarray(lens, np.int32)


def test_joint_hist_kernel_matches_plain(cuda):
    rows, lens = _lanes([0, 1, 2, 517, FBS, 40001, FBS, 16], 1)
    rows[6] = 0  # one pair 65,536 times: the largest cell
    args = [torch.from_numpy(a).to(cuda) for a in (rows, lens)]
    before = hist.KERNEL.launches
    got = hist.joint_hist(*args)
    assert hist.KERNEL.launches == before + 1
    assert torch.equal(got, hist.joint_hist_plain(*args))
    assert int(got[6, 0, 0]) == FBS


def _hist_edge_lanes():
    """The counter edges of K7 (packed uint16 counters, cell (0, 0) counted
    apart), pairs in rows >= 128 only, and segment edges (64-byte segments
    a thread, 16-byte words)."""
    rng = np.random.default_rng(4)
    rows, lens = [], []

    def lane(data, n=FBS):
        row = np.zeros(FBS, np.uint8)
        row[:len(data)] = data
        rows.append(row)
        lens.append(n)

    z = np.zeros(FBS, np.uint8)
    lane(z)                                  # (0, 0) = 65,536
    lane(z, FBS - 1)                         # (0, 0) = 65,535
    lane(np.r_[z[:FBS - 1], 1])              # 65,535 and its neighbour 1
    lane(np.r_[z[:FBS - 2], 7, 7])           # (0, 0) = 65,534
    lane(np.tile(np.uint8([200, 0]), FBS // 2))  # two cells of 32,768
    lane(np.tile(np.uint8([0, 0, 0, 1]), FBS // 4))  # (0, 0) at 32,769
    # beside (0, 1) at 16,384
    lane(rng.integers(128, 256, FBS))        # every pair but the first in
    lane(z)                                  # rows >= 128; 65,536 again
    lane(np.tile(np.uint8([1, 2, 1, 3]), FBS // 4))  # (1, 2) and (1, 3) at
    # 16,384 each: the low and high counters of one packed word
    for n in (1, 15, 17, 127, 128, 129, 511, 513, 4095, 40001, FBS - 1):
        lane(rng.integers(0, 256, FBS) if n % 2 else
             np.repeat(rng.integers(0, 5, FBS // 3 + 1), 3)[:FBS], n)
    return np.stack(rows), np.asarray(lens, np.int32)


def test_joint_hist_kernel_edge_cells(cuda):
    rows, lens = _hist_edge_lanes()
    args = [torch.from_numpy(a).to(cuda) for a in (rows, lens)]
    got = hist.joint_hist(*args)
    assert torch.equal(got, hist.joint_hist_plain(*args))
    assert [int(got[i, 0, 0]) for i in range(4)] == [FBS, FBS - 1, FBS - 1,
                                                     FBS - 2]
    assert int(got[2, 0, 1]) == 1 and int(got[3, 7, 7]) == 1
    assert int(got[4, 0, 200]) == int(got[4, 200, 0]) == FBS // 2
    assert int(got[5, 0, 0]) == FBS // 2 + 1 and int(got[5, 0, 1]) == FBS // 4
    assert int(got[6, 128:].sum()) == FBS - 1
    assert int(got[8, 1, 2]) == int(got[8, 1, 3]) == FBS // 4
    assert got.sum((1, 2)).tolist() == lens.tolist()


TILE = 256  # kTile of csrc/lpc.cu: the bytes a lane a stage


def _lpc_lanes(case):
    """'edges': lengths at K8's stage and tile edges and random (wrap-heavy)
    bytes; 'apply': the 129 rows of an -f2 apply or LPC decode, most of
    length 0 (the chunks that did not pick LPC)."""
    if case == "edges":
        return _lanes([0, 1, 17, 3000, FBS, 40001, 5, TILE - 1, TILE,
                       TILE + 1, 2 * TILE - 1, 3 * TILE + 1, FBS - 1,
                       FBS - 16, FBS, FBS], 2)
    lens = np.zeros(129, np.int32)
    lens[[0, 7, 8, 31, 32, 64, 100, 128]] = [FBS, FBS, 3, FBS - 1, 1000,
                                             FBS, TILE + 1, 2]
    return _lanes(lens.tolist(), 5)


@pytest.mark.parametrize("case", ["edges", "apply"])
@pytest.mark.parametrize("decode", [False, True])
def test_lpc_kernel_matches_plain(cuda, decode, case):
    rows, lens = _lpc_lanes(case)
    args = [torch.from_numpy(a).to(cuda) for a in (rows, lens)]
    before = lpc.KERNEL.launches
    got = lpc.lpc(*args, decode)
    assert lpc.KERNEL.launches == before + 1
    assert torch.equal(got, lpc.lpc_plain(*args, decode))
    back = lpc.lpc(got, args[1], not decode)
    j = np.arange(FBS)[None, :]
    assert np.array_equal(back.cpu().numpy(),
                          np.where(j < lens[:, None], rows, 0))


def _structured(seed=3):
    """LPC, inline-delta, delta and LPC regimes, one 64 KiB chunk each, the
    last ragged."""
    rng = np.random.default_rng(seed)
    t = np.arange(FBS // 4)
    sines = np.stack([(8000 * np.sin(t / 300.0)).astype(np.int16),
                      (6000 * np.cos(t / 410.0)).astype(np.int16)], 1)
    v = np.cumsum(rng.integers(-8, 9, FBS // 3 + 1))
    walks = np.stack([v * (k + 1) + 40 * k for k in range(3)], 1)
    i = np.arange(FBS // 4)
    recs = np.stack([i % 256, (i * 3) % 256, np.full_like(i, 7),
                     (i // 5) % 256], 1).astype(np.uint8).reshape(-1)
    audio = (np.sin(np.arange(9000) / 25) * 90 + 128).astype(np.uint8)
    return np.concatenate([sines.view(np.uint8).reshape(-1),
                           walks.astype(np.uint8).reshape(-1)[:FBS], recs,
                           audio])


def test_f1_previous_lpc_pick_runs_k8(cuda, monkeypatch):
    """A chunk whose only candidate is raw, after an LPC pick: the carried
    pick is scored on bytes that K8 made, not the host's LPC loop."""
    from jampack_tpu_torch.kernels import filters_search as fs
    from jampack_tpu_torch.stages import filters as port_spec

    def refuse(*args):
        raise AssertionError("the host LPC loop ran")

    audio = (np.sin(np.arange(FBS) / 25) * 90 + 128).astype(np.uint8)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", np.uint8)
    text = alpha[np.random.default_rng(5).integers(0, 30, 3000)]
    data = torch.from_numpy(np.concatenate([audio, text]))
    want = fs.pick_f1_configs(data)
    monkeypatch.setattr(port_spec, "lpc_encode", refuse)
    monkeypatch.setattr(port_spec, "_apply", refuse)
    before = lpc.KERNEL.launches
    assert fs.pick_f1_configs(data.to(cuda)) == want == [(1, 1), (1, 1)]
    assert lpc.KERNEL.launches >= before + 2  # the candidates, then chunk 1


@pytest.mark.parametrize("filters", [1, 2])
def test_filtered_block_encode_on_cuda_matches_cpu(cuda, filters):
    data = _structured()
    opt = Options(blocksize=1 << 20, match_finder=3, filters=filters,
                  anchor_units=960, rans_lanes=4, ans_chunk=4 << 10,
                  lpx_spans=0)
    launches = [k.KERNEL.launches for k in (hist, lpc)]
    got = encode_block_device(data, opt, device=cuda)
    assert all(k.KERNEL.launches > c for k, c in zip((hist, lpc), launches))
    assert got == encode_block_device(data, opt, device="cpu")
    assert got == compress_block_ex(data, opt, NativeEngine())[:2]
    before = lpc.KERNEL.launches
    back = decode_block_device(got[1], got[0], opt.blocksize, 960, 4, 0,
                               device=cuda)
    assert lpc.KERNEL.launches > before
    assert np.array_equal(back, data)


# ---------------------------------------------------------------------------
# K10, the Lpx span walk, and K11, the LZ token parse


def _spans_buffer(lens, kinds, seed):
    """Contiguous spans of the given lengths, span k filled with bytes of
    kinds[k % len(kinds)].  Returns (buf, starts, lens) as numpy arrays."""
    lens = np.asarray(lens, np.int32)
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    parts = [span_bytes(kinds[k % len(kinds)], int(n), seed + k)
             for k, n in enumerate(lens)]
    return np.concatenate(parts), starts, lens


def _walk_both(cuda, buf, starts, lens, plain_on, *layouts):
    """K10 against lpx_walk_plain both ways (the plain version on
    `plain_on`: the CPU steps a few spans faster, the card many), in each
    of `layouts`, the keywords of lpx._lpx_walk_at (pad, lanes, wide;
    none: lpx_walk itself); decode inverts encode."""
    args = [torch.from_numpy(a.copy()) for a in (buf, starts, lens)]
    dev_args = [a.to(cuda) for a in args]
    p_args = [a.to(plain_on) for a in args]
    enc = lpx.lpx_walk_plain(*p_args, False)
    dec = lpx.lpx_walk_plain(enc, p_args[1], p_args[2], True)
    assert torch.equal(dec.cpu(), args[0])
    mx = int(lens.max())
    for kw in layouts or ({},):
        walk, kernel = (lpx.lpx_walk, lpx.KERNEL) if not kw else (
            lambda *a: lpx._lpx_walk_at(*a, **kw), lpx._MEASURE)
        before = kernel.launches
        got = walk(*dev_args, False, mx)
        assert torch.equal(got.cpu(), enc.cpu()), kw
        back = walk(got, dev_args[1], dev_args[2], True, mx)
        assert torch.equal(back.cpu(), args[0]), kw
        assert kernel.launches == before + 2


@pytest.mark.parametrize("pad", [0, 1])
def test_lpx_kernel_at_the_s4096_shape(cuda, pad):
    """4,096 spans of 2 KiB (four-word records, the whole span in shared
    memory), zero, random and log-record bytes; a span's shared memory a
    multiple of 128 bytes, and padded by one record."""
    buf, starts, lens = _spans_buffer([2048] * 4095 + [1000],
                                      ["zeros", "random", "records"], 0)
    _walk_both(cuda, buf, starts, lens, cuda, {"pad": pad})


@pytest.mark.parametrize("lanes", [1, 2, 5, 20])
def test_lpx_kernel_spans_a_warp_at_the_s4096_shape(cuda, lanes):
    """Each layout of the spans-a-warp sweep on the spans of -S4096."""
    buf, starts, lens = _spans_buffer([2048] * 4095 + [1000],
                                      ["records", "zeros", "random"], 5)
    _walk_both(cuda, buf, starts, lens, cuda, {"lanes": lanes})


def _periodic(n, seed):
    """Short periods of a few byte values, 1% of the bytes changed: the
    step after a table store often reads the record it stored (forwarded
    through registers), and runs start and stop on such records."""
    rng = np.random.default_rng(seed)
    per = int(rng.integers(1, 9))
    x = np.tile(rng.integers(0, 4, per, dtype=np.uint8), n // per + 1)[:n]
    flip = rng.random(n) < 0.01
    x[flip] = rng.integers(0, 256, int(flip.sum()), dtype=np.uint8)
    return x


def test_lpx_kernel_on_runs_over_forwarded_records(cuda):
    """300 spans of periodic bytes, in both record layouts and with 1 and
    5 spans a warp."""
    parts = [_periodic(int(n), s) for s, n in enumerate(
        np.random.default_rng(6).integers(100, 6000, 300))]
    lens = np.asarray([p.size for p in parts], np.int32)
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    _walk_both(cuda, np.concatenate(parts), starts, lens, cuda, {},
               {"wide": True}, {"lanes": 1}, {"lanes": 5, "wide": True})


@pytest.mark.parametrize("size", [32767, 32768, 65536, 65537])
def test_lpx_kernel_at_the_32k_and_64k_limits(cuda, size):
    """Spans at 32 KiB (the limit of 16-bit counters) and at 64 KiB (of a
    span held whole in shared memory; past it, the ring), in both record
    layouts."""
    buf, starts, lens = _spans_buffer([size, size - 1],
                                      ["records", "zeros"], 8)
    _walk_both(cuda, buf, starts, lens, "cpu", {},
               {"wide": size <= lpx.RING})


@pytest.mark.parametrize("size,kind", [
    (2_097_217, "records"), ((1 << 24) - 1, "zeros"),
    ((1 << 24) - 1, "records"), (1 << 24, "zeros")])
def test_lpx_kernel_matches_native_at_the_record_limits(cuda, size, kind):
    """One span as long as a JAM -S4 span of an 8 MiB block, and at the
    four-word records' limit (2^24 - 1 bytes: on zeros the hit count
    reaches 2^24 - 5) and past it (eight words), against the native
    engine's Lpx, in both layouts where four words hold it."""
    data = span_bytes(kind, size, 9)
    want = np.asarray(NativeEngine().lpx_encode(data, 1), np.uint8)
    x = torch.from_numpy(data.copy()).to(cuda)
    st = torch.zeros(1, dtype=torch.int32, device=cuda)
    ln = torch.full((1,), size, dtype=torch.int32, device=cuda)
    for wide in (False, True):
        got = lpx._lpx_walk_at(x, st, ln, False, size, wide=wide)
        assert np.array_equal(got.cpu().numpy(), want), wide
        assert torch.equal(
            lpx._lpx_walk_at(got, st, ln, True, size, wide=wide), x), wide


@pytest.mark.parametrize("size", [1 << 16, (1 << 16) + 4096])
def test_lpx_kernel_on_long_spans(cuda, size):
    """Spans of 64 KiB (four-word records, the span in shared memory) and
    over 64 KiB (eight-word records, a 64 KiB ring)."""
    buf, starts, lens = _spans_buffer([size] * 3,
                                      ["zeros", "random", "records"], 1)
    _walk_both(cuda, buf, starts, lens, "cpu")


def test_lpx_kernel_on_tiny_spans(cuda):
    rng = np.random.default_rng(2)
    buf, starts, lens = _spans_buffer(rng.integers(1, 4, 20000),
                                      ["records", "random"], 2)
    _walk_both(cuda, buf, starts, lens, cuda)


def _parse_both(cuda, buf, n, max_tokens, out_cap, **kw):
    """K11 (kw: jump, head of _lz_parse_at; none: lz_parse itself) against
    lz_parse_plain, one launch counted."""
    want = device_stages.lz_parse_plain(torch.from_numpy(buf.copy()), n,
                                        max_tokens, out_cap)
    before = device_stages.LZ_KERNEL.launches
    parse = device_stages._lz_parse_at if kw else device_stages.lz_parse
    got = parse(torch.from_numpy(buf.copy()).to(cuda), n, max_tokens,
                out_cap, **kw)
    assert device_stages.LZ_KERNEL.launches == before + 1
    for g, w in zip(got[:5], want[:5]):
        assert np.array_equal(g.cpu().numpy(), w)
    assert got[5:] == want[5:]
    return want


@pytest.mark.parametrize("jump,head", [(32, 16), (2, 0), (8, 0), (32, 0),
                                       (1, 1)])
@pytest.mark.parametrize("name", LZ_CASES)
def test_lz_parse_kernel_matches_plain(cuda, name, jump, head):
    """Every parse case, with K11's head and D, and with no head (the
    chain phases from byte 0) at other D."""
    want = _parse_both(cuda, *lz_case(name), jump=jump, head=head)
    assert want[7] == LZ_BAD[name]


def test_lz_parse_kernel_on_an_unaligned_buffer(cuda):
    """A buffer at an odd address: every token window is read bytewise."""
    buf, n, max_tokens, out_cap = lz_case("many_tokens")
    x = torch.from_numpy(np.concatenate([[0], buf]).astype(np.uint8))
    want = device_stages.lz_parse_plain(x[1:], n, max_tokens, out_cap)
    got = device_stages._lz_parse_at(x.to(cuda)[1:], n, max_tokens, out_cap,
                                     head=0)
    for g, w in zip(got[:5], want[:5]):
        assert np.array_equal(g.cpu().numpy(), w)
    assert got[5:] == want[5:]


@pytest.mark.parametrize("mode", [0, 1])
def test_lz_parse_kernel_on_8mib_stages(cuda, mode):
    """The -m0 and -m1 LZ stages of 8 MiB of text whose last tenth is log
    records (the native engine's), at the decode's slots and out_cap, with
    K11's head and with none (the chain phases over the whole stage)."""
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", np.uint8)
    n = 8 << 20
    data = np.concatenate([alpha[rng.integers(0, 30, n - n // 10)],
                           log_records(n // 10)])
    stage = np.asarray(NativeEngine().lz_encode(data, mode), np.uint8)
    out_cap = 9 << 20
    for head in (device_stages.LZ_HEAD, 0):
        want = _parse_both(cuda, stage, stage.size, out_cap // 256, out_cap,
                           head=head)
    assert not want[7]


@pytest.mark.parametrize("name", [
    "golden_f0.jam", "golden_f1.jam", "golden_f2.jam", "golden_m1.jam",
    "golden_m2.jam", "golden_m3.jam", "golden_jtx_u960_L16_c256.jtx",
    "golden_jt3_prod_u960_L4_c16_Sa.jt3"])
def test_golden_fixtures_on_cuda(cuda, name):
    """Every golden archive decodes on the card: K11 twice a block, K10
    once a block that frames spans > 0."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        arc = f.read()
    with open(os.path.join(FIXTURES, "golden_input.bin"), "rb") as f:
        want = f.read()
    blocks = []
    stream = io.BytesIO(arc)
    while (rec := framing.read_block(stream)) is not None:
        blocks.append(rec[0].lpx_spans)
    before = (device_stages.LZ_KERNEL.launches, lpx.KERNEL.launches)
    out = io.BytesIO()
    decompress_stream_device(io.BytesIO(arc), out, cuda)
    assert out.getvalue() == want
    assert device_stages.LZ_KERNEL.launches - before[0] == 2 * len(blocks)
    assert lpx.KERNEL.launches - before[1] == sum(s > 0 for s in blocks)


@pytest.mark.parametrize("spans,auto", [(4, False), (4096, False),
                                        (4096, True), (8, True)])
def test_lpx_block_encode_on_cuda_matches_cpu(cuda, spans, auto):
    data = np.concatenate([log_records(60000), span_bytes("random", 3000, 3)])
    opt = PortOptions(blocksize=1 << 20, match_finder=3, filters=1,
                      anchor_units=120, rans_lanes=4, ans_chunk=16 << 10,
                      lpx_spans=spans, lpx_auto=auto)
    before = lpx.KERNEL.launches
    got = encode_block_device_ex(data, opt, device=cuda)
    assert lpx.KERNEL.launches == before + 1
    assert got == encode_block_device_ex(data, opt, device="cpu")
    back = decode_block_device(got[1], got[0], opt.blocksize, 120, 4, got[2],
                               device=cuda)
    assert np.array_equal(back, data)


@pytest.mark.parametrize("stream", ["jam", "jt3"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_host_lz_block_encode_on_cuda_matches_native(cuda, mode, stream):
    """The host-LZ route (-m0/-m1/-m2) on the card: byte-identical to the
    native engine, K4, K5, K6 and K10 launched once, decoded back."""
    data = np.concatenate([log_records(60000), span_bytes("random", 3000, 3),
                           log_records(20000)])
    kw = ({"lpx_spans": 4} if stream == "jam" else
          {"lpx_spans": 4096, "lpx_auto": True, "anchor_units": 960,
           "rans_lanes": 4, "ans_chunk": 16 << 10})
    opt = PortOptions(blocksize=1 << 20, match_finder=mode, filters=1, **kw)
    kernels = (encode_stages.RANK_KERNEL, rans_encode.PAIRS_KERNEL,
               rans_encode.REVERSE_KERNEL, lpx.KERNEL)
    before = [k.launches for k in kernels]
    got = encode_block_device_ex(data, opt, device=cuda)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1] * 4
    assert got == compress_block_ex(data, opt, NativeEngine())
    back = decode_block_device(got[1], got[0], opt.blocksize,
                               opt.anchor_units, opt.rans_lanes, got[2],
                               device=cuda)
    assert np.array_equal(back, data)


@pytest.mark.parametrize("spans", [4, 4096])
def test_lpx_kernel_matches_native_on_8mib_of_log_records(cuda, spans):
    """K10 against the native engine's Lpx on the -f1 stage of 8 MiB of
    log records: 4 spans of 2 MiB (wide records, the ring), where the
    threshold passes 2^31 / (order) and the JAX walk departs (ROADMAP C6),
    and 4,097 spans of 2 KiB."""
    eng = NativeEngine()
    stage = np.asarray(eng.filters_encode(
        eng.lz_encode(log_records(8 << 20), 3), 1), np.uint8)
    want = np.asarray(eng.lpx_encode(stage, spans), np.uint8)
    x = torch.from_numpy(stage.copy()).to(cuda)
    got = lpx.lpx_dyn(x, stage.size, spans, False)
    assert np.array_equal(got.cpu().numpy(), want)
    back = lpx.lpx_dyn(got, stage.size, spans, True)
    assert torch.equal(back, x)


# ---------------------------------------------------------------------------
# the stage engines on the card


def _engine_block(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", np.uint8)
    third = n // 3
    t = np.arange(third // 4 + 1)
    sines = np.stack([3000 * np.sin(t / 40.0), 5000 * np.cos(t / 95.0)], 1)
    sines = (sines + rng.normal(0, 2, sines.shape)).astype(np.int16)
    return np.concatenate([log_records(third),
                           alpha[rng.integers(0, 30, third)],
                           sines.view(np.uint8).reshape(-1)])[:n]


@pytest.mark.parametrize("stage", ["lz_decode", "lpx", "filters1",
                                   "filters2", "filters3", "bwt", "ans0",
                                   "ans4"])
def test_gpu_engine_stage_on_cuda_matches_its_cpu_run(cuda, stage):
    """Each device stage of the per-stage engine on the card against the
    same engine on the CPU (the plain versions of its kernels), exact."""
    from jampack_tpu_torch.runtime.engines import GpuEngine

    gpu, cpu, nat = GpuEngine(cuda), GpuEngine("cpu"), NativeEngine()
    data = _engine_block(150000, 2)
    s1 = np.asarray(nat.lz_encode(data, 0), np.uint8)
    if stage == "lz_decode":
        for mode in (0, 1):
            s = np.asarray(nat.lz_encode(data, mode), np.uint8)
            assert np.array_equal(gpu.lz_decode(s), cpu.lz_decode(s))
    elif stage == "lpx":
        for spans in (4, 64):
            enc = gpu.lpx_encode(s1, spans)
            assert np.array_equal(enc, cpu.lpx_encode(s1, spans))
            assert np.array_equal(gpu.lpx_decode(enc, spans), s1)
    elif stage.startswith("filters"):
        mode = int(stage[-1])
        enc = gpu.filters_encode(s1, mode)
        assert np.array_equal(enc, cpu.filters_encode(s1, mode))
        assert np.array_equal(gpu.filters_decode(enc), s1)
    elif stage == "bwt":
        for units in (120, 960):
            fwd = gpu.bwt_forward(s1, units)
            assert np.array_equal(fwd, cpu.bwt_forward(s1, units))
            assert np.array_equal(gpu.bwt_inverse(fwd, units), s1)
    else:
        lanes = int(stage[-1])
        fwd = np.asarray(nat.bwt_forward(s1, 960), np.uint8)
        enc = gpu.ans_encode(fwd, 16384, lanes)
        assert enc == cpu.ans_encode(fwd, 16384, lanes)
        assert np.array_equal(
            gpu.ans_decode(np.frombuffer(enc, np.uint8), lanes=lanes), fwd)


def test_gpu_engine_on_threads_counts_every_launch(cuda):
    """Four host threads drive the per-stage engine at once: each result
    equals the one-thread run, and the launch counts add up."""
    from concurrent.futures import ThreadPoolExecutor

    from jampack_tpu_torch.runtime.engines import GpuEngine

    gpu = GpuEngine(cuda)
    nat = NativeEngine()
    streams = [np.asarray(nat.bwt_forward(_engine_block(200000, s), 960),
                          np.uint8) for s in range(8)]
    want = [gpu.ans_encode(s, 16384, 4) for s in streams]
    kernels = (rans_encode.PAIRS_KERNEL, rans_encode.REVERSE_KERNEL)
    before = [k.launches for k in kernels]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda s: gpu.ans_encode(s, 16384, 4), streams))
    assert got == want
    assert [k.launches - b for k, b in zip(kernels, before)] == [8, 8]


def test_hybrid_engine_on_cuda_writes_the_native_archive(cuda):
    from jampack_tpu_torch.runtime import pipeline
    from jampack_tpu_torch.runtime.engines import HybridEngine

    data = _engine_block(3 << 20, 5).tobytes()
    opt = pipeline.Options(blocksize=1 << 20)
    want, got, back = io.BytesIO(), io.BytesIO(), io.BytesIO()
    pipeline.compress_stream(io.BytesIO(data), want, opt, NativeEngine())
    hyb = HybridEngine(device=cuda)
    pipeline.compress_stream(io.BytesIO(data), got, opt, hyb)
    pipeline.decompress_stream(io.BytesIO(got.getvalue()), back, hyb)
    assert got.getvalue() == want.getvalue() and back.getvalue() == data
    assert hyb.routes == {"device": 8}


def test_token_dense_8mib_block_decodes_on_cuda(cuda):
    """ROADMAP A9: 8 MiB of 61-byte log records at -m1 hold more LZ tokens
    than plan_shapes gives the JAX decode; the port's own `cli c` archive
    decodes on the card, K11 twice."""
    data = log_records(8 << 20)
    opt = PortOptions(match_finder=1)
    crc, payload, spans = encode_block_device_ex(data, opt, cuda)
    from jampack_tpu_torch.runtime import device_decode as dd

    meta = dd.block_meta(payload, 0)
    slots = dd.plan_shapes([meta], [len(payload)], opt.blocksize,
                           0)["max_tokens"]
    eng = NativeEngine()
    s4 = np.asarray(eng.lz_encode(eng.lpx_encode(eng.filters_encode(
        eng.lz_encode(data, 0), 1), 4), 1), np.uint8)
    from jampack_tpu_torch.stages.lz77 import read_token

    buf, pos, tokens = s4.tobytes(), 0, 0
    while True:
        _, lit, off, pos = read_token(buf, pos)
        tokens += 1
        if off == 0:
            break
        pos += lit
    assert tokens > slots
    before = device_stages.LZ_KERNEL.launches
    back = decode_block_device(payload, crc, opt.blocksize, 120, 0, spans,
                               device=cuda)
    assert device_stages.LZ_KERNEL.launches - before == 2
    assert np.array_equal(back, data)


# ---------------------------------------------------------------------------
# batched blocks and several cards


def _text_block(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", np.uint8)
    return alpha[rng.integers(0, alpha.size, n)]


BATCH_STREAMS = {
    # JAM: 1 MiB entropy chunks, no lanes, 4 Lpx spans a block
    "jam": dict(match_finder=3, filters=1, lpx_spans=4),
    # JT3 (the production stream with the Lpx stage kept): 16 KiB chunks,
    # 4 lanes, 960 anchors, 4096 spans
    "jt3": dict(match_finder=3, filters=1, rans_lanes=4, ans_chunk=16 << 10,
                anchor_units=960, lpx_spans=4096),
}


@pytest.mark.parametrize("stream", sorted(BATCH_STREAMS))
def test_batched_encode_and_decode_equal_the_per_block_path(cuda, stream):
    """3 x 8 MiB through encode_blocks_device and decode_blocks_device:
    byte-equal to encode_block_device_ex / decode_block_device block by
    block and to the input; K4, K5, K6 and K10 once for the encode batch,
    K1, K2 and K10 once for the decode batch."""
    from jampack_tpu_torch.runtime import device_decode as dd
    from jampack_tpu_torch.runtime import device_encode as de

    n = 8 << 20
    opt = PortOptions(blocksize=n, **BATCH_STREAMS[stream])
    blocks = [_text_block(n, s) for s in range(3)]
    enc = (encode_stages.RANK_KERNEL, rans_encode.PAIRS_KERNEL,
           rans_encode.REVERSE_KERNEL, lpx.KERNEL)
    before = [k.launches for k in enc]
    got = de.encode_blocks_device(blocks, opt, cuda)
    assert [k.launches - b for k, b in zip(enc, before)] == [1, 1, 1, 1]
    assert got == [de.encode_block_device_ex(b, opt, cuda) for b in blocks]
    crcs = [g[0] for g in got]
    payloads = [g[1] for g in got]
    spans = [g[2] for g in got]
    dec = (rans.KERNEL, rank.KERNEL, lpx.KERNEL)
    before = [k.launches for k in dec]
    outs = dd.decode_blocks_device(payloads, crcs, n, opt.anchor_units,
                                   opt.rans_lanes, spans, cuda)
    assert [k.launches - b for k, b in zip(dec, before)] == [1, 1, 1]
    for out, block, (crc, payload, s) in zip(outs, blocks, got):
        assert np.array_equal(out, block)
        assert np.array_equal(out, dd.decode_block_device(
            payload, crc, n, opt.anchor_units, opt.rans_lanes, s, cuda))


def test_a_kernel_launches_on_every_card(cuda):
    """K9 on each cuda:i, against its plain version (the library's current
    device follows the tensor's card)."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices")
    src = torch.arange(64 * 1024, dtype=torch.int32)
    offs = torch.randperm(64, generator=torch.Generator().manual_seed(1)).int()
    want = block_scatter.block_scatter_plain(src, offs, 1024)
    for i in range(count):
        dev = torch.device("cuda", i)
        before = block_scatter.KERNEL.launches
        got = block_scatter.block_scatter(src.to(dev), offs.to(dev), 1024)
        assert block_scatter.KERNEL.launches - before == 1
        assert got.device == dev and torch.equal(got.cpu(), want)


def test_a_missing_card_raises(cuda):
    from jampack_tpu_torch.kernels._build import stream_of
    from jampack_tpu_torch.runtime import sharding

    missing = torch.cuda.device_count()

    class Fake:
        device = torch.device("cuda", missing)

    with pytest.raises(ValueError, match=f"cuda:{missing}"):
        stream_of(Fake())
    with pytest.raises(ValueError, match=f"cuda:{missing}"):
        sharding.make_mesh([f"cuda:{missing}"])


def test_two_workers_on_one_card_decode_as_the_cli_does(cuda, tmp_path,
                                                        monkeypatch):
    """decode_archive_sharded on ["cuda:0", "cuda:0"] in batches of 2
    gives the bytes `cli d` writes, and the input."""
    from jampack_tpu_torch import cli
    from jampack_tpu_torch.runtime import pipeline, sharding

    data = np.concatenate([_text_block(1 << 20, s) for s in range(5)])
    data = data[: data.size - 4000].tobytes()
    src, arc, out = (str(tmp_path / f) for f in ("in", "in.jt3", "out"))
    with open(src, "wb") as f:
        f.write(data)
    opt = pipeline.Options(blocksize=1 << 20, rans_lanes=4,
                           ans_chunk=16 << 10, anchor_units=960,
                           lpx_spans=4096, lpx_auto=True)
    with open(src, "rb") as fin, open(arc, "wb") as fout:
        pipeline.compress_stream(fin, fout, opt, NativeEngine())
    assert cli.run(["cli", "d", arc, out, "--device", "cuda:0"]) == 0
    monkeypatch.setattr(sharding, "_mesh_batch", lambda mesh, size: 2)
    with open(arc, "rb") as f:
        got = sharding.decode_archive_sharded(f, ["cuda:0", "cuda:0"])
    with open(out, "rb") as f:
        assert f.read() == got == data
