"""The roofline's counts, read from a small archive's own streams, against
the program's parse of the same streams; and the arithmetic."""

import io

import numpy as np
import pytest

from benchmark.metrics import _roofline


def archive(lanes, chunk, units, spans):
    from jampack_tpu_torch.format import framing
    from jampack_tpu_torch.runtime.engines import NativeEngine
    from jampack_tpu_torch.runtime.options import Options
    from jampack_tpu_torch.runtime.pipeline import compress_block_ex

    rng = np.random.default_rng(5)
    out, payloads = io.BytesIO(), []
    for n in (50_000, 20_000):
        data = np.repeat(rng.integers(0, 40, n, dtype=np.uint8),
                         rng.integers(1, 6, n))[:n].astype(np.uint8)
        opt = Options(blocksize=1 << 20, match_finder=0, filters=0,
                      anchor_units=units, ans_chunk=chunk, rans_lanes=lanes,
                      lpx_spans=spans)
        crc, payload, used = compress_block_ex(data, opt, NativeEngine())
        framing.write_block(out, crc, payload, opt.blocksize, units, lanes,
                            used)
        payloads.append(payload)
    return out.getvalue(), payloads


def program_counts(payloads, lanes):
    """chains, chain bytes and symbols by the program's own parsers."""
    from jampack_tpu_torch.stages.ans import (read_chunk_header,
                                              read_lane_table)

    chains = chain_bytes = symbols = 0
    for p in payloads:
        view, pos = memoryview(p), 0
        while pos < len(p):
            _, _, clen, rlen, pos = read_chunk_header(view, pos)
            if lanes >= 2:
                clens, _ = read_lane_table(view, pos, rlen, lanes)
                chain_bytes += sum(clens)
            else:
                chain_bytes += clen
            chains += max(lanes, 1)
            symbols += rlen
            pos += clen
    return {"chains": chains, "chain_bytes": chain_bytes, "symbols": symbols}


@pytest.mark.parametrize("lanes,chunk,units,spans", [
    (0, 1 << 20, 120, 4),        # JAM
    (4, 16 << 10, 960, 4096),    # JT3
    (2, 8 << 10, 120, 4)])       # JTX
def test_counts_match_the_program(lanes, chunk, units, spans):
    blob, payloads = archive(lanes, chunk, units, spans)
    got = _roofline.chains(blob)
    assert got == program_counts(payloads, lanes)
    assert got["symbols"] > 0 and got["chains"] >= 2


def test_k1_work_and_least_time():
    blob, _ = archive(4, 16 << 10, 960, 4096)
    c = _roofline.chains(blob)
    moved, ops = _roofline.k1_work(blob)
    assert moved == c["chain_bytes"] + 9 * c["chains"] + 2 * c["symbols"]
    assert ops == 60 * c["symbols"]
    kind = "NVIDIA H100 80GB HBM3"
    assert _roofline.least_seconds(3350, 0, kind) == pytest.approx(1e-9)
    # 132 SMs x 64 int32 lanes x 1.98 GHz
    assert _roofline.least_seconds(0, 16_727, kind) == pytest.approx(
        1e-9, rel=1e-4)
    assert _roofline.least_seconds(3350, 167_270, kind) == pytest.approx(
        1e-8, rel=1e-4)


def test_k4_work():
    blob, _ = archive(0, 1 << 20, 120, 4)
    c = _roofline.chains(blob)
    moved, ops = _roofline.k4_work(blob)
    assert moved == 10 * c["symbols"] + 5 * c["chains"]
    assert ops == 50 * c["symbols"]
