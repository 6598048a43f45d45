"""The port's bench (jampack_tpu_torch/bench.py) on the CPU.

Its corpus and its archive input equal the JAX side's (the root bench.py,
tools/fused_cli_chip.py); its forward and inverse steps give the JAX
bench's BWT body, anchors and output bit for bit at 120 and 1,920 units;
run() with --device cpu prints one JSON line whose timed keys are all null
and whose contracts all hold (the bwt and block groups, on a 1,920-byte
block; the archive group is tests/test_torch_bench_archive.py's)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from golden_cases import one_thread
from jampack_tpu.kernels.ibwt import chase_combined_core, combined_map_core
from jampack_tpu.kernels.sa import bwt_from_prev_sorted, sa_doubling_core
from jampack_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3 * 1920 * 16  # a few x 1,920 x 16 bytes

RATE_KEYS = [
    "bwt_codec_native_stream_u1920_gbps",
    "encode_native_8mb_mbps", "encode_e2e_fused_8mb_mbps",
    "encode_e2e_fused_8mb_auto_mbps", "encode_compute_fused_8mb_auto_mbps",
    "encode_aggregate_b4_mbps", "decode_e2e_fused_8mb_gbps",
    "decode_e2e_fused_8mb_auto_gbps", "decode_compute_fused_8mb_auto_gbps",
    "decode_aggregate_b4_gbps",
    *(f"bwt_{part}_u{u}_ms" for part in ("forward", "inverse", "chase")
      for u in (120, 1920)),
]
SPLIT_KEYS = [
    "encode_native_8mb_mbps", "encode_e2e_fused_8mb_mbps",
    "encode_e2e_fused_8mb_auto_mbps", "encode_aggregate_b4_mbps",
    "decode_e2e_fused_8mb_gbps", "decode_e2e_fused_8mb_auto_gbps",
    "decode_aggregate_b4_gbps",
]


def _jax_steps(units: int):
    """The root bench.py's forward and inverse (bench.py:115-124)."""

    @jax.jit
    def forward(t):
        _, isa, prev_sorted = sa_doubling_core(t, N)
        step = N // units
        return (bwt_from_prev_sorted(prev_sorted, isa[0], N),
                isa[: units * step: step] + 1)

    @jax.jit
    def inverse(bwt, anchors):
        cmap = combined_map_core(bwt, anchors[0], N)
        return chase_combined_core(cmap, anchors, N, units)

    return forward, inverse


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_textlike_is_the_jax_bench_corpus(seed):
    assert np.array_equal(bench.textlike(5000, seed),
                          jax_bench.textlike(5000, seed))


def test_archive_input_is_the_fused_cli_tool_input(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import fused_cli_chip
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    want = fused_cli_chip.build_input(str(tmp_path / "in.bin"), 1)
    assert bench.archive_input(1 << 20, 5) == want


@pytest.mark.parametrize("units", [120, 1920])
def test_bwt_steps_equal_the_jax_bench(units):
    data = bench.textlike(N, 0)
    forward, inverse = _jax_steps(units)
    j_bwt, j_anchors = forward(jnp.asarray(data))
    j_out = inverse(j_bwt, j_anchors)
    with one_thread():
        stats = {}
        bwt, anchors = bench.forward_step(torch.from_numpy(data), units,
                                          stats)
        out = bench.inverse_step(bwt, anchors, units)
    assert anchors.dtype == torch.int32 and anchors.shape == (units,)
    assert np.array_equal(bwt.numpy(), np.asarray(j_bwt))
    assert np.array_equal(anchors.numpy(), np.asarray(j_anchors))
    assert np.array_equal(out.numpy(), np.asarray(j_out))
    assert np.array_equal(out.numpy(), data)
    assert stats["rounds"] >= 0


def test_cpu_line(capsys):
    with one_thread():
        code = bench.main(["--device", "cpu", "--size", "1920", "--trials",
                           "1", "--keys", "bwt,block"])
    assert code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["metric"] == "bwt_codec_combined_8mb"
    assert line["unit"] == "GB/s"
    assert line["device"] == {"platform": "cpu"}
    assert line["value"] is None
    extra = line["extra"]
    for key in ["bwt_codec_combined_8mb", *RATE_KEYS]:
        if key != "bwt_codec_combined_8mb":
            assert key in extra and extra[key] is None, key
        assert extra[key + "_min"] is None and extra[key + "_max"] is None
        assert extra[key + "_n"] == 0
    assert extra["setup_native_build_s"] is None
    for key in SPLIT_KEYS:
        assert extra[key + "_times"], key
    assert "host_crc" in extra["decode_e2e_fused_8mb_gbps_times"]
    assert "ans_encode" in extra["encode_native_8mb_mbps_times"]
    assert set(extra["contracts"]) == {
        "bwt_exact_u120", "bwt_exact_u1920", "encode_fused_equals_native",
        "encode_auto_spans_0", "encode_auto_equals_native",
        "encode_b4_block0_equals_auto", "decode_exact", "decode_auto_exact",
        "decode_b4_spans_shared", "decode_b4_exact"}
    assert all(extra["contracts"].values())
    assert extra["bwt_bytes"] == 1920 and extra["sa_rounds"] >= 0
    assert extra["lpx_auto_spans_used"] == 0
    assert extra["jam_default_bytes"] > 0
    assert extra["ratio_vs_jam_default_pct"] == round(
        100 * (extra["auto_payload_bytes"] / extra["jam_default_bytes"] - 1),
        2)
    # the plain versions launch no kernel
    assert not any(extra["launches"].values())


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(["--keys", "bwt"])


def test_a_broken_contract_raises():
    rep = bench.Report(torch.device("cpu"), 1)
    with pytest.raises(bench.ContractError, match="decode_exact"):
        rep.check("decode_exact", False)
    assert rep.contracts == {"decode_exact": False}
