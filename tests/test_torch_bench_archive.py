"""The port's bench: its archive group on the CPU.

The archive group is called through its function, archive_keys, at a
small block size: -b counts MiB and the format refuses block headers under
1 MiB, so the test lowers both floors (the CLI's parsed block size and
framing.MIN_BLOCKSIZE) for that call; the plain walks on 1 MiB blocks
would take minutes.  32 KiB is the smallest block at which the -Sa gate
keeps Lpx on the log records; the JAM archive, whose gate is off, runs at
2 KiB.  Each call runs cli c with --engine native and fused and cli d with
fused on the four-block input: the fused archive must equal the native
one, the decode must give the input back, the JT3 span words must mix 0
and 8, and every timed key is null."""

import pytest
import torch

from golden_cases import one_thread
from jampack_tpu_torch import bench, cli
from jampack_tpu_torch.format import framing


@pytest.mark.parametrize("label,block", [("jt3", 32 << 10), ("jam", 2 << 10)])
def test_archive_keys(label, block, tmp_path, monkeypatch):
    parse = cli._parse

    def small_blocks(argv):
        mode, inp, outp, opt = parse(argv)
        opt.blocksize = block
        return mode, inp, outp, opt

    monkeypatch.setattr(cli, "_parse", small_blocks)
    monkeypatch.setattr(framing, "MIN_BLOCKSIZE", 1)
    rep = bench.Report(torch.device("cpu"), 1)
    with one_thread():
        bench.archive_keys(rep, label, block, 0, "cpu", str(tmp_path))
    extra = rep.extra
    for name in ("encode_native", "encode_fused", "decode_fused"):
        key = f"archive_{label}_{name}_32mb"
        assert extra[key + "_mbps"] is None and extra[key + "_mbps_n"] == 0
        assert extra[key + "_first_s"] is None
    words = extra[f"archive_{label}_span_words"]
    assert words == ([8, 0, 0, 8, 0] if label == "jt3" else [4] * 5)
    assert rep.contracts and all(rep.contracts.values())
    assert f"archive_{label}_fused_equals_native" in rep.contracts
    assert f"archive_{label}_decode_exact" in rep.contracts
