"""The benchmark's own tests; `python -m pytest benchmark/tests -q`.

On the CPU the cells run at small sizes through the plain PyTorch versions
of the kernels (`--device cpu`): -b counts MiB and the format refuses
blocks under 1 MiB, so the `small` fixture lowers both floors (the CLI's
parsed block size and framing.MIN_BLOCKSIZE).  Tests marked gpu run the
cells at their own sizes on a card and skip without one."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# (block bytes) of each configuration at the tests' size: JT3's -Sa gate
# and 960 units need a few KiB; the JAM plain walks are slow past 2 KiB
SMALL_BLOCK = {"jam-default": 2048, "jt3-prod": 8192}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.fixture
def small(monkeypatch):
    """overrides(workload) -> the run_cell overrides of a small run, with
    the CLI's floors lowered to match."""
    from jampack_tpu_torch import cli
    from jampack_tpu_torch.format import framing

    from benchmark import registry

    block = {}
    parse = cli._parse

    def small_blocks(argv):
        mode, inp, outp, opt = parse(argv)
        opt.blocksize = block["bytes"]
        return mode, inp, outp, opt

    monkeypatch.setattr(cli, "_parse", small_blocks)
    monkeypatch.setattr(framing, "MIN_BLOCKSIZE", 1)
    torch.set_num_threads(1)

    def overrides(workload):
        cell = registry.cell(registry.benchmark(), workload)
        block["bytes"] = SMALL_BLOCK[cell["config"]]
        return {"config": {"block_bytes": block["bytes"],
                           "archive_bytes": 4 * block["bytes"]},
                "traffic": {"objects": 4, "min_bytes": 512,
                            "max_bytes": block["bytes"] // 2, "cycle": 8}}

    return overrides
