"""Golden archives of tests/fixtures decode through the port's per-stage
GPU engine on the CPU (the plain versions of its kernels) to
golden_input.bin: golden_f2.jam and golden_m2.jam here, the other JAM archives in the
other test_torch_engine_fixtures_*.py files and the JTX/JT3 ones with the
host engines in tests/test_torch_engine_fixtures.py (a JAM archive walks
one 87 KB entropy chain and 22 KiB Lpx spans in the plain versions, about
25 s each: tests/golden_cases.py says why the files are split)."""

import pytest

from jampack_tpu_torch.runtime.engines import GpuEngine

from golden_cases import decode_golden_engine


@pytest.mark.parametrize("name", ["golden_f2.jam", "golden_m2.jam"])
def test_gpu_engine_decodes_golden(name):
    assert decode_golden_engine(name, GpuEngine("cpu"))
