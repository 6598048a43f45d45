"""All eight golden archives of tests/fixtures decode through the port's
stage engines to golden_input.bin: the native, hybrid (on the CPU, the
plain versions of its BWT) and numpy engines here, and the per-stage GPU
engine on the JTX and JT3 archives (its JAM archives are in the
test_torch_engine_fixtures_*.py files)."""

import pytest

from jampack_tpu_torch.runtime.engines import GpuEngine, HybridEngine, NativeEngine
from jampack_tpu_torch.runtime.pipeline import Engine

from golden_cases import ARCHIVES, decode_golden_engine


def test_eight_archives():
    assert len(ARCHIVES) == 8


@pytest.mark.parametrize("engine", ["native", "hybrid", "numpy"])
@pytest.mark.parametrize("name", ARCHIVES)
def test_host_engines_decode_golden(name, engine):
    eng = {"native": NativeEngine, "numpy": Engine,
           "hybrid": lambda: HybridEngine(device="cpu")}[engine]()
    assert decode_golden_engine(name, eng)
    if engine == "hybrid":
        assert eng.routes["device"] >= 1 and eng.routes["host"] == 0


@pytest.mark.parametrize("name", [n for n in ARCHIVES
                                  if not n.endswith(".jam")])
def test_gpu_engine_decodes_golden(name):
    assert decode_golden_engine(name, GpuEngine("cpu"))
