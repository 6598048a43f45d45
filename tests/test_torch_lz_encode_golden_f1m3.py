"""golden_input.bin encoded through the port on the CPU (the plain versions
of the kernels) at the flags of golden_f1.jam and golden_m3.jam reproduces
each byte for byte and decodes back; the other JAM fixtures are in the
other test_torch_lz_encode_golden*.py files (tests/golden_cases.py says
why)."""

import pytest

from golden_cases import encode_golden


@pytest.mark.parametrize("name", ["golden_f1.jam", "golden_m3.jam"])
def test_golden_archive_encodes(name):
    assert encode_golden(name) == (True, True)
