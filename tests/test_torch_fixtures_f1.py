"""Golden archives of tests/fixtures decode through the port on the CPU to
golden_input.bin (golden_f1.jam, golden_m2.jam; the others are in the
other test_torch_fixtures*.py files, tests/golden_cases.py says why; the JT3
archive is in tests/test_torch_decode_block.py)."""

import pytest

from golden_cases import decode_golden


@pytest.mark.parametrize("name", ["golden_f1.jam", "golden_m2.jam"])
def test_golden_archive_decodes(name):
    words, exact = decode_golden(name)
    assert exact
    assert words == [4]
