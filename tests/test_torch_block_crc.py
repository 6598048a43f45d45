"""The fused paths' block CRC: the function runtime/device_decode.py and
runtime/device_encode.py call as integrity_check (the native engine's C++
checksum) equals the spec, format/checksum.integrity_check, on every
length class of the 16-byte strides and their tail, on 8 MiB blocks, and
on every input form the callers hand it."""

import functools

import numpy as np
import pytest

from jampack_tpu_torch import native
from jampack_tpu_torch.format.checksum import integrity_check as spec
from jampack_tpu_torch.runtime import device_decode, device_encode

MIB8 = 8 << 20
CASES = {f"{n}B": n for n in (*range(0, 18), 31, 32, 33, 4097, 100003)}
CASES.update({"8MiB-00": "zeros", "8MiB-ff": "ones", "8MiB-random": "random"})


@functools.lru_cache(maxsize=None)
def _case(name):
    """(data, the spec's value), made once a case."""
    kind = CASES[name]
    if kind == "zeros":
        data = np.zeros(MIB8, np.uint8)
    elif kind == "ones":
        data = np.full(MIB8, 0xFF, np.uint8)
    else:
        size = MIB8 if kind == "random" else kind
        data = np.random.default_rng(size).integers(0, 256, size, np.uint8)
    return data, spec(data)


def _strided(data):
    """The bytes of data as a non-contiguous uint8 view."""
    wide = np.zeros(2 * data.size, np.uint8)
    wide[::2] = data
    return wide[::2]


FORMS = {
    "bytes": lambda a: a.tobytes(),
    "bytearray": lambda a: bytearray(a.tobytes()),
    "memoryview": lambda a: memoryview(a.tobytes()),
    "uint8": lambda a: a,
    "strided": _strided,
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", CASES)
def test_fused_crc_equals_the_spec(name, form):
    data, want = _case(name)
    given = FORMS[form](data)
    assert device_decode.integrity_check is native.checksum
    assert device_encode.integrity_check is native.checksum
    assert device_decode.integrity_check(given) == want
    assert device_encode.integrity_check(given) == want
