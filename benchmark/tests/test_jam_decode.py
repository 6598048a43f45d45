"""The plain JAM decoder (reference/jam_decode.py) against archives it did
not write: the golden archives of the reference's formats, and archives
the port writes on the CPU of each corpus class; and it raises on a
broken archive."""

import os

import numpy as np
import pytest

from benchmark import harness, registry
from benchmark.reference import jam_decode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
GOLDEN = sorted(f for f in os.listdir(FIXTURES)
                if f.startswith("golden_") and f != "golden_input.bin")
BLOCK = 2048  # the small fixture's JAM block (conftest.SMALL_BLOCK)


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_decodes_exactly(name):
    assert jam_decode.decode(fixture(name)) == fixture("golden_input.bin")


def class_block(index: int, seed: int) -> np.ndarray:
    """Corpus block `index` of the backup mix at the small size."""
    config = registry.config("jam-default", {"block_bytes": BLOCK})
    ctx = harness.Context.__new__(harness.Context)
    ctx.config, ctx.traffic = config, registry.traffic("backup")
    ctx.seed = seed
    return ctx.block(index)


@pytest.mark.parametrize("index", range(4), ids=lambda i: registry.traffic(
    "backup")["classes"][i]["class"])
def test_port_archive_decodes_exactly(index, small, tmp_path):
    from jampack_tpu_torch import cli

    small("jam-default.backup")
    data = class_block(index, 2**31 + 11)
    raw, archive = tmp_path / "in.raw", tmp_path / "in.jam"
    raw.write_bytes(data.tobytes())
    assert cli.run(["cli", "c", str(raw), str(archive), "--device",
                    "cpu"]) == 0
    assert jam_decode.decode(archive.read_bytes(), BLOCK) == data.tobytes()
    got = jam_decode.verify(str(archive), str(raw), BLOCK, workers=0)
    assert [(g["bytes"], g["wrong"], g["error"]) for g in got] == [
        (BLOCK, 0, None), (0, 0, None)]


def broken(kind: str) -> bytes:
    archive = bytearray(fixture("golden_f1.jam"))
    if kind == "payload":  # a byte in the middle of the block's payload
        archive[15 + (len(archive) - 15) // 2] ^= 0x01
    else:  # the stored checksum off by one
        crc = int.from_bytes(archive[3:7], "little")
        archive[3:7] = ((crc + 1) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(archive)


@pytest.mark.parametrize("kind", ["payload", "crc"])
def test_broken_archive_raises(kind):
    with pytest.raises(jam_decode.CorruptArchive):
        jam_decode.decode(broken(kind))


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, 33, 4096, 65543])
def test_checksum_matches_the_serial_loop(size):
    data = np.random.default_rng(size).integers(0, 256, size, np.uint8)
    acc = [3, 0, 0, 0]
    n = max(0, (size - 1) // 16)
    for j in range(n):
        for k in range(4):
            w = int.from_bytes(data[16 * j + 4 * k:16 * j + 4 * k + 4],
                               "big")
            acc[k] ^= ((w + (1 << (acc[k] & 7))) * 0x9E3779B1) & 0xFFFFFFFF
    for b in data[16 * n:].tolist():
        acc[0] ^= ((b + (1 << (acc[0] & 7))) * 0x9E3779B1) & 0xFFFFFFFF
    assert jam_decode.checksum(data) == acc[0] ^ acc[1] ^ acc[2] ^ acc[3]
