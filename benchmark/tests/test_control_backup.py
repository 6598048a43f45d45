"""`correct` of the backup cell has to come out false when what the port
writes is wrong: faults planted where runtime/sharding.py calls the block
encode, and the control, a writer in the program's place that breaks the
configuration's guarantee that every block carries the checksum of its
raw bytes.  Each drives a whole run but the look for a card.

A fault planted before set-up is in the archive every op must write, so
only the checks after the window can see it: the plain decoder in every
block of its sample, the port's restore in any block.  Planted in one
block, the plain decoder sees it where that block is in the seed's sample
(2 of the 8 blocks of its class at the cell's size), which the gpu case
prints.

On the CPU at a small size; marked gpu, at the cell's own size on the
card (the control and the one-block fault on three seeds, each other
fault on one):

    python -m pytest benchmark/tests/test_control_backup.py -m gpu -q \
        -p no:cacheprovider -s
"""

import zlib

import numpy as np
import pytest

from benchmark import harness, registry

CELL = "jam-default.backup"
SEEDS = [2718281829, 3000000019, 1414213563]


def after_setup(monkeypatch, plant):
    """Run `plant()` once the op's set-up is done."""
    op = registry.op

    class Planted:
        def __init__(self, real):
            self.real = real

        def setup(self, ctx):
            jobs = self.real.setup(ctx)
            plant()
            return jobs

    monkeypatch.setattr(harness.registry, "op",
                        lambda kind: Planted(op(kind)))


def fault(monkeypatch, kind):
    """A fault in the port's block encode as runtime/sharding.py calls it:
    every block's payload with a byte altered ("byte"), the payload of
    the second block the encode sees (the same bytes in every op) with a
    byte altered ("one"), or the first block after planting handed back
    as its raw bytes ("unencoded")."""
    from jampack_tpu_torch.runtime import sharding

    real = sharding.encode_block_device_ex
    calls, seen = [], []

    def broken(data, *args, **kwargs):
        crc, payload, spans = real(data, *args, **kwargs)
        calls.append(len(data))
        key = zlib.crc32(np.ascontiguousarray(data))
        if len(seen) < 2:
            seen.append(key)
        if kind == "byte" or (kind == "one" and len(seen) > 1
                              and key == seen[1]):
            payload = bytearray(payload)
            payload[len(payload) // 2] ^= 0x20
            payload = bytes(payload)
        elif kind == "unencoded" and len(calls) == 1:
            payload = bytes(data)
        return crc, payload, spans

    return lambda: monkeypatch.setattr(sharding, "encode_block_device_ex",
                                       broken)


def control(monkeypatch):
    """The set-up's own archive (beside its raw file, without ".raw") in
    the program's place in each `cli c`, each block's stored checksum off
    by one."""
    from jampack_tpu_torch import cli

    real = cli.run

    def wrong_crc(argv):
        if argv[1] != "c":
            return real(argv)
        with open(argv[2][:-len(".raw")], "rb") as f:
            archive = bytearray(f.read())
        pos = 0
        while pos < len(archive):
            crc = int.from_bytes(archive[pos + 3:pos + 7], "little")
            archive[pos + 3:pos + 7] = ((crc + 1) & 0xFFFFFFFF).to_bytes(
                4, "little")
            pos += 15 + int.from_bytes(archive[pos + 7:pos + 11], "little")
        with open(argv[3], "wb") as f:
            f.write(archive)
        return 0

    monkeypatch.setattr(cli, "run", wrong_crc)


def run(seed, device, overrides):
    return harness.run_cell(CELL, seed, 1.0 if device == "cpu" else 2.0,
                            False, device, overrides)


def _before_setup(kind, seed, device, overrides, monkeypatch):
    """A fault in the archive every op writes: the window's ops agree with
    the set-up's, and the checks after the window have to see it."""
    fault(monkeypatch, kind)()
    got = run(seed, device, overrides)
    checks = got["checks"]
    print(f"fault {kind!r} before set-up, seed {seed}: {checks}")
    assert got["correct"] is False
    assert checks["ops_wrong"][0] == checks["ops_failed"][0] == 0
    assert checks["restore_bytes_wrong"][0] >= 1
    if kind == "byte":  # in every block, so in every block of the sample
        assert checks["plain_blocks_bad"][0] >= 1
    return checks


def _after_setup(kind, device, overrides, monkeypatch):
    from jampack_tpu_torch.runtime import sharding

    monkeypatch.setattr(sharding, "encode_block_device_ex",
                        sharding.encode_block_device_ex)
    after_setup(monkeypatch, fault(monkeypatch, kind))
    got = run(SEEDS[0], device, overrides)
    assert got["correct"] is False
    assert got["checks"]["ops_wrong"][0] >= 1
    assert got["checks"]["bytes_wrong"][0] >= 1


def _control(seed, device, overrides, monkeypatch):
    after_setup(monkeypatch, lambda: control(monkeypatch))
    got = run(seed, device, overrides)
    checks = got["checks"]
    assert got["correct"] is False
    assert checks["ops_wrong"][0] == got["attempted"] >= 1
    assert checks["ops_failed"][0] == 0


def test_fault_before_setup_small(small, monkeypatch):
    _before_setup("byte", SEEDS[0], "cpu", small(CELL), monkeypatch)


def test_one_block_fault_small(small, monkeypatch):
    # at this size each class has one block, all in the sample: both see it
    checks = _before_setup("one", SEEDS[0], "cpu", small(CELL), monkeypatch)
    assert checks["plain_blocks_bad"][0] == 1


@pytest.mark.parametrize("kind", ["byte", "unencoded"])
def test_fault_after_setup_small(kind, small, monkeypatch):
    _after_setup(kind, "cpu", small(CELL), monkeypatch)


def test_control_fails_small(small, monkeypatch):
    _control(SEEDS[0], "cpu", small(CELL), monkeypatch)


@pytest.mark.gpu
def test_fault_before_setup(cuda, monkeypatch):
    _before_setup("byte", SEEDS[0], cuda, None, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_one_block_fault(seed, cuda, monkeypatch):
    _before_setup("one", seed, cuda, None, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["byte", "unencoded"])
def test_fault_after_setup(kind, cuda, monkeypatch):
    _after_setup(kind, cuda, None, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(seed, cuda, monkeypatch):
    _control(seed, cuda, None, monkeypatch)
