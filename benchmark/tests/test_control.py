"""`correct` has to come out false when what the window gives back is
wrong: the control (the reference in the program's place, with the
guarantee that every byte comes back broken) and faults planted in the
program's timed path.  Each drives a whole run but the look for a card.
They are a restore's, so they run in the cells whose ops give raw bytes
back (the restore and objects op kinds); a backup's control and faults
are test_control_backup.py's.

On the CPU at small sizes; marked gpu, at the cells' own sizes on the
card (the control on three seeds, each fault on one):

    python -m pytest benchmark/tests/test_control.py -m gpu -q \
        -p no:cacheprovider
"""

import numpy as np
import pytest

from benchmark import harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]
         if registry.traffic(w["traffic"])["op"] in ("restore", "objects")]
SEEDS = [2718281829, 3000000019, 1414213563]


def restore_answers(monkeypatch):
    """{archive path: its raw bytes}, filled as set-up writes archives."""
    answers = {}
    encode = harness.Context.encode

    def recording(ctx, data, name):
        path = encode(ctx, data, name)
        answers[path] = (data, int(ctx.config["block_bytes"]))
        return path

    monkeypatch.setattr(harness.Context, "encode", recording)
    return answers


def after_setup(monkeypatch, plant):
    """Run `plant()` once the op's set-up (and its warm-up) is done."""
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


def control(monkeypatch, answers):
    """The reference restore with a block's last byte changed: a lossy
    restore that checks no CRC."""
    from jampack_tpu_torch import cli

    def lossy(argv):
        data, block = answers[argv[2]]
        out = data.copy()
        out[min(block, out.size) - 1::block] ^= 1
        with open(argv[3], "wb") as f:
            f.write(out.tobytes())
        return 0

    monkeypatch.setattr(cli, "run", lossy)


def fault(kind):
    """A fault planted in the program's decode, as runtime/sharding.py
    calls it: each batch's result altered where it is produced."""
    from jampack_tpu_torch.runtime import sharding

    real = sharding.decode_blocks_device

    def broken(payloads, *args, **kwargs):
        got = real(payloads, *args, **kwargs)
        if kind == "byte":  # an answer altered
            got[0] = got[0].copy()
            got[0][len(got[0]) // 2] ^= 0x20
        elif kind == "half":  # half the batch left out
            got = got[:len(got) // 2]
        elif kind == "unchanged":  # the step hands back its input
            got = [np.frombuffer(p, np.uint8) for p in payloads]
        return got

    return lambda: setattr(sharding, "decode_blocks_device", broken)


def run(workload, seed, device, overrides):
    return harness.run_cell(workload, seed, 1.0 if device == "cpu" else 2.0,
                            False, device, overrides)


def _control(workload, seed, device, overrides, monkeypatch):
    answers = restore_answers(monkeypatch)
    after_setup(monkeypatch, lambda: control(monkeypatch, answers))
    got = run(workload, seed, device, overrides)
    checks = got["checks"]
    assert got["correct"] is False
    assert checks["ops_wrong"][0] == got["attempted"] >= 1
    assert checks["bytes_wrong"][0] >= got["attempted"]
    assert checks["ops_failed"][0] == 0


def _fault(workload, kind, device, overrides, monkeypatch):
    from jampack_tpu_torch.runtime import sharding

    monkeypatch.setattr(sharding, "decode_blocks_device",
                        sharding.decode_blocks_device)
    after_setup(monkeypatch, fault(kind))
    got = run(workload, SEEDS[0], device, overrides)
    assert got["correct"] is False
    assert got["checks"]["bytes_wrong"][0] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_small(workload, small, monkeypatch):
    _control(workload, SEEDS[0], "cpu", small(workload), monkeypatch)


@pytest.mark.parametrize("kind", ["byte", "half", "unchanged"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails_small(workload, kind, small, monkeypatch):
    _fault(workload, kind, "cpu", small(workload), monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, seed, cuda, monkeypatch):
    _control(workload, seed, cuda, None, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["byte", "half", "unchanged"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_fails(workload, kind, cuda, monkeypatch):
    _fault(workload, kind, cuda, None, monkeypatch)
