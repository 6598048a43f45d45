"""The port's CLI around the stage engines, on the CPU: --engine parsing
and its refusals, `cli i` against the JAX package's, -v's per-stage
report, the block-parallel read-ahead loop with its feof rule, and the
per-stage GPU engine's -f3 through the CLI (--device cpu: the plain
versions of its kernels)."""

import io
import os

import numpy as np
import pytest

import jampack_tpu.cli as jcli
from jampack_tpu_torch import cli
from jampack_tpu_torch.runtime import engines, pipeline

from golden_cases import ARCHIVES, FIXTURES, one_thread
from lz_encode_cases import block, sines

STAGES = ("checksum", "lz_encode", "filters_encode", "lpx_encode",
          "bwt_forward", "ans_encode")


def _run(capsys, *argv):
    assert cli.run(["cli", *map(str, argv)]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("form", ["=", " "])
@pytest.mark.parametrize("engine", ["native", "numpy", "hybrid", "gpu"])
def test_engine_flag_both_forms(tmp_path, capsys, engine, form):
    src = tmp_path / "in.bin"
    src.write_bytes(block(6000, 2).tobytes())
    flag = ([f"--engine={engine}"] if form == "=" else ["--engine", engine])
    out = _run(capsys, "c", src, tmp_path / "a.jt3", "-c2", "-L4", "-u24",
               *flag, "--device", "cpu")
    assert f"[{engine}]" in out
    ref = tmp_path / "ref.jt3"
    assert jcli.run(["cli", "c", str(src), str(ref), "-c2", "-L4", "-u24",
                     "--engine=native"]) == 0
    assert (tmp_path / "a.jt3").read_bytes() == ref.read_bytes()
    _run(capsys, "d", tmp_path / "a.jt3", tmp_path / "back", *flag,
         "--device=cpu")
    assert (tmp_path / "back").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "tpu"], "--engine gpu"),
    (["--engine=tpu"], "--engine gpu"),
    (["--engine", "cuda"], "the engines are fused, gpu, hybrid, native, numpy"),
    (["-f3"], "--engine gpu"),
    (["-f3", "--engine", "fused", "-m1"], "--engine gpu")])
def test_engine_refusals(tmp_path, argv, msg):
    src = tmp_path / "in.bin"
    src.write_bytes(b"refused" * 10)
    with pytest.raises(SystemExit, match=msg):
        cli.run(["cli", "c", str(src), str(tmp_path / "out"), *argv,
                 "--device", "cpu"])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("name", ARCHIVES)
def test_info_prints_what_the_jax_cli_prints(capsys, name):
    path = os.path.join(FIXTURES, name)
    mine = _run(capsys, "i", path)
    assert jcli.run(["cli", "i", path]) == 0
    assert mine == capsys.readouterr().out
    assert mine.endswith("compressed bytes\n")


def test_verbose_report(tmp_path, capsys):
    src = tmp_path / "in.bin"
    src.write_bytes(block(20000, 4).tobytes())
    out = _run(capsys, "c", src, tmp_path / "a.jam", "-v", "-t2",
               "--engine", "native")
    assert "[native+metrics]" in out
    assert "per-stage (aggregated across 2 threads):" in out
    assert all(f"  {s} " in out for s in STAGES)
    out = _run(capsys, "d", tmp_path / "a.jam", tmp_path / "b", "--verbose",
               "--engine", "hybrid", "--device", "cpu", "-t1")
    assert "[hybrid+metrics]" in out and "bwt_inverse" in out
    assert "bwt routes: device 1, host 0" in out
    assert (tmp_path / "b").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("n", [0, 1 << 20, (1 << 20) + 5, 2 << 20])
def test_read_ahead_loop_keeps_the_feof_rule(tmp_path, capsys, n):
    """-b1 blocks on 3 threads: an input of K whole blocks (K = 0
    included) gets one trailing empty block, as the JAX CLI writes."""
    rng = np.random.default_rng(n)
    src = tmp_path / "in.bin"
    src.write_bytes(rng.integers(0, 9, n, dtype=np.uint8).tobytes())
    mine, ref = tmp_path / "m.jam", tmp_path / "r.jam"
    _run(capsys, "c", src, mine, "-b1", "-t3", "-f0", "--engine", "native")
    assert jcli.run(["cli", "c", str(src), str(ref), "-b1", "-t3", "-f0",
                     "--engine=native"]) == 0
    assert mine.read_bytes() == ref.read_bytes()
    blocks = _run(capsys, "i", mine).splitlines()[-1]
    assert blocks.startswith(f"{n // (1 << 20) + 1} blocks")
    _run(capsys, "d", mine, tmp_path / "b", "-t3", "--engine", "native")
    assert (tmp_path / "b").read_bytes() == src.read_bytes()


def test_plan_workers_agrees_with_the_jax_cli():
    for threads, multiblock, bs in ((0, True, 8 << 20), (3, True, 1 << 20),
                                    (5, False, 8 << 20)):
        opt = pipeline.Options(blocksize=bs, threads=threads,
                               multiblock=multiblock)
        assert cli.plan_workers(opt) == jcli.plan_workers(opt)


def test_gpu_engine_f3_through_the_cli(tmp_path, capsys):
    """-f3 runs on --engine gpu: the CLI's read-ahead loop gives the bytes
    of compress_stream with the same engine, and both the gpu and the
    native engine read them back (-S64: short Lpx spans for the plain
    walk)."""
    data = np.concatenate([sines(70000, 3), block(50000, 1)])
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    flags = ["-f3", "-c16", "-L4", "-u960", "-S64", "-b1"]
    arc = tmp_path / "a.jt3"
    with one_thread():
        out = _run(capsys, "c", src, arc, *flags, "-t2", "--engine", "gpu",
                   "--device", "cpu", "-v")
        assert "[gpu+metrics]" in out and "filters_encode" in out
        want = io.BytesIO()
        pipeline.compress_stream(io.BytesIO(data.tobytes()), want,
                                 cli._parse(["cli", "c", "x", "y", *flags])[3],
                                 engines.GpuEngine("cpu"))
        assert arc.read_bytes() == want.getvalue()
        for engine in ("gpu", "native"):
            back = tmp_path / f"back.{engine}"
            _run(capsys, "d", arc, back, "--engine", engine, "--device",
                 "cpu")
            assert back.read_bytes() == data.tobytes()
