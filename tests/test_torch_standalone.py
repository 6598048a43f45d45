"""The port stands alone: it imports neither jax nor jampack_tpu, and each
copy it keeps of the JAX package's host code equals its original."""

import inspect
import io
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import jampack_tpu.cli as jcli
import jampack_tpu_torch
from jampack_tpu.format import checksum as jchecksum
from jampack_tpu.format import constants as jconstants
from jampack_tpu.format import framing as jframing
from jampack_tpu.format import tables as jtables
from jampack_tpu.format import varint as jvarint
from jampack_tpu.runtime import device_decode as jdd
from jampack_tpu.runtime import distributed as jdistributed
from jampack_tpu.runtime import engines as jengines
from jampack_tpu.runtime import metrics as jmetrics
from jampack_tpu.runtime import pipeline as jpipeline
from jampack_tpu.runtime import sysinfo as jsysinfo
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.stages import ans as jans
from jampack_tpu.stages import filters as jfilters
from jampack_tpu.stages import lpx as jlpx
from jampack_tpu.stages import lz77 as jlz77
from jampack_tpu_torch import cli
from jampack_tpu_torch.format import checksum, constants, framing, tables, varint
from jampack_tpu_torch.runtime import device_decode as dd
from jampack_tpu_torch.runtime import distributed, engines, metrics, options
from jampack_tpu_torch.runtime import pipeline
from jampack_tpu_torch.runtime import sysinfo
from jampack_tpu_torch.stages import ans, filters, lpx, lz77

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        jampack_tpu_torch.__path__, "jampack_tpu_torch."))


def test_every_module_imports_with_jax_and_jampack_tpu_blocked():
    mods = _modules()
    assert {"jampack_tpu_torch.kernels.filters_search",
            "jampack_tpu_torch.kernels.block_scatter",
            "jampack_tpu_torch.kernels.filters",
            "jampack_tpu_torch.native",
            "jampack_tpu_torch.dryrun",
            "jampack_tpu_torch.runtime.distributed",
            "jampack_tpu_torch.runtime.engines",
            "jampack_tpu_torch.runtime.metrics",
            "jampack_tpu_torch.runtime.sharding",
            "jampack_tpu_torch.runtime.pipeline",
            "jampack_tpu_torch.runtime.sysinfo",
            *(f"jampack_tpu_torch.stages.{m}" for m in STAGES)} <= set(mods)
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['jampack_tpu'] = None; import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert sys.modules['jax'] is None\n"
            "assert sys.modules['jampack_tpu'] is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", ["jampack_tpu_torch", "chip_smoke.py"])
def test_no_jampack_tpu_import_in_sources(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    assert files
    if path == "jampack_tpu_torch":
        assert os.path.join(full, "native", "__init__.py") in files
    for f in files:
        for line in open(f):
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] == "jampack_tpu"), (f, line)


def _read(*parts):
    with open(os.path.join(REPO, *parts), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["jn_lz.cpp", "jn_sais.cpp",
                                  "jn_common.hpp", "jn_ans.cpp",
                                  "jn_stages.cpp", "jn_transform.cpp"])
def test_native_sources_equal_their_originals(name):
    assert _read("jampack_tpu_torch", "native", "src", name) == _read(
        "jampack_tpu", "native", "src", name)


def test_native_copy_is_the_whole_engine():
    assert sorted(os.listdir(os.path.join(REPO, "jampack_tpu_torch", "native",
                                          "src"))) == sorted(
        f for f in os.listdir(os.path.join(REPO, "jampack_tpu", "native",
                                           "src"))
        if f.endswith((".cpp", ".hpp")))


STAGES = ("ans", "bwt", "filters", "lpx", "lz77", "lz77_mf", "models",
          "rank", "rans", "rle0")


@pytest.mark.parametrize("name", STAGES)
def test_stage_copies_equal_their_originals(name):
    """The spec stages are copies byte for byte: the port's format/ gives
    them the same import names."""
    assert _read("jampack_tpu_torch", "stages", f"{name}.py") == _read(
        "jampack_tpu", "stages", f"{name}.py")


@pytest.mark.parametrize("port,ref,names", [
    (pipeline, jpipeline, ["Engine", "compress_block_ex", "compress_block",
                           "decompress_block", "compress_stream",
                           "decompress_stream"]),
    (metrics, jmetrics, ["InstrumentedEngine"]),
    (engines, jengines, ["NativeEngine"]),
    (sysinfo, jsysinfo, ["core_count", "available_memory"]),
    (distributed, jdistributed, ["owner", "decompress_stream_part",
                                 "compress_stream_part", "stitch_archive",
                                 "stitch"]),
    (cli, jcli, ["plan_workers", "_Progress", "info"])])
def test_copied_runtime_code_equals_its_original(port, ref, names):
    """Line for line.  Where a copy must differ it is held by behaviour
    instead: pipeline's gate calls the integer comparison that the device
    encode shares (test_copied_functions_agree); StageMetrics.stage also
    records a span (test_stage_metrics_report_as_the_original);
    distributed's initialize
    meets over torch.distributed (tests/test_torch_distributed.py);
    sysinfo's device half
    asks PyTorch and raises without a card (tests/test_torch_engines_
    native.py); the hybrid and per-stage engines run the port's kernels
    (tests/test_torch_engines*.py)."""
    for name in names:
        assert inspect.getsource(getattr(port, name)) == inspect.getsource(
            getattr(ref, name)), name


def test_stage_metrics_report_as_the_original():
    """The port's StageMetrics is its original line for line but for
    stage, which also records a span: the same calls give the same
    report, seconds apart."""
    port, ref = metrics.StageMetrics, jmetrics.StageMetrics
    for name in ("__init__", "summary", "report", "to_json"):
        assert inspect.getsource(getattr(port, name)) == inspect.getsource(
            getattr(ref, name)), name
    got = []
    for cls in (port, ref):
        stats = cls()
        for name, nbytes in (("bwt_forward", 10**6), ("ans_encode", 3000),
                             ("bwt_forward", 5 * 10**6)):
            with stats.stage(name, nbytes):
                pass
        got.append({k: (v["MB"], v["calls"])
                    for k, v in stats.summary().items()})
    assert got[0] == got[1] == {"ans_encode": (0.003, 1),
                                "bwt_forward": (6.0, 2)}


def test_native_loader_opens_nothing_of_jampack_tpu():
    """The port's LZ library builds from its own copy into build/ and
    loads from there: no file it opens, compiles or loads lies under
    jampack_tpu/."""
    code = (
        "import builtins, ctypes, subprocess, sys\n"
        "sys.modules['jax'] = None; sys.modules['jampack_tpu'] = None\n"
        "seen = []\n"
        "real_open, real_cdll, real_run = builtins.open, ctypes.CDLL, subprocess.run\n"
        "def spy_open(f, *a, **k):\n"
        "    seen.append(str(f)); return real_open(f, *a, **k)\n"
        "def spy_cdll(name, *a, **k):\n"
        "    seen.append(str(name)); return real_cdll(name, *a, **k)\n"
        "def spy_run(cmd, *a, **k):\n"
        "    seen.extend(map(str, cmd)); return real_run(cmd, *a, **k)\n"
        "builtins.open, ctypes.CDLL, subprocess.run = spy_open, spy_cdll, spy_run\n"
        "import os\n"
        "import numpy as np\n"
        "from jampack_tpu_torch import native\n"
        "if os.path.exists(native.LIB + '.sha256'):  # build it in this run\n"
        "    os.remove(native.LIB + '.sha256')\n"
        "out = native.lz_encode(np.frombuffer(b'abcabcabcabc' * 50, np.uint8), 1)\n"
        "assert out.size > 0\n"
        "assert any(s.endswith('libjamnative.so') for s in seen), seen\n"
        "assert any(s.endswith('jn_lz.cpp') for s in seen), seen\n"
        "bad = [s for s in seen if '/jampack_tpu/' in s or 'libjamtpu' in s]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


@pytest.mark.parametrize("port,ref", [(constants, jconstants),
                                      (tables, jtables), (varint, jvarint),
                                      (framing, jframing),
                                      (options, jpipeline),
                                      (pipeline, jpipeline)])
def test_copied_constants_equal(port, ref):
    mine = _public(port)
    assert mine
    for k, v in mine.items():
        want = getattr(ref, k)
        if isinstance(v, np.ndarray):
            assert v.dtype == want.dtype and np.array_equal(v, want), k
        else:
            assert v == want, k


def test_copied_functions_agree():
    rng = np.random.default_rng(4)
    for n in (0, 1, 15, 16, 17, 1000):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert checksum.integrity_check(buf) == jchecksum.integrity_check(buf)
    for v in (0, 126, 127, 20000, 2**31, jvarint.CONSTANTS[3] + 5):
        enc = varint.encode_leb128(v)
        assert enc == jvarint.encode_leb128(v)
        assert varint.decode_leb128(enc) == jvarint.decode_leb128(enc)
    for m, lit, off in ((4, 0, 0), (40, 9, 300), (4000, 3, 70000)):
        assert lz77.write_token(m, lit, off) == jlz77.write_token(m, lit, off)
    freqs = rng.integers(0, 5000, 256)
    head = ans.write_chunk_header(freqs, 16384, 999, 12000)
    assert head == jans.write_chunk_header(freqs, 16384, 999, 12000)
    assert ans.read_chunk_header(head, 0) == jans.read_chunk_header(head, 0)
    assert [ans.lane_rlen(1001, 4, l) for l in range(4)] == [
        jans.lane_rlen(1001, 4, l) for l in range(4)]
    x = rng.integers(0, 256, 3001).astype(np.uint8)
    for name in ("order0_entropy", "mixed_entropy", "sorted_entropy",
                 "delta_encode", "lpc_encode", "lpc_decode"):
        a, b = getattr(filters, name)(x), getattr(jfilters, name)(x)
        assert np.array_equal(a, b), name
    for t in range(3):
        for w in (0, 1, 5, 32):
            assert np.array_equal(filters._apply(x, t, w),
                                  jfilters._apply(x, t, w))
    for n in (0, 1, 3, 4, 30, 31, 4001, 1 << 20):
        for spans in (1, 4, 16, 4096):
            assert lpx._split_spans(n, spans) == jlpx._split_spans(n, spans)
    for before, after, n in ((0, 0, 0), (5, 5, 100), (0, 1, 100), (0, 0, 1),
                             (3, 1, 50), (100, 200, 10000),
                             (100, 199, 10000)):
        a = np.zeros(n, np.uint8)
        a[before:] = 1
        b = np.zeros(n, np.uint8)
        b[after:] = 1
        assert pipeline.gain_gate(before, after, n) == \
            jpipeline._lpx_gain_gate(a, b)
        assert pipeline._lpx_gain_gate(a, b) == jpipeline._lpx_gain_gate(a, b)


def test_framing_and_block_meta_agree():
    data = np.frombuffer(b"stand alone port " * 4000, np.uint8)
    opt = jpipeline.Options(blocksize=1 << 20, filters=0, anchor_units=960,
                            rans_lanes=4, ans_chunk=4096, lpx_spans=0)
    crc, payload, spans = jpipeline.compress_block_ex(data, opt,
                                                      NativeEngine())
    a, b = io.BytesIO(), io.BytesIO()
    framing.write_block(a, crc, payload, opt.blocksize, 960, 4, spans)
    jframing.write_block(b, crc, payload, opt.blocksize, 960, 4, spans)
    assert a.getvalue() == b.getvalue()
    h, p = framing.read_block(io.BytesIO(a.getvalue()))
    jh, jp = jframing.read_block(io.BytesIO(a.getvalue()))
    assert vars(h) == vars(jh) and p == jp
    mine, ref = dd.block_meta(payload, 4), jdd.block_meta(payload, 4)
    assert mine.keys() == ref.keys()
    for k in mine:
        assert np.array_equal(mine[k], ref[k]), k
    assert dd.plan_shapes([mine], [len(payload)], 1 << 20, 4) == \
        jdd.plan_shapes([ref], [len(payload)], 1 << 20, 4)


@pytest.mark.parametrize("argv", [
    ["c", "a", "b"], ["c", "a", "b", "-m3", "-f2", "-c16", "-L4", "-u960",
                      "-S0"],
    ["d", "a", "b", "-b16", "-Sa", "-t3", "-T"],
    ["c", "a", "b", "-S4", "-b2", "-L1", "-v"]])
def test_parse_agrees_with_jax_cli(argv):
    mode, inp, outp, opt = cli._parse(["cli", *argv])
    jmode, jinp, joutp, jopt, _ = jcli._parse(["cli", *argv])
    assert (mode, inp, outp) == (jmode, jinp, joutp)
    assert vars(opt) == vars(jopt)


@pytest.mark.parametrize("argv,msg", [
    (["c", "a", "a"], "Refusing to write to input"),
    (["c", "a", "b", "-S4a"], "Unknown option character 'a' in -S4a"),
    (["c", "a", "b", "--nope"], "Unknown option: --nope")])
def test_parse_refusals_agree_with_jax_cli(argv, msg):
    for parse in (cli._parse, jcli._parse):
        with pytest.raises(SystemExit, match=msg):
            parse(["cli", *argv])


def test_options_validators_agree():
    for fn in ("validate_match_finder", "validate_lpx_spans",
               "validate_rans_lanes"):
        for v in (-1, 0, 1, 2, 3, 4, 4096, 4097, 1 << 16, (1 << 16) + 1):
            outs = []
            for mod in (options, jpipeline):
                try:
                    outs.append(getattr(mod, fn)(v))
                except ValueError as e:
                    outs.append(str(e))
            assert outs[0] == outs[1], (fn, v)
    assert vars(options.Options()) == vars(jpipeline.Options())
