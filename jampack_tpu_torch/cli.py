"""Command line of the port.

    python -m jampack_tpu_torch.cli d archive output [--device cuda|cpu]
    python -m jampack_tpu_torch.cli c input archive [-b# -m# -f# -t# -u# -c# -L# -S# -Sa]
    python -m jampack_tpu_torch.cli c input archive --engine fused -m3 -f0 -S0 [-b# -u# -c# -L#] [--device cuda|cpu]

d decodes on the GPU.  c is the shared host encoder (jampack_tpu's native
C++ engine), not a device path.  c --engine fused encodes on the GPU, every
block of any length, in the configuration the port has: -m3 (store), -f0
and Lpx spans 0 (-S0).  It refuses -m0/-m1/-m2 (the host-LZ route),
-f1/-f2 (the device filter search) and spans other than 0 (the Lpx encode)
with a message naming what is not ported yet.  The device defaults to cuda;
there is no fallback to the CPU: --device cpu runs the plain PyTorch
versions of the kernels and exists for tests.  Other flags are
jampack_tpu.cli's.
"""

import sys
import time

from jampack_tpu.cli import _parse
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import LZ_MODE_STORE, compress_stream

from .runtime.device_decode import decompress_stream_device
from .runtime.device_encode import compress_stream_device


def _split_flags(argv):
    """(argv without --device/--engine, the device or 'cuda', the engine or
    'native'); each takes `--flag value` or `--flag=value`."""
    rest, found, i = [], {"--device": "cuda", "--engine": "native"}, 0
    while i < len(argv):
        arg = argv[i]
        name = arg.split("=", 1)[0]
        if name in found:
            if "=" in arg:
                found[name] = arg.split("=", 1)[1]
            elif i + 1 < len(argv):
                found[name] = argv[i + 1]
                i += 1
            else:
                raise SystemExit(f"{name} needs a value")
        else:
            rest.append(arg)
        i += 1
    return rest, found["--device"], found["--engine"]


def _fused_unsupported(opt) -> str:
    """Why --engine fused cannot encode with `opt`, or '' when it can."""
    if opt.match_finder != LZ_MODE_STORE:
        return (f"-m{opt.match_finder}: the host-LZ encode route is not "
                f"ported yet (use -m3)")
    if opt.filters != 0:
        return (f"-f{opt.filters}: the device filter search is not ported "
                f"yet (use -f0)")
    if opt.lpx_spans != 0:
        return (f"Lpx spans {opt.lpx_spans}: the Lpx encode stage is not "
                f"ported yet (use -S0)")
    return ""


def run(argv) -> int:
    argv, device, engine = _split_flags(list(argv))
    if len(argv) < 4:
        print(__doc__)
        return 0
    mode, inp, outp, opt, _ = _parse(argv)
    if engine not in ("native", "fused") or (engine == "fused" and mode != "c"):
        raise SystemExit("the port's only --engine choice is fused, for c")
    if engine == "fused" and (why := _fused_unsupported(opt)):
        raise SystemExit(f"--engine fused: {why}")
    start = time.time()
    with open(inp, "rb") as fin, open(outp, "wb") as fout:
        if mode == "c" and engine == "fused":
            raw, comp = compress_stream_device(fin, fout, opt, device)
            label = f"device encode: {device}"
        elif mode == "c":
            raw, comp = compress_stream(fin, fout, opt,
                                        NativeEngine(threads=opt.threads))
            label = "host encode: native"
        elif mode == "d":
            comp, raw = decompress_stream_device(fin, fout, device)
            label = f"device decode: {device}"
        else:
            raise SystemExit("Invalid option!")
    dt = time.time() - start
    ratio = (comp / raw * 100) if raw else 0.0
    rate = (raw / 1e6) / dt if dt > 0 else 0.0
    print(f"{raw / 1e6:.2f} MB <=> {comp / 1e6:.2f} MB ({ratio:.2f}%) "
          f"@ {rate:.2f} MB/s in {dt:.2f}s [{label}]")
    return 0


def main():
    sys.exit(run(sys.argv))


if __name__ == "__main__":
    main()
