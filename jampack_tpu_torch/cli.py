"""Command line of the port.

    python -m jampack_tpu_torch.cli d archive output [--device cuda|cpu]
    python -m jampack_tpu_torch.cli c input archive [-m0..-m3 -f0|-f1|-f2 -S# -Sa -b# -u# -c# -L#] [--engine fused] [--device cuda|cpu]

d decodes on the GPU, every archive the JAX package's engines write.  c
encodes on the GPU (--engine fused, the only engine and the default),
every block of any length: the LZ match finders -m0/-m1/-m2 on the host
around the device stages, or -m3 (store) all on the device; -f0/-f1/-f2
(the filter search on the device); any Lpx span count -S# (0 skips the
stage), with -Sa the per-block gate that frames spans 0 where the stage
gains too little.  With no flag it writes the reference's default JAM
archive (-m0 -f1 -S4).  It refuses -f3 with a message naming what is not
ported yet; `python -m jampack_tpu.cli c` encodes it on the host.  The
device defaults to cuda; there is no fallback to the CPU: --device cpu
runs the plain PyTorch versions of the kernels and exists for tests.  Flags and
messages are jampack_tpu.cli's (_parse is a copy).
"""

import sys
import time

from .format.constants import DEFAULT_BLOCKSIZE, MAX_BLOCKSIZE, MIN_BLOCKSIZE
from .runtime.device_decode import decompress_stream_device
from .runtime.device_encode import compress_stream_device
from .runtime.options import (
    Options,
    validate_lpx_spans,
    validate_match_finder,
    validate_rans_lanes,
)

HOST_ENCODE = "python -m jampack_tpu.cli c"


def _split_flags(argv):
    """(argv without --device/--engine, the device or 'cuda', the engine or
    'fused'); each takes `--flag value` or `--flag=value`."""
    rest, found, i = [], {"--device": "cuda", "--engine": "fused"}, 0
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


def _parse(argv):
    """(mode, input, output, Options) from the reference's flags
    (main.cpp:65-89 semantics) and the JTX/JT3 stream parameters; a copy
    of jampack_tpu.cli._parse without its engine choice."""
    mode, inp, outp = argv[1], argv[2], argv[3]
    if inp == outp:
        raise SystemExit("Refusing to write to input, change the output directory.")
    opt = Options(blocksize=DEFAULT_BLOCKSIZE, match_finder=0, filters=1)
    threads = 0
    multiblock = True
    for arg in argv[4:]:
        if arg.startswith("--"):
            if arg != "--verbose":
                raise SystemExit(f"Unknown option: {arg}")
        elif arg.startswith("-") and len(arg) >= 2:
            p = arg[1:]
            while p:
                c = p[0]
                rest = p[1:]
                num = ""
                while rest and (rest[0].isdigit()):
                    num += rest[0]
                    rest = rest[1:]
                if c == "b" and num:
                    # in place, so stream parameters set by earlier flags
                    # survive regardless of flag order
                    opt.blocksize = int(min(max(int(num) << 20,
                                                MIN_BLOCKSIZE),
                                            MAX_BLOCKSIZE))
                elif c == "u" and num:
                    opt.anchor_units = int(num)  # native JTX container
                elif c == "c" and num:
                    opt.ans_chunk = int(num) << 10  # ANS chunk in KB
                elif c == "L" and num:
                    opt.rans_lanes = validate_rans_lanes(int(num))
                elif c == "S" and num:
                    opt.lpx_spans = validate_lpx_spans(int(num))
                elif c == "S" and rest[:1] == "a":
                    opt.lpx_auto = True
                    rest = rest[1:]
                elif c == "m" and num:
                    opt.match_finder = validate_match_finder(int(num))
                elif c == "f" and num:
                    opt.filters = int(num)
                elif c == "t" and num:
                    threads = int(num)
                elif c == "T":
                    multiblock = False
                elif c == "v":
                    pass
                else:
                    raise SystemExit(f"Unknown option character "
                                     f"'{c}' in {arg}")
                p = rest
    opt.threads = threads
    opt.multiblock = multiblock
    return mode, inp, outp, opt


def _fused_unsupported(opt) -> str:
    """Why the device encode cannot encode with `opt`, or '' when it can."""
    if opt.filters not in (0, 1, 2):
        return (f"-f{opt.filters}: the -f3 device filter search is not "
                f"ported yet (use -f0/-f1/-f2, or {HOST_ENCODE})")
    return ""


def run(argv) -> int:
    argv, device, engine = _split_flags(list(argv))
    if len(argv) < 4:
        print(__doc__)
        return 0
    mode, inp, outp, opt = _parse(argv)
    if mode not in ("c", "d"):
        raise SystemExit("Invalid option!")
    if engine != "fused":
        raise SystemExit(f"--engine {engine}: the port's only engine is "
                         f"fused (the host engines: {HOST_ENCODE})")
    if mode == "c" and (why := _fused_unsupported(opt)):
        raise SystemExit(f"--engine fused: {why}")
    start = time.time()
    with open(inp, "rb") as fin, open(outp, "wb") as fout:
        if mode == "c":
            raw, comp = compress_stream_device(fin, fout, opt, device)
            label = f"device encode: {device}"
        else:
            comp, raw = decompress_stream_device(fin, fout, device)
            label = f"device decode: {device}"
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
