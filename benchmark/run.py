"""The benchmark of jampack_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

harness.py runs it.  Without a trace the result line holds the cell's
end-to-end metrics.  With --trace 1 the window runs under torch.profiler,
with spans around the program's layers (spans.py, trace.py), and the line
holds the cell's per-layer metrics, `busy_s`, `window_s` and a breakdown.
Each metric is read by metrics/<name>.py; one that finds nothing to read
is left out.

The last line of stdout is one JSON object: correct, attempted, failed,
metrics, device, (breakdown,) checks; the checks, each number compared
with its limit, are also the last lines of stderr.  No card, fewer cards
than the cell asks for, or JAX in the process after the window: exit 2
and no line.
"""

import time

START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import registry  # noqa: E402
from .harness import run_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "jampack_tpu")


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _args(argv):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    chips = registry.cell(registry.benchmark(), args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    device = "cuda" if chips > 1 else "cuda:0"
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device, start=START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)} after the "
              f"window; the port and the harness import none of them",
              file=sys.stderr)
        return 2
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
