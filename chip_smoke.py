#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives jampack_tpu_torch's two paths on cuda:0, with no JAX anywhere:
the fused block decode of the production JT3 stream (-c16 -L4 -u960
-S4096 -Sa, the CLI's -f1) and the fused block encode of the store
configuration (-m3 -f0 -c16 -L4 -u960 -S0):

  1. facts     nvidia-smi name and power limit; NVIDIA, torch, CUDA versions
  2. build     nvcc builds the six kernels from csrc/, one process each
  3. encode    host encode (shared native engine) of a 32 MiB, four-block
               textlike archive through the port's CLI; every block must
               frame lpx_spans = 0 (the Lpx gate drops the stage on text)
  4. parity    each decode kernel against its plain PyTorch version, exact,
               on the stage inputs of the archive's first 8 MiB block, with
               both times from CUDA events after a warm-up
  5. decode    the archive through `jampack_tpu_torch.cli d` on cuda, with
               the decode kernels' launch counts zeroed just before: bytes
               and per-block CRCs must match, and every kernel must have
               run; then the per-stage split of one block
  6. parity    each encode kernel against its plain version, exact, on the
               stage inputs of the first 8 MiB block of the encode
               configuration
  7. fused     the same 32 MiB through `cli c --engine fused` on cuda, with
               the encode kernels' launch counts zeroed just before: the
               archive must equal the host engine's (`cli c`, same flags)
               byte for byte, and every encode kernel must have run once per
               block, the trailing empty block included
  8. round     that archive through `cli d` on cuda, decode counts zeroed:
               the input comes back, every decode kernel ran
  9. split     the per-stage times of block 0's device encode
 10. golden    the golden JT3 fixture decodes to golden_input.bin

Any failure raises, so the script exits non-zero without its last line.
The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Exits 1 at once when no GPU is present.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = 8 << 20
NBLOCKS = 4
PROD_FLAGS = ["-c16", "-L4", "-u960", "-S4096", "-Sa"]
ENC_FLAGS = ["-m3", "-f0", "-c16", "-L4", "-u960", "-S0"]


def textlike(n: int, seed: int):
    """bench.py's textlike corpus (30-letter alphabet, uniform)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    return alpha[(x >> 16) % 30]


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, from CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parity(name, kernel_fn, plain_fn, reps):
    """Run both versions (first calls are the warm-up), require exact
    equality, then time each.  Returns (outputs, row of the kernels JSON
    without launches)."""
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    check(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, 1)
    print(f"parity {name}: exact; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    return got, {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


def decode_cli(cli, kernels, arc, out):
    """`cli d` of `arc` on cuda with the kernels' launch counts zeroed just
    before; every kernel must have run.  Returns (wall s, launches)."""
    import torch

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(cli.run(["cli", "d", arc, out, "--device", "cuda"]) == 0,
          "decode failed")
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    for k, n in zip(kernels, launches):
        check(n > 0, f"{k.name} was not launched on the decode path")
    return wall, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from jampack_tpu.runtime.pipeline import Options
    from jampack_tpu_torch import cli
    from jampack_tpu_torch.kernels import (
        _build,
        device_stages,
        encode_stages,
        ibwt,
        rank,
        rans,
        rans_encode,
    )
    from jampack_tpu_torch.runtime import device_decode as dd
    from jampack_tpu_torch.runtime import device_encode as de

    dev = torch.device("cuda:0")
    dec_kernels = [rans.KERNEL, rank.KERNEL, ibwt.KERNEL]
    enc_kernels = [encode_stages.RANK_KERNEL, rans_encode.PAIRS_KERNEL,
                   rans_encode.REVERSE_KERNEL]

    # ---- 1. facts
    card = smi("name,power.limit")
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    print(f"facts: {card}; NVIDIA {smi('driver_version')}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; triton {triton_v}; "
          f"python {sys.version.split()[0]}")

    # ---- 2. build
    t0 = time.perf_counter()
    info = _build.build()
    lib = _build.load()
    check(lib is not None, "kernel library did not load")
    ptxas = [ln.split(":", 1)[-1].strip() for ln in info["log"].splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s,"
          f" built={info['built']}); " + " | ".join(ptxas))

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "textlike32.bin")
        arc = os.path.join(tmp, "textlike32.jt3")
        back = os.path.join(tmp, "textlike32.out")

        # ---- 3. encode (host, shared native engine)
        with open(src, "wb") as f:
            for seed in range(NBLOCKS):
                f.write(textlike(BLOCK, seed).tobytes())
        t0 = time.perf_counter()
        check(cli.run(["cli", "c", src, arc, *PROD_FLAGS]) == 0, "encode failed")
        enc_s = time.perf_counter() - t0
        blocks = []
        with open(arc, "rb") as f:
            while (rec := dd.framing.read_block(f)) is not None:
                blocks.append(rec)
        check(len(blocks) == NBLOCKS + 1, f"{len(blocks)} blocks framed")
        check(all(h.lpx_spans == 0 and h.units == 960 and h.lanes == 4
                  for h, _ in blocks), "a block framed Lpx spans > 0")
        print(f"encode: {NBLOCKS * BLOCK} bytes -> {os.path.getsize(arc)} in "
              f"{enc_s:.1f} s on the host (first use builds the native "
              f"engine); "
              f"{len(blocks)} blocks, all lpx_spans=0")

        # ---- 4. kernel parity at the slice shapes of block 0
        header, payload = blocks[0]
        meta = dd.block_meta(payload, header.lanes)
        C = meta["chunk_olens"].size
        pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(dev)
        starts = torch.from_numpy(meta["starts"]).to(dev)
        rlens = torch.from_numpy(meta["rlens"]).to(dev)
        olens = torch.from_numpy(meta["chunk_olens"]).to(dev)
        crlens = torch.from_numpy(meta["chunk_rlens"]).to(dev)
        freqs = torch.from_numpy(meta["freqs"]).to(dev)
        rmax = int(meta["rlens"].max())
        ocap = int(meta["chunk_olens"].max())
        print(f"shapes: payload {len(payload)} B, {C} chunks, {starts.numel()} "
              f"chains of <= {rmax} symbols, chunks of <= {ocap} bytes")
        rows = []
        (syms, _), row = parity(
            "rans_decode",
            lambda: rans.decode_lanes_wide(pay, starts, rlens, rmax, groups=C),
            lambda: rans.decode_lanes_wide_plain(pay, starts, rlens, rmax,
                                                 groups=C), 5)
        rows.append(row)
        ranks, _ = device_stages.rle0_decode(syms, crlens, olens, ocap)
        (chunk_bytes, _), row = parity(
            "rank_decode",
            lambda: rank.rank_decode(ranks, freqs, olens, ocap),
            lambda: rank.rank_decode_plain(ranks, freqs, olens, ocap), 5)
        rows.append(row)
        total = int(meta["chunk_olens"].sum())
        stage = chunk_bytes.reshape(-1)[:total]
        n = total - 4 * header.units
        nlen = n - n % header.units
        anchors = device_stages.read_anchors(stage, n, header.units)
        lf, sbyte = ibwt.combined_map(stage[:nlen], anchors[0])
        print(f"shapes: BWT stage {total} B, chase {header.units} chains x "
              f"{nlen // header.units} steps over a {nlen}-entry map")
        _, row = parity(
            "ibwt_chase",
            lambda: (ibwt.chase(lf, sbyte, anchors, header.units),),
            lambda: (ibwt.chase_plain(lf, sbyte, anchors, header.units),), 5)
        rows.append(row)

        # ---- 5. decode the archive through the CLI, counting launches
        dec_s, launches = decode_cli(cli, dec_kernels, arc, back)
        with open(src, "rb") as f:
            want = f.read()
        with open(back, "rb") as f:
            got = f.read()
        check(got == want, "decoded archive differs from the input")
        for i, (h, _) in enumerate(blocks[:NBLOCKS]):
            part = np.frombuffer(got[i * BLOCK:(i + 1) * BLOCK], np.uint8)
            check(dd.integrity_check(part) == h.crc, f"block {i} CRC")
        print(f"decode: {len(got)} bytes in {dec_s:.3f} s = "
              f"{len(got) / dec_s / 1e9:.4f} GB/s (CLI wall, host CRC "
              f"included); bytes and {NBLOCKS} block CRCs match; launches "
              + ", ".join(f"{k.name}={c}" for k, c in zip(dec_kernels, launches)))
        times = {}
        t0 = time.perf_counter()
        dd.decode_block_device(payload, header.crc, header.blocksize, header.units,
                            header.lanes, header.lpx_spans, dev, times)
        block_s = time.perf_counter() - t0
        print(f"block 0 stages (s, synchronized): "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; block wall {block_s:.3f} s incl. host CRC")

        # ---- 6. encode kernel parity at the slice shapes of block 0
        opt = Options(blocksize=BLOCK, match_finder=3, filters=0,
                      rans_lanes=4, ans_chunk=16 << 10, anchor_units=960,
                      lpx_spans=0)
        block0 = textlike(BLOCK, 0)
        s4 = encode_stages.bwt_stage(torch.from_numpy(block0).to(dev), 960)
        rows_in, olens_e = encode_stages.chunk_rows(s4, opt.ans_chunk)
        print(f"shapes: encode stage {s4.numel()} B, {rows_in.shape[0]} "
              f"chunks of <= {rows_in.shape[1]} bytes")
        (ranks_e, _), row = parity(
            "rank_encode",
            lambda: encode_stages.rank_encode(rows_in, olens_e),
            lambda: encode_stages.rank_encode_plain(rows_in, olens_e), 5)
        rows.append(row)
        syms_e, rlens_e = encode_stages.rle0_encode(ranks_e, olens_e)
        chains, crlens, mr = encode_stages.deal(syms_e, rlens_e, opt.rans_lanes)
        print(f"shapes: {chains.shape[0]} chains of <= {int(crlens.max())} "
              f"symbols (max_rlen {mr})")
        (lows, fqs, oks), row = parity(
            "model_pairs",
            lambda: rans_encode.model_pairs_wide(chains, crlens, mr),
            lambda: rans_encode.model_pairs_wide_plain(chains, crlens, mr), 5)
        rows.append(row)
        check(bool(oks.all()), "model pass flagged a zero-frequency op")
        _, row = parity(
            "rans_encode",
            lambda: rans_encode.rans_reverse_encode_wide(lows, fqs, crlens, mr),
            lambda: rans_encode.rans_reverse_encode_wide_plain(lows, fqs,
                                                               crlens, mr), 5)
        rows.append(row)

        # ---- 7. fused encode through the CLI, counting launches
        host_arc = os.path.join(tmp, "textlike32.host.jt3")
        dev_arc = os.path.join(tmp, "textlike32.dev.jt3")
        t0 = time.perf_counter()
        check(cli.run(["cli", "c", src, host_arc, *ENC_FLAGS]) == 0,
              "host encode (store configuration) failed")
        host_s = time.perf_counter() - t0
        for k in enc_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(cli.run(["cli", "c", src, dev_arc, *ENC_FLAGS, "--engine",
                       "fused", "--device", "cuda"]) == 0, "fused encode failed")
        enc_s = time.perf_counter() - t0
        enc_launches = [k.launches for k in enc_kernels]
        with open(host_arc, "rb") as f:
            host_bytes = f.read()
        with open(dev_arc, "rb") as f:
            dev_bytes = f.read()
        check(dev_bytes == host_bytes,
              "fused archive differs from the host engine's")
        nblk = 0
        with open(dev_arc, "rb") as f:
            while dd.framing.read_block(f) is not None:
                nblk += 1
        check(nblk == NBLOCKS + 1,
              f"{nblk} blocks framed; the trailing empty block is missing")
        for k, c in zip(enc_kernels, enc_launches):
            check(c == nblk, f"{k.name} launched {c} times for {nblk} blocks")
        print(f"fused encode: {NBLOCKS * BLOCK} bytes -> {len(dev_bytes)} in "
              f"{enc_s:.3f} s = {NBLOCKS * BLOCK / enc_s / 1e9:.4f} GB/s (CLI "
              f"wall, host CRC and splice included); byte-identical to the "
              f"host engine ({host_s:.1f} s); {nblk} blocks, the empty one "
              f"included; launches "
              + ", ".join(f"{k.name}={c}" for k, c in zip(enc_kernels,
                                                          enc_launches)))

        # ---- 8. round trip: the fused archive decodes on the card
        rt_s, rt_launches = decode_cli(cli, dec_kernels, dev_arc, back)
        with open(back, "rb") as f:
            check(f.read() == want, "fused archive did not decode to the input")
        print(f"round trip: fused archive decoded in {rt_s:.3f} s, exact; "
              "launches " + ", ".join(
                  f"{k.name}={c}" for k, c in zip(dec_kernels, rt_launches)))

        # ---- 9. stage split of block 0's device encode
        times = {}
        t0 = time.perf_counter()
        crc, payload0 = de.encode_block_device(block0, opt, dev, times)
        block_s = time.perf_counter() - t0
        with open(dev_arc, "rb") as f:
            first = dd.framing.read_block(f)
        check((crc, payload0) == (first[0].crc, first[1]),
              "block 0 encode differs from the archive's")
        print("encode block 0 stages (s; device stages synchronized): "
              + ", ".join(f"{k}={v:.4f}" for k, v in times.items())
              + f"; block wall {block_s:.3f} s")

    # ---- 10. golden fixture
    import io

    fixtures = os.path.join(HERE, "tests", "fixtures")
    with open(os.path.join(fixtures, "golden_jt3_prod_u960_L4_c16_Sa.jt3"), "rb") as f:
        gold_arc = f.read()
    with open(os.path.join(fixtures, "golden_input.bin"), "rb") as f:
        gold = f.read()
    out = io.BytesIO()
    dd.decompress_stream_device(io.BytesIO(gold_arc), out, dev)
    check(out.getvalue() == gold, "golden JT3 fixture decoded wrongly")
    print(f"golden: golden_jt3_prod_u960_L4_c16_Sa.jt3 -> {len(gold)} bytes, exact")

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": c, **row}
        for k, c, row in zip(dec_kernels + enc_kernels,
                             launches + enc_launches, rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
