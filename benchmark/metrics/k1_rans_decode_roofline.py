"""k1_rans_decode_roofline: K1's share of its roofline, in percent: the
least time the card could take for the rANS decode of every op's archive
in the window (_roofline.k1_work, each op's archive counted on its own)
over the summed time of csrc/rans_decode.cu's kernel in the trace."""

import torch

from ._roofline import PEAKS, k1_work, least_seconds

KERNEL = "rans_decode_kernel"


def read(run, metric):
    if run.device is None or not torch.cuda.is_available():
        return None
    spent = run.device.seconds(KERNEL)
    kind = torch.cuda.get_device_name(0)
    if spent <= 0 or kind not in PEAKS:
        return None
    least = {}
    for r in run.records:
        if r.source not in least:
            with open(r.source, "rb") as f:
                least[r.source] = least_seconds(*k1_work(f.read()), kind)
    return 100.0 * sum(least[r.source] for r in run.records) / spent
