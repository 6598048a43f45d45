"""k4_model_pairs_roofline: K4's share of its roofline, in percent: the
least time the card could take for the encode model pass of every op's
archive in the window (_roofline.k4_work, each op's archive counted on
its own) over the summed time of csrc/model_pairs.cu's kernel in the
trace.  An op's archive is the file its job names as holding its answer
(harness.Job.archive): every op has to write it byte for byte."""

import torch

from ._roofline import PEAKS, k4_work, least_seconds

KERNEL = "model_pairs_kernel"


def read(run, metric):
    if run.device is None or not torch.cuda.is_available():
        return None
    spent = run.device.seconds(KERNEL)
    kind = torch.cuda.get_device_name(0)
    if (spent <= 0 or kind not in PEAKS
            or any(r.archive is None for r in run.records)):
        return None
    least = {}
    for r in run.records:
        if r.archive not in least:
            with open(r.archive, "rb") as f:
                least[r.archive] = least_seconds(*k4_work(f.read()), kind)
    return 100.0 * sum(least[r.archive] for r in run.records) / spent
