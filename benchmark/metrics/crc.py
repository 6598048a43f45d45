"""crc.<op>: time an op in the host's block checksum,
format/checksum.integrity_check, as the block runtime calls it
(runtime/device_decode.py after the fetch, runtime/device_encode.py before
the upload), summed over the worker threads, in the metric's unit (s or
ms)."""

SPANS = {"integrity_check": [
    "jampack_tpu_torch.runtime.device_decode:integrity_check",
    "jampack_tpu_torch.runtime.device_encode:integrity_check"]}


def read(run, metric):
    spans = run.spans.named("integrity_check")
    if not spans:
        return None
    return run.per_op(sum(b - a for a, b in spans), metric["unit"])
