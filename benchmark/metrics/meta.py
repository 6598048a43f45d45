"""meta.<op>: time an op in the host's parse of a block's chunk headers
and lane tables, runtime/device_decode.block_meta, in the metric's unit
(s or ms)."""

SPANS = {"block_meta": ["jampack_tpu_torch.runtime.device_decode:block_meta"]}


def read(run, metric):
    spans = run.spans.named("block_meta")
    if not spans:
        return None
    return run.per_op(sum(b - a for a, b in spans), metric["unit"])
