"""archive_self.<op>: the CLI and archive runtime's own time an op
(cli.py, runtime/sharding.py): each op's cli.run span less the part of it
that block-runtime spans cover (decode_blocks_device and the block
encodes, in the worker threads), averaged over the window's ops, in the
metric's unit (s or ms).  It is argument parsing, the mesh, threads and
batch planning, framing, file reads and writes."""

from ..spans import union

SPANS = {"block_runtime": [
    "jampack_tpu_torch.runtime.sharding:decode_blocks_device",
    "jampack_tpu_torch.runtime.sharding:encode_blocks_device",
    "jampack_tpu_torch.runtime.sharding:encode_block_device_ex"]}


def read(run, metric):
    inner = run.spans.named("block_runtime")
    if not inner:
        return None
    own = sum((r.end - r.start) - union(inner, r.start, r.end)
              for r in run.records)
    return run.per_op(own, metric["unit"])
