"""wait.<op>: time an op in which the host blocks on the card: the
program's sync.* spans around each host read of device data on the
decode chain (kernels/device_stages.py: the K11 walk's status, the
filter picks, the LZ expansion's checks, the batch status), summed over
the threads, in the metric's unit (s or ms)."""

from ._program import per_op


def read(run, metric):
    return per_op(run, metric, lambda name: name.startswith("sync."))
