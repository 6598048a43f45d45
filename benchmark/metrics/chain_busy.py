"""chain_busy.<op>: time an op in which a kernel ran on the card, the
union of the kernel intervals in the profiler's trace over the window, in
the metric's unit (s or ms).  It counts the decode and encode chains of
kernels/device_stages.py and kernels/encode_stages.py (the port's kernels
and the torch operations between them) and leaves out the block runtime's
copies and memsets, which idle_pct counts besides."""


def read(run, metric):
    if run.device is None or not run.device.ops:
        return None
    return run.per_op(run.device.busy(*run.window, cats=("kernel",)),
                      metric["unit"])
