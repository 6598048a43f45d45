"""idle_pct.<op>: the share of the traced window in which no kernel, copy
or memset ran on the card, in percent."""


def read(run, metric):
    if run.device is None or not run.device.ops:
        return None
    return 100.0 * (1.0 - run.device.busy(*run.window) / run.window_s)
