"""stored_pct: archive bytes over raw bytes, in percent, of everything the
port wrote in the run's set-up (the restore archive, or every object)."""


def read(run, metric):
    return 100.0 * run.stored / run.raw if run.raw else None
