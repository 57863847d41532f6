"""Device: the share of the traced window in which no device record
(kernel, copy, set) ran (%)."""


def read(run):
    return run.idle_pct()
