"""Load generator: 99th percentile over the requests due in the window of
submit time less due time (ms), on the harness's clock."""

from portbench.harness.readings import percentile_ms


def read(run):
    return percentile_ms([r.submit - r.due for r in run.due_in_window()
                          if r.submit is not None], 99)
