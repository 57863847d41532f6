"""Engine admission: 95th percentile over the requests due in the window
of due time to the start of the tick that admitted them (ms). The
admitting tick is the engine tracer's "admit" event, its start the
harness's stamp before that tick."""

from portbench.harness.readings import percentile_ms


def read(run):
    admit = run.admit_tick()
    start = {t: s for t, s, _ in run.win.ticks}
    return percentile_ms([start[admit[r.index]] - r.due
                          for r in run.due_in_window()
                          if admit.get(r.index) in start], 95)
