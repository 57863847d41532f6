"""Device: the share of the traced window in which no device record ran
and the host was not waiting on a step (%). A call span's host is
waiting over [its start + ``enqueued_us``, its end], from the step's
return (inputs copied, the step launched) to its logits on the host; an
idle gap of the device window (``DeviceWindow.idle_gaps``) counts when
its middle lies outside every such stretch. ``idle_share`` less this is
the idle time inside the steps themselves. None where the call spans
carry no ``enqueued_us``."""

import bisect


def read(run):
    d = run.device()
    if d is None:
        return None
    # every call span of the trace: the traced stretch ends at the first
    # tick boundary after the window, later than run.spans' filter
    waits = sorted(
        (run.trace_t0 + 1e-6 * (r["ts_us"] + r["attrs"]["enqueued_us"]),
         run.trace_t0 + 1e-6 * (r["ts_us"] + r["dur_us"]))
        for r in run.records
        if r.get("type") == "span" and r.get("name") == "call"
        and r.get("dur_us") is not None
        and "enqueued_us" in r.get("attrs", {}))
    if not waits:
        return None
    starts = [s for s, _ in waits]

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        return "waiting" if i >= 0 and waits[i][1] >= t else "host"
    host = sum(s for k, s in d.idle_gaps(label) if k == "host")
    return 100.0 * host / d.window_s
