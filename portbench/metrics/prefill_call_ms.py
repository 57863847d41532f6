"""Model step: the engine tracer's prefill-chunk "call" spans started in
the window, their time summed over their count (ms). A span closes once
the call's logits are on the host."""


def read(run):
    return run.mean_call_ms("prefill")
