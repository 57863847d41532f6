"""Model step: the share of the chunk call's rows that held prompt tokens
(%), the engine tracer's ``rows_valid`` summed over its ``rows`` (slots x
chunk) across the prefill "call" spans started in the window. None where
the spans carry no row counts."""


def read(run):
    rows = valid = 0
    for _, _, a in run.spans("call", phase="prefill"):
        if "rows" in a:
            rows += a["rows"]
            valid += a["rows_valid"]
    if not rows:
        return None
    return 100.0 * valid / rows
