"""Engine: mean over the window's ticks of the slots prefilling or
decoding, as a share of all slots (%), from the engine tracer's "tick"
spans."""


def read(run):
    ticks = run.spans("tick")
    if not ticks:
        return None
    busy = sum(a["n_prefilling"] + a["n_decoding"] for _, _, a in ticks)
    return 100.0 * busy / (len(ticks) * run.slots)
