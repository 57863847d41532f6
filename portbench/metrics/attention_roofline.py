"""Kernels: ``row_attention``'s least time over its device time in the
traced ticks (%): live keys only, K and V read once per slot and layer
(``Costs.attention_call``), each decode and chunk call of the traced
ticks."""


def read(run):
    d = run.device()
    if d is None:
        return None
    least = 0.0
    for decode, chunk, _ in run.profiled_work():
        if decode:
            least += run.costs.attention_call([(p, 1) for p in decode])
        if chunk:
            least += run.costs.attention_call(chunk)
    device_s = d.kernel_seconds(run.attention_symbols)
    if not least or not device_s:
        return None
    return 100.0 * least / device_s
