"""Kernels: ``joint_sparse_matmul``'s least time over its device time in
the traced ticks (%). The least time is the frozen cost functions' over
each decode and chunk call the traced ticks made (``Costs.joint_call``);
the device time sums the records of the kernel's symbols."""


def read(run):
    d = run.device()
    if d is None:
        return None
    least = 0.0
    for decode, chunk, _ in run.profiled_work():
        if decode:
            least += run.costs.joint_call(run.slots, len(decode))
        if chunk:
            least += run.costs.joint_call(run.slots * run.chunk,
                                          sum(n for _, n in chunk))
    device_s = d.kernel_seconds(run.joint_symbols)
    if not least or not device_s:
        return None
    return 100.0 * least / device_s
