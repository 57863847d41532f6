"""Engine: the slot reset's device time, the mean over the engine
tracer's reset "call" spans started in the window of their ``device_us``
(ms): the CUDA-event time on the stream from before the reset mask's
input copy to after the reset step. None where no reset span holds one,
as in a program whose tracer spans no reset."""


def read(run):
    times = [a["device_us"] for _, _, a in run.spans("call", phase="reset")
             if "device_us" in a]
    if not times:
        return None
    return 1e-3 * sum(times) / len(times)
