"""The device's own records of a traced stretch of the window.

``DeviceWindow`` runs torch.profiler over whole engine ticks of the
measured window and reads its device-side records (kernels, copies,
sets) straight from the profiler's raw results, without building one
Python event per kernel. Late in a long process the profiler can drop
the first and last records of a window, so the stretch opens and closes
on 64 spin kernels (``torch.cuda._sleep``, ~0.2 ms each; the method of
``chip_smoke.py``'s profile phase), which every reading leaves out.
The traced window is the device time from the end of the opening spins
to the start of the closing ones; busy is the union of the other records
inside it. The opening spins' end is also where the device clock is tied
to the host's.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

PAD_SYMBOL = "spin_kernel"
PAD_KERNELS = 64
PAD_CYCLES = 400_000


def _pad():
    torch.cuda.synchronize()
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()


class DeviceWindow:
    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self.records = []           # (name, start s, end s) on the host clock
        self.window_s = self.busy_s = None
        self.start_s = self.stop_s = None
        self.n_pads = self.n_recs = 0

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def prime(self):
        """One short profiled stretch before the window: the profiler's
        first start in a process loads and sets up its tracing library,
        which takes seconds that must not fall inside the window."""
        with self._profile():
            _pad()

    def start(self):
        s = time.perf_counter()
        self._prof = self._profile()
        self._prof.__enter__()
        _pad()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - s

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        _pad()
        self._prof.__exit__(None, None, None)
        self._read()
        self._prof = None
        self.stop_s = time.perf_counter() - self.t1

    def _read(self):
        from torch.autograd import DeviceType
        pads, recs = [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = e.start_ns() * 1e-9
            rec = (e.name(), s, s + e.duration_ns() * 1e-9)
            (pads if PAD_SYMBOL in rec[0] else recs).append(rec)
        self.n_pads, self.n_recs = len(pads), len(recs)
        if len(pads) < 2 or not recs:
            return
        # the window is the gap between consecutive spin records that holds
        # the most other records: the opening spins end it on the left,
        # the closing ones on the right, whichever of them the profiler
        # kept, and a record from before the opening spins stays out
        pads.sort(key=lambda r: r[1])
        starts = sorted(r[1] for r in recs)

        def inside(j):
            lo = bisect.bisect_left(starts, pads[j][2])
            return bisect.bisect_right(starts, pads[j + 1][1]) - lo
        i = max(range(len(pads) - 1), key=inside)
        d0, d1 = pads[i][2], pads[i + 1][1]
        shift = self.t0 - d0
        self.window_s = d1 - d0
        self.records = sorted((n, s + shift, e + shift) for n, s, e in recs
                              if d0 <= s and e <= d1)
        busy, end = 0.0, None
        for _, s, e in sorted(self.records, key=lambda r: r[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        self.busy_s = busy

    # -- readings ----------------------------------------------------------
    def kernel_seconds(self, symbols) -> float:
        """Device seconds of the records whose name holds a symbol."""
        return sum(e - s for n, s, e in self.records
                   if any(sym in n for sym in symbols))

    def top_ops(self, n: int = 10):
        by = defaultdict(float)
        for name, s, e in self.records:
            by[name] += e - s
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, label, n: int = 10):
        """Idle device time of the traced window, summed by ``label(t)``:
        what the host was doing at the middle of each gap."""
        by = defaultdict(float)
        t = self.t0 + 0.0
        end = self.t0 + self.window_s
        for _, s, e in sorted(self.records, key=lambda r: r[1]):
            if s > t:
                by[label(0.5 * (t + s))] += s - t
            t = max(t, e)
        if end > t:
            by[label(0.5 * (t + end))] += end - t
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]
