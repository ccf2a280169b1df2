"""The traced window: torch.profiler over device activity only, its raw
events summed by kernel name, the busy time (the union of every device
operation's interval), and the idle gaps named by the kernel that ran
before each. Recording host events too would cost many times the
window's own length."""
from __future__ import annotations

import time


class Window:
    """Profiles what runs between start() and stop()."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    def start(self):
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        """Call after a torch.cuda.synchronize()."""
        self.t1 = time.perf_counter()
        self.prof.stop()
        return summarize(device_events(self.prof), self.t1 - self.t0)


def device_events(prof) -> list:
    """[(name, start ns, duration ns)] of every device operation."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
    return out


def summarize(events: list, window_s: float) -> dict:
    """kernels {name: [seconds, count]}, busy_s (the union of the events'
    intervals), window_s, and the idle gaps inside the events' span as
    [(name of the operation before the gap, seconds)]."""
    kernels = {}
    for name, _, dur in events:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += dur / 1e9
        k[1] += 1
    busy = 0
    gaps = []
    end, last = None, None
    for name, start, dur in sorted(events, key=lambda e: e[1]):
        if end is None or start >= end:
            if end is not None and start > end:
                gaps.append((last, (start - end) / 1e9))
            busy += dur
            end, last = start + dur, name
        elif start + dur > end:
            busy += start + dur - end
            end, last = start + dur, name
    return {"kernels": kernels, "busy_s": busy / 1e9, "window_s": window_s,
            "gaps": gaps}


def short(name: str, n: int = 96) -> str:
    """A kernel's name without the namespaces that every one of them has."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:n]


def top(pairs, n: int = 10) -> list:
    """The n largest of [(name, seconds)], summed by shortened name."""
    acc = {}
    for name, s in pairs:
        name = short(name)
        acc[name] = acc.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
