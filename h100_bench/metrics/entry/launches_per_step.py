"""entry.launches_per_step: kernel events on the device a traced step
(memory copies and sets not counted); nothing of the harness runs on the
device in the profiled window."""
from h100_bench.kernels import is_copy


def read(run):
    if not run.trace or not run.traced_steps:
        return None
    n = sum(c for name, (_, c) in run.trace["kernels"].items()
            if not is_copy(name))
    return n / run.traced_steps if n else None
