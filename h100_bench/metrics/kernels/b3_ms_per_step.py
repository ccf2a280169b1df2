"""kernels.b3_ms_per_step: device ms a traced step of kernel B3, the
cluster kernels' two-level walk over an instanced layout
(csrc/traverse_cluster.cu two_level_kernel<*, true>, closest and any hit),
summed by kernel name over the profiled steps."""
import re

B3 = re.compile(r"two_level_kernel(<\s*(true|false)\s*,\s*true\s*>"
                r"|ILb[01]ELb1E)")


def seconds(run):
    """B3's device seconds over the profiled steps, None where none ran."""
    if not run.trace or not run.traced_steps:
        return None
    s = sum(sec for name, (sec, _) in run.trace["kernels"].items()
            if B3.search(name))
    return s if s > 0 else None


def read(run):
    s = seconds(run)
    return None if s is None else 1e3 * s / run.traced_steps
