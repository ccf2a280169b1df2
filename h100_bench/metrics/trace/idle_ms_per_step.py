"""trace.idle_ms_per_step: device idle ms a step while the host was inside
a `trace.*` span, in the span pass's run of the traced steps."""
from h100_bench import spans_pass


def read(run):
    return spans_pass.ms_per_step(run, "trace", "idle_s")
