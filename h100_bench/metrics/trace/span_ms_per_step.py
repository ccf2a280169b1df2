"""trace.span_ms_per_step: device ms a step of the operations launched
inside the port's `trace.*` spans (trace_api.closest_hit / any_hit), in the
span pass's run of the traced steps: no synchronize around a call."""
from h100_bench import spans_pass


def read(run):
    return spans_pass.ms_per_step(run, "trace", "device_s")
