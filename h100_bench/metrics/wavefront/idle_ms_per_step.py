"""wavefront.idle_ms_per_step: device idle ms a step while the host was
inside a bounce span (`pt.bounce` / `lt.bounce` and their phases) but in no
`trace.*` span, in the span pass's run of the traced steps."""
from h100_bench import spans_pass


def read(run):
    return spans_pass.ms_per_step(run, "wavefront", "idle_s")
