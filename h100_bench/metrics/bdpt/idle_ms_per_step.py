"""bdpt.idle_ms_per_step: device idle ms a step while the host was inside a
`bdpt.*` span but in no `trace.*` span, in the span pass's run of the
traced steps."""
from h100_bench import span_layers


def read(run):
    return span_layers.ms_per_step(run, span_layers.in_bdpt, "idle_s")
