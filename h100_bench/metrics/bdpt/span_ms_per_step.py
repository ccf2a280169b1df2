"""bdpt.span_ms_per_step: device ms a step of the operations launched
inside a `bdpt.*` span (bdpt.pass and its phases bdpt.eye, bdpt.camera,
bdpt.light, bdpt.connect, bdpt.splat) but in no `trace.*` span, in the span
pass's run of the traced steps."""
from h100_bench import span_layers


def read(run):
    return span_layers.ms_per_step(run, span_layers.in_bdpt, "device_s")
