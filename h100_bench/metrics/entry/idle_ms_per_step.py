"""entry.idle_ms_per_step: device idle ms a step while the host was in a
step's root span (`pt.tile` / `lt.pass`) outside its bounces: `pt.eye_rays`,
`pt.resolve`, `lt.emit` and the root itself, in the span pass's run of the
traced steps."""
from h100_bench import spans_pass


def read(run):
    return spans_pass.ms_per_step(run, "entry", "idle_s")
