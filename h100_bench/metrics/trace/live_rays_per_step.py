"""trace.live_rays_per_step: the port's counter `trace.live_rays` (the
live rays handed to trace_api.closest_hit and any_hit) over the span
pass's run of the traced steps, a step; millions."""
from h100_bench import spans_pass


def read(run):
    got = spans_pass.result(run)
    if got is None or got.get("live_rays") is None:
        return None
    return got["live_rays"] / got["steps"] / 1e6
