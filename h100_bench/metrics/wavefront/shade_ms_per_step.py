"""wavefront.shade_ms_per_step: device ms a traced step of every kernel in
the profiled window (eye rays, shading, BSDF and light sampling, NEE
set-up, splats, traversal) less the traversal calls' own device ms
(trace.ms_per_step, the same steps run again)."""
from h100_bench.kernels import is_copy


def read(run):
    if not run.trace or not run.traced_steps or run.trace_s is None:
        return None
    s = sum(sec for name, (sec, _) in run.trace["kernels"].items()
            if not is_copy(name)) - run.trace_s
    return 1e3 * s / run.traced_steps if s > 0 else None
