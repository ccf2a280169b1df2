"""kernels.b3_roofline: kernel B3's share of its roofline over the traced
steps: the least time (roofline.bound_s) of what the traversal calls need
whatever implements them (roofline.traversal_need over the Probe pass's
calls and live rays, the count trace.traversal_roofline reads), over B3's
device time in the profiled steps (kernels.b3_ms_per_step)."""
import sys

from h100_bench import harness, roofline


def read(run):
    s = harness.metric_reader("kernels.b3_ms_per_step").seconds(run)
    if s is None or run.calls is None:
        return None
    b, ops = roofline.traversal_need(run.calls, run.live, run.recipe)
    t, by = roofline.bound_s(b, ops)
    print(f"kernels.b3_roofline: bound by {by} ({b:.0f} bytes, {ops:.0f} "
          f"operations, {t * 1e3:.6f} ms of {s * 1e3:.3f} ms)",
          file=sys.stderr)
    return 100.0 * t / s
