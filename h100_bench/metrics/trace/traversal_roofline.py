"""trace.traversal_roofline: the traversal calls' share of their roofline
over the traced steps: the least time (roofline.bound_s) of what any
implementation must touch (each call's live rays in, their hit records
out, the description's raw triangles and instance matrices once a call,
one ray-triangle test a live ray), over the calls' device time
(trace.ms_per_step)."""
import sys

from h100_bench import roofline


def read(run):
    if run.trace_s is None or run.trace_s <= 0 or run.calls is None:
        return None
    b, ops = roofline.traversal_need(run.calls, run.live, run.recipe)
    t, by = roofline.bound_s(b, ops)
    print(f"trace.traversal_roofline: bound by {by} ({b:.0f} bytes, "
          f"{ops:.0f} operations, {t * 1e3:.6f} ms of "
          f"{run.trace_s * 1e3:.3f} ms)", file=sys.stderr)
    return 100.0 * t / run.trace_s
