"""trace.ms_per_step: device ms a traced step of the calls into the
traversal API (closest and any hit, whatever route the scene takes: the
dense tensor test or the cluster kernels), each call timed alone by CUDA
events when the traced steps run again after the window."""


def read(run):
    if run.trace_s is None or not run.traced_steps or run.trace_s <= 0:
        return None
    return 1e3 * run.trace_s / run.traced_steps
