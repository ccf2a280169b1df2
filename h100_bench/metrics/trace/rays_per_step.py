"""trace.rays_per_step: live rays handed to the traversal API a traced
step (closest-hit and any-hit calls), counted by wrapping the entry's
traversal calls when the traced steps run again after the window;
millions."""


def read(run):
    if run.live is None or not run.traced_steps:
        return None
    n = run.live["closest"] + run.live["any"]
    return n / run.traced_steps / 1e6 if n else None
