"""step_ms_p90: the 90th percentile of the host-clock time of every step
completed in the window, each from its start to a synchronize after it."""
import numpy as np


def read(run):
    if run.n_steps == 0:
        return None
    return float(np.percentile(np.asarray(run.durations) * 1e3, 90))
