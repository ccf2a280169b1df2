"""msamples_per_s: sampling units of every step completed in the window,
over the window's whole time (its start to the end of its last step)."""


def read(run):
    if run.n_steps == 0 or run.window_s <= 0:
        return None
    return run.n_steps * run.units_per_step / run.window_s / 1e6
