"""device.idle_share: share of the traced window (host clock, first traced
step's start to the synchronize after the last) in which no operation ran
on the device."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - run.trace["busy_s"] / run.trace["window_s"])
