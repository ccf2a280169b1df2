"""entry.host_syncs_per_step: the port's host syncs a step, every site
(`host_syncs`: torch's sync debug mode, each sync from a frame of the
port), in the span pass's run of the traced steps on the card."""
from h100_bench import spans_pass


def read(run):
    got = spans_pass.result(run)
    if got is None or got.get("syncs") is None:
        return None
    return sum(got["syncs"].values()) / got["steps"]
