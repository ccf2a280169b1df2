"""bdpt.host_syncs_per_step: the port's host syncs a step inside the span
`bdpt.pass` (torch's sync debug mode, each sync from a frame of the port),
in the span pass's run of the traced steps on the card."""
from h100_bench import span_layers


def read(run):
    return span_layers.syncs_per_step(run, "bdpt.pass")
