"""The span pass's attribution table (spans_pass.py) read by span names,
for the layers whose spans spans_pass.LAYERS does not name: a reader
picks the span paths it counts with a rule of its own."""
from __future__ import annotations

from h100_bench import spans_pass


def names(path: str) -> list:
    return path.split("/")


def in_bdpt(path: str) -> bool:
    """Inside a `bdpt.*` span (bdpt.pass and its phases) and in no
    `trace.*` span."""
    n = names(path)
    return (any(x.startswith("bdpt.") for x in n)
            and not any(x.startswith("trace.") for x in n))


def ms_per_step(run, keep, what: str) -> float | None:
    """Device or idle ms a step of the span paths `keep(path)` picks, None
    off the card, where the pass cannot run, or where no such span ran."""
    got = spans_pass.result(run)
    if got is None or "table" not in got:
        return None
    rows = [r for p, r in got["table"].items() if keep(p)]
    if not rows:
        return None
    return 1e3 * sum(r[what] for r in rows) / got["steps"]


def syncs_per_step(run, root: str) -> float | None:
    """Host syncs a step whose span path starts at the root span `root`;
    None off the card, or where no such span ran."""
    got = spans_pass.result(run)
    if got is None or "table" not in got or got.get("syncs") is None:
        return None
    if not any(names(p)[0] == root for p in got["table"]):
        return None
    n = sum(c for (_, p), c in got["syncs"].items() if names(p)[0] == root)
    return n / got["steps"]
