"""The span pass of a traced run: the port's own spans and counters
(hydracore_tpu_torch/utils/spans.py), recorded after the Probe pass, so
that nothing an earlier metric reads changes.

It assembles the recipe once more while recording (host only:
`scene.build`); on the card it then runs the traced steps again, each to a
synchronize as in the window, while recording and under profile.Window
(device activity only). spans.attribute puts every device operation on the
span open at its launch and every idle gap on the spans open during it;
each span path falls in one layer (layer_of). Off the card the steps do not
run again: they would time nothing of the device, and their live rays are
the Probe pass's.

The harness hands a metric reader the Run alone; the pass takes the cell's
entry, recipe and device from harness.run_cell's frame, the reader's
caller, runs once a run and keeps its result on the Run (`spans_pass`).
Where the port has no spans module, or no run_cell is calling, every
reader of the pass reads None.
"""
from __future__ import annotations

import json
import sys

from h100_bench import profile

LAYERS = ("trace", "wavefront", "entry", "outside")
ROOTS = ("pt.tile", "lt.pass")
BOUNCES = ("pt.bounce", "lt.bounce")


def layer_of(path: str) -> str:
    """The layer of a span path: `trace` under a trace.* span, `wavefront`
    under a bounce (and its phases), `entry` in the rest of a step's root,
    else `outside`."""
    names = path.split("/")
    if any(n.startswith("trace.") for n in names):
        return "trace"
    if any(n in BOUNCES for n in names):
        return "wavefront"
    if names[0] in ROOTS:
        return "entry"
    return "outside"


def _spans():
    try:
        from hydracore_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def _cell_locals() -> dict | None:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and "entry" in f.f_locals:
            return f.f_locals
        f = f.f_back
    return None


def result(run) -> dict | None:
    """The span pass of `run`, run at the first call; None where it cannot
    run."""
    if not hasattr(run, "spans_pass"):
        spans, cell = _spans(), _cell_locals()
        got = None
        if spans is not None and cell is not None and run.traced_steps:
            device = cell["device"]
            got = measure(spans, cell["entry"], cell["rmod"], cell["rec"],
                          device,
                          run.traced_steps if device.type == "cuda" else 0)
        run.spans_pass = got
    return run.spans_pass


def measure(spans, entry, rmod, rec, device, steps: int) -> dict:
    """The pass itself over the first `steps` steps: {"steps", "build_s";
    with steps, "live_rays" and "syncs" {(site, span path): n}; on the card
    also "table" (spans.attribute), "layers" {layer: {"device_s", "idle_s",
    "ops"}}, "busy_s", "window_s", "unlinked"}."""
    import torch

    with spans.recording():
        rmod.to_port(rec)
    builds = [s for s in spans.take().spans if s.name == "scene.build"]
    out = {"steps": steps,
           "build_s": sum(s.end - s.start for s in builds) / 1e9 if builds
           else None}
    if not steps:
        return out
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    win = profile.Window() if on_card else None
    with spans.recording():
        if win:
            win.start()
        for k in range(steps):
            entry.step(k)
            sync()
        summary = win.stop() if win else None
    got = spans.take()
    out.update(live_rays=got.counters.get("trace.live_rays"),
               syncs=got.syncs)
    if not win:
        return out
    ops, launches = spans.device_events(win.prof)
    table = spans.attribute(got.spans, ops, launches)
    layers = {k: {"device_s": 0.0, "idle_s": 0.0, "ops": 0} for k in LAYERS}
    for path, row in table.items():
        for k, v in row.items():
            layers[layer_of(path)][k] += v
    out.update(table=table, layers=layers, busy_s=summary["busy_s"],
               window_s=summary["window_s"],
               unlinked=sum(1 for *_, c in ops if c not in launches))
    report(out)
    return out


def report(out: dict) -> None:
    """The pass's tables on standard error: idle by span path, host syncs
    by site, and each layer's device time and idle a step."""
    n = out["steps"]
    idle = sorted(((p, r["idle_s"]) for p, r in out["table"].items()),
                  key=lambda kv: -kv[1])[:10]
    syncs = sorted(((f"{site} {path}", c) for (site, path), c
                    in out["syncs"].items()), key=lambda kv: -kv[1])
    err = sys.stderr
    print("breakdown.idle_by_span: " + json.dumps([list(x) for x in idle]),
          file=err)
    print("breakdown.syncs_by_site: " + json.dumps([list(x) for x in syncs]),
          file=err)
    total = sum(r["device_s"] for r in out["layers"].values())
    idle_all = sum(r["idle_s"] for r in out["layers"].values())
    for k, r in out["layers"].items():
        print(f"spans pass: {k} device {1e3 * r['device_s'] / n:.3f} ms a "
              f"step ({100 * r['device_s'] / max(total, 1e-12):.3f}%), "
              f"idle {1e3 * r['idle_s'] / n:.3f} ms a step "
              f"({100 * r['idle_s'] / max(idle_all, 1e-12):.2f}% of idle), "
              f"{r['ops'] / n:.1f} operations a step", file=err)
    print(f"spans pass: busy {out['busy_s']:.4f} s of {out['window_s']:.4f} s"
          f" (idle share {100 * (1 - out['busy_s'] / out['window_s']):.2f}%),"
          f" {out['unlinked']} operations with no launch recorded", file=err)


def ms_per_step(run, layer: str, what: str) -> float | None:
    """A layer's device or idle ms a step from the pass (None off the
    card, or where the pass cannot run)."""
    got = result(run)
    if got is None or "layers" not in got:
        return None
    return 1e3 * got["layers"][layer][what] / got["steps"]
