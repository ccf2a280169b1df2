"""The benchmark's machinery, driven by BENCHMARK.json: a cell names a
configuration (`configs/<name>.json`, recipe `scenes/<recipe>.py`) and a
traffic mix (`traffic/<name>.json`, entry `entries/<entry>.py`); each
metric is a reader `metrics/<name, dots as slashes>.py`; each cell's
limits are `limits/<cell>.json`. `run_cell` runs one cell once: set-up,
the measured window, the reference check, and the result line's fields.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field


HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hydracore_tpu")
TRACE_STEPS = 8  # the first window steps a traced run profiles


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE, "traffic", f"{name}.json")


def recipe_module(cfg: dict):
    return load_module(os.path.join(HERE, "scenes", f"{cfg['recipe']}.py"),
                       f"h100_bench.scenes.{cfg['recipe']}")


def entry_module(tr: dict):
    return load_module(os.path.join(HERE, "entries", f"{tr['entry']}.py"),
                       f"h100_bench.entries.{tr['entry']}")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", *name.split(".")) + ".py"


def metric_reader(name: str):
    return load_module(metric_path(name), "h100_bench_metric_" +
                       name.replace(".", "_").replace("-", "_"))


def limits(cell_name: str) -> dict:
    """{number: limit} of the cell's check."""
    spec = load_json(HERE, "limits", f"{cell_name}.json")
    return {k: v["limit"] for k, v in spec.items()}


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The metrics a run of the cell prints: end-to-end ones untraced,
    per-layer ones traced; a metric with `workloads` only in those."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result_line(out: dict) -> tuple[str, list]:
    """The result's JSON line, "check" its last key (each number compared
    with its limit), and the stderr lines that end a run."""
    line = {k: v for k, v in out.items() if k not in ("check", "run")}
    check = out["check"]
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in check.items()}
    tail = [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in check.items()]
    return json.dumps(line), tail


@dataclass
class Run:
    """What a run measured; the metric readers read it."""
    setup_s: float = 0.0
    compile_s: float = 0.0
    durations: list = field(default_factory=list)  # seconds a step
    window_s: float = 0.0
    units_per_step: int = 0
    trace: dict | None = None  # profile.summarize() of the traced steps
    traced_steps: int = 0
    calls: dict | None = None  # traversal calls by kind, traced steps
    live: dict | None = None  # live rays by kind, traced steps
    trace_s: float | None = None  # device s of those calls, each alone
    peak_window_bytes: int = 0
    recipe: object = None

    @property
    def n_steps(self) -> int:
        return len(self.durations)


class Probe:
    """Counts the calls and live rays of wrapped traversal functions
    (module, attribute, kind) and, on the card, times each call alone: a
    synchronize before it, CUDA events at its start and its end. It runs
    over the traced steps once more after the window, so nothing of it
    runs in the measured or the profiled window."""

    def __init__(self, targets, on_card: bool):
        self.targets, self.on_card = targets, on_card
        self.calls = {"closest": 0, "any": 0}
        self.live = {"closest": 0, "any": 0}
        self.spans = []

    def _wrap(self, fn, kind):
        import torch

        def call(scene, ray_o, ray_d, t_max=1e30, active=None, *a, **kw):
            self.calls[kind] += 1
            self.live[kind] += (ray_o.shape[0] if active is None
                                else int(active.sum()))
            if not self.on_card:
                return fn(scene, ray_o, ray_d, t_max, active, *a, **kw)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(scene, ray_o, ray_d, t_max, active, *a, **kw)
            ev[1].record()
            self.spans.append(ev)
            return out
        return call

    def __enter__(self):
        self.saved = [getattr(m, a) for m, a, _ in self.targets]
        for (m, a, kind), fn in zip(self.targets, self.saved):
            setattr(m, a, self._wrap(fn, kind))
        return self

    def __exit__(self, *exc):
        for (m, a, _), fn in zip(self.targets, self.saved):
            setattr(m, a, fn)

    def seconds(self):
        """Device seconds of the timed calls (None off the card); call
        after a synchronize."""
        if not self.on_card:
            return None
        return sum(a.elapsed_time(b) for a, b in self.spans) / 1e3


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: dict | None = None,
             control=None, min_steps: int = 1,
             marks: list | None = None) -> dict:
    """One run of a cell: returns the result line's fields, "check"
    (number -> (value, limit)) last. `overrides` replace keys of the
    configuration ("config") and traffic ("traffic") for small runs;
    `control` (a dtype) puts the reference in that precision in the
    port's place; the window runs at least `min_steps` steps; `marks`
    [(part, host clock at its end)] of the set-up before this call."""
    import torch

    from h100_bench import compare, profile
    from h100_bench.scenes.common import flatten

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    bench = benchmark()
    wl = cell(bench, cell_name)
    cfg = {**config(wl["config"]), **(overrides or {}).get("config", {})}
    tr = {**traffic(wl["traffic"]), **(overrides or {}).get("traffic", {})}
    rmod, emod = recipe_module(cfg), entry_module(tr)
    lim = limits(cell_name)

    run = Run()
    marks = list(marks or []) + [("imports", time.perf_counter())]
    starts = []
    if on_card:  # the kernels' libraries build while the host assembles
        from hydracore_tpu_torch.utils import build
        for src in ("traverse_cluster.cu", "bvh_builder.cpp"):
            starts.append((src, build.start_build(src)))
    rec = rmod.recipe(cfg)
    run.recipe = rec
    marks.append(("recipe", time.perf_counter()))
    scene = rmod.to_port(rec)
    marks.append(("assembly", time.perf_counter()))
    run.compile_s = marks[-1][1] - marks[-2][1]
    for src, st in starts:
        build.finish_build(src, st)
    marks.append(("builds", time.perf_counter()))
    scene = scene.to(device)
    entry = emod.Entry(scene, rec, tr, seed, device)
    run.units_per_step = entry.units_per_step
    sync()
    marks.append(("upload", time.perf_counter()))
    entry.warm()
    sync()
    marks.append(("warm step", time.perf_counter()))
    peak_setup = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_start
    prev = t_start
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    print("setup: " + ", ".join(parts), file=sys.stderr)

    n_traced = TRACE_STEPS if trace else 0
    win = None
    w0 = time.perf_counter()
    i = 0
    while True:
        if i == 0 and n_traced and on_card:
            win = profile.Window()
            win.start()
        s0 = time.perf_counter()
        out = entry.step(i)
        sync()
        s1 = time.perf_counter()
        entry.record(i, out)
        run.durations.append(s1 - s0)
        if win and i == n_traced - 1:
            run.trace = win.stop()
        i += 1
        if s1 - w0 >= seconds and i >= max(n_traced, min_steps):
            break
    run.window_s = s1 - w0
    if on_card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    peak = max(peak_setup, run.peak_window_bytes)
    if n_traced:  # the traced steps again, their traversal calls counted
        with Probe(entry.trace_targets(), on_card) as probe:
            for k in range(n_traced):
                entry.step(k)
            sync()
        run.calls, run.live = dict(probe.calls), dict(probe.live)
        run.traced_steps = n_traced
        run.trace_s = probe.seconds()

    values = {}
    for m in metrics_of(bench, cell_name, trace):
        v = metric_reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": run.n_steps, "failed": 0,
           "metrics": values, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {
            "device_ops": profile.top(
                (k, v[0]) for k, v in run.trace["kernels"].items()),
            "idle_gaps": profile.top(
                ("after " + profile.short(k), s)
                for k, s in run.trace["gaps"])}

    # the port's state goes before the reference runs
    entry.release()
    del scene
    if on_card:
        torch.cuda.empty_cache()
    got = entry.check(flatten(rec), run.n_steps, seed, lim[compare.AGREE],
                      control=control)
    print("check info: " + ", ".join(f"{k} {v!r}" for k, v in got.items()
                                     if k not in lim), file=sys.stderr)
    check = {k: (float(got[k]), float(lim[k])) for k in lim}
    out["correct"] = all(v <= limit for v, limit in check.values())
    out["check"] = check
    out["run"] = run
    return out
