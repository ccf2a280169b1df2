"""The span pass (spans_pass.py) on the CPU: the port's live-ray counter
against the Probe's count over the same steps and seed, the new readers'
None where the pass cannot run, and the other readers' inputs all set
before the pass starts."""
import dataclasses

import pytest
import torch

from h100_bench import harness, spans_pass
from h100_bench.tests.conftest import SEED, SMALL, small_run

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = ["scene.build_s", "trace.live_rays_per_step", "trace.span_ms_per_step",
       "trace.idle_ms_per_step", "wavefront.span_ms_per_step",
       "wavefront.idle_ms_per_step", "entry.idle_ms_per_step",
       "entry.host_syncs_per_step"]


def _small_entry(cell: str):
    """The cell's recipe module, recipe and entry at the tests' small size,
    set up and warmed as run_cell does."""
    wl = harness.cell(BENCH, cell)
    cfg = {**harness.config(wl["config"]), **SMALL["config"]}
    tr = {**harness.traffic(wl["traffic"]), **SMALL["traffic"]}
    rmod, emod = harness.recipe_module(cfg), harness.entry_module(tr)
    rec = rmod.recipe(cfg)
    dev = torch.device("cpu")
    entry = emod.Entry(rmod.to_port(rec), rec, tr, SEED, dev)
    entry.warm()
    return rmod, rec, entry, dev


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_counts_the_live_rays_the_probe_counts(cell):
    from hydracore_tpu_torch.utils import spans

    rmod, rec, entry, dev = _small_entry(cell)
    n = harness.TRACE_STEPS
    with harness.Probe(entry.trace_targets(), False) as probe:
        for k in range(n):
            entry.step(k)
    got = spans_pass.measure(spans, entry, rmod, rec, dev, n)
    run = harness.Run(live=dict(probe.live), traced_steps=n)
    run.spans_pass = got
    want = harness.metric_reader("trace.rays_per_step").read(run)
    assert harness.metric_reader("trace.live_rays_per_step").read(run) == want
    assert got["live_rays"] == sum(probe.live.values()) > 0
    assert got["build_s"] > 0 and got["syncs"] == {}
    assert "layers" not in got  # no device off the card


def test_the_new_readers_read_none_without_the_span_pass():
    for name in NEW:
        read = harness.metric_reader(name).read
        assert read(harness.Run(traced_steps=8)) is None, name
        run = harness.Run(traced_steps=8)
        run.spans_pass = None
        assert read(run) is None, name


@pytest.mark.parametrize("cell", CELLS)
def test_the_span_pass_starts_after_every_other_reader_input(monkeypatch,
                                                             cell):
    fields = [f.name for f in dataclasses.fields(harness.Run)]
    seen = []
    real = spans_pass.result

    def spy(run):
        if not hasattr(run, "spans_pass"):
            seen.append({k: getattr(run, k) for k in fields})
            seen[-1]["durations"] = list(run.durations)
        return real(run)

    monkeypatch.setattr(spans_pass, "result", spy)
    out = small_run(cell, trace=True, seconds=0.0)
    run = out["run"]
    assert len(seen) == 1
    assert seen[0]["calls"] is not None and seen[0]["live"] is not None
    for k in fields:
        assert seen[0][k] == getattr(run, k), k
    # off the card the pass only assembles the recipe again
    assert out["metrics"]["scene.build_s"]["value"] > 0
    assert set(NEW) & set(out["metrics"]) == {"scene.build_s"}


def test_layers_of_span_paths():
    want = {"pt.tile/pt.bounce/pt.nee/trace.any": "trace",
            "lt.pass/lt.bounce/trace.closest": "trace",
            "trace.closest": "trace",
            "pt.tile/pt.bounce/pt.shade": "wavefront",
            "lt.pass/lt.bounce": "wavefront",
            "pt.tile/pt.eye_rays": "entry", "pt.tile/pt.resolve": "entry",
            "lt.pass/lt.emit": "entry", "lt.pass": "entry",
            "outside": "outside", "scene.build": "outside"}
    assert {p: spans_pass.layer_of(p) for p in want} == want


def test_the_pass_reports_idle_by_span_and_syncs_by_site(capsys):
    out = {"steps": 2, "busy_s": 0.5, "window_s": 1.0, "unlinked": 0,
           "syncs": {("hydracore_tpu_torch/ops/rng.py:27", "pt.tile"): 4},
           "table": {"pt.tile": {"device_s": 3e-9, "idle_s": 2e-9,
                                 "ops": 1},
                     "pt.tile/pt.bounce/trace.closest": {
                         "device_s": 5e-9, "idle_s": 7e-9, "ops": 2}}}
    out["layers"] = {k: {"device_s": 0.0, "idle_s": 0.0, "ops": 0}
                     for k in spans_pass.LAYERS}
    spans_pass.report(out)
    err = capsys.readouterr().err.splitlines()
    assert err[0] == ('breakdown.idle_by_span: [["pt.tile/pt.bounce/'
                      'trace.closest", 7e-09], ["pt.tile", 2e-09]]')
    assert err[1] == ('breakdown.syncs_by_site: [["hydracore_tpu_torch/ops/'
                      'rng.py:27 pt.tile", 4]]')
