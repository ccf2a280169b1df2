"""The harness's machinery on the CPU: names resolve to files, the result
line's keys, the window arithmetic, the traced window's sums, the
roofline's bytes and the check for JAX by whole module names."""
import ast
import json
import os
import re
import sys

import numpy as np
import pytest

from h100_bench import harness, profile, roofline
from h100_bench.tests.conftest import small_run

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_name_resolves_to_its_files():
    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert harness.recipe_module(cfg).recipe
    for w in BENCH["workloads"]:
        tr = harness.traffic(w["traffic"])
        assert harness.entry_module(tr).Entry
        assert harness.limits(w["name"])
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(harness.metric_path(m["name"])), m["name"]
        assert callable(harness.metric_reader(m["name"]).read)


def test_names_and_units_keep_to_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert "traversal API" in layers and "device" in layers


def test_metrics_of_a_cell_follow_their_workloads():
    untraced = [m["name"] for m in harness.metrics_of(BENCH, "cornell.lt",
                                                      False)]
    traced = [m["name"] for m in harness.metrics_of(BENCH, "cornell.lt", True)]
    assert untraced == ["msamples_per_s", "step_ms_p90", "setup_s"]
    assert "trace.traversal_roofline" in traced
    assert harness.metrics_of(BENCH, "no.such_cell", True) == []


@pytest.fixture(scope="module")
def small_pt():
    return small_run("cornell.pt_offline")


def test_the_last_line_carries_the_result_keys(small_pt):
    line, tail = harness.result_line(small_pt)
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["metrics"]) == {"msamples_per_s", "step_ms_p90",
                                   "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert [t.split()[1] for t in tail] == ["pixel_mismatch_share",
                                            "pixel_rel_err_agreeing_max"]
    assert out["check"]["pixel_mismatch_share"]["limit"] > 0
    agree = out["check"]["pixel_rel_err_agreeing_max"]
    assert 0 <= agree["value"] <= agree["limit"]


def test_a_traced_run_counts_rays_outside_the_window(monkeypatch):
    """The traced steps run again after the window with the traversal
    calls wrapped; the profiled and the measured window call the port's
    own functions."""
    from hydracore_tpu_torch.integrators import pt

    real, seen = pt.closest_hit, []

    def spy(*a, **kw):
        seen.append(pt.closest_hit is spy)
        return real(*a, **kw)

    monkeypatch.setattr(pt, "closest_hit", spy)
    out = small_run("cornell.pt_offline", trace=True, seconds=0.0)
    run = out["run"]
    assert run.traced_steps == harness.TRACE_STEPS
    assert run.n_steps >= harness.TRACE_STEPS
    assert run.calls["closest"] == 5 * harness.TRACE_STEPS  # depth 5
    assert run.calls["any"] > 0 and run.live["closest"] > 0
    assert run.trace_s is None  # timed only on the card
    # the warm step and the window call the port unwrapped; only the
    # traced steps run again after the window go through the probe
    assert seen.count(True) == 5 * (run.n_steps + 1)
    assert seen.count(False) == 5 * harness.TRACE_STEPS
    assert out["metrics"]["trace.rays_per_step"]["value"] > 0


def test_pt_tiles_spread_over_the_frame_and_cover_it():
    from h100_bench.entries.pt_tile import Entry
    from h100_bench.scenes import common as C

    rec = C.Recipe(meshes=[], instances=[], materials=[], lights=[],
                   camera={}, width=1024, height=1024, depth=5)
    e = Entry(None, rec, harness.traffic("pt_offline"), 1, "cpu")
    assert e.n_tiles == 64 and e.units_per_step == 1 << 20
    first = [int(e.tile(i)[0][0]) // 1024 for i in range(e.stride)]
    assert first == [128 * k for k in range(8)]  # one tile an eighth
    rows = sorted(int(e.tile(i)[0][0]) for i in range(e.n_tiles))
    assert rows == [16384 * k for k in range(64)]
    assert e.tile(0)[1] == 0 and e.tile(64)[1] == 64


def _run(durations, units=100, window=None):
    r = harness.Run(durations=list(durations), units_per_step=units)
    r.window_s = sum(durations) if window is None else window
    return r


def test_rate_is_every_step_over_the_whole_window():
    read = harness.metric_reader("msamples_per_s").read
    r = _run([0.1] * 10, units=1_000_000, window=2.0)
    assert read(r) == pytest.approx(10 * 1e6 / 2.0 / 1e6)
    assert read(_run([])) is None


def test_p90_takes_every_step_and_a_stall_moves_it():
    read = harness.metric_reader("step_ms_p90").read
    steady = [0.1] * 20
    assert read(_run(steady)) == pytest.approx(100.0)
    stalled = steady[:17] + [0.5, 0.5, 0.5]
    assert read(_run(stalled)) == pytest.approx(
        np.percentile(np.asarray(stalled) * 1e3, 90))
    assert read(_run(stalled)) > 400.0


def _synthetic():
    ns = 1_000_000  # 1 ms
    events = [
        ("void two_level_kernel<false, false>(...)", 0, 4 * ns),
        ("elementwise_kernel<add>", 5 * ns, 2 * ns),
        ("elementwise_kernel<add>", 6 * ns, 2 * ns),  # overlaps by 1 ms
        ("Memset (Device)", 8 * ns, ns),
        ("void two_level_kernel<true, false>(...)", 12 * ns, 3 * ns),
    ]
    return profile.summarize(events, window_s=0.020)


def test_idle_share_and_kernel_sums_from_a_synthetic_profile():
    s = _synthetic()
    assert s["busy_s"] == pytest.approx(0.011)  # the union: 4 + 3 + 1 + 3 ms
    assert s["kernels"]["elementwise_kernel<add>"] == [pytest.approx(0.004), 2]
    assert sorted(round(g, 6) for _, g in s["gaps"]) == [0.001, 0.003]
    assert profile.top([("a", 1.0), ("b", 3.0), ("a", 2.5)]) == [
        ["a", 3.5], ["b", 3.0]]
    r = harness.Run(trace=s, traced_steps=2, trace_s=0.006)
    read = {n: harness.metric_reader(n).read for n in (
        "device.idle_share", "entry.launches_per_step",
        "wavefront.shade_ms_per_step", "trace.ms_per_step")}
    assert read["device.idle_share"](r) == pytest.approx(45.0)
    assert read["entry.launches_per_step"](r) == pytest.approx(2.0)
    # every kernel (4 + 2 + 2 + 3 ms) less the traversal calls' 6 ms
    assert read["wavefront.shade_ms_per_step"](r) == pytest.approx(2.5)
    assert read["trace.ms_per_step"](r) == pytest.approx(3.0)
    r.trace_s = None  # off the card: nothing to read
    assert read["trace.ms_per_step"](r) is None
    assert read["wavefront.shade_ms_per_step"](r) is None


def test_roofline_counts_rays_records_and_raw_triangles_once_a_call():
    cfg = harness.config("cornell")
    rec = harness.recipe_module(cfg).recipe(cfg)
    stored = sum(m.pos.shape[0] for m in rec.meshes)
    assert stored == cfg["triangles"]
    calls, live = {"closest": 5, "any": 4}, {"closest": 1000, "any": 600}
    b, ops = roofline.traversal_need(calls, live, rec)
    assert b == (1600 * 28 + 1000 * 16 + 600 * 1
                 + 9 * (stored * 36 + len(rec.instances) * 48))
    assert ops == 1600 * 51
    t, by = roofline.bound_s(b, ops)
    assert by == "bytes" and t == pytest.approx(b / 3.35e12)
    r = harness.Run(calls=calls, live=live, recipe=rec, traced_steps=1,
                    trace_s=2 * t)
    assert harness.metric_reader("trace.traversal_roofline").read(r) == \
        pytest.approx(50.0)


def test_the_cornell_box_is_the_published_one():
    """The page's quads as triangles in metres, normals into the box and
    out of the blocks, the light lowered 0.1 mm under the ceiling."""
    from h100_bench.scenes import common as C

    cfg = harness.config("cornell")
    rec = harness.recipe_module(cfg).recipe(cfg)
    f = C.flatten(rec)
    assert len(f.v0) == 32
    lo = np.minimum.reduce([f.v0, f.v1, f.v2]).min(0)
    hi = np.maximum.reduce([f.v0, f.v1, f.v2]).max(0)
    assert np.allclose(lo, [0, 0, 0]) and np.allclose(hi, [0.556, 0.5488,
                                                           0.5592])
    floor = f.n0[0]
    assert np.allclose(floor, [0, 1, 0])
    light = rec.lights[0]
    assert np.allclose(light["pos"], [0.278, 0.5487, 0.2795])
    assert light["area"] == pytest.approx(0.130 * 0.105)
    assert rec.camera["fov"] == pytest.approx(39.3077, abs=1e-4)
    assert set(cfg["reduced"]) == set(cfg["reduced_why"])


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert "hydracore_tpu" not in harness.forbidden_modules()
    for name, bad in (("hydracore_tpu_torch.fake", False), ("jaxtyping", False),
                      ("hydracore_tpu.fake", True), ("jaxlib.fake", True),
                      ("flax", True)):
        monkeypatch.setitem(sys.modules, name, object())
        assert (name.split(".")[0] in harness.forbidden_modules()) is bad
        monkeypatch.delitem(sys.modules, name)


def test_no_benchmark_file_imports_jax_or_reads_the_old_bench():
    banned = set(harness.FORBIDDEN)
    for base, _, files in os.walk(harness.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            src = open(path).read()
            for node in ast.walk(ast.parse(src)):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in banned, (path, n)
            for old in ("chip_smoke", "bench.py", "BENCH_r", "BASELINE.json"):
                assert old not in src or "tests" in base, (path, old)
