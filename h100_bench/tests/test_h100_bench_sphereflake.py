"""The cell sphereflake.ibpt on the CPU at a size a test run holds (size
factor 3: 820 instances, 787,200 flattened triangles, which the port
still lays out instanced; 16x16, depth 3): a sound run is correct, and
`correct` comes out false for the bfloat16 control and for four faults
planted underneath the timed path (an instance left out, one instance
scaled wrong, the t = 1 splats dropped, the traversal losing a ray in
64). The geometry part's numbers count mismatched rays and tiles, and the
new per-layer metrics read None off the card."""
import time

import pytest
import torch

from h100_bench import harness
from h100_bench.tests.conftest import SEED

CELL = "sphereflake.ibpt"
SMALL = {"config": {"width": 16, "height": 16, "size_factor": 3,
                    "trace_depth": 3},
         "traffic": {"max_depth": 3,
                     "check": {"passes": 2, "early": 3}}}
NEW = ("kernels.b3_ms_per_step", "kernels.b3_roofline",
       "bdpt.span_ms_per_step", "bdpt.idle_ms_per_step",
       "bdpt.host_syncs_per_step")
# the accepted metrics whose layers the cell runs (a BDPT pass has no
# pt.*/lt.* root or bounce, so the span pass's wavefront and entry layers
# read nothing there)
ACCEPTED = ("scene.compile_s", "entry.launches_per_step",
            "wavefront.shade_ms_per_step", "trace.rays_per_step",
            "trace.ms_per_step", "trace.traversal_roofline",
            "device.idle_share", "device.peak_mem_gib", "scene.build_s",
            "trace.live_rays_per_step", "trace.span_ms_per_step",
            "trace.idle_ms_per_step", "entry.host_syncs_per_step")


def _run(trace=False, control=None, min_steps=3):
    return harness.run_cell(CELL, SEED, 0.0, trace, torch.device("cpu"),
                            time.perf_counter(), overrides=SMALL,
                            control=control, min_steps=min_steps)


def test_a_sound_run_is_correct_and_instanced(monkeypatch):
    from hydracore_tpu_torch.integrators import bdpt

    seen = []
    real = bdpt.bdpt_pass

    def spy(scene, *a, **kw):
        seen.append(scene.cl_map is not None)
        return real(scene, *a, **kw)

    monkeypatch.setattr(bdpt, "bdpt_pass", spy)
    out = _run()
    assert out["correct"], out["check"]
    assert seen and all(seen)
    assert set(out["check"]) == {
        "pixel_mismatch_share", "pixel_rel_err_agreeing_max",
        "primary_hit_mismatch_share", "primary_hit_tile_mismatch_max"}


def test_control_in_bfloat16_is_not_correct():
    out = _run(control=torch.bfloat16)
    assert not out["correct"], out["check"]


def _edit_desc(monkeypatch, edit):
    """Plants a fault in the description the port reads."""
    from hydracore_tpu_torch.scene import scene as sc

    real = sc.load_statefile

    def load(*a, **kw):
        desc = real(*a, **kw)
        edit(desc)
        return desc

    monkeypatch.setattr(sc, "load_statefile", load)


def _missing_instance(monkeypatch):
    # the root sphere, which most camera rays see
    _edit_desc(monkeypatch, lambda d: d.instances.pop(0))


def _scaled_wrong(monkeypatch):
    def edit(desc):
        desc.instances[0].matrix[:3, :3] *= 0.9

    _edit_desc(monkeypatch, edit)


def _no_t1_splats(monkeypatch):
    from hydracore_tpu_torch.integrators import bdpt

    real = bdpt._bdpt_core

    def core(*a, **kw):
        return [x for x in real(*a, **kw) if x[0][1] != 1]

    monkeypatch.setattr(bdpt, "_bdpt_core", core)


def _traversal_loses_rays(monkeypatch):
    from hydracore_tpu_torch.ops import traverse_cluster

    real = traverse_cluster.closest_hit

    def lossy(scene, o, d, *a, **kw):
        t, tri, u, v = real(scene, o, d, *a, **kw)
        lost = torch.arange(t.shape[0]) % 64 == 5
        return (torch.where(lost, float("inf"), t), torch.where(lost, -1, tri),
                u, v)

    monkeypatch.setattr(traverse_cluster, "closest_hit", lossy)


@pytest.mark.parametrize("fault", [_missing_instance, _scaled_wrong,
                                   _no_t1_splats, _traversal_loses_rays],
                         ids=["instance_missing", "instance_scaled_wrong",
                              "t1_splats_dropped", "traversal_loses_rays"])
def test_each_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = _run()
    assert out["attempted"] >= 3
    assert not out["correct"], out["check"]


def test_the_new_metrics_read_none_off_the_card():
    out = _run(trace=True, min_steps=8)
    assert out["correct"], out["check"]
    assert not set(NEW) & set(out["metrics"])
    run = out["run"]
    for name in NEW:
        assert harness.metric_reader(name).read(run) is None
    metrics = [m["name"] for m in harness.metrics_of(harness.benchmark(),
                                                      CELL, True)]
    assert metrics[-len(NEW):] == list(NEW)
    assert set(metrics) - set(NEW) == set(ACCEPTED)


def test_the_geometry_numbers_count_mismatched_rays_and_tiles():
    from h100_bench.entries import ibpt_pass as E

    want = torch.full((4 * E.TILE,), 2.0)
    want[:E.TILE] = float("inf")  # the first tile: misses on both sides
    got = want.clone()
    got[E.TILE + 3] *= 1.0 + 0.5 * E.T_TOL  # agrees
    got[2 * E.TILE:2 * E.TILE + 5] *= 1.0 + 2.0 * E.T_TOL  # moved
    got[3 * E.TILE + 1] = float("inf")  # lost
    got[3 * E.TILE + 2] = 5.0  # behind
    out = E.hit_numbers(got, want)
    assert out[E.HIT_SHARE] == 7 / (4 * E.TILE)
    assert out[E.HIT_TILE] == 5.0
    assert 0.0 < out[E.HIT_AGREE] <= E.T_TOL
    same = E.hit_numbers(want, want)
    assert same[E.HIT_SHARE] == same[E.HIT_TILE] == same[E.HIT_AGREE] == 0.0


def test_a_difference_at_the_tolerance_in_float32_is_a_mismatch():
    from h100_bench import compare
    from h100_bench.entries import ibpt_pass as E

    tol = harness.limits(CELL)[compare.AGREE]
    errs = [torch.tensor([0.5 * tol, tol, 2.0 * tol], dtype=torch.float32)]
    got = E.image_numbers(errs, tol)
    assert got[compare.SHARE] == 2 / 3
    assert got[compare.AGREE] == float(errs[0][0]) <= tol
