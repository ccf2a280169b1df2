"""The benchmark's sphereflake configuration (h100_bench/configs/
sphereflake.json, recipe h100_bench/scenes/sphereflake.py) on the CPU:
balls.c's geometry at size factors 0-4, its instances, the port's own
choice of the instanced layout and kernel B3 for it, the port's IBPT pass
against the benchmark's plain reference (h100_bench/reference/ibpt.py) at
16x16 under the cell's limits, and the reference's grouped caster against
its run-by-run one."""
import copy
import math

import numpy as np
import pytest
import torch

from h100_bench import compare, harness
from h100_bench.reference import ibpt as ref
from h100_bench.reference.grouped import GroupedCaster
from h100_bench.reference.trace import Caster
from h100_bench.scenes import common as C
from h100_bench.scenes import sphereflake as SF
from hydracore_tpu_torch.integrators import bdpt
from hydracore_tpu_torch.ops import trace_api, traverse_cluster
from hydracore_tpu_torch.scene.scene import load_scene

CPU = torch.device("cpu")
SEED = 2**31 + 9


def _cfg(size_factor: int, **kw) -> dict:
    cfg = copy.deepcopy(harness.config("sphereflake"))
    cfg.update(size_factor=size_factor, **kw)
    return cfg


@pytest.mark.parametrize("size_factor,count",
                         [(0, 1), (1, 10), (2, 91), (3, 820), (4, 7381)])
def test_size_factors_give_the_published_sphere_counts(size_factor, count):
    c, r, parent = SF.spheres(_cfg(size_factor))
    assert c.shape == (count, 3) and r.shape == parent.shape == (count,)
    if size_factor == 4:
        assert count == harness.config("sphereflake")["spheres"]["count"]


def test_children_touch_their_parents_at_a_third_of_the_radius():
    cfg = _cfg(4)
    c, r, parent = SF.spheres(cfg)
    kid = parent >= 0
    p = parent[kid]
    assert np.allclose(r[kid], r[p] / 3.0, rtol=1e-12)
    gap = np.linalg.norm(c[kid] - c[p], axis=1)
    assert np.allclose(gap, r[p] + r[kid], rtol=1e-12)
    assert np.bincount(p).max() == 9
    dirs = np.asarray(cfg["assumed"]["child_directions"]["values"])
    assert np.allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-12)
    elev = np.degrees(np.arcsin(dirs[:, 2]))
    assert np.allclose(np.sort(elev)[6:], math.degrees(math.asin(
        1 / math.sqrt(3))), atol=1e-6)  # three above the equator, 35.26
    assert np.allclose(np.sort(elev)[:6], -16.78, atol=0.01)
    assert (c[:, 2] - r).min() == pytest.approx(-0.5, abs=1e-12)
    assert (np.linalg.norm(c, axis=1) + r).max() == pytest.approx(0.9113,
                                                                  abs=5e-5)


def test_instances_are_a_uniform_scale_and_a_translation():
    rec = SF.recipe(_cfg(1))
    c, r, _ = SF.spheres(_cfg(1))
    flat = C.flatten(rec)
    ball = rec.meshes[SF.SPHERE]
    assert ball.pos.shape == (960, 3, 3)
    spheres = [(i, m) for i, (mesh, m, _) in enumerate(rec.instances)
               if mesh == SF.SPHERE]
    assert len(spheres) == 10
    for (i, m), ci, ri in zip(spheres, c, r):
        assert np.array_equal(m[:3, :3], np.float32(ri) * np.eye(
            3, dtype=np.float32))
        assert np.array_equal(m[3], [0, 0, 0, 1])
        assert np.allclose(m[:3, 3], ci, atol=1e-7)
        mine = flat.object_of == i
        for j, v in enumerate((flat.v0, flat.v1, flat.v2)):
            want = ball.pos[:, j] @ m[:3, :3].T + m[:3, 3]
            assert np.array_equal(v[mine], want.astype(np.float32))


def test_the_port_picks_the_instanced_layout_and_b3_by_itself():
    rec = SF.recipe(_cfg(3, width=16, height=16))
    assert sum(rec.meshes[m].pos.shape[0] for m, _, _ in rec.instances) \
        == 787_200 + 4
    scene = SF.to_port(rec)  # instancing and traversal "auto"
    assert scene.cl_map is not None and scene.settings.has_inst
    assert scene.traversal == "auto"
    assert trace_api._pick(scene) is traverse_cluster
    assert scene.inst_woop.shape[0] == 821  # the spheres and instance 0


def test_every_traversal_call_of_a_pass_takes_the_cluster_route():
    from hydracore_tpu_torch.utils import spans

    scene = SF.to_port(SF.recipe(_cfg(3, width=8, height=8, trace_depth=3)))
    with spans.recording():
        bdpt.bdpt_pass(scene, 0, SEED, 3, "3way", device="cpu")
    got = spans.take()
    routes = [s.attrs["route"] for s in got.spans
              if s.name.startswith("trace.")]
    assert len(routes) == 3 + 2 + 2 + 2 and set(routes) == {"cluster"}


def test_the_port_ibpt_pass_agrees_with_the_reference(tmp_path):
    rec = SF.recipe(_cfg(2, width=16, height=16, trace_depth=3))
    port = load_scene(SF.write_library(rec, str(tmp_path)),
                      instancing="force")
    assert port.cl_map is not None
    S = ref.Scene(C.flatten(rec), CPU)
    lim = harness.limits("sphereflake.ibpt")
    errs = []
    for p in (0, 7):
        got = bdpt.bdpt_pass(port, p, SEED, 3, "3way", device="cpu")
        want = ref.ibpt_pass(S, p, SEED, 3)
        assert want.sum() > 0
        errs.append(compare.errors(got, want, lit_only=True))
    assert sum(e.numel() for e in errs) > 400
    got = compare.judge(errs, lim[compare.AGREE])
    assert got[compare.SHARE] <= lim[compare.SHARE], got


def test_the_grouped_caster_equals_the_run_by_run_caster():
    flat = C.flatten(SF.recipe(_cfg(2)))
    a, b = Caster(flat, CPU), GroupedCaster(flat, CPU)
    g = torch.Generator().manual_seed(5)
    R = 3000
    o = torch.tensor([2.1, 1.3, 1.7]) + 0.3 * torch.randn(R, 3, generator=g)
    d = 0.5 * torch.randn(R, 3, generator=g) - o
    d = d / d.norm(dim=1, keepdim=True)
    act = torch.rand(R, generator=g) > 0.1
    want, got = a.closest(o, d, act), b.closest(o, d, act)
    assert int((want[1] >= 0).sum()) > R // 2
    for x, y in zip(want, got):
        assert torch.equal(x, y)
    for t_max in (torch.where(want[1] >= 0, 0.999 * want[0], 5.0),
                  torch.full((R,), 3.0)):
        occ = a.occluded(o, d, t_max, act)
        assert torch.equal(occ, b.occluded(o, d, t_max, act))
    assert int(occ.sum()) > 100


def test_the_card_tests_flake_is_the_recipes():
    """tests/sphereflake_case.py, which the card tests build the flake
    from without the benchmark's code, holds the recipe's spheres, and the
    port lays it out instanced on kernel B3 by its own rules."""
    from sphereflake_case import config, sphereflake_scene, spheres

    c, r = spheres(config())
    want_c, want_r, _ = SF.spheres(_cfg(4))
    assert np.allclose(c, want_c, rtol=0.0, atol=1e-12)
    assert np.array_equal(r, want_r)
    scene = sphereflake_scene(3)
    assert scene.cl_map is not None and scene.settings.has_inst
    assert trace_api._pick(scene) is traverse_cluster
    assert scene.inst_woop.shape[0] == 821  # the spheres and the floor
