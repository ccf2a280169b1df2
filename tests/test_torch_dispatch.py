"""The port's traversal dispatcher (ops/trace_api.py) and the path tracer's
two wavefront modes over it.

`scene.traversal` is the static choice: "auto" follows the JAX package's
_pick as far as it carries over (instanced -> cluster; at most
2 * DENSE_MAX_TRIS triangle slots -> dense; otherwise cluster), and each of
"dense", "cluster", "packet", "wide" is honoured when named. "packet" and
"wide" keep the cluster pool flat. Only the cluster route wants sorted
rays; with any other the path tracer leaves the live state in caller order.

One small scene is rendered through pt.render by all four routes at 64x64,
2 spp, seed 777: >= 99% of pixels within 1e-3 of each other and of the JAX
render (the tolerance of tests/test_torch_pt.py: the sample set is the
same, a rare ulp-level difference can flip a discrete choice of one path),
and the ray counters within 0.1%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import trace_api as jtrace
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import (trace_api, traverse_cluster,
                                     traverse_dense, traverse_packet,
                                     traverse_wide)
from hydracore_tpu_torch.scene import scene as pscene
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from tests.test_torch_assemble import PORT, make_desc
from tests.test_torch_scene import build_with, rects_recipe, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

ROUTES = {"dense": traverse_dense, "cluster": traverse_cluster,
          "packet": traverse_packet, "wide": traverse_wide}
SEED = 777


@pytest.mark.parametrize("name", sorted(gs.SCENES))
def test_auto_follows_the_jax_size_rule(name):
    """Dense up to 2 * DENSE_MAX_TRIS triangle slots (the two box-only
    recipes, 32 slots), the cluster kernels above (the three recipes with a
    960-triangle sphere pad to over 2,200 slots): the JAX package's own
    _use_dense on the same scene."""
    js = build_with(JaxBuilder, gs.SCENES[name])
    ps = build_with(PortBuilder, gs.SCENES[name])
    assert ps.traversal == "auto"
    dense = bool(jtrace._use_dense(js))
    assert dense == (name in ("cornell_diffuse", "ggx_rough"))
    assert trace_api._pick(ps) is (traverse_dense if dense else traverse_cluster)
    assert trace_api.wants_sorted_rays(ps) == (not dense)
    assert traverse_dense.DENSE_MAX_TRIS == 512


def test_auto_picks_cluster_over_the_dense_limit_and_for_instances():
    ps = build_with(PortBuilder, rects_recipe)
    assert ps.wbvh_tri9f.shape[0] * 8 > 2 * traverse_dense.DENSE_MAX_TRIS
    assert trace_api._pick(ps) is traverse_cluster
    inst = pscene.assemble(make_desc(PORT, False), instancing="force")
    assert inst.settings.has_inst
    # a handful of triangles, yet not dense: only the cluster kernels
    # understand the instanced layout, and its single-level pools are dummies
    assert inst.wbvh_tri9f.shape[0] == 1 and inst.pkt_nodes.shape == (8, 128)
    assert trace_api._pick(inst) is traverse_cluster
    flat = pscene.assemble(make_desc(PORT, False), instancing="off")
    assert trace_api._pick(flat) is traverse_dense


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forced_choice_is_honoured(route):
    ps = _rects(traversal=route)
    assert ps.traversal == route
    assert trace_api._pick(ps) is ROUTES[route]
    assert trace_api.wants_sorted_rays(ps) == (route == "cluster")
    # 24,000 triangles at a cap of 128 clusters: packet and wide keep the
    # pool flat whatever its size, the others partition it
    big = _rects(n=12000, traversal=route, part_cap=128)
    assert (big.cl_tris.dim() == 3) == (route in ("packet", "wide"))
    moved = to_port(build_with(JaxBuilder, rects_recipe), traversal=route)
    assert trace_api._pick(moved) is ROUTES[route]
    desc = make_desc(PORT, False)
    assert trace_api._pick(pscene.assemble(desc, instancing="off",
                                           traversal=route)) is ROUTES[route]


def _rects(n=350, **kw):
    rng = np.random.default_rng(7)
    b = PortBuilder()
    m = b.lambert([0.7, 0.7, 0.7])
    for _ in range(n):
        b.add_rect(rng.uniform(-4, 4, 3), rng.uniform(-0.4, 0.4, 3),
                   rng.uniform(-0.4, 0.4, 3), m)
    return b.build(cam_pos=[0, 0, 10], cam_lookat=[0, 0, 0], width=8, height=8,
                   **kw)


def test_bad_choices_raise():
    with pytest.raises(ValueError, match="traversal"):
        _rects(n=2, traversal="fastest")
    desc = make_desc(PORT, False)
    with pytest.raises(ValueError, match="traversal"):
        pscene.assemble(desc, traversal="bvh")
    for route in ("dense", "packet", "wide"):
        with pytest.raises(ValueError, match="instanced"):
            pscene.assemble(desc, instancing="force", traversal=route)
    inst = pscene.assemble(desc, instancing="force", traversal="cluster")
    assert trace_api._pick(inst) is traverse_cluster
    import dataclasses
    # a scene checks its choice whenever it is made, so none reaches _pick
    with pytest.raises(ValueError, match="instanced"):
        dataclasses.replace(inst, traversal="packet")
    with pytest.raises(ValueError, match="traversal"):
        dataclasses.replace(_rects(n=2), traversal="bvh")


def test_sorted_entry_points_sort_only_for_the_cluster_route(monkeypatch):
    calls = []
    real = trace_api.coherence_order
    monkeypatch.setattr(trace_api, "coherence_order",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    ro = torch.tensor(rng.uniform(-6, 6, (512, 3)).astype(np.float32))
    rd = rng.normal(size=(512, 3)).astype(np.float32)
    rd = torch.tensor(rd / np.linalg.norm(rd, axis=1, keepdims=True))
    out = {}
    for route in sorted(ROUTES):
        ps = _rects(traversal=route)
        n0 = len(calls)
        t, tri, _, _ = trace_api.closest_hit_sorted(ps, ro, rd)
        occ = trace_api.any_hit_sorted(ps, ro, rd, 6.0)
        assert (len(calls) - n0) == (2 if route == "cluster" else 0)
        assert torch.equal(tri, trace_api.closest_hit(ps, ro, rd)[1])
        assert torch.equal(occ, trace_api.any_hit(ps, ro, rd, 6.0))
        out[route] = (t, tri, occ)
    for route in ("cluster", "packet", "wide"):
        assert torch.equal(out[route][2], out["dense"][2])
        assert float((out[route][1] == out["dense"][1]).float().mean()) > 0.999
        h = torch.isfinite(out["dense"][0])
        np.testing.assert_allclose(out[route][0][h].numpy(),
                                   out["dense"][0][h].numpy(), rtol=1e-4)


@pytest.fixture(scope="module")
def renders():
    """mirror_sphere at 64x64, 2 spp through the JAX package and through
    each of the port's four routes."""
    js = build_with(JaxBuilder, gs.scene_mirror_sphere)
    md = js.settings.trace_depth
    img_j, rays_j = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(SEED),
                                      n_pass=2, max_depth=md)
    out = {"jax": (np.asarray(img_j) / 2.0, float(rays_j))}
    for route in sorted(ROUTES):
        ps = to_port(js, traversal=route)
        img, rays = tpt.render_passes(ps, 0, SEED, n_pass=2, max_depth=md,
                                      device="cpu")
        out[route] = (img.numpy() / 2.0, float(rays))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_by_every_route_matches_jax(renders, route):
    img_j, rays_j = renders["jax"]
    img, rays = renders[route]
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    agree = (np.abs(img - img_j).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, (route, agree)
    assert abs(rays - rays_j) <= 1e-3 * rays_j
    for other in sorted(ROUTES):
        agree = (np.abs(img - renders[other][0]).max(axis=-1) <= 1e-3).mean()
        assert agree >= 0.99, (route, other, agree)


def test_unsorted_mode_permutes_nothing(monkeypatch):
    """With a route that does not want sorted rays the path tracer never
    computes a coherence order; with the cluster route it does once per
    bounce after the first. Both give the same image."""
    calls = []
    real = tpt.coherence_order
    monkeypatch.setattr(tpt, "coherence_order",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(gs, "SIZE", 16)
    imgs = {}
    for route in ("dense", "cluster"):
        ps = build_with(PortBuilder, gs.scene_cornell_diffuse)
        import dataclasses
        ps = dataclasses.replace(ps, traversal=route)
        n0 = len(calls)
        imgs[route], _ = tpt.render_passes(ps, 0, SEED, n_pass=1, max_depth=4,
                                           device="cpu")
        assert (len(calls) - n0) == (3 if route == "cluster" else 0)
    agree = ((imgs["dense"] - imgs["cluster"]).abs().amax(dim=-1) <= 1e-3)
    assert float(agree.float().mean()) >= 0.99
