"""Alpha parity: the split shadow sets, B2's twin over the opaque pool,
the dense alpha-layer test, the layered shadow walk and alpha renders of
the port against the JAX package.

Tolerances:
  * scene leaves (the opaque pool cl_tris_shadow, alpha_tri9f,
    alpha_tri_id among them) bit for bit;
  * occlusion masks equal (the JAX cluster kernel runs in Pallas interpret
    mode here);
  * alpha_layer_hit: hit ids equal, t, u, v within rtol 1e-5 (atol 1e-6);
  * images at 32x32, 4 spp, seed 777: >= 99% of pixels within 1e-3 of the
    JAX render and the ray count within 0.1%, through the layered walk of
    the dense route and through the split walk of the cluster route (the
    JAX render takes its dense route: the two walks make the same
    decisions).
"""
import dataclasses
import struct
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import trace_api as jta
from hydracore_tpu.ops import traverse_cluster as jtc
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import trace_api as tta
from hydracore_tpu_torch.scene.scene import scene_leaves
from tests.test_torch_assemble import JAX, make_desc
from tests.test_torch_scene import (_assert_same_leaves, jax_leaves,
                                    jax_settings, to_port)

torch.set_num_threads(1)

SEED = 777
N = 1024
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def alpha_scenes():
    js = ts.alpha()
    return js, to_port(js, traversal="cluster")


@pytest.fixture
def jax_cluster_route(monkeypatch):
    """The JAX package's cluster route on the CPU: its kernel in Pallas
    interpret mode, picked for a scene its size rule sends to the dense
    route."""
    monkeypatch.setattr(jtc, "INTERPRET", True)
    monkeypatch.setattr(jta, "_use_dense", lambda s: False)
    monkeypatch.setattr(jta, "_use_cluster", lambda s: True)


def _shadow_rays(scene, seed, n=N):
    """Rays from random floor points (y = 0) to jittered points around
    the point light, as NEE sends them: (o, d, dist)."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, [0, 2]] = rng.uniform(-2.5, 2.5, (n, 2))
    o[:, 1] = 1e-4
    target = np.array([0.2, 2.5, 0.1]) + rng.uniform(-0.6, 0.6, (n, 3))
    d = (target - o).astype(np.float32)
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    return o, (d / dist[:, None]).astype(np.float32), dist


def test_shadow_split_leaves():
    """Both packages' builders give the same leaves, the opaque pool and
    the dense alpha set among them; the pool's alpha lanes are all zero and
    every other lane is cl_tris's."""
    js, ps = ts.alpha("jax"), ts.alpha("port")
    _assert_same_leaves(jax_leaves(js), scene_leaves(ps))
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    ids = ps.alpha_tri_id[ps.alpha_tri_id >= 0]
    assert ids.numel() == 8  # 4 soft quads
    soft = torch.isin(ps.cl_slot_tri.reshape(-1, 128), ids)
    full = ps.cl_tris.reshape(-1, 4, 3, 128)
    shadow = ps.cl_tris_shadow.reshape(-1, 4, 3, 128)
    keep = ~soft[:, None, None, :].expand_as(full)
    assert (shadow[~keep] == 0).all() and torch.equal(shadow[keep], full[keep])


def test_any_hit_opaque(alpha_scenes, jax_cluster_route):
    """B2's twin over the opaque pool against the JAX kernel over the
    same pool; rays stopped just past an alpha quad hit the full pool and
    never the opaque one."""
    js, ps = alpha_scenes
    o, d, dist = _shadow_rays(ps, 1)
    act = np.random.default_rng(2).random(N) < 0.9
    occ_j = np.asarray(jtc.any_hit(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(dist * 0.995),
                                   active=jnp.asarray(act), opaque_only=True))
    args = [torch.tensor(x) for x in (o, d, dist * 0.995)]
    occ_p = tta.any_hit_opaque(ps, *args, active=torch.tensor(act))
    assert np.array_equal(occ_p.numpy(), occ_j)
    assert 0 < occ_j.sum() < act.sum()
    # aim at the alpha triangles' centroids, stopping just past them
    tri9 = ps.alpha_tri9f[:, ps.alpha_tri_id >= 0]
    c = (tri9[0:3] + (tri9[3:6] + tri9[6:9]) / 3.0).T
    o2 = torch.tensor([0.1, 0.05, 0.2]).expand_as(c).contiguous()
    d2 = c - o2
    t2 = d2.norm(dim=1)
    d2 = d2 / t2[:, None]
    full = tta.any_hit(ps, o2, d2, t2 + 1e-3)
    opaque = tta.any_hit_opaque(ps, o2, d2, t2 + 1e-3)
    assert full.all() and not opaque.any()
    occ_jz = np.asarray(jtc.any_hit(js, jnp.asarray(o2.numpy()),
                                    jnp.asarray(d2.numpy()),
                                    jnp.asarray((t2 + 1e-3).numpy()),
                                    opaque_only=True))
    assert not occ_jz.any()


def test_any_hit_opaque_partitioned():
    """The opaque pool of a pool partitioned into chunks answers as the
    flat one (the twin's chunk walk over cl_tris_shadow)."""
    flat, part = (ts.alpha("port", sphere_segments=96, traversal="cluster",
                           part_cap=cap) for cap in (1 << 20, 128))
    assert flat.cl_tris.dim() == 3 and part.cl_tris_shadow.dim() == 4
    o, d, dist = _shadow_rays(flat, 3)
    args = [torch.tensor(x) for x in (o, d, dist * 0.995)]
    occ_f = tta.any_hit_opaque(flat, *args)
    occ_p = tta.any_hit_opaque(part, *args)
    assert torch.equal(occ_f, occ_p) and 0 < int(occ_f.sum()) < N


def test_alpha_layer_hit(alpha_scenes, monkeypatch):
    """The dense alpha-layer test in steps of 64 rays against the JAX
    package's one dense block."""
    js, ps = alpha_scenes
    o, d, dist = _shadow_rays(ps, 4)
    rng = np.random.default_rng(5)
    t_lo = rng.uniform(1e-5, 0.8, N).astype(np.float32)
    t_hi = dist * 0.995
    act = rng.random(N) < 0.8
    out_j = jta.alpha_layer_hit(js, *(jnp.asarray(x) for x in
                                      (o, d, t_lo, t_hi, act)))
    monkeypatch.setattr(tta, "ALPHA_STEP_ELEMS", 64 * ps.alpha_tri9f.shape[1])
    out_p = tta.alpha_layer_hit(ps, *(torch.tensor(x) for x in
                                      (o, d, t_lo, t_hi, act)))
    t_j, id_j, u_j, v_j = (np.asarray(x) for x in out_j)
    t_p, id_p, u_p, v_p = (x.numpy() for x in out_p)
    assert np.array_equal(id_p, id_j) and 0 < (id_j >= 0).sum() < N
    for name, a, b in (("t", t_p, t_j), ("u", u_p, u_j), ("v", v_p, v_j)):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_layered_walk_split(alpha_scenes, jax_cluster_route):
    """The split walk's occlusion (B2 over the opaque pool, then up to
    MAX_ALPHA_SHADOW_STEPS alpha layers) against the JAX package's."""
    js, ps = alpha_scenes
    assert jta.has_shadow_split(js) and tta.has_shadow_split(ps)
    o, d, dist = _shadow_rays(ps, 6)
    rng = np.random.default_rng(7)
    act = rng.random(N) < 0.9
    u_alpha = rng.integers(0, 2**32, N, dtype=np.uint64)
    occ_j = np.asarray(jpt.shadow_trace(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
        jnp.asarray(act), jnp.asarray(u_alpha.astype(np.uint32)), True,
        presorted=True))
    occ_p = tpt.shadow_trace(ps, *(torch.tensor(x) for x in (o, d, dist, act)),
                             torch.tensor(u_alpha.astype(np.int64)))
    assert np.array_equal(occ_p.numpy(), occ_j)
    opaque = tta.any_hit_opaque(ps, *(torch.tensor(x) for x in
                                      (o, d, dist * 0.995)),
                                active=torch.tensor(act))
    assert (occ_j & ~opaque.numpy()).any()  # alpha layers occlude some
    assert (act & ~occ_j).any()


def _alpha_boxes_desc(tmp_path, pkg):
    """test_torch_assemble's plane and five boxes with an opacity map on
    the boxes' material, its texture file in tmp_path."""
    sf = pkg[0]
    desc = make_desc(pkg, False)
    img = np.clip(np.round(ts.opacity_map(8, 8) * 255), 0, 255).astype(np.uint8)
    data = struct.pack("<ii", 8, 8) + img.tobytes()
    (tmp_path / "op.image4ub").write_bytes(data)
    desc.textures[1] = sf.TextureDesc(id=1, name="op", loc="op.image4ub",
                                      offset=0, bytesize=len(data))
    desc.lib_dir = str(tmp_path)
    desc.materials[0] = ET.fromstring(
        '<material id="0" type="hydra_material"><diffuse><color val="0.7 0.3 '
        '0.2"/></diffuse><opacity><texture id="1" type="texref"/></opacity>'
        '</material>')
    return desc


def test_layered_walk_instanced(tmp_path):
    """An instanced alpha scene has no split: the layered closest-hit walk
    (B3's twin here, the JAX kernel in interpret mode there) gives equal
    occlusion masks."""
    js = jscene.assemble(_alpha_boxes_desc(tmp_path, JAX), instancing="force")
    assert js.settings.has_inst and js.settings.has_alpha
    assert js.cl_tris_shadow is None
    ps = to_port(js)
    assert not tta.has_shadow_split(ps)
    rng = np.random.default_rng(8)
    o = np.zeros((N, 3), np.float32)
    o[:, [0, 2]] = rng.uniform(-4, 4, (N, 2))
    o[:, 1] = -0.999
    target = rng.uniform([-4, 3.0, -2], [4, 4.0, 4], (N, 3))
    d = (target - o).astype(np.float32)
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    d = (d / dist[:, None]).astype(np.float32)
    act = np.ones(N, bool)
    u_alpha = rng.integers(0, 2**32, N, dtype=np.uint64)
    occ_j = np.asarray(jpt.shadow_trace(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
        jnp.asarray(act), jnp.asarray(u_alpha.astype(np.uint32)), True,
        presorted=True))
    occ_p = tpt.shadow_trace(ps, *(torch.tensor(x) for x in (o, d, dist, act)),
                             torch.tensor(u_alpha.astype(np.int64)))
    assert np.array_equal(occ_p.numpy(), occ_j)
    solid = tta.any_hit(ps, *(torch.tensor(x) for x in (o, d, dist * 0.995)))
    assert (solid.numpy() & ~occ_j).any()  # some rays pass an alpha surface
    assert occ_j.any()


@pytest.fixture(scope="module")
def jax_render(alpha_scenes):
    js, _ = alpha_scenes
    img, rays = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(SEED),
                                  n_pass=4, max_depth=4)
    return np.asarray(img) / 4.0, float(rays)


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_alpha_render_matches_jax(alpha_scenes, jax_render, traversal):
    js, ps = alpha_scenes
    if traversal != "cluster":
        ps = to_port(js, traversal=traversal)
    assert tta.has_shadow_split(ps) == (traversal == "cluster")
    img_j, rays_j = jax_render
    img_p, rays_p = tpt.render_passes(ps, 0, SEED, n_pass=4, max_depth=4,
                                      device="cpu")
    img_p = img_p.numpy() / 4.0
    assert img_p.shape == (32, 32, 3) and np.isfinite(img_p).all()
    assert img_p.mean() > 0.01
    agree = (np.abs(img_p - img_j).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
    assert abs(int(rays_p) - rays_j) <= 1e-3 * rays_j
