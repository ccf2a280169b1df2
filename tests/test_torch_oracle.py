"""The port's numpy oracle (integrators/oracle.py) and the builder's
brute-force intersector and BVH statistics against the JAX package's, and
the port's light tracer against the port's OracleLT.

Tolerances:
  * brute_force_closest_hit, bvh_stats: equal (the same numpy code);
  * OracleLT.render: rtol 1e-9 (the same scalar float64 walk over the
    same float32 tables);
  * OracleRenderer.render: rtol 1e-5, atol 1e-7 (its eye rays come from
    each package's make_eye_rays, float32 and an ulp apart);
  * render_lt against OracleLT: the criteria of tests/test_oracle_lt.py;
  * pt.render against OracleRenderer: the criteria of tests/test_oracle.py.
"""
import numpy as np
import pytest
import torch

from hydracore_tpu.bvh import builder as jbuilder
from hydracore_tpu.integrators import oracle as joracle
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.bvh import builder as tbuilder
from hydracore_tpu_torch.integrators import lt as tlt
from hydracore_tpu_torch.integrators import oracle as toracle
from hydracore_tpu_torch.integrators import pt as tpt
from tests.test_torch_scene import to_port

torch.set_num_threads(1)


def _tris(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    return v0, e1, e2


def test_brute_force_closest_hit_matches_jax():
    v0, e1, e2 = _tris(300, 1)
    rng = np.random.default_rng(2)
    o = rng.uniform(-5, 5, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for t_max in (1e30, 2.5):
        a = tbuilder.brute_force_closest_hit(o, d, v0, e1, e2, t_max)
        b = jbuilder.brute_force_closest_hit(o, d, v0, e1, e2, t_max)
        assert (a[1] >= 0).any() and (a[1] < 0).any()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_bvh_stats_matches_jax():
    v0, e1, e2 = _tris(700, 3)
    v1, v2 = v0 + e1, v0 + e2
    st = tbuilder.bvh_stats(tbuilder.build_bvh(v0, v1, v2))
    sj = jbuilder.bvh_stats(jbuilder.build_bvh(v0, v1, v2))
    assert st == sj
    assert st["tris"] == 700 and st["max_depth"] > 4


def _box(width, height):
    """tests/test_oracle_lt.py's box."""
    b = SceneBuilder()
    grey = b.lambert([0.65, 0.65, 0.65])
    red = b.lambert([0.7, 0.15, 0.1])
    b.add_box_interior(2.0, grey, grey, grey, red, grey)
    b.rect_light([0, 1.95, 0], 0.7, 0.7, [12.0, 11.0, 9.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=width,
                   height=height, trace_depth=4)


def test_oracle_lt_matches_jax():
    js = _box(8, 6)
    a = toracle.OracleLT(to_port(js)).render(n_paths=600, max_depth=4, seed=8)
    b = joracle.OracleLT(js).render(n_paths=600, max_depth=4, seed=8)
    assert a.shape == (6, 8, 3) and a.sum() > 0
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


@pytest.mark.parametrize("mode", ["mispt", "ptstupid", "shadowpt"])
def test_oracle_renderer_matches_jax(mode):
    """A glossy and a glass sphere in the box (every lobe of the oracle's
    bounce), 5x4, 2 spp, depth 3."""
    b = SceneBuilder()
    grey = b.lambert([0.65, 0.65, 0.65])
    b.add_box_interior(2.0, grey, grey, grey, grey, grey)
    ggx = b.add_material(refl_color=np.array([0.8, 0.7, 0.5], np.float32),
                         refl_dist=2, refl_alpha=0.3, refl_gloss=0.7,
                         diff_color=np.array([0.2, 0.2, 0.2], np.float32))
    b.add_sphere([-0.6, -1.2, -0.3], 0.7, ggx, n_seg=8, n_ring=4)
    glass = b.add_material(transp_color=np.array([0.95] * 3, np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_sphere([0.8, -1.4, 0.6], 0.5, glass, n_seg=8, n_ring=4)
    b.rect_light([0, 1.95, 0], 0.7, 0.7, [12.0, 11.0, 9.0])
    js = b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=5,
                 height=4, trace_depth=3)
    ps = to_port(js)
    a = toracle.OracleRenderer(ps, mode).render(5, 4, spp=2, max_depth=3,
                                                seed=3)
    b = joracle.OracleRenderer(js, mode).render(5, 4, spp=2, max_depth=3,
                                                seed=3)
    assert a.shape == (4, 5, 3) and a.sum() > 0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_rand4_matches_jax():
    for idx, bounce, group, seed in ((0, 0, 0, 0), (12345, 3, 6, 777),
                                     (0xFFFFFFFF, 11, 12, 0xDEADBEEF)):
        np.testing.assert_array_equal(toracle._rand4(idx, bounce, group, seed),
                                      joracle._rand4(idx, bounce, group, seed))


def test_oracle_lt_matches_render_lt():
    """tests/test_oracle_lt.py on the port: the port's wavefront LT against
    the port's scalar OracleLT."""
    sc = to_port(_box(16, 12))
    W, H = 16, 12
    dev = tlt.render_lt(sc, n_passes=64, paths_per_pass=W * H * 16, seed=3,
                        max_depth=4, device="cpu").numpy()
    orc = toracle.OracleLT(sc).render(n_paths=24000, max_depth=4, seed=8)
    assert np.isfinite(orc).all() and orc.max() > 0
    rel = abs(dev.mean() - orc.mean()) / max(dev.mean(), 1e-9)
    assert rel < 0.12, f"device={dev.mean():.4f} oracle={orc.mean():.4f}"
    db = dev.reshape(H // 4, 4, W // 4, 4, 3).mean(axis=(1, 3, 4))
    ob = orc.reshape(H // 4, 4, W // 4, 4, 3).mean(axis=(1, 3, 4))
    mask = db > 0.05 * db.max()
    rb = np.abs(db - ob)[mask] / np.maximum(db[mask], 1e-9)
    assert np.median(rb) < 0.2, f"block medians differ: {np.median(rb):.3f}"
    dc = dev.reshape(-1, 3).sum(axis=0)
    oc = orc.reshape(-1, 3).sum(axis=0)
    assert dc[0] > dc[2] and oc[0] > oc[2]



def test_oracle_renderer_matches_render():
    """tests/test_oracle.py's first case on the port: the port's wavefront
    path tracer against the port's scalar OracleRenderer."""
    b = SceneBuilder()
    m = b.lambert([0.6, 0.5, 0.4])
    b.add_box_interior(2.0, m, m, m, m, m)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [14.0, 14.0, 14.0])
    sc = to_port(b.build(cam_pos=[0, 0, 5.4], cam_lookat=[0, 0, 0], width=10,
                         height=10, trace_depth=3))
    prod = tpt.render(sc, spp=256, seed=3, max_depth=3, device="cpu").numpy()
    orc = toracle.OracleRenderer(sc).render(10, 10, spp=48, max_depth=3,
                                            seed=11)
    emit = prod.max(-1) > 5.0  # the emitter's pixels: large variance
    a = np.where(emit[..., None], 0, prod)
    c = np.where(emit[..., None], 0, orc)
    rel = abs(a.mean() - c.mean()) / max(a.mean(), 1e-9)
    assert rel < 0.12, f"render={a.mean():.4f} oracle={c.mean():.4f}"
    mask = a.mean(-1) > 0.05
    perpix = np.abs(a.mean(-1) - c.mean(-1))[mask] \
        / np.maximum(a.mean(-1)[mask], 1e-9)
    assert np.median(perpix) < 0.25, f"median per pixel {np.median(perpix)}"
