"""Path-tracer parity: the port's eye rays, hit interpolation and images
against the JAX package's integrators/pt.py on the same scene bytes.

Tolerances:
  * make_eye_rays / compute_hit: rtol 1e-5, atol 1e-6 (ulp-level
    differences of the transcendentals and matrix products), integer ids
    exactly;
  * images at 32x32, 4 spp, seed 777: >= 99% of pixels within 1e-3 of the
    JAX render (the counter-based RNG gives both the same sample set; a
    rare ulp-level difference can flip a discrete choice of one path), and
    the ray counter within 0.1%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from tests.test_torch_scene import build_with, to_port

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SEED = 777


def _close(t, j, name):
    t, j = t.numpy(), np.asarray(j)
    if np.issubdtype(j.dtype, np.integer):
        assert np.array_equal(t, j), name
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=name)


def _dof_scene():
    b = gs.SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    b.add_box_interior(2.0, m, m, m, m, m)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build(cam_pos=[0.3, 0.2, 5.6], cam_lookat=[0, 0, 0], width=24,
                   height=16, lens_radius=0.2)


@pytest.mark.parametrize("recipe", [gs.scene_ggx_rough, _dof_scene])
def test_make_eye_rays(recipe):
    js = build_with(JaxBuilder, recipe)
    ps = to_port(js)
    W, H = ps.camera.width, ps.camera.height
    rng = np.random.default_rng(11)
    n = 4096
    px = rng.integers(0, W, n).astype(np.int32)
    py = rng.integers(0, H, n).astype(np.int32)
    jit = rng.random((n, 2)).astype(np.float32)
    lens = rng.random((n, 2)).astype(np.float32)
    oj, dj = jpt.make_eye_rays(js.camera, jnp.asarray(px), jnp.asarray(py),
                               jnp.asarray(jit), jnp.asarray(lens))
    op, dp = tpt.make_eye_rays(ps.camera, torch.tensor(px), torch.tensor(py),
                               torch.tensor(jit), torch.tensor(lens))
    _close(op, oj, "origin")
    _close(dp, dj, "direction")


def test_compute_hit():
    js = build_with(JaxBuilder, gs.scene_spot_sphere_lights)
    ps = to_port(js)
    rng = np.random.default_rng(12)
    n = 4096
    tri = rng.integers(0, ps.num_triangles, n).astype(np.int32)
    u = rng.random(n).astype(np.float32) * 0.5
    v = rng.random(n).astype(np.float32) * 0.5
    ro = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t = rng.uniform(0.1, 3.0, n).astype(np.float32)
    outj = jpt.compute_hit(js, *(jnp.asarray(x) for x in (tri, u, v, ro, rd, t)))
    outp = tpt.compute_hit(ps, *(torch.tensor(x) for x in (tri, u, v, ro, rd, t)))
    for name, a, b in zip(("pos", "n", "ng", "uv", "mat", "light", "tangent"),
                          outp, outj):
        _close(a, b, name)


@pytest.mark.parametrize("name", ["cornell_diffuse", "glass_sphere"])
def test_render_matches_jax(name, monkeypatch):
    monkeypatch.setattr(gs, "SIZE", 32)
    js = build_with(JaxBuilder, gs.SCENES[name])
    ps = to_port(js)
    md = js.settings.trace_depth
    img_j, rays_j = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(SEED),
                                      n_pass=4, max_depth=md)
    img_p, rays_p = tpt.render_passes(ps, 0, SEED, n_pass=4, max_depth=md,
                                      device="cpu")
    img_j = np.asarray(img_j) / 4.0
    img_p = img_p.numpy() / 4.0
    assert img_p.shape == (32, 32, 3) and np.isfinite(img_p).all()
    assert img_p.mean() > 0.01
    agree = (np.abs(img_p - img_j).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
    rays_j = float(rays_j)
    assert abs(int(rays_p) - rays_j) <= 1e-3 * rays_j


def test_render_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ps = build_with(PortBuilder, gs.scene_cornell_diffuse)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.render(ps, spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.render_passes(ps, 0, SEED, n_pass=1)
