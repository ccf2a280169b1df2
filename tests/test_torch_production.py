"""The path tracer's other schedules: the port's render_pass and production
sampling (render_tile_production, render_production) against the JAX
package's integrators/pt.py, and against the port's own pass loop.

Production draws the pass loop's sample set: sample s of pixel p keys the
streams by p * PHI ^ s and the QMC index s, whether it runs as pass s of
render or as sample s of a round, so production at spp <= 64 (one round)
equals render at the same spp pixel for pixel, up to accumulation order,
and spp 100 (two rounds of 64, as in the JAX package) equals render at
spp 128. Images are held to the rule of tests/test_torch_pt.py: >= 99% of
pixels within 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.integrators import pt as tpt
from tests.test_torch_scene import to_port

torch.set_num_threads(1)


def _close(a, b) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) <= 1e-3).mean())


def _box(width=12, height=12, mirror=False):
    """test_aux_subsystems.py's production box (a diffuse box under a rect
    light), optionally with a mirror sphere."""
    b = SceneBuilder()
    m = b.lambert([0.6] * 3)
    b.add_box_interior(2.0, m, m, m, m, m)
    if mirror:
        mm = b.add_material(refl_color=np.array([0.85] * 3, np.float32))
        b.add_sphere([-0.5, -1.2, 0.2], 0.7, mm, n_seg=12, n_ring=6)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=width,
                   height=height, trace_depth=3)


@pytest.fixture(scope="module")
def box():
    js = _box()
    return js, to_port(js)


def test_render_pass_matches_jax():
    js = _box(24, 16, mirror=True)
    img_j, rays_j = jpt.render_pass(js, jnp.uint32(5), jnp.uint32(777),
                                    max_depth=4)
    img_p, rays_p = tpt.render_pass(to_port(js), 5, 777, max_depth=4,
                                    device="cpu")
    assert img_p.shape == (16, 24, 3) and torch.isfinite(img_p).all()
    assert float(img_p.mean()) > 0.01
    assert _close(img_j, img_p) >= 0.99
    assert abs(int(rays_p) - float(rays_j)) <= 1e-3 * float(rays_j)
    # one pass of render_passes is the same sample set, banded alike
    img_b, rays_b = tpt.render_passes(to_port(js), 5, 777, n_pass=1,
                                      max_depth=4, device="cpu")
    assert _close(img_b, img_p) == 1.0 and int(rays_b) == int(rays_p)


def test_render_production_matches_jax(box):
    """test_aux_subsystems.py's case: 12x12, spp 64, tiles of 72 pixels."""
    js, ps = box
    img_j = jpt.render_production(js, spp=64, seed=3, max_depth=3,
                                  tile_pixels=72)
    stats = {}
    img_p = tpt.render_production(ps, spp=64, seed=3, max_depth=3,
                                  tile_pixels=72, device="cpu", stats=stats)
    assert stats["tiles"] == 2 and stats["rounds"] == 1
    assert img_p.shape == (12, 12, 3) and float(img_p.mean()) > 0.01
    assert _close(img_j, img_p) >= 0.99


def test_tile_production_is_the_mean_of_its_samples(box):
    """render_tile_production of a few pixels equals the clamped mean of
    its samples traced one by one as passes of the pass loop."""
    _, ps = box
    ids = torch.tensor([0, 13, 77, 143])
    tile = tpt.render_tile_production(ps, ids, 8, 3, k_samples=4,
                                      max_depth=3, device="cpu")
    passes = [tpt.render_pass(ps, 8 + k, 3, max_depth=3, device="cpu")[0]
              for k in range(4)]
    ref = torch.stack(passes).mean(0).reshape(-1, 3)[ids]
    assert _close(ref, tile) == 1.0


def test_production_entry_points_need_cuda(box):
    """render_pass, render_tile_production and render_production run on
    the card unless asked for the CPU: without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, ps = box
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.render_pass(ps, 0, 3, max_depth=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.render_tile_production(ps, torch.arange(4), 0, 3, k_samples=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.render_production(ps, spp=2, seed=3, max_depth=3)


def test_production_equals_render_one_round(box):
    """spp 16: one round of K = 16, the samples of render's 16 passes."""
    _, ps = box
    a = tpt.render(ps, spp=16, seed=9, max_depth=3, device="cpu")
    stats = {}
    c = tpt.render_production(ps, spp=16, seed=9, max_depth=3,
                              tile_pixels=50, device="cpu", stats=stats)
    assert stats["rounds"] == 1 and stats["tiles"] == 3
    assert _close(a, c) >= 0.99


def test_production_rounds_spp_up(box):
    """spp 100 runs ceil(100 / 64) = 2 rounds of K = 64, so 128 samples a
    pixel (as the JAX package does): twice the rays of one round, and the
    image of render at spp 128."""
    _, ps = box
    one, two = {}, {}
    tpt.render_production(ps, spp=64, seed=4, max_depth=3, device="cpu",
                          stats=one)
    c = tpt.render_production(ps, spp=100, seed=4, max_depth=3,
                              device="cpu", stats=two)
    assert one["rounds"] == 1 and two["rounds"] == 2
    r1, r2 = int(one["rays"]), int(two["rays"])
    assert abs(r2 - 2 * r1) <= 0.05 * r1
    a = tpt.render(ps, spp=128, seed=4, max_depth=3, device="cpu")
    assert _close(a, c) >= 0.99
