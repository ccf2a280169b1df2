"""The port's bidirectional oracle (integrators/oracle.py:OracleSBDPT)
against the JAX package's, and the port's BDPT against the JAX package's
on the sky-lit scenes of tests/test_bdpt_sky.py (a constant sky and an
importance-sampled sky image): the env strategies the oracle's sky mode
pins.

Tolerances:
  * OracleSBDPT.render_strategy in rect-light and sky mode, every strategy
    the JAX oracle tests pin: rtol 1e-9 (the same scalar float64 walk over
    the same float32 tables);
  * the subpath vertices and the per-strategy images: as in
    tests/test_torch_bdpt.py (vertex fields at rtol 1e-5, atol 1e-6, masks
    equal; images by the image rule, total energy within rtol 1e-4), for
    "full" and "3way" on the port's auto and cluster routes.

The two statistical checks, the port's BDPT per (s, t) against the port's
OracleSBDPT (the criteria of tests/test_oracle_bdpt.py and
tests/test_oracle_bdpt_sky.py: 192 passes against 48 oracle samples a
pixel) and the port's BDPT and IBPT against the port's PT (the criteria of
tests/test_bdpt.py and tests/test_bdpt_sky.py), do not fit this file's
time budget on the CPU at those counts (the oracle alone takes about 70 s
for the eleven strategies): they run unchanged at 16x16 on the card, in
phase 18 of chip_smoke.py (bidir_statistics).
"""
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import oracle as joracle
from tests.test_bdpt_sky import _grad_env, _sky_scene
from tests.test_oracle_bdpt import _cornell as _oracle_cornell
from tests.test_oracle_bdpt_sky import _sky_scene as _oracle_sky
from tests.test_torch_bdpt import jax_cache, same_strategies, same_subpaths
from tests.test_torch_scene import to_port
from hydracore_tpu_torch.integrators import oracle as toracle

torch.set_num_threads(1)

RECT = [(0, 2), (1, 2), (1, 3), (2, 1), (2, 2)]
SKY = [(0, 2), (0, 3), (1, 2), (1, 3), (2, 1), (2, 2)]


@pytest.fixture(scope="module")
def oracles():
    out = {}
    for mode, make in (("rect", _oracle_cornell), ("sky", _oracle_sky)):
        js = make()
        out[mode] = (joracle.OracleSBDPT(js),
                     toracle.OracleSBDPT(to_port(js)))
    return out


@pytest.mark.parametrize("mode,s,t", [("rect", *st) for st in RECT]
                         + [("sky", *st) for st in SKY])
def test_oracle_sbdpt_matches_jax(oracles, mode, s, t):
    ref, got = oracles[mode]
    assert got.sky_mode == ref.sky_mode == (mode == "sky")
    a = got.render_strategy(s, t, spp=1, seed=23)
    b = ref.render_strategy(s, t, spp=1, seed=23)
    assert a.shape == (16, 16, 3) and a.dtype == np.float64
    assert b.sum() > 0.0
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


SCENES = {"sky_const": lambda: _sky_scene(),
          "sky_image": lambda: _sky_scene(img=_grad_env())}


@pytest.fixture(scope="module")
def jax_runs():
    return jax_cache(SCENES)


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
def test_sky_subpath_vertices_match_jax(jax_runs, traversal):
    """Sky lanes of y0 (directional measure, beta_dir, the planar disk
    density of y1) and the camera rays that escape (is_env, env_dir,
    pf_w_arr)."""
    js, _, sub = jax_runs("sky_image")
    same_subpaths(js, sub, traversal)


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
@pytest.mark.parametrize("strategy", ["full", "3way"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sky_strategy_images_match_jax(jax_runs, name, strategy, traversal):
    js, imgs, _ = jax_runs(name)
    same_strategies(js, imgs, strategy, traversal, name)
