"""The port's utils against the JAX package's: utils/framebuffer.py,
utils/checkpoint.py, utils/denoise.py, utils/stats.py and the bakers of
bsdf/energy_tables.py.

Tolerances:
  * hdr_to_ldr, mse and the bakers are numpy in both packages, the same
    operations in the same order: bit for bit;
  * checkpoints: the same .npz keys, so a file written by either package
    loads in the other bit for bit;
  * multiscatter_factor: one float32 gather, subtract and IEEE divide in
    both: bit for bit;
  * the filters are float32 shift stacks in both (jnp.roll / torch.roll);
    XLA fuses and may contract them, and the exps of the two libraries may
    differ by an ulp, so rtol 1e-5, atol 1e-6 (normalmap_from_height
    rtol 1e-6, atol 1e-7: no exp);
  * MRaysStat.summary() prints the same line from the same fields.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.bsdf import energy_tables as jet
from hydracore_tpu.utils import checkpoint as jck
from hydracore_tpu.utils import denoise as jdn
from hydracore_tpu.utils import framebuffer as jfb
from hydracore_tpu.utils import stats as jst
from hydracore_tpu_torch.bsdf import energy_tables as pet
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.utils import checkpoint as pck
from hydracore_tpu_torch.utils import denoise as pdn
from hydracore_tpu_torch.utils import framebuffer as pfb
from hydracore_tpu_torch.utils import stats as pst

torch.set_num_threads(1)


def _hdr(seed=3, shape=(13, 17, 3)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32) ** 2
    x.reshape(-1)[:4] = [np.nan, np.inf, -np.inf, -1.0]
    return x


@pytest.mark.parametrize("gamma,exposure", [(2.2, 1.0), (1.0, 0.5), (1.8, 3.0)])
def test_hdr_to_ldr_bit_equal(gamma, exposure):
    x = _hdr()
    want = jfb.hdr_to_ldr(x, gamma=gamma, exposure=exposure)
    got = pfb.hdr_to_ldr(x, gamma=gamma, exposure=exposure)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_png_and_mse_match(tmp_path):
    from PIL import Image

    x = _hdr(5)
    jfb.save_hdr_as_png(str(tmp_path / "j.png"), x)
    pfb.save_hdr_as_png(str(tmp_path / "p.png"), x)
    a = np.asarray(Image.open(tmp_path / "j.png"))
    b = np.asarray(Image.open(tmp_path / "p.png"))
    assert np.array_equal(a, b)
    y = jfb.hdr_to_ldr(_hdr(6))
    assert pfb.mse(a, y) == jfb.mse(a, y) > 0.0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_loads(tmp_path, writer):
    fb = _hdr(7)[..., :3]
    fb = np.nan_to_num(fb, posinf=1.0, neginf=0.0)
    path = str(tmp_path / "ck.npz")
    (jck if writer == "jax" else pck).save_checkpoint(path, fb, 24, 91)
    for mod in (jck, pck):
        got, spp, seed = mod.load_checkpoint(path)
        assert np.array_equal(got, fb) and (spp, seed) == (24, 91)
    assert sorted(np.load(path).files) == ["fb_sum", "seed", "spp", "version"]


def _noisy(seed=11, H=20, W=23):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W, 3), np.float32)
    img[:, W // 2:] = [0.8, 0.6, 0.3]
    return img + rng.normal(0, 0.05, img.shape).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(sigma_s=1.5, sigma_r=0.2, radius=2)])
def test_bilateral_matches_jax(kw):
    img = _noisy()
    want = np.asarray(jdn.bilateral_filter(jnp.asarray(img), **kw))
    got = pdn.bilateral_filter(torch.as_tensor(img), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, dict(h=0.2, search_radius=2, patch_radius=2)])
def test_nlm_matches_jax(kw):
    img = _noisy(12)
    want = np.asarray(jdn.nlm_filter(jnp.asarray(img), **kw))
    got = pdn.nlm_filter(torch.as_tensor(img), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("amount", [1.0, 2.5])
def test_normalmap_from_height_matches_jax(amount):
    h = np.random.default_rng(13).random((15, 18)).astype(np.float32)
    want = np.asarray(jdn.normalmap_from_height(jnp.asarray(h), amount))
    got = pdn.normalmap_from_height(torch.as_tensor(h), amount).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_ggx_baker_bit_equal():
    want = jet.bake_ggx_albedo(size=8, n_samples=512, seed=2)
    got = pet.bake_ggx_albedo(size=8, n_samples=512, seed=2)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_transp_baker_bit_equal():
    want = jet.bake_transp_albedo(size=8, n_samples=512, seed=2)
    got = pet.bake_transp_albedo(size=8, n_samples=512, seed=2)
    assert got.shape == (8, 8, 8) and np.array_equal(got, want)


def test_multiscatter_factor_matches_jax():
    rng = np.random.default_rng(17)
    E = np.load(pet._GGX_PATH)["E"].astype(np.float32)
    mu = rng.random(4096).astype(np.float32)
    alpha = rng.random(4096).astype(np.float32)
    want = np.asarray(jet.multiscatter_factor(jnp.asarray(E), jnp.asarray(mu),
                                              jnp.asarray(alpha)))
    got = pet.multiscatter_factor(torch.as_tensor(E), torch.as_tensor(mu),
                                  torch.as_tensor(alpha)).numpy()
    assert np.array_equal(got, want)
    # the committed tables are the loaders' tables, untouched by a bake
    assert np.array_equal(pet.ggx_tables(torch.device("cpu"))[0].numpy(), E)


def test_mrays_stat_summary_matches_jax():
    vals = dict(raysPerSec=123.456, samplesPerSec=7.891, traversalTimeMs=1.25,
                shadowTimeMs=0.75, shadeTimeMs=3.5, samLightTimeMs=0.1,
                bounceTimeMs=1.1, sampleTimeMs=5.5, tracePercent=41.6, passes=2)
    assert ([f.name for f in dataclasses.fields(pst.MRaysStat)]
            == [f.name for f in dataclasses.fields(jst.MRaysStat)])
    assert pst.MRaysStat(**vals).summary() == jst.MRaysStat(**vals).summary()


def test_profile_pass_on_cpu():
    """The differential scheme on the CPU: every stage finite, the rates
    from one pass's ray counter (no timing is asserted: the CPU's clock
    says nothing of the card)."""
    from hydracore_tpu_torch.integrators.pt import render_passes

    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    b.add_box_interior(2.0, m, m, m, m, m)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    sc = b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=8, height=8,
                 trace_depth=3)
    st = pst.profile_pass(sc, n_rays=32, max_depth=3, n_timed=2, device="cpu")
    assert pst.N_LO == 2 and pst.N_HI == 6 and st.passes == 1
    for v in dataclasses.astuple(st):
        assert np.isfinite(v)
    _, rays = render_passes(sc, 0, 777, n_pass=1, max_depth=3, device="cpu")
    assert st.raysPerSec / st.samplesPerSec == pytest.approx(int(rays) / 64)
    assert st.bounceTimeMs == pytest.approx(st.sampleTimeMs / 3)
    assert st.summary().startswith("[stat] rays/sec(")
